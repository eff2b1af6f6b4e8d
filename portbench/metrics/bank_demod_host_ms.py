"""Host ms a block inside the gear's demod-bank range (its own spans,
profiled stretch)."""

RANGE = "gear demod bank"


def read(view):
    s = view.stretch
    return None if s is None else s.host_ms_per_block(RANGE)
