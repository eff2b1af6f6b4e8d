"""Device ms a block launched inside the gear's demod-bank range."""

RANGE = "gear demod bank"


def read(view):
    s = view.stretch
    if s is None:
        return None
    return s.device_ms_per_block(lambda op: op.owner == RANGE) or None
