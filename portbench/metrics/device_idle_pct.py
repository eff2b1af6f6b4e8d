"""The share of the profiled stretch's wall time in which no kernel, copy
or memset ran on the card."""


def read(view):
    s = view.stretch
    if s is None or not s.ops or s.wall_us <= 0:
        return None
    return 100.0 * (1.0 - s.busy_us / s.wall_us)
