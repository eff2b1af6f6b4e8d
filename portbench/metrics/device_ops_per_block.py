"""Device operations (kernels, copies, memsets) a block in the profiled
stretch."""


def read(view):
    s = view.stretch
    if s is None or not s.ops:
        return None
    return len(s.ops) / s.blocks
