"""MB (10^6 bytes) of host memory pinned a block: the program's `pinned
bytes` counter (`sdrangel_tpu_torch.runtime.tracing`: `RxPipeline.upload`'s
pinned copy of the block, `engine.fetch`'s pinned buffer), which adds only
while a profiler runs: the harness's profiled stretch."""

COUNTER = "pinned bytes"


def read(view):
    if view.stretch is None:
        return None
    try:
        from sdrangel_tpu_torch.runtime import tracing
    except ImportError:  # a program without the counter
        return None
    n = tracing.totals()[1].get(COUNTER)
    return None if n is None else n / 1e6 / view.stretch.blocks
