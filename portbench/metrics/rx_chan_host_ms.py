"""Host ms a block in the product step's channelizer spans (`rx
channelizer`, one a channel), from the program's own tally
(`sdrangel_tpu_torch.runtime.tracing`), which adds only while a profiler
runs: the harness's profiled stretch. The time carries the profiler's
inflation, as bank_demod_host_ms does."""

SPANS = ("rx channelizer",)


def read(view):
    if view.stretch is None:
        return None
    try:
        from sdrangel_tpu_torch.runtime import tracing
    except ImportError:  # a program without the tally
        return None
    spans = tracing.totals()[0]
    if not any(n in spans for n in SPANS):
        return None
    return sum(spans[n][1] for n in SPANS if n in spans) * 1e3 / view.stretch.blocks
