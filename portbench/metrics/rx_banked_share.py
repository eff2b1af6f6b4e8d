"""The share of the product step's channels whose demod ran inside a bank
of two or more (one batched `process` call over their stacked inputs): the
program's `rx banked channels` counter over its `rx channels` counter
(`sdrangel_tpu_torch.runtime.tracing`), which add only while a profiler
runs: the harness's profiled stretch."""

BANKED, CHANNELS = "rx banked channels", "rx channels"


def read(view):
    if view.stretch is None:
        return None
    try:
        from sdrangel_tpu_torch.runtime import tracing
    except ImportError:  # a program without the counters
        return None
    counters = tracing.totals()[1]
    if not counters.get(CHANNELS):
        return None
    return counters.get(BANKED, 0) / counters[CHANNELS]
