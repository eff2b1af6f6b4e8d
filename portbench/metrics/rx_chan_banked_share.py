"""The share of the product step's channels whose channelizer ran inside a
bank of two or more (one cascade over their stacked tails): the program's
`rx chan banked channels` counter over its `rx channels` counter
(`sdrangel_tpu_torch.runtime.tracing`), which add only while a profiler
runs: the harness's profiled stretch. A program that runs the channelizer
channel by channel counts channels and no `rx chan banked channels`:
nothing to read there."""

BANKED, CHANNELS = "rx chan banked channels", "rx channels"


def read(view):
    if view.stretch is None:
        return None
    try:
        from sdrangel_tpu_torch.runtime import tracing
    except ImportError:  # a program without the counters
        return None
    counters = tracing.totals()[1]
    if not counters.get(CHANNELS) or BANKED not in counters:
        return None
    return counters[BANKED] / counters[CHANNELS]
