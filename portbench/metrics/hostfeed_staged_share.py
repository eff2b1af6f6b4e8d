"""The share of the feed's bytes that `hostfeed.shard_block` uploaded from
a pinned staging slot: the program's `hostfeed staged bytes` counter over
its `fed bytes` counter (`sdrangel_tpu_torch.runtime.tracing`), which add
only while a profiler runs: the harness's profiled stretch. A program
without the staging ring counts fed bytes and no staged ones: nothing to
read there."""

STAGED, FED = "hostfeed staged bytes", "fed bytes"


def read(view):
    if view.stretch is None:
        return None
    try:
        from sdrangel_tpu_torch.runtime import tracing
    except ImportError:  # a program without the counters
        return None
    counters = tracing.totals()[1]
    if not counters.get(FED) or STAGED not in counters:
        return None
    return counters[STAGED] / counters[FED]
