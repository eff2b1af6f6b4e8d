"""The share of the device sets' blocks that their workers queued on a CUDA
stream of the set's own: the program's `session own-stream blocks` counter
over its `session blocks` counter (`sdrangel_tpu_torch.runtime.session`),
which add only while a profiler runs (`runtime/tracing.py`): the harness's
profiled stretch. 1.0 where every worker queues on its own stream; a
program whose workers share the default stream counts no blocks and reads
nothing."""

BLOCKS, OWN = "session blocks", "session own-stream blocks"


def read(view):
    if view.stretch is None:
        return None
    try:
        from sdrangel_tpu_torch.runtime import tracing
    except ImportError:  # a program without the counters
        return None
    counters = tracing.totals()[1]
    if not counters.get(BLOCKS):
        return None
    return counters.get(OWN, 0) / counters[BLOCKS]
