"""GB/s (10^9 bytes) of the feed's host-to-device copies: the program's
`fed bytes` counter (`sdrangel_tpu_torch.runtime.tracing`: the blocks that
`RxPipeline.upload` and `hostfeed.shard_block` hand to the card; it adds
only while a profiler runs, the harness's profiled stretch) over the device
time of the `Memcpy HtoD` operations launched inside the harness's feed
span in that stretch."""

COUNTER = "fed bytes"
OWNER = "portbench feed"


def read(view):
    s = view.stretch
    if s is None:
        return None
    try:
        from sdrangel_tpu_torch.runtime import tracing
    except ImportError:  # a program without the counter
        return None
    n = tracing.totals()[1].get(COUNTER)
    ms = s.device_ms_per_block(lambda op: op.owner == OWNER and "Memcpy HtoD" in op.name)
    if not n or not ms:
        return None
    return n / s.blocks / (ms * 1e-3) / 1e9
