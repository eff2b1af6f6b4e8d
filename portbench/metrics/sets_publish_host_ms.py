"""Host ms a round (a block of every set) that the device sets' workers spend
reading back and publishing their blocks (`session publish`:
`engine.fetch`, the unpacking, and the reports and audio of
`DeviceSet._publish_block`), summed over the sets, from the program's own
tally (`sdrangel_tpu_torch.runtime.tracing`), which adds only while a
profiler runs: the harness's profiled stretch. The time carries the
profiler's inflation, as fetch_wait_ms does."""

SPANS = ("session publish",)


def read(view):
    if view.stretch is None:
        return None
    try:
        from sdrangel_tpu_torch.runtime import tracing
    except ImportError:  # a program without the tally
        return None
    spans = tracing.totals()[0]
    calls = sum(spans[n][0] for n in SPANS if n in spans)
    if not calls or not view.config.get("sets"):
        return None
    # each set calls the span once a block: a round is `sets` calls, also
    # where the clock released rounds in a burst (after the profiler's start)
    return sum(spans[n][1] for n in SPANS if n in spans) * 1e3 * view.config["sets"] / calls
