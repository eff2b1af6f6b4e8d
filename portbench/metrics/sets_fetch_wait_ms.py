"""Host ms a round (a block of every set) that the device sets' workers wait
in `engine.fetch` for the device to finish the outputs they copy (`rx
fetch wait`), summed over the sets: where the sets share one stream, a set
waits here for the others' work too. From the program's own tally
(`sdrangel_tpu_torch.runtime.tracing`), which adds only while a profiler
runs: the harness's profiled stretch. The time carries the profiler's
inflation, as fetch_wait_ms does."""

SPANS = ("rx fetch wait",)


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
