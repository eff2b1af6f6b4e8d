"""Host ms a block in the feed call (`RxPipeline.upload`, or
`hostfeed.shard_block`): the harness's span, unprofiled blocks."""


def read(view):
    ms = view.spans_ms.get("feed")
    return float(ms.mean()) if ms is not None and len(ms) else None
