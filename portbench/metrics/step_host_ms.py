"""Host ms a block in the step call (`step_packed`, or the gear's step):
the enqueue, Python and launches; the harness's span, unprofiled blocks."""


def read(view):
    ms = view.spans_ms.get("step")
    return float(ms.mean()) if ms is not None and len(ms) else None
