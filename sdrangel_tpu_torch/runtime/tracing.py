"""The port's spans and counters, on the profiler's clock.

Tracing is on while a torch.profiler session runs in the process (a
benchmark's profiled stretch, `POST /sdrangel/profile`, `profile_product`);
there is no other switch. Off, `span` costs one read of the profiler's flag
and returns a shared null context, and `count` adds nothing. On, a span is
a `torch.profiler.record_function` range, so it lies on the profiler's
timeline beside the device's kernels and copies, and its host seconds and
calls add to an in-memory tally by name; `count` adds to a counter by name.
Nothing is written out: the profiler exports the ranges, and `totals()`
reads the tallies. A span inside another adds to both tallies; self time is
read off the profiler's timeline.
"""

from __future__ import annotations

import contextlib
import threading
import time

from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()
_spans: dict[str, list] = {}  # name -> [calls, host seconds]
_counters: dict[str, int] = {}


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = _profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        with _LOCK:
            tally = _spans.setdefault(self.name, [0, 0.0])
            tally[0] += 1
            tally[1] += dt


def span(name: str):
    """A context manager: a profiler range named `name` while tracing is
    on, else a null context."""
    return _Span(name) if _profiler._is_profiler_enabled else _NULL


def count(name: str, n: int) -> None:
    """Add n to the counter `name` while tracing is on."""
    if _profiler._is_profiler_enabled:
        with _LOCK:
            _counters[name] = _counters.get(name, 0) + n


def totals() -> tuple[dict[str, tuple[int, float]], dict[str, int]]:
    """({span name: (calls, host seconds)}, {counter name: value}) as they
    stand: the sums over every traced stretch of this process."""
    with _LOCK:
        return {k: (c, s) for k, (c, s) in _spans.items()}, dict(_counters)


def since(before) -> tuple[dict[str, tuple[int, float]], dict[str, int]]:
    """`totals()` less an earlier `totals()`: what was traced in between."""
    spans0, counters0 = before
    spans, counters = totals()
    out = {}
    for k, (c, s) in spans.items():
        c0, s0 = spans0.get(k, (0, 0.0))
        if c > c0:
            out[k] = (c - c0, s - s0)
    return out, {k: v - counters0.get(k, 0) for k, v in counters.items()
                 if v != counters0.get(k, 0)}
