"""The reduction of a profiled stretch of the window to what the
per-layer metrics read: the device's operations with the host range that
launched each, the host ranges, the union of device activity, and the
idle gaps labelled by what the host was doing.

torch.profiler gives host events (ranges of record_function, aten ops,
CUDA runtime calls) and device events (kernels, copies, memsets) on one
timeline in microseconds. A device event shares its correlation id with
the runtime call that launched it; a kernel launched through ctypes has
no aten op around it, but its launch call lies inside the program's or
the harness's range, which owns it.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float  # µs on the profiler's timeline
    end: float
    owner: str | None  # the innermost named range around its launch


@dataclasses.dataclass
class Stretch:
    """A profiled stretch of `blocks` blocks lasting `wall_us`."""

    blocks: int
    wall_us: float
    ops: list[DeviceOp]
    ranges: dict[str, list[tuple[float, float]]]  # named range -> host spans
    busy_us: float  # the union of device activity inside the stretch
    gaps: list[tuple[str, float]]  # (host activity, µs) of each idle gap

    def device_ms_per_block(self, match) -> float:
        """Device ms a block of the operations that `match(op)` accepts."""
        return sum(o.end - o.start for o in self.ops if match(o)) / self.blocks / 1e3

    def host_ms_per_block(self, name: str) -> float | None:
        spans = self.ranges.get(name)
        if not spans:
            return None
        return sum(e - s for s, e in spans) / self.blocks / 1e3


def union_us(intervals, lo: float, hi: float) -> tuple[float, list[tuple[float, float]]]:
    """(length of the union of intervals clipped to [lo, hi], the gaps
    between them inside [lo, hi])."""
    busy, gaps, cur = 0.0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s or e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
        busy += e - max(s, cur)
        cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return busy, gaps


def reduce(events, blocks: int, wall_us: float, range_names, outer_names=()) -> Stretch:
    """A Stretch from profiler events (each with name, device_type, id
    and time_range: FunctionEvent's fields). `range_names` are the named
    host ranges that own device work; `outer_names` those that label
    what the host was doing in a gap."""
    from torch.autograd import DeviceType

    host, device = [], []
    for e in events:
        (device if e.device_type == DeviceType.CUDA else host).append(e)
    host_names = {e.name for e in host}
    # a range's own device-side mirror carries the range's name: not an op
    device = [e for e in device if e.name not in host_names]
    t0 = min((e.time_range.start for e in host), default=0.0)
    hi = t0 + wall_us

    wanted = set(range_names) | set(outer_names)
    ranges = collections.defaultdict(list)
    for e in host:
        if e.name in wanted:
            ranges[e.name].append((e.time_range.start, e.time_range.end))
    launched_at = {e.id: e.time_range.start for e in host if e.name.startswith("cu")}

    owned = [(s, e, n) for n in range_names for s, e in ranges.get(n, ())]
    ops = []
    for e in device:
        t = launched_at.get(e.id)
        inside = [(end - s, n) for s, end, n in owned if t is not None and s <= t <= end]
        ops.append(DeviceOp(e.name, e.time_range.start, e.time_range.end,
                            min(inside)[1] if inside else None))

    busy, gaps = union_us([(o.start, o.end) for o in ops], t0, hi)
    return Stretch(blocks, wall_us, ops, dict(ranges), busy,
                   _label_gaps(gaps, host, outer_names))


def _label_gaps(gaps, host, outer_names, most: int = 2000) -> list[tuple[str, float]]:
    """Each gap (the `most` longest) as (what the host did at its middle:
    the harness's range, then the innermost host event, µs)."""
    if not gaps:
        return []
    starts = np.array([e.time_range.start for e in host])
    ends = np.array([e.time_range.end for e in host])
    names = [e.name for e in host]
    outer = set(outer_names)
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:most]:
        mid = (s + e) / 2
        idx = np.flatnonzero((starts <= mid) & (ends >= mid))
        inner = min(idx, key=lambda i: ends[i] - starts[i]) if len(idx) else None
        outs = [i for i in idx if names[i] in outer]
        label = (names[outs[0]] if outs else "between ranges") + " > " + (
            names[inner] if inner is not None else "no host event")
        out.append((label, e - s))
    return out


def breakdown(stretch: Stretch, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, in seconds over the stretch."""
    by_op = collections.Counter()
    for o in stretch.ops:
        by_op[o.name[:160]] += (o.end - o.start) / 1e6
    by_gap = collections.Counter()
    for label, us in stretch.gaps:
        by_gap[label[:160]] += us / 1e6
    return {"device_ops": [[k, v] for k, v in by_op.most_common(top)],
            "idle_gaps": [[k, v] for k, v in by_gap.most_common(top)]}
