"""The benchmark's harness: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace 0|1

Everything a cell is comes from files found by name: its entry in
BENCHMARK.json names the configuration (`configs/<config>.json`, whose
`driver` names `drivers/<driver>.py`) and the traffic
(`traffic/<traffic>.json`); `limits/<cell>.json` holds the limits of the
comparison, and each per-layer metric is read by `metrics/<metric>.py`.

A run: the capture is made on the card from the seed (set-up), the
system is built and warmed over `warm_blocks` blocks of the cell's own
shapes (set-up), then blocks are fed back to back for `--seconds` (the
window, which runs on until the sample below has more blocks than it
keeps): one stream, closed loop, through the program's own loop, which
reads block b's outputs while block b + 1 is queued. `setup_s` runs from
the process's start to the first timed block's feed; `input_msps` is the
block's samples × the blocks completed ÷ the time from that feed to the
last completion; `block_ms_p95` is the 95th percentile over every
completed block of the time from its feed call to its outputs on the
host. With `--trace 1` a stretch of `profile_blocks` blocks from three
quarters into the window runs under torch.profiler (the window runs on
until it has); the per-layer metrics are read from it and from the
harness's host spans of the blocks before it, and printed in place of the
end-to-end ones.

After the window, a sample of the completed blocks drawn from the seed
(a reservoir of `compare_blocks`) is judged against the plain reference
(`reference/`), which works each one out anew from the capture in
float64, starting one block earlier. The first block of the window is
not among them: the port's NFM resampler starts its stream one output
after SDRangel's Interpolator (the first input emits in SDRangel), so
only that block's audio lies one sample apart.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import capture, judge, trace
from .reference import dsp

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules that may not be loaded in a run: JAX and the JAX
#: package the program was ported from (names compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "sdrangel_tpu")
#: the harness's own host spans, as torch.profiler ranges in a traced run
SPAN_PREFIX = "portbench "


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: dict  # name -> unit
    per_layer: dict  # name -> unit


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench_path: str = os.path.join(ROOT, "BENCHMARK.json")) -> Cell:
    bench = _json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {bench_path}")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(
        name=name, chips=w["chips"],
        config=_json(os.path.join(ROOT, conf["file"])),
        traffic=_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(HERE, "limits", name + ".json")),
        end_to_end={m["name"]: m["unit"] for m in bench["end_to_end"] if mine(m)},
        per_layer={m["name"]: m["unit"] for m in bench["per_layer"] if mine(m)},
    )


def driver(config: dict):
    return importlib.import_module(f"{__package__}.drivers.{config['driver']}")


class Hooks:
    """What the program's loop reports to the harness: the start of each
    block's feed and the host spans around its feed, step and fetch calls.
    In a traced run the profiler runs over `profile_blocks` blocks from
    `profile_at` seconds into the window, with each span a torch.profiler
    range while it runs."""

    def __init__(self, trace_on: bool = False, profile_at: float = 0.0, profile_blocks: int = 0):
        self.feed_t: dict[int, float] = {}
        self.spans: dict[str, dict[int, float]] = {}
        self.block = -1
        self.trace_on = trace_on
        self.profile_at, self.profile_blocks = profile_at, profile_blocks
        self.prof = None
        self.profiled: range = range(0)
        self.prof_wall = 0.0

    def feed(self, b: int) -> None:
        now = time.perf_counter()
        self.block = b
        self.feed_t[b] = now
        if not self.trace_on:
            return
        if self.prof is None and now - self.feed_t[0] >= self.profile_at:
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
            self._prof_t0 = time.perf_counter()
            self.profiled = range(b, b)
        elif self.prof is not None and not self.prof_wall and b - self.profiled.start >= \
                self.profile_blocks:
            self.stop_profile()

    def stop_profile(self) -> None:
        if self.prof is not None and not self.prof_wall:
            self.prof_wall = time.perf_counter() - self._prof_t0
            self.prof.stop()
            self.profiled = range(self.profiled.start, self.block)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.prof is not None and not self.prof_wall:
            with torch.profiler.record_function(SPAN_PREFIX + name):
                yield
        else:
            yield
        self.spans.setdefault(name, {})[self.block] = (time.perf_counter() - t0) * 1e3


class Reservoir:
    """A uniform sample of `k` of the blocks offered, drawn from the seed
    (Algorithm R); a kept block's outputs are copied."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, np.random.default_rng([seed, 1])
        self.kept: dict[int, object] = {}
        self.seen = 0

    def offer(self, b: int, outputs, copy) -> None:
        if self.seen < self.k:
            self.kept[b] = copy(outputs)
        else:
            j = self.rng.integers(self.seen + 1)
            if j < self.k:
                del self.kept[sorted(self.kept)[j]]
                self.kept[b] = copy(outputs)
        self.seen += 1


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    check: dict
    numbers: dict  # every number compared, judged or not
    lines: list  # the earlier output lines
    breakdown: dict | None = None


def run_cell(cell: Cell, seed: int, seconds: float, trace_on: bool, device,
             setup_origin: tuple[float, float] | None = None, patch=None,
             inspect=None) -> Outcome:
    """One run of `cell` on `device` ("cuda" or, in the tests, "cpu").
    setup_origin: (process age, perf_counter) at one instant, so that
    set-up counts from the process's start; patch(system), if given, runs
    once the system is built (the tests plant faults with it);
    inspect(b, ours, reference), if given, sees each compared block."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    cfg, tr = cell.config, cell.traffic
    drv = driver(cfg)
    lines = []

    block = drv.block_samples(cfg)
    ring = capture.ring(tr, drv.frequencies(cfg, tr), cfg["sample_rate"], block, seed,
                        device).cpu().numpy()  # the capture in host memory, as a file's
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    system = drv.System(cfg, tr, ring, device)
    # what a patch may need to stand in for the program
    system.driver, system.config, system.traffic, system.ring, system.device = (
        drv, cfg, tr, ring, device)
    if patch is not None:
        patch(system)

    loop = system.loop(Hooks())
    for i, _ in enumerate(loop):  # warm-up: the cell's own shapes, built and planned
        if i + 1 >= tr["warm_blocks"]:
            break
    loop.close()
    if on_card:
        torch.cuda.synchronize(device)
    counts0 = system.launches()

    # a profiler once started slows every later launch of the process, so
    # the stretch comes late and the host spans are read before it
    hooks = Hooks(trace_on, 0.75 * seconds, tr["profile_blocks"])
    keep = Reservoir(tr["compare_blocks"], seed)
    done: dict[int, float] = {}
    loop = system.loop(hooks)
    for b, outputs in loop:
        now = time.perf_counter()
        done[b] = now
        if b:  # the port's streams start one resampler output after SDRangel's
            keep.offer(b, outputs, system.copy)
        if (now - hooks.feed_t[0] >= seconds and keep.seen > keep.k
                and (not trace_on or hooks.prof_wall)):
            break
    loop.close()
    hooks.stop_profile()
    if on_card:
        torch.cuda.synchronize(device)
    t0 = hooks.feed_t[0]
    window = max(done.values()) - t0
    latency = np.array([(done[b] - hooks.feed_t[b]) * 1e3 for b in sorted(done)])
    counts = {k: v - counts0.get(k, 0) for k, v in system.launches().items()}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    n_done = len(done)
    msps = n_done * block / window / 1e6
    lines.append(f"blocks completed {n_done} in {window:.6f} s; real-time factor "
                 f"{msps * 1e6 / cfg['sample_rate']:.4f}; block ms median "
                 f"{float(np.median(latency)):.4f} p95 {float(np.percentile(latency, 95)):.4f}")
    quarters = np.array_split(latency, 4)
    lines.append("block ms median by quarter of the window: " + ", ".join(
        f"{float(np.median(q)):.4f}" for q in quarters if len(q)))
    lines.append("kernel launches in the window: " + ", ".join(
        f"{k} {v}" for k, v in counts.items()))

    metrics, breakdown, dev = {}, None, {}
    if trace_on:
        stretch = None
        if hooks.prof is not None and len(hooks.profiled):
            stretch = trace.reduce(hooks.prof.events(), len(hooks.profiled),
                                   hooks.prof_wall * 1e6, system.ranges,
                                   [SPAN_PREFIX + s for s in ("feed", "step", "fetch")])
        before = hooks.profiled.start if hooks.prof is not None else math.inf
        view = View(cfg, stretch, {
            name: np.array([ms for b, ms in by_block.items() if b < before])
            for name, by_block in hooks.spans.items()})
        for name, unit in cell.per_layer.items():
            value = read_metric(name, view)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
        if stretch is not None:
            breakdown = trace.breakdown(stretch)
            dev = {"busy_s": stretch.busy_us / 1e6, "window_s": stretch.wall_us / 1e6}
        lines.append(f"profiled stretch: blocks {list(hooks.profiled)[:1]}.. "
                     f"{len(hooks.profiled)} blocks, {hooks.prof_wall:.6f} s")
    else:
        e2e = {"input_msps": msps, "block_ms_p95": float(np.percentile(latency, 95))}
        if setup_origin is not None:
            age, pc = setup_origin
            e2e["setup_s"] = age + (t0 - pc)
        metrics = {n: {"value": e2e[n], "unit": u} for n, u in cell.end_to_end.items()
                   if n in e2e}

    system.close()
    del system, loop
    if on_card:
        torch.cuda.empty_cache()
    per_block = []
    for b in sorted(keep.kept):
        raws = [torch.as_tensor(ring[i % len(ring)]).to(device) for i in (b - 1, b)]
        ref = drv.reference(cfg, tr, raws, dsp.F64)
        per_block.append(drv.numbers(keep.kept[b], ref))
        if inspect is not None:
            inspect(b, keep.kept[b], ref)
    numbers = judge.combine(per_block)
    correct, check = judge.verdict(numbers, cell.limits)
    failed = sum(not judge.verdict(n, cell.limits)[0] for n in per_block)
    lines.append(f"compared blocks {sorted(keep.kept)} of {n_done}")
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak), **dev}
    return Outcome(correct, n_done, failed, metrics, dev, check, numbers, lines, breakdown)


@dataclasses.dataclass
class View:
    """What a per-layer metric's reader reads: the configuration, the
    profiled stretch (None if none ran) and the harness's host spans in ms
    per block, of the blocks before the stretch."""

    config: dict
    stretch: trace.Stretch | None
    spans_ms: dict


def read_metric(name: str, view: View):
    """metrics/<name>.py's read(view): a number, or None where it finds
    nothing to read."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"{__package__}.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(view)


def forbidden_modules() -> list[str]:
    """Top-level names of `sys.modules` that are JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_lines(chips: int) -> list[str]:
    """The cards as nvidia-smi reads them: name, power limit, SM clock."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi: {e}"]
    return [f"card {i}: {line.strip()}" for i, line in enumerate(out.splitlines()[:chips])]


def _plain(v):
    """A number for the result line: finite floats as they are, others as text."""
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    return v


def main(argv=None, origin: tuple[float, float] | None = None) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    for line in card_lines(cell.chips):
        print(line, flush=True)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", origin)
    for line in out.lines:
        print(line, flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: JAX or the JAX package", file=sys.stderr)
        return 3
    check = {k: {"value": _plain(v["value"]), "limit": v["limit"]} for k, v in out.check.items()}
    result = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": out.metrics, "device": out.device}
    if out.breakdown is not None:
        result["breakdown"] = out.breakdown
    result["check"] = check
    print(json.dumps(result), flush=True)
    for k, v in check.items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr, flush=True)
    return 0
