"""Where the product path's time goes on the card.

    python -m sdrangel_tpu_torch.profile_product [--channels N] [--blocks B]

The product configuration of chip_smoke.py (10 MS/s i16, ÷64 cen, NFM at
+20 kHz; with --channels N, N NFM channels spread over ±60 kHz). After a
warm-up it prints:
  * the per-layer split: each stage of RxPipeline.step run on its own and
    synchronized (host clock, launch overhead included) — upload (host copy
    into pinned memory + H2D), K1 (ingest + ÷64), channelizer, NFM, taps,
    fetch of the outputs;
  * the steady loop as RxPipeline.run drives it: seconds per block; then,
    from torch.profiler over a second run, the device time by kernel and
    the device's busy share of the steady loop's wall time.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from .dsp import channelizer as chan
from .dsp import decimators as dec
from .dsp import scope as dsp_scope
from .dsp import spectrum as dsp_spectrum
from .io import testsource
from .runtime.engine import ChannelSpec, DeviceConfig, RxPipeline, _to_host

RATE = 10e6


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def layer_split(pipe: RxPipeline, blocks: list[np.ndarray]) -> dict[str, float]:
    """Mean synchronized wall ms per stage of the step, over `blocks`."""
    state = pipe.init_state()
    totals: dict[str, float] = {}

    def add(name, ms):
        totals[name] = totals.get(name, 0.0) + ms / len(blocks)

    for raw_np in blocks:
        raw, ms = _timed(lambda: pipe.upload(raw_np))
        add("upload (pin + H2D)", ms)
        (dev_state, bb), ms = _timed(
            lambda: dec.decimate_flat_raw(state["dev_casc"], raw, pipe.frontend.log2_decim))
        add("ingest + K1 ÷64", ms)
        ys = []
        for i, plan in enumerate(pipe.plans):
            (cs, y), ms = _timed(lambda: chan.channelize(state["chan"][i], bb, plan))
            add("channelizer", ms)
            ys.append(y)
        for i, (kind, cfg) in enumerate(zip(pipe.kinds, pipe.demod_cfgs)):
            _, ms = _timed(lambda: kind.process(state["demod"][i], ys[i], cfg))
            add("NFM demod", ms)
        _, ms = _timed(lambda: (
            dsp_spectrum.power_spectrum(state["spectrum"], bb, pipe.spectrum_cfg),
            dsp_scope.project(bb[:1024], dsp_scope.Projection.MAG_DB)))
        add("spectrum + scope taps", ms)
        (state, outs), _ = _timed(lambda: pipe.step(state, raw))
        _, ms = _timed(lambda: _to_host(outs))
        add("fetch outputs", ms)
    return totals


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sdrangel_tpu_torch.profile_product")
    p.add_argument("--channels", type=int, default=1)
    p.add_argument("--blocks", type=int, default=6)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_product needs a CUDA card", file=sys.stderr)
        return 1
    offsets = np.linspace(-60e3, 60e3, args.channels) if args.channels > 1 else [20e3]
    pipe = RxPipeline(
        DeviceConfig(RATE, log2_decim=6),
        [ChannelSpec("sdrangel.channel.nfmdemod", float(f), {"squelch_db": -60.0})
         for f in offsets],
        torch.device("cuda"))
    cfg = testsource.TestSourceConfig(sample_rate=RATE, carrier_freq=20e3, modulation="fm")
    blocks = [testsource.to_iq_int16(testsource.generate(
        cfg, pipe.device_block, start_sample=b * pipe.device_block)) for b in range(args.blocks)]
    name = torch.cuda.get_device_name(0)
    print(f"{name}: {args.channels} NFM channel(s), block {pipe.device_block}, "
          f"{args.blocks} blocks", flush=True)
    list(pipe.run(lambda b, n: blocks[b], 2))  # warm-up

    for stage, ms in layer_split(pipe, blocks).items():
        print(f"layer {stage}: {ms:.3f} ms/block (synchronized)", flush=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    list(pipe.run(lambda b, n: blocks[b], args.blocks))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"steady run: {wall / args.blocks * 1e3:.3f} ms/block, real-time factor "
          f"{args.blocks * pipe.device_block / RATE / wall:.2f}", flush=True)

    # device time by kernel from a profiled run of the same loop; the busy
    # share is taken against the unprofiled steady wall time above
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        list(pipe.run(lambda b, n: blocks[b], args.blocks))
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / args.blocks / 1e3
    print(f"device busy {busy_ms:.3f} ms/block = {100 * busy_ms / (wall / args.blocks * 1e3):.1f}% "
          f"of the steady run's wall time; {sum(e.count for e in kernels) // args.blocks} "
          f"device operations per block", flush=True)
    for e in kernels[:15]:
        print(f"  {e.self_device_time_total / args.blocks / 1e3:9.4f} ms/block "
              f"{e.count // args.blocks:5d}x  {e.key[:100]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
