"""Where the product path's or the bank gear's time goes on the card.

    python -m sdrangel_tpu_torch.profile_product [--channels N] [--blocks B]
    python -m sdrangel_tpu_torch.profile_product --receiver am|ssb|wfm [--blocks B]
    python -m sdrangel_tpu_torch.profile_product --gear bank [--blocks B]

--gear product (the default): the product configuration of chip_smoke.py
(10 MS/s i16, ÷64 cen, NFM at +20 kHz; with --channels N, N NFM channels
spread over ±60 kHz; with --receiver, one of chip_smoke.py phase 6's
receivers instead, `RECEIVERS`). --gear bank: the bank gear
(parallel/sharded.py) at the bench's chainsharded width — 12.288 MS/s i16
in 2^25-sample blocks, ÷64 cen on K1-TC, PFB-4, 16 NFM at the bench's
offsets, on the bench's input (uniform int16 in [−2048, 2048) from a seed). After a warm-up it
prints the steady loop (upload, step, fetch one block behind): seconds per
block; then, from torch.profiler over a second run, the per-layer split —
device time and host time per layer, read from the step's own tracing spans
(product gear: engine.LAYERS and the fetch's wait; bank gear:
sharded.LAYERS and the loop's feed and fetch spans) — the device time by
kernel and the device's busy share of the steady loop's wall time.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from .io import testsource
from .parallel import sharded
from .runtime import engine, tracing
from .runtime.engine import ChannelSpec, DeviceConfig, RxPipeline

RATE = 10e6
NFM = sharded.NFM_URI
#: the AM, SSB and WFM product configurations (chip_smoke.py phase 6), each
#: one channel on a 10 MS/s i16 capture: name -> (uri, log2_decim, channel
#: offset Hz, requested rate, test source). AM: a 1 kHz tone at 80 % depth
#: at +20 kHz; SSB: a USB tone 1 kHz above a −20 kHz carrier; WFM: a 1 kHz
#: tone at 75 kHz deviation, ÷32, a 250 kHz request (312.5 kS/s channel)
RECEIVERS = {
    "am": ("sdrangel.channel.amdemod", 6, 20e3, 48e3,
           dict(modulation="am", am_depth=0.8, carrier_freq=20e3)),
    "ssb": ("sdrangel.channel.ssbdemod", 6, -20e3, 48e3,
            dict(modulation="none", carrier_freq=-19e3)),
    "wfm": ("sdrangel.channel.wfmdemod", 5, 0.0, 250e3,
            dict(modulation="fm", fm_deviation=75e3, carrier_freq=0.0)),
}


def receiver_pipeline(name: str, device: torch.device | str
                      ) -> tuple[RxPipeline, testsource.TestSourceConfig]:
    """RECEIVERS[name] as a pipeline on `device`, and its test source."""
    uri, log2, offset, requested, src = RECEIVERS[name]
    pipe = RxPipeline(DeviceConfig(RATE, log2_decim=log2),
                      [ChannelSpec(uri, offset, {}, requested)], device)
    return pipe, testsource.TestSourceConfig(sample_rate=RATE, **src)


def chainsharded_config() -> sharded.ShardedPipelineConfig:
    """bench.py -t chainsharded (bench.py:141-217): 12.288 MS/s i16, 2^25
    blocks, ÷64 cen, PFB-4, 16 NFM (squelch −100 dB, gate 1 ms), one card."""
    return sharded.ShardedPipelineConfig(
        n_time=1, n_channel=1, device_rate=12_288_000.0, log2_decim=6, block=1 << 25,
        pfb_m=4, bank=(sharded.BankGroup(NFM, 16, {"squelch_db": -100.0,
                                                   "squelch_gate_ms": 1.0}),))


def chainsharded_offsets(cfg: sharded.ShardedPipelineConfig) -> np.ndarray:
    """bench.py:185-192: 4 demods per grid channel, distinct residuals."""
    grid = cfg.baseband_rate / cfg.pfb_m
    leaf = cfg.baseband_rate / 8.0
    jit4 = (-0.18 * leaf, -0.06 * leaf, 0.06 * leaf, 0.18 * leaf)
    return np.array([(k % 4 - 1.5) * grid * 2 + jit4[k // 4] for k in range(16)])


def _upload(raw: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(raw).pin_memory().to(device, non_blocking=True)


#: the bank loop's host layers as tracing spans, beside the step's own
FEED, FETCH = "host feed (pin + H2D)", "fetch audio (D2H)"


def run_bank(step, init_fn, blocks, res, idx):
    """The steady loop: upload, step, fetch one block behind."""
    dev = torch.device("cuda")
    state, carry = init_fn()
    pending = None
    for raw_np in blocks:
        with tracing.span(FEED):
            x = _upload(raw_np, dev)
        state, audio, carry = step(state, x, carry, res, idx)
        if pending is not None:
            with tracing.span(FETCH):
                pending.cpu().numpy()
        pending = audio
    with tracing.span(FETCH):
        pending.cpu().numpy()


def main_bank(n_blocks: int) -> int:
    cfg = chainsharded_config()
    idx_np, res_np = sharded.grid_split(cfg, chainsharded_offsets(cfg))
    step, init_fn = sharded.build_sharded_step(cfg, "cuda")
    res = torch.from_numpy(res_np).cuda()
    idx = torch.from_numpy(idx_np).to(torch.int64).cuda()
    rng = np.random.default_rng(7)
    blocks = [rng.integers(-2048, 2048, size=(cfg.block, 2), dtype=np.int16)
              for _ in range(n_blocks)]
    name = torch.cuda.get_device_name(0)
    signal_s = cfg.block / cfg.device_rate
    print(f"{name}: bank gear, 12.288 MS/s ÷64 → PFB-4 → 16 NFM, block {cfg.block} "
          f"({signal_s:.4f} s of signal), {n_blocks} blocks", flush=True)
    run_bank(step, init_fn, blocks[:2], res, idx)  # warm-up

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_bank(step, init_fn, blocks, res, idx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"steady run: {wall / n_blocks * 1e3:.3f} ms/block, real-time factor "
          f"{n_blocks * signal_s / wall:.2f}", flush=True)
    _device_time(lambda: run_bank(step, init_fn, blocks, res, idx), n_blocks, wall,
                 layers=(FEED, *sharded.LAYERS, FETCH))
    return 0


def _device_time(run, n_blocks: int, wall: float, layers: tuple[str, ...] = ()) -> None:
    """Device time by kernel from a profiled run of the loop; the busy share
    is taken against the unprofiled steady wall time. Each name in `layers`
    is a torch.profiler range of the loop: its device time (the kernels and
    copies whose launch call on the host lies inside it — a kernel launched
    through ctypes has no torch op to carry it) and its host time (the
    range's own span: launches and host copies, not synchronized) per block."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    if layers:
        events = prof.events()
        spans = {name: [e.time_range for e in events
                        if e.name == name and e.device_type == DeviceType.CPU]
                 for name in layers}
        # a device event shares its correlation id with its runtime launch call
        launched_at = {e.id: e.time_range.start for e in events
                       if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
        device_us = dict.fromkeys((*layers, None), 0.0)
        for e in events:
            if e.device_type != DeviceType.CUDA or e.name in layers:
                continue
            t = launched_at.get(e.id)
            owner = next((name for name, rs in spans.items()
                          if t is not None and any(r.start <= t <= r.end for r in rs)), None)
            device_us[owner] += e.time_range.elapsed_us()
        for name, rs in spans.items():
            if not rs:  # a layer this configuration does not run
                continue
            host_us = sum(r.elapsed_us() for r in rs)
            print(f"layer {name}: device {device_us[name] / n_blocks / 1e3:.3f} ms/block, "
                  f"host {host_us / n_blocks / 1e3:.3f} ms/block ({len(rs)} ranges)", flush=True)
        print(f"device time launched outside every layer: "
              f"{device_us[None] / n_blocks / 1e3:.3f} ms/block", flush=True)
    # the ranges' own device-side spans are not kernels
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA and e.key not in layers]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / n_blocks / 1e3
    print(f"device busy {busy_ms:.3f} ms/block = {100 * busy_ms / (wall / n_blocks * 1e3):.1f}% "
          f"of the steady run's wall time; {sum(e.count for e in kernels) // n_blocks} "
          f"device operations per block", flush=True)
    for e in kernels[:15]:
        print(f"  {e.self_device_time_total / n_blocks / 1e3:9.4f} ms/block "
              f"{e.count // n_blocks:5d}x  {e.key[:100]}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sdrangel_tpu_torch.profile_product")
    p.add_argument("--gear", choices=("product", "bank"), default="product")
    p.add_argument("--channels", type=int, default=1)
    p.add_argument("--receiver", choices=sorted(RECEIVERS), default=None,
                   help="one AM, SSB or WFM channel in place of the NFM channels")
    p.add_argument("--blocks", type=int, default=6)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_product needs a CUDA card", file=sys.stderr)
        return 1
    if args.gear == "bank":
        return main_bank(args.blocks)
    if args.receiver:
        pipe, cfg = receiver_pipeline(args.receiver, "cuda")
        what = f"1 {args.receiver.upper()} channel, ÷{1 << pipe.frontend.log2_decim}"
    else:
        offsets = np.linspace(-60e3, 60e3, args.channels) if args.channels > 1 else [20e3]
        pipe = RxPipeline(
            DeviceConfig(RATE, log2_decim=6),
            [ChannelSpec(NFM, float(f), {"squelch_db": -60.0}) for f in offsets], "cuda")
        cfg = testsource.TestSourceConfig(sample_rate=RATE, carrier_freq=20e3, modulation="fm")
        what = f"{args.channels} NFM channel(s), ÷64"
    blocks = [testsource.to_iq_int16(testsource.generate(
        cfg, pipe.device_block, start_sample=b * pipe.device_block)) for b in range(args.blocks)]
    name = torch.cuda.get_device_name(0)
    print(f"{name}: {what}, block {pipe.device_block}, {args.blocks} blocks", flush=True)
    list(pipe.run(lambda b, n: blocks[b], 2))  # warm-up

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    list(pipe.run(lambda b, n: blocks[b], args.blocks))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"steady run: {wall / args.blocks * 1e3:.3f} ms/block, real-time factor "
          f"{args.blocks * pipe.device_block / RATE / wall:.2f}", flush=True)

    _device_time(lambda: list(pipe.run(lambda b, n: blocks[b], args.blocks)), args.blocks, wall,
                 layers=(*engine.LAYERS, engine.FETCH_WAIT))
    return 0


if __name__ == "__main__":
    sys.exit(main())
