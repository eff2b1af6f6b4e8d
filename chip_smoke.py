"""Drive the PyTorch port's Rx product path and its channel-bank gear once
on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own line; every number carries the card's name and
power limit as nvidia-smi reports them):
  0. device and precision: the card, its power limit, the TF32 flags;
  1. build: K1 (kernels/csrc/flat_decimate.cu) and K1-TC
     (kernels/csrc/flat_decimate_tc.cu) with nvcc for sm_90a; ptxas's
     registers and spills (a spill of any variant of either kernel fails),
     each kernel's shared memory per block and resident blocks per SM;
  2. K1 against its plain twin on the card, the block and its tail as two
     tensors: i16 real legs, f32 real legs and f32 complex legs (inf and
     sup) at ÷4/÷16/÷64 on the 10,240,000-sample product block; each
     form's time at ÷64 beside its bound and its conv1d; three streamed
     blocks of 39,977 outputs (no multiple of the tile) equal one long
     block bit for bit;
  2b. K1-TC against its plain version on the card: i16 cen at ÷4/÷16/÷64 on
     the product block and on the 2^25-sample gear block, the block and its
     tail as two tensors (the gear's call), three streamed blocks of an
     output count that is no multiple of 128 against one long block, the
     MXU counterpart against K1 on one raw block; per-block times of K1-TC,
     K1, the plain version and conv1d;
  3. the product path: RxPipeline on cuda, 10 MS/s i16, ÷64 cen, NFM at
     +20 kHz, 8 blocks of continuous FM, timed twin, K1, K1, twin; K1
     launched once per block, the 1 kHz tone above 25 dB, and ≥ 80 dB
     agreement with the runs whose decimator is the plain twin;
  4. the CLI on cuda at 768 kS/s ÷2 with the channel at +100 kHz;
  5. the bank gear (parallel/sharded.py) at the bench's chainsharded width:
     12.288 MS/s i16, 2^25-sample blocks, ÷64 cen on K1-TC, PFB-4, 16 NFM
     (squelch −100 dB, gate 1 ms) at the bench's offsets; 3 continuous
     blocks of FM carriers at two demods' offsets, timed K1-TC, plain,
     plain, K1-TC; K1-TC launched once per block, the tone above 25 dB,
     all 16 streams finite, ≥ 80 dB agreement with the plain-decimator runs;
  6. the other receivers: RxPipeline on cuda with one AM (10 MS/s i16 ÷64,
     +20 kHz, a 1 kHz tone at 80 % depth), one SSB (÷64, USB 1 kHz above a
     −20 kHz carrier) and one WFM channel (÷32, 250 kHz request, a 1 kHz
     tone at 75 kHz deviation), 6 blocks each at their device blocks
     (10,240,000, 20,480,000, 10,240,000), timed twin, K1, K1, twin; per
     kind K1 launched once per block, the tone above 25 dB, ≥ 80 dB against
     the twin path and against the CPU pipeline on the first 2 blocks;
  7. the REST server: phase 3's first 6 blocks written to a .sdriq with the
     port's SdriqWriter, the port's server started in this process on
     127.0.0.1 with a Session on cuda, and driven over HTTP only: a device
     set playing the capture (÷64, run_blocks 6, publish_every 1) with an
     NFM channel at +20 kHz (squelch −60 dB), run to idle, its reports and
     its audio WAV read back; once streaming from the file and once with
     file_preload. K1 launched 6 times in each run, the tone above 25 dB,
     preload audio equal to streaming audio bit for bit, ≥ 80 dB against
     RxPipeline.run on the same blocks, the set idle with no error; each
     run's ms per block and real-time factor from the device report, and
     the streaming feed's ms per block alone;
  8. the Tx path (no kernel of its own; K1 only in the loopback):
     (a) TxPipeline on cuda at 9.6 MS/s ×64, NFM at +20 kHz, a 1 kHz tone,
         52 AF blocks of 4096 (819,200 device samples each), timed on the
         host clock around a synchronize after a warm-up of 4 blocks; each
         stage alone timed by CUDA events (the stream's elapsed time, which
         for these launch-bound stages is the host's launch time); the
         host's pieces alone (AF, upload, enqueue, read-back, a pinned
         allocation of the read-back's size); the device busy time of 8
         blocks by torch.profiler; the first 2 blocks
         on the CPU: int16 within 1 LSB and ≥ 80 dB;
     (b) the loopback: the 52 blocks written with SdriqWriter and decoded
         by RxPipeline on cuda at 9.6 MS/s ÷64, NFM at +20 kHz, three
         13,107,200-sample blocks; K1 launched once per Rx block, the tone
         above 25 dB;
     (c) four channels (NFM −50 and +50 kHz, AM +20 kHz, SSB −20 kHz: three
         groups, the sum/÷n merge), 2 blocks on the card against the CPU;
     (d) the `mod` CLI on cuda for 1 s at 384 kS/s ×1 (two UpChannelizer
         stages) against TxPipeline in this process;
     (e) a Tx device set over HTTP (the server in this process, a Session
         on cuda, NFM, 9.6 MS/s ×64, a filesink), stopped after 20 blocks
         by polling blocksProcessed: the .sdriq header and sample count,
         the set idle with no error, its samples equal to (a)'s.
Then a JSON line of the kernels, and last the ok line. Any failed check
raises: the script then exits non-zero and prints no ok line. It needs a
card; without one it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave

import numpy as np
import torch

import torch.nn.functional as F

import sdrangel_tpu_torch.dsp.decimators as dec
from sdrangel_tpu_torch.api.server import make_server
from sdrangel_tpu_torch.io import sdriq, testsource, wav
from sdrangel_tpu_torch.kernels import build
from sdrangel_tpu_torch.kernels import decimator as kdec
from sdrangel_tpu_torch.kernels import flat_decimate as k1_kernel
from sdrangel_tpu_torch.kernels.flat_decimate import flat_decimate, flat_decimate_reference
from sdrangel_tpu_torch.kernels.flat_decimate_tc import (
    RATIOS,
    blocks_per_sm,
    flat_decimate_tc,
    flat_decimate_tc_reference,
)
from sdrangel_tpu_torch.parallel import sharded
from sdrangel_tpu_torch.profile_product import (
    RECEIVERS,
    _device_time,
    chainsharded_config,
    chainsharded_offsets,
    receiver_pipeline,
)
from sdrangel_tpu_torch.dsp import interpolators as interp
from sdrangel_tpu_torch.runtime.engine import ChannelSpec, DeviceConfig, RxPipeline, fetch
from sdrangel_tpu_torch.runtime.session import Session
from sdrangel_tpu_torch.runtime.tx import TxChannelSpec, TxDeviceConfig, TxPipeline

REPO = os.path.dirname(os.path.abspath(__file__))
ATOL = 2e-5  # K1 vs twin, the Pallas kernel's own tolerance
PRODUCT_RATE = 10e6
PRODUCT_BLOCK = 10_240_000  # RxPipeline's device block at 10 MS/s ÷64 NFM
NFM = "sdrangel.channel.nfmdemod"
DEVICE = "cuda"
GEAR_RATE = 12_288_000.0  # bench.py chainsharded: 12.288 MS/s ÷64 -> 192 kHz
GEAR_BLOCK = 1 << 25
TX_RATE = 9.6e6  # phase 8: ×64 from a 150 kHz baseband, the mirror of ÷64
TX_BLOCK = 819_200  # device samples per 4096-sample AF block at 9.6 MS/s ×64
TX_BLOCKS = 52
TX_RX_BLOCK = 13_107_200  # RxPipeline's block at 9.6 MS/s ÷64 NFM
NFM_MOD = "sdrangel.channeltx.modnfm"
# published H100 SXM peaks at 700 W (NVIDIA's data sheet, dense): HBM bytes/s,
# FP32 outside the tensor cores and dense TF32 FLOP/s
HBM_BPS, FP32_FLOPS, TF32_FLOPS = 3.35e12, 67e12, 495e12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[torch.cuda.current_device()]


def tone_snr(audio: np.ndarray, tone_hz: float, fs: float) -> float:
    audio = audio - audio.mean()
    n = len(audio)
    spec = np.abs(np.fft.rfft(audio * np.hanning(n))) ** 2
    tone = np.abs(np.fft.rfftfreq(n, 1.0 / fs) - tone_hz) < 4.0 * fs / n
    return float(10 * np.log10(spec[tone].sum() / max(spec[~tone].sum(), 1e-30)))


def agreement_db(ref: np.ndarray, ours: np.ndarray) -> float:
    err = ours.astype(np.float64) - ref.astype(np.float64)
    return float(10 * np.log10(np.sum(ref.astype(np.float64) ** 2)
                               / max(np.sum(err ** 2), 1e-300)))


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def fm_blocks(n_blocks: int, block: int, rate: float, carrier: float | tuple[float, ...],
              amplitude: float = 0.5) -> list[np.ndarray]:
    """Continuous FM (1 kHz tone, 5 kHz deviation) at each carrier, summed."""
    carriers = carrier if isinstance(carrier, tuple) else (carrier,)
    cfgs = [testsource.TestSourceConfig(
        sample_rate=rate, carrier_freq=c, modulation="fm", tone_freq=1000.0,
        fm_deviation=5000.0, amplitude=amplitude) for c in carriers]
    return [testsource.to_iq_int16(sum(testsource.generate(c, block, start_sample=b * block)
                                       for c in cfgs))
            for b in range(n_blocks)]


def decimator_bound(n_in: int, n_out: int, r: int, t_leg: int, tensor_cores: bool,
                    in_bytes: int = 4, complex_legs: bool = False) -> tuple[float, str]:
    """(ms, what bounds it): the least time for one ÷r decimation of n_in
    I/Q pairs of in_bytes each — its bytes (input read once, output written
    once) over HBM, against its arithmetic over the peak of its type: per
    output, r·t_leg FMA per plane with real legs (2 FLOP each, two planes),
    4 real FMA per complex sample and tap with complex legs, on FP32 for
    K1; for K1-TC one TF32 pass of them plus the (t_leg − 1)-add diagonal
    sum on FP32. K1-TC's three TF32 passes (the hi/lo splits that keep f32
    fidelity) are its design's cost, not work the function needs, so the
    bound counts one."""
    t_bytes = (n_in * in_bytes + n_out * 8) / HBM_BPS
    flop = n_out * r * t_leg * (8 if complex_legs else 4)
    if tensor_cores:
        t_ops = flop / TF32_FLOPS + n_out * 2 * (t_leg - 1) / FP32_FLOPS
    else:
        t_ops = flop / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def ptxas_summary(report: str) -> list[str]:
    """Each kernel's registers and spills from nvcc's -Xptxas -v report, as
    'flat_decimate_tc_kernel<Li6>: 149 registers, 0 bytes spill stores, ...'
    (K1-TC's template arguments as mangled; K1's as
    'flat_decimate_kernel<short2 r=64 real>')."""
    out, name, spill = [], None, ""
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            mangled = m.group(1)
            if v := re.search(r"flat_decimate_kernelI.*Variant\w*?I\d+(short2|float2)Li(\d)ELb([01])",
                              mangled):
                name = (f"flat_decimate_kernel<{v.group(1)} r={1 << int(v.group(2))} "
                        f"{'complex' if v.group(3) == '1' else 'real'}>")
            elif k := re.search(r"\d(flat_decimate(?:_tc)?_kernel)I(.+?)EE+v", mangled):
                name = f"{k.group(1)}<{k.group(2)}>"
            else:
                name = mangled
            spill = ""
        elif name and "spill" in line:
            spill = line.split("stack frame,")[-1].strip()
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out.append(f"{name}: {m.group(1)} registers, {spill}")
            name = None
    return out


def conv1d_planes(ext: torch.Tensor, legs: torch.Tensor, legs_im: torch.Tensor | None = None):
    """The library call computing the decimator: one F.conv1d over the f32
    polyphase planes (made outside the timed call), with the two weights
    (real and imaginary legs) that `flat_decimate_reference` stacks for
    complex legs."""
    r = legs.shape[0]
    x = ext.to(torch.float32)
    if ext.dtype == torch.int16:
        x = x * (1.0 / 32768.0)
    planes = x.reshape(-1, r, 2).permute(2, 1, 0).contiguous()
    weight = (legs[None] if legs_im is None else torch.stack([legs, legs_im])).contiguous()
    return lambda: F.conv1d(planes, weight)


# K1's three forms: (name, input dtype, placement of the legs)
K1_FORMS = (("i16 real", torch.int16, "cen"), ("f32 real", torch.float32, "cen"),
            ("f32 complex", torch.float32, "inf"))


def phase_k1(dev: torch.device, tag: str) -> dict:
    """K1 in the two-pointer form against its plain twin, each form timed
    beside its bound and its conv1d."""
    rng = np.random.default_rng(1234)
    worst = 0.0

    def compare(name, got, want):
        nonlocal worst
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite K1 output")
        check(err <= ATOL, f"{name}: K1 vs twin max abs {err:.3e} > {ATOL}")
        worst = max(worst, err)
        print(f"phase 2 k1 {name}: out {tuple(got.shape)} max_abs_err {err:.3e} "
              f"(atol {ATOL}) [{tag}]", flush=True)

    raw = torch.from_numpy(
        rng.integers(-32768, 32767, size=(PRODUCT_BLOCK, 2), endpoint=True, dtype=np.int16)
    ).to(dev)
    inputs = {torch.int16: raw, torch.float32: (raw.to(torch.float32) / 32768.0).contiguous()}
    forms = {}
    for log2 in (2, 4, 6):
        tail_i16 = torch.from_numpy(rng.integers(-32768, 32767, endpoint=True, dtype=np.int16,
                                                 size=(dec.flat_tail_len(log2), 2))).to(dev)
        tails = {torch.int16: tail_i16, torch.float32: tail_i16.to(torch.float32) / 32768.0}
        for name, dtype, fc_pos in K1_FORMS:
            legs_re, legs_im, _ = dec._device_legs(log2, fc_pos, dev)
            x, tail = inputs[dtype], tails[dtype]
            compare(f"{name} legs k={log2} block={PRODUCT_BLOCK} two-pointer vs twin",
                    flat_decimate(x, legs_re, legs_im, tail=tail),
                    flat_decimate_reference(x, legs_re, legs_im, tail=tail))
            if log2 != 6:
                continue
            t = {"ms": time_ms(lambda: flat_decimate(x, legs_re, legs_im, tail=tail)),
                 "plain_ms": time_ms(
                     lambda: flat_decimate_reference(x, legs_re, legs_im, tail=tail)),
                 "library_ms": time_ms(conv1d_planes(torch.cat([tail, x]), legs_re, legs_im))}
            t["bound_ms"], t["bound_by"] = decimator_bound(
                tail.shape[0] + x.shape[0], PRODUCT_BLOCK >> 6, 64, legs_re.shape[1],
                tensor_cores=False, in_bytes=x.element_size() * 2,
                complex_legs=legs_im is not None)
            print(f"phase 2 k1 time {name} legs k=6 block={PRODUCT_BLOCK}: K1 {t['ms']:.4f} ms "
                  f"(tail and block as two tensors), twin {t['plain_ms']:.4f} ms, conv1d alone "
                  f"{t['library_ms']:.4f} ms per block (CUDA events, 20 launches after 3 "
                  f"warm-up); bound {t['bound_ms']:.4f} ms by {t['bound_by']}, K1 at "
                  f"{100 * t['bound_ms'] / t['ms']:.1f} % of it [{tag}]", flush=True)
            forms[name] = t
        # the sup placement's complex legs (the CLI's --fc-pos sup, the
        # gear's sup route), checked and not timed: the inf form's variant
        legs_re, legs_im, _ = dec._device_legs(log2, "sup", dev)
        x, tail = inputs[torch.float32], tails[torch.float32]
        compare(f"f32 complex (sup) legs k={log2} block={PRODUCT_BLOCK} two-pointer vs twin",
                flat_decimate(x, legs_re, legs_im, tail=tail),
                flat_decimate_reference(x, legs_re, legs_im, tail=tail))

    # three streamed blocks (tail carried as raw int16, passed as its own
    # tensor) equal one long block bit for bit; a block is an output count
    # that is not a multiple of K1's 64-output tile, so outputs change their
    # place in a tile between the streamed and the long run
    legs, _, _ = dec._device_legs(6, "cen", dev)
    third = PRODUCT_BLOCK // 4 - 64 * 23
    blocks = [raw[i * third:(i + 1) * third].contiguous() for i in range(3)]
    state = dec.init_flat_state(6, dev, raw=True)
    parts = []
    for b in blocks:
        state, y = dec.decimate_flat_raw(state, b, 6)
        parts.append(torch.view_as_real(y))
    streamed = torch.cat(parts)
    zero_tail = dec.init_flat_state(6, dev, raw=True).tail
    long = flat_decimate(raw[:3 * third], legs, tail=zero_tail)
    long_twin = flat_decimate_reference(raw[:3 * third], legs, tail=zero_tail)
    torch.cuda.synchronize()
    err_stream = float((streamed - long).abs().max())
    err_stream_twin = float((streamed - long_twin).abs().max())
    check(err_stream == 0.0, f"K1 streamed vs long block differ by {err_stream:.3e}")
    check(err_stream_twin <= ATOL, f"streamed vs long block (twin): {err_stream_twin:.3e}")
    worst = max(worst, err_stream_twin)
    print(f"phase 2 k1 streaming 3x{third} ({third // 64} outputs each) vs one block: max abs "
          f"{err_stream:.3e} K1 vs K1, "
          f"{err_stream_twin:.3e} vs twin [{tag}]", flush=True)
    return {"max_abs_err": worst, **forms["i16 real"], "forms": forms}


def phase_k1_tc(dev: torch.device, tag: str) -> dict:
    """K1-TC against its plain Z-form version, at the product and gear blocks."""
    rng = np.random.default_rng(4321)
    worst = 0.0

    def compare(name, got, want):
        nonlocal worst
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite K1-TC output")
        err = float((got - want).abs().max())
        check(err <= ATOL, f"{name}: max abs {err:.3e} > {ATOL}")
        worst = max(worst, err)
        print(f"phase 2b k1-tc {name}: out {tuple(got.shape)} max_abs_err {err:.3e} "
              f"(atol {ATOL}) [{tag}]", flush=True)

    timings = {}
    for block in (PRODUCT_BLOCK, GEAR_BLOCK):
        raw = torch.from_numpy(rng.integers(-32768, 32767, size=(block, 2), endpoint=True,
                                            dtype=np.int16)).to(dev)
        for log2 in (2, 4, 6):
            legs, _, _ = dec._device_legs(log2, "cen", dev)
            tail = torch.from_numpy(rng.integers(-32768, 32767, endpoint=True, dtype=np.int16,
                                                 size=(dec.flat_tail_len(log2), 2))).to(dev)
            # the gear's call: the block and its carried tail as two tensors
            compare(f"i16 cen k={log2} block={block} two-pointer vs plain",
                    flat_decimate_tc(raw, legs, tail=tail),
                    flat_decimate_tc_reference(raw, legs, tail=tail))
            if log2 != 6:
                continue
            ext = torch.cat([tail, raw])  # K1's and conv1d's one-tensor input
            t = {"ms": time_ms(lambda: flat_decimate_tc(raw, legs, tail=tail)),
                 "k1_ms": time_ms(lambda: flat_decimate(ext, legs)),
                 "plain_ms": time_ms(lambda: flat_decimate_tc_reference(raw, legs, tail=tail)),
                 "library_ms": time_ms(conv1d_planes(ext, legs))}
            t["bound_ms"], t["bound_by"] = decimator_bound(
                ext.shape[0], block >> 6, 64, legs.shape[1], tensor_cores=True)
            print(f"phase 2b k1-tc time i16 cen k=6 block={block}: K1-TC {t['ms']:.4f} ms "
                  f"(tail and block as two tensors), K1 {t['k1_ms']:.4f} ms, plain (Z-form) "
                  f"{t['plain_ms']:.4f} ms, conv1d alone {t['library_ms']:.4f} ms per block "
                  f"(CUDA events, 20 launches after 3 warm-up); K1-TC bound "
                  f"{t['bound_ms']:.4f} ms by {t['bound_by']}, K1-TC at "
                  f"{100 * t['bound_ms'] / t['ms']:.1f} % of it [{tag}]", flush=True)
            timings[block] = t
        if block == GEAR_BLOCK:
            # the MXU counterpart against K1 on one raw block (HALO convention)
            halo_raw = torch.cat([torch.zeros((kdec.HALO, 2), dtype=torch.int16, device=dev),
                                  raw])
            compare(f"decimate_cascade_fused_mxu vs decimate_cascade_fused (K1) k=6 "
                    f"block={block}", kdec.decimate_cascade_fused_mxu(halo_raw, 6),
                    kdec.decimate_cascade_fused(halo_raw, 6))
            # three streamed blocks, each with the previous one's raw tail as
            # its own tensor, equal one long block; a block is an output count
            # that is not a multiple of the 128-output tile
            legs, _, _ = dec._device_legs(6, "cen", dev)
            tail_len = dec.flat_tail_len(6)
            size = ((block // 4) // 64 - 37) * 64
            tail = torch.zeros((tail_len, 2), dtype=torch.int16, device=dev)
            long = flat_decimate_tc(raw[:3 * size], legs, tail=tail)
            long_plain = flat_decimate_tc_reference(raw[:3 * size], legs, tail=tail)
            parts = []
            for i in range(3):
                b = raw[i * size:(i + 1) * size]
                parts.append(flat_decimate_tc(b, legs, tail=tail))
                tail = b[size - tail_len:].clone()
            parts = torch.cat(parts)
            torch.cuda.synchronize()
            err = float((parts - long).abs().max())
            check(err == 0.0, f"K1-TC streamed vs long block differ by {err:.3e}")
            compare(f"streaming 3x{size} vs one long block (plain)", parts, long_plain)
            print(f"phase 2b k1-tc streaming 3x{size} ({size // 64} outputs each) vs one long "
                  f"block: max abs {err:.3e} K1-TC vs K1-TC [{tag}]", flush=True)
    return {"max_abs_err": worst, **timings[GEAR_BLOCK], "product": timings[PRODUCT_BLOCK]}


def run_product(pipe: RxPipeline, blocks: list[np.ndarray]) -> tuple[np.ndarray, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio = [outs["channels"][0]["audio"] for _, outs in pipe.run(lambda b, n: blocks[b],
                                                                   len(blocks))]
    torch.cuda.synchronize()
    return np.concatenate(audio), time.perf_counter() - t0


@contextlib.contextmanager
def plain_decimator():
    """The same product path with K1's plain twin as the device decimator."""
    real_kernel = dec.flat_decimate
    dec.flat_decimate = flat_decimate_reference
    try:
        yield
    finally:
        dec.flat_decimate = real_kernel


def phase_product(pipe: RxPipeline, tag: str) -> tuple[int, list[np.ndarray]]:
    n_blocks = 8
    check(pipe.device_block == PRODUCT_BLOCK, f"device block {pipe.device_block}")
    t0 = time.perf_counter()
    blocks = fm_blocks(n_blocks, PRODUCT_BLOCK, PRODUCT_RATE, 20_000.0)
    print(f"phase 3 product: generated {n_blocks} blocks of {PRODUCT_BLOCK} i16 samples on "
          f"the host in {time.perf_counter() - t0:.2f} s (set-up, not timed) [{tag}]", flush=True)
    # warm-up of both paths: cuFFT plans, cuDNN choices, the kernel library
    list(pipe.run(lambda b, n: blocks[b], 2))
    with plain_decimator():
        list(pipe.run(lambda b, n: blocks[b], 2))

    signal_s = n_blocks * PRODUCT_BLOCK / PRODUCT_RATE
    seconds = {"K1": [], "twin": []}
    for path in ("twin", "K1", "K1", "twin"):  # alternated, so drift cancels
        if path == "K1":
            flat_decimate.launches = 0
            audio, elapsed = run_product(pipe, blocks)
            launches = flat_decimate.launches
            check(launches == n_blocks, f"K1 launched {launches} times for {n_blocks} blocks")
        else:
            with plain_decimator():
                twin_audio, elapsed = run_product(pipe, blocks)
        seconds[path].append(elapsed)
        print(f"phase 3 product ({path}): {n_blocks} blocks in {elapsed:.4f} s = "
              f"{elapsed / n_blocks * 1e3:.3f} ms/block, real-time factor "
              f"{signal_s / elapsed:.2f}, {n_blocks * PRODUCT_BLOCK / elapsed / 1e6:.1f} MS/s "
              f"input [{tag}]", flush=True)

    check(bool(np.isfinite(audio).all()), "non-finite audio")
    check(audio.shape == (n_blocks * 49_152,), f"audio shape {audio.shape}")
    snr = tone_snr(audio[len(audio) // 2:].astype(np.float64), 1000.0, 48_000.0)
    check(snr > 25.0, f"product-path tone SNR {snr:.1f} dB")
    agree = agreement_db(twin_audio, audio)
    check(agree >= 80.0, f"K1 path vs twin path audio agreement {agree:.1f} dB")
    k1_s, twin_s = (sum(seconds[k]) / 2 for k in ("K1", "twin"))
    print(f"phase 3 product: K1 path {k1_s / n_blocks * 1e3:.3f} ms/block (real-time factor "
          f"{signal_s / k1_s:.2f}), twin path {twin_s / n_blocks * 1e3:.3f} ms/block "
          f"({signal_s / twin_s:.2f}), mean of 2 runs each; K1 launches {launches} in the "
          f"last K1 run; tone SNR {snr:.2f} dB; K1 vs twin audio agreement {agree:.2f} dB "
          f"[{tag}]", flush=True)
    return launches, blocks


def phase_cli(tag: str) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli.wav")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sdrangel_tpu_torch", "demod", "--device", DEVICE,
             "--test-fm", "1000", "--rate", "768000", "--log2-decim", "1",
             "--channel", "nfm:100000", "--squelch", "-60", "--seconds", "1.1",
             "--out", out],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        elapsed = time.perf_counter() - t0
        check(proc.returncode == 0, f"CLI exit {proc.returncode}:\n{proc.stderr}")
        data, fs = wav.read_wav(out)
    audio = data[:, 0].astype(np.float64)[len(data) // 2:] / 32768.0
    snr = tone_snr(audio, 1000.0, fs)
    check(snr > 25.0, f"CLI tone SNR {snr:.1f} dB")
    print(f"phase 4 cli: demod --device cuda 768 kS/s /2 nfm:100000 exit 0 in {elapsed:.2f} s "
          f"(process start included), {len(data)} audio samples, tone SNR {snr:.2f} dB "
          f"[{tag}]", flush=True)
    print("phase 4 cli stderr: " + proc.stderr.strip().replace("\n", " | "), flush=True)


@contextlib.contextmanager
def plain_tc_decimator():
    """The bank gear with K1-TC's plain version as its decimator."""
    real_kernel = sharded.flat_decimate_tc
    sharded.flat_decimate_tc = flat_decimate_tc_reference
    try:
        yield
    finally:
        sharded.flat_decimate_tc = real_kernel


def phase_bank(dev: torch.device, tag: str) -> int:
    n_blocks = 3
    cfg = chainsharded_config()
    check(cfg.device_rate == GEAR_RATE and cfg.block == GEAR_BLOCK, "gear configuration")
    offs = chainsharded_offsets(cfg)
    idx, res = sharded.grid_split(cfg, offs)
    # one carrier in each used grid channel, so every demod holds a strong
    # signal: at demod 5's offset (grid 3) and demod 6's (grid 1)
    tone_demods = (5, 6)
    t0 = time.perf_counter()
    blocks = fm_blocks(n_blocks, GEAR_BLOCK, GEAR_RATE,
                       tuple(float(offs[k]) for k in tone_demods), amplitude=0.35)
    print(f"phase 5 bank: generated {n_blocks} blocks of {GEAR_BLOCK} i16 samples on the host "
          f"in {time.perf_counter() - t0:.2f} s (set-up, not timed); carriers at "
          f"{[float(offs[k]) for k in tone_demods]} Hz; grid {idx.tolist()}, residuals "
          f"{res.tolist()} Hz [{tag}]", flush=True)
    t0 = time.perf_counter()
    step, init_fn = sharded.build_sharded_step(cfg, dev)
    res_t, idx_t = torch.from_numpy(res).to(dev), torch.from_numpy(idx).to(dev)
    xs = [torch.from_numpy(b).to(dev) for b in blocks]  # the capture, resident on the card
    torch.cuda.synchronize()
    print(f"phase 5 bank: built and uploaded in {time.perf_counter() - t0:.2f} s [{tag}]",
          flush=True)

    def run():
        state, carry = init_fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        audio = []
        for x in xs:
            state, a, carry = step(state, x, carry, res_t, idx_t)
            audio.append(a)
        out = torch.cat(audio, dim=-1).cpu().numpy()
        torch.cuda.synchronize()
        return out, time.perf_counter() - start

    run()  # warm-up of both paths: cuFFT plans, the kernel library
    with plain_tc_decimator():
        run()
    signal_s = n_blocks * GEAR_BLOCK / GEAR_RATE
    seconds = {"K1-TC": [], "plain": []}
    # alternated, so drift cancels; K1-TC first (phase 3 runs the plain path
    # first), so a first-timed-run effect shows on either path
    order = ("K1-TC", "plain", "plain", "K1-TC")
    for path in order:
        if path == "K1-TC":
            flat_decimate_tc.launches = 0
            audio, elapsed = run()
            launches = flat_decimate_tc.launches
            check(launches == n_blocks, f"K1-TC launched {launches} times for {n_blocks} blocks")
        else:
            with plain_tc_decimator():
                plain_audio, elapsed = run()
        seconds[path].append(elapsed)
        print(f"phase 5 bank ({path}): {n_blocks} blocks in {elapsed:.4f} s = "
              f"{elapsed / n_blocks * 1e3:.3f} ms/block, real-time factor "
              f"{signal_s / elapsed:.2f} (capture resident on the card; audio fetched) "
              f"[{tag}]", flush=True)

    per_block = cfg.demod_cfg.resampler_plan.block_out
    check(audio.shape == (16, n_blocks * per_block), f"bank audio shape {audio.shape}")
    check(bool(np.isfinite(audio).all()), "non-finite bank audio")
    snrs = [tone_snr(audio[k, audio.shape[1] // 2:].astype(np.float64), 1000.0, 48_000.0)
            for k in tone_demods]
    check(min(snrs) > 25.0, f"bank tone SNR {snrs} dB")
    agree = agreement_db(plain_audio, audio)
    per_channel = [agreement_db(plain_audio[k], audio[k]) for k in range(16)]
    check(agree >= 80.0, f"K1-TC gear vs plain-decimator gear audio agreement {agree:.1f} dB")
    tc_s, plain_s = (sum(seconds[k]) / 2 for k in ("K1-TC", "plain"))
    first = order[0]
    rest = {k: seconds[k][1:] if k == first else seconds[k] for k in seconds}
    rest_ms = ", ".join(f"{k} {sum(v) / len(v) / n_blocks * 1e3:.3f} ms/block ({len(v)} runs)"
                        for k, v in rest.items())
    print(f"phase 5 bank: K1-TC path {tc_s / n_blocks * 1e3:.3f} ms/block (real-time factor "
          f"{signal_s / tc_s:.2f}), plain-decimator path {plain_s / n_blocks * 1e3:.3f} "
          f"ms/block ({signal_s / plain_s:.2f}), mean of 2 runs each; without the first "
          f"timed run ({first}): {rest_ms}; K1-TC launches "
          f"{launches} in the last K1-TC run; tone SNR {snrs[0]:.2f} / {snrs[1]:.2f} dB "
          f"(demods {tone_demods}); audio agreement {agree:.2f} dB over the bank, "
          f"{min(per_channel):.2f} dB at the worst channel [{tag}]", flush=True)
    return launches


#: phase 6: each receiver's device block (the engine's block solver at
#: 10 MS/s; PERF.md §4)
RECEIVER_BLOCKS = {"am": 10_240_000, "ssb": 20_480_000, "wfm": 10_240_000}


def phase_receivers(dev: torch.device, tag: str) -> None:
    """AM, SSB and WFM through RxPipeline on the card, each behind K1."""
    n_blocks, n_cpu = 6, 2
    for name in RECEIVERS:
        pipe, src = receiver_pipeline(name, dev)
        block = pipe.device_block
        check(block == RECEIVER_BLOCKS[name], f"{name}: device block {block}")
        check(pipe.fused_ingest, f"{name}: the i16 capture must go straight into K1")
        t0 = time.perf_counter()
        blocks = [testsource.to_iq_int16(testsource.generate(src, block, start_sample=b * block))
                  for b in range(n_blocks)]
        print(f"phase 6 {name}: generated {n_blocks} blocks of {block} i16 samples on the host "
              f"in {time.perf_counter() - t0:.2f} s (set-up, not timed); channel plan "
              f"{pipe.plans[0]} [{tag}]", flush=True)
        list(pipe.run(lambda b, n: blocks[b], 2))  # warm-up of both paths
        with plain_decimator():
            list(pipe.run(lambda b, n: blocks[b], 2))

        signal_s = n_blocks * block / PRODUCT_RATE
        seconds = {"K1": [], "twin": []}
        for path in ("twin", "K1", "K1", "twin"):
            if path == "K1":
                flat_decimate.launches = flat_decimate_tc.launches = 0
                audio, elapsed = run_product(pipe, blocks)
                launches = flat_decimate.launches
                check(launches == n_blocks and flat_decimate_tc.launches == 0,
                      f"{name}: K1 launched {launches} times, K1-TC "
                      f"{flat_decimate_tc.launches}, for {n_blocks} blocks")
            else:
                with plain_decimator():
                    twin_audio, elapsed = run_product(pipe, blocks)
            seconds[path].append(elapsed)
            print(f"phase 6 {name} ({path}): {n_blocks} blocks in {elapsed:.4f} s = "
                  f"{elapsed / n_blocks * 1e3:.3f} ms/block, real-time factor "
                  f"{signal_s / elapsed:.2f} [{tag}]", flush=True)

        per_block = pipe.demod_cfgs[0].resampler_plan.block_out
        check(audio.shape == (n_blocks * per_block,), f"{name}: audio shape {audio.shape}")
        check(bool(np.isfinite(audio).all()), f"{name}: non-finite audio")
        snr = tone_snr(audio[len(audio) // 2:].astype(np.float64), 1000.0, 48_000.0)
        check(snr > 25.0, f"{name}: tone SNR {snr:.1f} dB")
        agree = agreement_db(twin_audio, audio)
        check(agree >= 80.0, f"{name}: K1 path vs twin path audio agreement {agree:.1f} dB")
        cpu_pipe, _ = receiver_pipeline(name, "cpu")
        t0 = time.perf_counter()
        cpu_audio = np.concatenate([o["channels"][0]["audio"] for _, o in cpu_pipe.run(
            lambda b, n: blocks[b], n_cpu)])
        cpu_s = time.perf_counter() - t0
        cpu_agree = agreement_db(cpu_audio, audio[:n_cpu * per_block])
        check(cpu_agree >= 80.0, f"{name}: card vs CPU pipeline agreement {cpu_agree:.1f} dB")
        k1_s, twin_s = (sum(seconds[k]) / 2 for k in ("K1", "twin"))
        print(f"phase 6 {name}: K1 path {k1_s / n_blocks * 1e3:.3f} ms/block (real-time factor "
              f"{signal_s / k1_s:.2f}), twin path {twin_s / n_blocks * 1e3:.3f} ms/block "
              f"({signal_s / twin_s:.2f}), mean of 2 runs each; K1 launches {launches} "
              f"in the last K1 run; tone SNR {snr:.2f} dB; K1 vs twin {agree:.2f} dB; card vs "
              f"CPU pipeline on {n_cpu} blocks {cpu_agree:.2f} dB (CPU run {cpu_s:.1f} s) "
              f"[{tag}]", flush=True)


SERVER_BLOCKS = 6


def http(base: str, path: str, method: str = "GET", body: dict | None = None):
    """One request to the server: (status, JSON reply, or the raw bytes of a
    WAV)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method)
    if data:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            raw = r.read()
            return r.status, (raw if r.headers["Content-Type"] == "audio/wav" else json.loads(raw))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_server(pipe: RxPipeline, blocks: list[np.ndarray], tag: str) -> dict:
    """The REST server on the card, driven over HTTP, streaming and preloaded."""
    blocks = blocks[:SERVER_BLOCKS]
    check(len(blocks) == SERVER_BLOCKS, "phase 3 made too few blocks")
    # the reference: RxPipeline.run on the same blocks, its audio through the
    # WAV egress's int16 rounding
    ref = np.concatenate([o["channels"][0]["audio"] for _, o in pipe.run(
        lambda b, n: blocks[b], SERVER_BLOCKS)])
    ref_pcm = np.clip(ref * 32768.0, -32768, 32767).astype(np.int16)
    session = Session(device=DEVICE)
    srv = make_server(session, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                              daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    runs = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "product.sdriq")
            t0 = time.perf_counter()
            writer = sdriq.SdriqWriter(path, sample_rate=int(PRODUCT_RATE))
            for b in blocks:
                writer.write(b)
            writer.close()
            print(f"phase 7 server: wrote {SERVER_BLOCKS} blocks of phase 3 to a .sdriq "
                  f"({os.path.getsize(path) / 1e6:.1f} MB) in {time.perf_counter() - t0:.2f} s; "
                  f"server on {base} [{tag}]", flush=True)
            for i, preload in enumerate((False, True)):
                name = "preload" if preload else "streaming"
                code, reply = http(base, "/sdrangel/devicesets", "POST")
                check(code == 201 and reply["index"] == i, f"{name}: add device set {reply}")
                code, reply = http(base, f"/sdrangel/deviceset/{i}/device/settings", "PATCH", {
                    "kind": "filesource", "file_path": path, "log2_decim": 6,
                    "run_blocks": SERVER_BLOCKS, "publish_every": 1, "file_preload": preload})
                check(code == 200, f"{name}: device settings {reply}")
                code, reply = http(base, f"/sdrangel/deviceset/{i}/channel", "POST", {
                    "channelType": NFM, "inputFrequencyOffset": 20_000.0, "squelch_db": -60.0})
                check(code == 201, f"{name}: add channel {reply}")
                flat_decimate.launches = flat_decimate_tc.launches = 0
                t0 = time.perf_counter()
                code, reply = http(base, f"/sdrangel/deviceset/{i}/device/run", "POST")
                check(code == 200, f"{name}: run {reply}")
                while http(base, f"/sdrangel/deviceset/{i}")[1]["state"] == "running":
                    check(time.perf_counter() - t0 < 300, f"{name}: still running after 300 s")
                    time.sleep(0.01)
                wall = time.perf_counter() - t0
                launches, tc_launches = flat_decimate.launches, flat_decimate_tc.launches
                _, summary = http(base, "/sdrangel")
                _, device = http(base, f"/sdrangel/deviceset/{i}/device/report")
                _, channel = http(base, f"/sdrangel/deviceset/{i}/channel/0/report")
                code, data = http(base, f"/sdrangel/deviceset/{i}/channel/0/audio")
                check(code == 200, f"{name}: audio {data}")
                with wave.open(io.BytesIO(data)) as w:
                    check(w.getframerate() == 48_000, f"{name}: WAV rate {w.getframerate()}")
                    pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
                entry = summary["devicesetlist"]["deviceSets"][i]
                check(entry["state"] == "idle" and not entry["error"],
                      f"{name}: /sdrangel reports {entry['state']} {entry['error']!r}")
                check(device["blocksProcessed"] == SERVER_BLOCKS,
                      f"{name}: {device['blocksProcessed']} blocks processed")
                check(launches == SERVER_BLOCKS and tc_launches == 0,
                      f"{name}: K1 launched {launches} times, K1-TC {tc_launches}, for "
                      f"{SERVER_BLOCKS} blocks")
                check(pcm.shape == ref_pcm.shape, f"{name}: audio {pcm.shape} vs {ref_pcm.shape}")
                snr = tone_snr(pcm[len(pcm) // 2:].astype(np.float64) / 32768.0, 1000.0, 48_000.0)
                check(snr > 25.0, f"{name}: tone SNR {snr:.1f} dB")
                agree = agreement_db(ref_pcm, pcm)
                check(agree >= 80.0, f"{name}: server audio vs RxPipeline.run {agree:.1f} dB")
                runs[name] = {"pcm": pcm, "launches": launches,
                              "ms_per_block": device["elapsedSeconds"] / SERVER_BLOCKS * 1e3,
                              "rtf": device["realtimeFactor"]}
                print(f"phase 7 server ({name}): {SERVER_BLOCKS} blocks of {pipe.device_block} "
                      f"i16 samples, {runs[name]['ms_per_block']:.3f} ms/block from the first "
                      f"queued block to the last publish (device report elapsedSeconds "
                      f"{device['elapsedSeconds']:.4f} s), real-time factor {device['realtimeFactor']:.2f}"
                      f"; POST run to idle {wall:.3f} s host clock; K1 launches {launches}, "
                      f"K1-TC {tc_launches}; channel power {channel['channelPowerDB']:.2f} dB, "
                      f"squelch {channel['squelch']}, {channel['audioSamples']} audio samples; "
                      f"tone SNR {snr:.2f} dB; vs RxPipeline.run {agree:.2f} dB [{tag}]",
                      flush=True)
            # the streaming run's feed alone: memmap read, copy, pin, H2D
            _, mm = sdriq.open_mmap(path)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in range(SERVER_BLOCKS):
                pipe.upload(sdriq.read_block(mm, b * pipe.device_block, pipe.device_block))
            torch.cuda.synchronize()
            feed_ms = (time.perf_counter() - t0) / SERVER_BLOCKS * 1e3
            del mm
    finally:
        session.shutdown()
        srv.shutdown()
        srv.server_close()
    equal = np.array_equal(runs["streaming"]["pcm"], runs["preload"]["pcm"])
    check(equal, "preload audio differs from streaming audio")
    print(f"phase 7 server: preload audio equals streaming audio bit for bit ({equal}); "
          f"streaming {runs['streaming']['ms_per_block']:.3f} ms/block (RTF "
          f"{runs['streaming']['rtf']:.2f}), preload without per-block H2D "
          f"{runs['preload']['ms_per_block']:.3f} ms/block (RTF {runs['preload']['rtf']:.2f}); "
          f"the streaming feed alone (memmap read, copy, pin, H2D; synchronized) "
          f"{feed_ms:.3f} ms/block [{tag}]", flush=True)
    return {name: r["launches"] for name, r in runs.items()}


def tone_af(tones: tuple[float, ...]):
    """af_source(b, c, count): channel c's continuous full-scale tone, the
    AF the Tx session and the `mod` CLI make."""
    def src(b, c, count):
        tt = (b * count + np.arange(count)) / 48_000.0
        return np.sin(2 * np.pi * tones[c] * tt).astype(np.float32)
    return src


def int16_agreement(want: np.ndarray, got: np.ndarray) -> tuple[int, float]:
    """(max |difference| in LSB, agreement in dB) of two int16 captures."""
    return (int(np.abs(got.astype(np.int32) - want).max()),
            agreement_db(want.astype(np.float64), got.astype(np.float64)))


def tx_stage_ms(pipe: TxPipeline, af: torch.Tensor) -> dict:
    """Each stage of one Tx block alone, device ms by CUDA events: the AF
    upload, modulate, UpChannelizer, ×2^k cascade, int16, read-back."""
    state = pipe.init_state()
    group = pipe.groups[0]
    host_af = [af[c].cpu().numpy() for c in range(af.shape[0])]
    _, iq = group.modulate(state["mod"][0], af, group.cfg, pipe._residuals[0])
    _, bb = interp.upchannelize_bank(state["up"][0], iq, group.signs)
    merged = bb.sum(dim=0)
    _, out = interp.interpolate_cascade(state["dev"], merged, pipe.sink.log2_interp)
    i16 = (torch.view_as_real(out) * 32768.0).clamp(-32768.0, 32767.0).to(torch.int16)
    return {
        "upload": time_ms(lambda: pipe.upload(host_af)),
        "modulate": time_ms(lambda: group.modulate(state["mod"][0], af, group.cfg,
                                                   pipe._residuals[0])),
        "upchannelize": time_ms(lambda: interp.upchannelize_bank(state["up"][0], iq,
                                                                 group.signs)),
        "cascade": time_ms(lambda: interp.interpolate_cascade(state["dev"], merged,
                                                              pipe.sink.log2_interp)),
        "int16": time_ms(lambda: (torch.view_as_real(out) * 32768.0).clamp(
            -32768.0, 32767.0).to(torch.int16)),
        "read-back": time_ms(lambda: fetch(i16)),
        "step": time_ms(lambda: pipe.step(state, af)),
    }


def tx_host_ms(pipe: TxPipeline, af, iters: int = 10) -> dict:
    """The host's part of one Tx block, each piece alone on the host clock
    (mean of `iters`, synchronized before and after): the AF tone, the
    upload (stack, pin, H2D), enqueueing the step (no wait), the read-back
    (a pinned buffer, D2H, the wait) and a pinned allocation of the
    read-back's size alone."""
    state = pipe.init_state()
    host_af = [af(0, c, 4096) for c in range(len(pipe.specs))]
    dev_af = pipe.upload(host_af)
    _, out = pipe.step(state, dev_af)

    def clock(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    def enqueue() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.step(state, dev_af)
        spent = time.perf_counter() - t0
        torch.cuda.synchronize()
        return spent * 1e3

    enqueue()
    return {
        "af": clock(lambda: [af(0, c, 4096) for c in range(len(pipe.specs))]),
        "upload": clock(lambda: pipe.upload(host_af)),
        "step enqueue": sum(enqueue() for _ in range(iters)) / iters,
        "read-back": clock(lambda: fetch(out)),
        "pinned alloc": clock(lambda: torch.empty(out.shape, dtype=out.dtype, pin_memory=True)),
    }


def phase_tx(dev: torch.device, tag: str) -> int:
    """The Tx path on the card: full width, loopback through K1, four
    channels, the CLI, a Tx device set over HTTP."""
    af = tone_af((1000.0,))
    spec = [TxChannelSpec(NFM_MOD, 20_000.0, {})]
    pipe = TxPipeline(TxDeviceConfig(TX_RATE, 6), spec, device=dev)
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 flags on after TxPipeline construction")
    check(pipe.device_block == TX_BLOCK and pipe.plans[0].signs == (),
          f"Tx device block {pipe.device_block}, plan {pipe.plans[0]}")
    list(pipe.run(af, 4))  # warm-up by block count: cuFFT plans, cuDNN choices
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks = list(pipe.run(af, TX_BLOCKS))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    tx = np.concatenate(blocks)
    check(tx.shape == (TX_BLOCKS * TX_BLOCK, 2) and tx.dtype == np.int16,
          f"Tx output {tx.shape} {tx.dtype}")
    block_s = 4096 / 48_000.0
    stages = tx_stage_ms(pipe, pipe.upload([af(0, 0, 4096)]))
    host = tx_host_ms(pipe, af)
    t0 = time.perf_counter()
    cpu = np.concatenate(list(TxPipeline(TxDeviceConfig(TX_RATE, 6), spec, device="cpu").run(af, 2)))
    cpu_s = time.perf_counter() - t0
    lsb, agree = int16_agreement(cpu, tx[:len(cpu)])
    check(lsb <= 1 and agree >= 80.0, f"Tx card vs CPU: {lsb} LSB, {agree:.1f} dB")
    print(f"phase 8a tx: 9.6 MS/s x64 NFM +20 kHz, {TX_BLOCKS} blocks of {TX_BLOCK} int16 I/Q "
          f"({len(tx)} samples) in {elapsed:.4f} s = {elapsed / TX_BLOCKS * 1e3:.3f} ms/block "
          f"(host clock, read-back included, after 4 warm-up blocks), Tx real-time factor "
          f"{TX_BLOCKS * block_s / elapsed:.2f}; stages alone, device ms by CUDA events: "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + "; host ms alone: " + ", ".join(f"{k} {v:.4f}" for k, v in host.items())
          + f"; card vs CPU on 2 blocks: max {lsb} LSB, {agree:.2f} dB (CPU run {cpu_s:.1f} s) "
          f"[{tag}]", flush=True)
    print(f"phase 8a tx: device time of 8 blocks by torch.profiler, against the timed run's "
          f"{elapsed / TX_BLOCKS * 1e3:.3f} ms/block [{tag}]", flush=True)
    _device_time(lambda: list(pipe.run(af, 8)), 8, elapsed / TX_BLOCKS * 8)

    # (b) the loopback through the port's Rx path, K1 in front
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tx.sdriq")
        writer = sdriq.SdriqWriter(path, sample_rate=int(TX_RATE))
        for b in blocks:
            writer.write(b)
        writer.close()
        info, mm = sdriq.open_mmap(path)
        check(info.n_samples == len(tx) and info.sample_rate == int(TX_RATE),
              f"loopback capture header {info}")
        rx = RxPipeline(DeviceConfig(TX_RATE, log2_decim=6),
                        [ChannelSpec(NFM, 20_000.0, {"squelch_db": -60.0})], dev)
        check(rx.device_block == TX_RX_BLOCK, f"Rx block {rx.device_block}")
        n_rx = 3
        check(n_rx * TX_RX_BLOCK <= info.n_samples, "loopback capture too short")
        flat_decimate.launches = flat_decimate_tc.launches = 0
        t0 = time.perf_counter()
        audio = np.concatenate([o["channels"][0]["audio"] for _, o in rx.run(
            lambda b, count: sdriq.read_block(mm, b * count, count), n_rx)])
        rx_s = time.perf_counter() - t0
        loop_launches, tc = flat_decimate.launches, flat_decimate_tc.launches
        del mm
    check(loop_launches == n_rx and tc == 0,
          f"loopback: K1 launched {loop_launches} times, K1-TC {tc}, for {n_rx} Rx blocks")
    check(bool(np.isfinite(audio).all()), "loopback: non-finite audio")
    snr = tone_snr(audio[len(audio) // 2:].astype(np.float64), 1000.0, 48_000.0)
    check(snr > 25.0, f"loopback tone SNR {snr:.1f} dB")
    print(f"phase 8b tx loopback: the {TX_BLOCKS} blocks as a .sdriq, decoded by RxPipeline on "
          f"cuda at 9.6 MS/s /64 NFM +20 kHz over {n_rx} blocks of {TX_RX_BLOCK} in {rx_s:.2f} s; "
          f"K1 launches {loop_launches}, K1-TC {tc}; {len(audio)} audio samples, tone SNR "
          f"{snr:.2f} dB [{tag}]", flush=True)

    # (c) four channels in three groups, merged by sum/÷n
    four = [TxChannelSpec(NFM_MOD, -50_000.0, {}), TxChannelSpec(NFM_MOD, 50_000.0, {}),
            TxChannelSpec("sdrangel.channeltx.modam", 20_000.0, {}),
            TxChannelSpec("sdrangel.channeltx.modssb", -20_000.0, {})]
    src4 = tone_af((700.0, 1100.0, 900.0, 1300.0))
    card4, cpu4 = (np.concatenate(list(TxPipeline(TxDeviceConfig(TX_RATE, 6), four,
                                                  device=device).run(src4, 2)))
                   for device in (dev, "cpu"))
    groups4 = [len(g.idxs) for g in TxPipeline(TxDeviceConfig(TX_RATE, 6), four,
                                               device=dev).groups]
    check(groups4 == [2, 1, 1], f"four channels: groups {groups4}")
    lsb4, agree4 = int16_agreement(cpu4, card4)
    check(lsb4 <= 1 and agree4 >= 80.0, f"four channels: card vs CPU {lsb4} LSB, {agree4:.1f} dB")
    x = card4[TX_BLOCK:].astype(np.float32)
    c = (x[:, 0] + 1j * x[:, 1])[::64]  # the 150 kHz baseband's samples (in-band)
    spec4 = np.abs(np.fft.fft(c * np.hanning(len(c))))
    freqs = np.fft.fftfreq(len(c), 64 / TX_RATE)
    peaks = [float(spec4[np.abs(freqs - f0) < 6_000.0].max() / np.median(spec4))
             for f0 in (-50e3, 50e3, 20e3, -19e3)]
    check(min(peaks) > 50.0, f"four channels: carrier peaks over the median {peaks}")
    print(f"phase 8c tx four channels: NFM -50/+50 kHz, AM +20 kHz, SSB -20 kHz in groups "
          f"{groups4}, 2 blocks: card vs CPU max {lsb4} LSB, "
          f"{agree4:.2f} dB; each carrier {min(peaks):.0f}x or more above the median bin [{tag}]",
          flush=True)

    # (d) the CLI: 384 kS/s ×1, two UpChannelizer stages
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli.sdriq")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sdrangel_tpu_torch", "mod", "--device", DEVICE,
             "--channel", "nfm:20000", "--rate", "384000", "--seconds", "1.0", "--out", out],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"mod CLI exit {proc.returncode}:\n{proc.stderr}")
        info, mm = sdriq.open_mmap(out)
        cli = np.array(mm)
        del mm
    ref_pipe = TxPipeline(TxDeviceConfig(384_000.0), [TxChannelSpec(NFM_MOD, 20_000.0, {})],
                          device=dev)
    check(ref_pipe.plans[0].signs == (0, 0), f"CLI plan {ref_pipe.plans[0]}")
    ref = np.concatenate(list(ref_pipe.run(tone_af((1000.0,)), 11)))
    check(info.sample_rate == 384_000 and cli.shape == ref.shape, f"CLI capture {cli.shape}")
    lsb_cli, agree_cli = int16_agreement(ref, cli)
    check(lsb_cli <= 1 and agree_cli >= 80.0, f"CLI vs TxPipeline {lsb_cli} LSB")
    print(f"phase 8d tx cli: mod --device cuda 384 kS/s x1 nfm:20000 (stages {ref_pipe.plans[0].signs}) "
          f"exit 0 in {cli_s:.2f} s (process start included), {len(cli)} samples; against "
          f"TxPipeline in this process max {lsb_cli} LSB, {agree_cli:.2f} dB [{tag}]", flush=True)
    print("phase 8d tx cli stderr: " + proc.stderr.strip().replace("\n", " | "), flush=True)

    # (e) a Tx device set over HTTP
    n_set = 20
    session = Session(device=DEVICE)
    srv = make_server(session, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                              daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "set.sdriq")
            code, reply = http(base, "/sdrangel/devicesets", "POST", {"direction": "tx"})
            check(code == 201 and reply["direction"] == "tx", f"add Tx set {reply}")
            code, reply = http(base, "/sdrangel/deviceset/0/device/settings", "PATCH", {
                "file_path": path, "sample_rate": TX_RATE, "log2_interp": 6})
            check(code == 200, f"sink settings {reply}")
            code, reply = http(base, "/sdrangel/deviceset/0/channel", "POST", {
                "channelType": NFM_MOD, "inputFrequencyOffset": 20_000.0,
                "toneFrequency": 1000.0})
            check(code == 201, f"add modulator {reply}")
            t0 = time.perf_counter()
            code, reply = http(base, "/sdrangel/deviceset/0/device/run", "POST")
            check(code == 200, f"run {reply}")
            while http(base, "/sdrangel/deviceset/0/device/report")[1]["blocksProcessed"] < n_set:
                check(time.perf_counter() - t0 < 300, "Tx set: 20 blocks not reached in 300 s")
                time.sleep(0.005)
            _, report = http(base, "/sdrangel/deviceset/0/device/report")
            code, _ = http(base, "/sdrangel/deviceset/0/device/run", "DELETE")
            wall = time.perf_counter() - t0
            check(code == 200, "stop the Tx set")
            _, entry = http(base, "/sdrangel/deviceset/0")
            check(entry["state"] == "idle" and not entry["error"],
                  f"Tx set {entry['state']} {entry['error']!r}")
            info, mm = sdriq.open_mmap(path)
            recorded = np.array(mm[:n_set * TX_BLOCK])
            del mm
    finally:
        session.shutdown()
        srv.shutdown()
        srv.server_close()
    final = session.device_sets[0].blocks_processed
    check(info.sample_rate == int(TX_RATE) and info.n_samples == final * TX_BLOCK
          and final >= n_set, f"Tx set capture {info}, {final} blocks")
    equal = np.array_equal(recorded, tx[:n_set * TX_BLOCK])
    check(equal, "the Tx set's samples differ from phase 8a's first 20 blocks")
    print(f"phase 8e tx server: a Tx set over HTTP (NFM +20 kHz, 9.6 MS/s x64, filesink) stopped "
          f"after {report['blocksProcessed']} blocks ({final} recorded, {info.n_samples} samples); "
          f"its first {n_set} blocks equal phase 8a's ({equal}); device report at the stop: "
          f"realtimeFactor {report['realtimeFactor']:.2f}, elapsedSeconds "
          f"{report['elapsedSeconds']:.4f} ({report['elapsedSeconds'] / report['blocksProcessed'] * 1e3:.3f} "
          f"ms/block); POST run to stop {wall:.3f} s host clock [{tag}]", flush=True)
    return loop_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    dev = torch.device(DEVICE)
    tag = card()
    print(tag, flush=True)
    pipe = RxPipeline(
        DeviceConfig(PRODUCT_RATE, log2_decim=6),
        [ChannelSpec(NFM, 20_000.0, {"squelch_db": -60.0})], dev)
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 flags still on after pipeline construction")
    print(f"phase 0 device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__} cuda {torch.version.cuda}; cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} [{tag}]", flush=True)

    info = build.build()
    regs = ptxas_summary(info.ptxas)
    print(f"phase 1 build: {os.path.relpath(info.path, REPO)}, nvcc {info.seconds:.2f} s; "
          f"ptxas: {'; '.join(regs) or 'n/a'} [{tag}]", flush=True)
    lib = build.library()
    for kernel, count in (("flat_decimate_tc_kernel", len(RATIOS)),
                          ("flat_decimate_kernel", 4 * len(RATIOS))):
        lines = [line for line in regs if line.startswith(kernel + "<")]
        check(len(lines) == count and all(" 0 bytes spill stores" in line for line in lines),
              f"{kernel} spills or is missing from the ptxas report: {lines}")
    k1_occ = {}
    for k in (2, 4, 6):
        for name, dtype, fc_pos in K1_FORMS:
            variant = (1 << k, dec.flat_legs(k).shape[1], dtype == torch.int16, fc_pos != "cen")
            k1_occ[k, name] = (k1_kernel.smem_bytes(*variant), k1_kernel.blocks_per_sm(*variant))
    print("phase 1 build: dynamic shared memory per block and blocks resident per SM: K1 "
          + ", ".join(f"k={k} {name} {b} B {n} blocks" for (k, name), (b, n) in k1_occ.items())
          + "; K1-TC " + ", ".join(f"k={k} {lib.sdr_flat_decimate_tc_smem_bytes(1 << k)} B "
                                   f"{blocks_per_sm(1 << k)} blocks" for k in (2, 4, 6))
          + f" [{tag}]", flush=True)
    check(all(n >= 2 for (k, _), (_, n) in k1_occ.items() if k == 6),
          "K1 at r=64 holds fewer than 2 blocks per SM")
    check(blocks_per_sm(64) >= 2, "K1-TC at r=64 holds fewer than 2 blocks per SM")

    k1 = phase_k1(dev, tag)
    tc = phase_k1_tc(dev, tag)
    launches, product_blocks = phase_product(pipe, tag)
    phase_cli(tag)
    tc_launches = phase_bank(dev, tag)
    phase_receivers(dev, tag)
    server_launches = phase_server(pipe, product_blocks, tag)
    tx_loopback_launches = phase_tx(dev, tag)

    print(tag, flush=True)
    print(json.dumps({"kernels": [{
        "name": "flat_decimate",
        "route": "cuda",
        "source": "sdrangel_tpu_torch/kernels/csrc/flat_decimate.cu",
        "replaces": "sdrangel_tpu/pallas/decimator.py:94",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "gear_block_ms": tc["k1_ms"],
        "forms": k1["forms"],
        "server_launches": server_launches,
        "tx_loopback_launches": tx_loopback_launches,
    }, {
        "name": "flat_decimate_tc",
        "route": "cuda",
        "source": "sdrangel_tpu_torch/kernels/csrc/flat_decimate_tc.cu",
        "replaces": "sdrangel_tpu/pallas/decimator.py:165",
        "launches": tc_launches,
        "max_abs_err": tc["max_abs_err"],
        "ms": tc["ms"],
        "plain_ms": tc["plain_ms"],
        "bound_ms": tc["bound_ms"],
        "bound_by": tc["bound_by"],
        "library_ms": tc["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
