"""Drive the PyTorch port's Rx product path once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own line; every number carries the card's name and
power limit as nvidia-smi reports them):
  0. device and precision: the card, its power limit, the TF32 flags;
  1. build: K1 (kernels/csrc/flat_decimate.cu) with nvcc for sm_90a;
  2. K1 against its plain twin on the card: i16 at ÷4/÷16/÷64 on the
     10,240,000-sample product block, f32 real legs, complex legs (inf/sup),
     three streamed blocks against one long block; per-block times;
  3. the product path: RxPipeline on cuda, 10 MS/s i16, ÷64 cen, NFM at
     +20 kHz, 8 blocks of continuous FM, timed twin, K1, K1, twin; K1
     launched once per block, the 1 kHz tone above 25 dB, and ≥ 80 dB
     agreement with the runs whose decimator is the plain twin;
  4. the CLI on cuda at 768 kS/s ÷2 with the channel at +100 kHz.
Then a JSON line of the kernels, and last the ok line. Any failed check
raises: the script then exits non-zero and prints no ok line. It needs a
card; without one it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import sdrangel_tpu_torch.dsp.decimators as dec
from sdrangel_tpu_torch.io import testsource, wav
from sdrangel_tpu_torch.kernels import build
from sdrangel_tpu_torch.kernels.flat_decimate import flat_decimate, flat_decimate_reference
from sdrangel_tpu_torch.runtime.engine import ChannelSpec, DeviceConfig, RxPipeline

REPO = os.path.dirname(os.path.abspath(__file__))
ATOL = 2e-5  # K1 vs twin, the Pallas kernel's own tolerance
PRODUCT_RATE = 10e6
PRODUCT_BLOCK = 10_240_000  # RxPipeline's device block at 10 MS/s ÷64 NFM
NFM = "sdrangel.channel.nfmdemod"
DEVICE = "cuda"


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


def fm_blocks(n_blocks: int, block: int, rate: float, carrier: float) -> list[np.ndarray]:
    cfg = testsource.TestSourceConfig(
        sample_rate=rate, carrier_freq=carrier, modulation="fm", tone_freq=1000.0,
        fm_deviation=5000.0, amplitude=0.5)
    return [testsource.to_iq_int16(testsource.generate(cfg, block, start_sample=b * block))
            for b in range(n_blocks)]


def phase_k1(dev: torch.device, tag: str) -> dict:
    rng = np.random.default_rng(1234)
    worst = 0.0

    def compare(name, ext, legs_re, legs_im=None):
        nonlocal worst
        got = flat_decimate(ext, legs_re, legs_im)
        want = flat_decimate_reference(ext, legs_re, legs_im)
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
    timings = {}
    for log2 in (2, 4, 6):
        legs, _, _ = dec._device_legs(log2, "cen", dev)
        tail = torch.from_numpy(rng.integers(-32768, 32767, size=(dec.flat_tail_len(log2), 2),
                                             dtype=np.int16)).to(dev)
        ext = torch.cat([tail, raw])
        compare(f"i16 cen k={log2} block={PRODUCT_BLOCK}", ext, legs)
        if log2 == 6:
            timings["ms"] = time_ms(lambda: flat_decimate(ext, legs))
            timings["plain_ms"] = time_ms(lambda: flat_decimate_reference(ext, legs))
            print(f"phase 2 k1 time i16 cen k=6 block={PRODUCT_BLOCK}: K1 "
                  f"{timings['ms']:.4f} ms, twin {timings['plain_ms']:.4f} ms per block "
                  f"(CUDA events, 20 launches after 3 warm-up) [{tag}]", flush=True)

    x = (raw.to(torch.float32) * (1.0 / 32768.0)).contiguous()
    legs, _, _ = dec._device_legs(6, "cen", dev)
    ext = torch.cat([torch.zeros((dec.flat_tail_len(6), 2), device=dev), x])
    compare(f"f32 cen k=6 block={PRODUCT_BLOCK}", ext, legs)
    t_f32 = time_ms(lambda: flat_decimate(ext, legs))
    t_f32_plain = time_ms(lambda: flat_decimate_reference(ext, legs))
    for fc_pos in ("inf", "sup"):
        legs_re, legs_im, _ = dec._device_legs(6, fc_pos, dev)
        compare(f"f32 {fc_pos} complex legs k=6 block={PRODUCT_BLOCK}", ext, legs_re, legs_im)
    legs_re, legs_im, _ = dec._device_legs(6, "inf", dev)
    t_cplx = time_ms(lambda: flat_decimate(ext, legs_re, legs_im))
    t_cplx_plain = time_ms(lambda: flat_decimate_reference(ext, legs_re, legs_im))
    print(f"phase 2 k1 time f32 k=6: real legs K1 {t_f32:.4f} ms twin {t_f32_plain:.4f} ms; "
          f"complex legs K1 {t_cplx:.4f} ms twin {t_cplx_plain:.4f} ms per block [{tag}]",
          flush=True)

    # three streamed blocks (tail carried as raw int16) equal one long block
    third = PRODUCT_BLOCK // 4
    blocks = [raw[i * third:(i + 1) * third].contiguous() for i in range(3)]
    state = dec.init_flat_state(6, dev, raw=True)
    parts = []
    for b in blocks:
        state, y = dec.decimate_flat_raw(state, b, 6)
        parts.append(torch.view_as_real(y))
    streamed = torch.cat(parts)
    long = flat_decimate(torch.cat([dec.init_flat_state(6, dev, raw=True).tail, *blocks]), legs)
    long_twin = flat_decimate_reference(
        torch.cat([dec.init_flat_state(6, dev, raw=True).tail, *blocks]), legs)
    torch.cuda.synchronize()
    err_stream = float((streamed - long).abs().max())
    err_stream_twin = float((streamed - long_twin).abs().max())
    check(err_stream <= ATOL and err_stream_twin <= ATOL,
          f"streamed vs long block: {err_stream:.3e} (K1) {err_stream_twin:.3e} (twin)")
    worst = max(worst, err_stream_twin)
    print(f"phase 2 k1 streaming 3x{third} vs one block: max abs {err_stream:.3e} vs K1, "
          f"{err_stream_twin:.3e} vs twin [{tag}]", flush=True)
    return {"max_abs_err": worst, **timings}


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


def phase_product(pipe: RxPipeline, tag: str) -> int:
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
    return launches


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
    ptxas = "; ".join(
        line.strip() for line in info.ptxas.splitlines()
        if re.search(r"registers|Compiling entry|spill", line))
    print(f"phase 1 build: {os.path.relpath(info.path, REPO)}, nvcc {info.seconds:.2f} s; "
          f"ptxas: {ptxas or 'n/a'} [{tag}]", flush=True)
    lib = build.library()
    print("phase 1 build: dynamic shared memory per block "
          + ", ".join(f"k={k} {lib.sdr_flat_decimate_smem_bytes(1 << k, dec.flat_legs(k).shape[1], c)} B"
                      f"{' (complex legs)' if c else ''}" for k in (2, 4, 6) for c in (0, 1))
          + f" [{tag}]", flush=True)

    k1 = phase_k1(dev, tag)
    launches = phase_product(pipe, tag)
    phase_cli(tag)

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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
