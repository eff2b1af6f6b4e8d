"""K-PLL: the per-sample phase-locked loops on the card — wrappers.

Three entry points of `csrc/pll_scan.cu`, each a serial loop run by one
thread per channel walking the block in order with the loop state in
registers:
  pll_run        x (C, T) complex64 -> carrier e^{jθ} (C, T) complex64,
                 state (2, C) [phase, freq]; three launches on the current
                 stream: arg x per sample, the loop, the carrier per sample
                 (two (T, C) float32 scratch arrays between them)
  ref_pll_run    x (C, T) complex64 -> carrier (C, T) complex64,
                 state (4, C) [v0, v1, v2, phi]
  pilot_pll_run  x (C, T) float32 -> pre-update phases (C, T) float32,
                 state (8, C) [phase, freq, i1, i2, q1, q2, x1, lock]
Each takes CUDA tensors only and updates `state` in place; the plain
versions (the per-sample PyTorch loops in dsp/phaselock.py) are what a CPU
tensor runs, and phaselock dispatches between the two by the tensors'
device. There is no fallback: a failed build or launch raises. Each call
adds one to its wrapper's `launches`, pll_run's three kernels included.
"""

from __future__ import annotations

import torch

from . import build

STATE_ROWS = {"pll_run": 2, "ref_pll_run": 4, "pilot_pll_run": 8}


def _check(name: str, x: torch.Tensor, state: torch.Tensor, dtype: torch.dtype) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} launches on cuda tensors, not {x.device}")
    if x.dim() != 2 or x.dtype != dtype or not x.is_contiguous():
        raise TypeError(f"{name}: x must be a contiguous (C, T) {dtype}, got {x.dtype} "
                        f"{tuple(x.shape)}")
    want = (STATE_ROWS[name], x.shape[0])
    if (state.dtype != torch.float32 or tuple(state.shape) != want
            or not state.is_contiguous() or state.device != x.device):
        raise TypeError(f"{name}: state must be a contiguous {want} float32 on {x.device}, got "
                        f"{state.dtype} {tuple(state.shape)} on {state.device}")


def _raise_on(err: int, name: str, x: torch.Tensor) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({build.library().sdr_cuda_error_string(err).decode()}) at "
                           f"x {tuple(x.shape)}")


def pll_run(x: torch.Tensor, state: torch.Tensor, g1: float, g2: float) -> torch.Tensor:
    """The 2nd-order loop (JAX phaselock.pll_run): returns the carrier."""
    _check("pll_run", x, state, torch.complex64)
    out = torch.empty_like(x)
    theta_x, theta = torch.empty((2, x.shape[1], x.shape[0]), dtype=torch.float32,
                                 device=x.device)
    with torch.cuda.device(x.device):
        err = build.library().sdr_pll_run(
            x.data_ptr(), out.data_ptr(), state.data_ptr(), theta_x.data_ptr(), theta.data_ptr(),
            x.shape[0], x.shape[1], g1, g2, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "pll_run", x)
    pll_run.launches += 1
    return out


def ref_pll_run(x: torch.Tensor, state: torch.Tensor, coeffs: tuple[float, ...]) -> torch.Tensor:
    """PhaseLockComplex's biquad loop (JAX phaselock.ref_pll_run); coeffs
    (b0, b1, b2, a1, a2). Returns the carrier."""
    _check("ref_pll_run", x, state, torch.complex64)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = build.library().sdr_ref_pll_run(
            x.data_ptr(), out.data_ptr(), state.data_ptr(), x.shape[0], x.shape[1], *coeffs,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "ref_pll_run", x)
    ref_pll_run.launches += 1
    return out


def pilot_pll_run(x: torch.Tensor, state: torch.Tensor, coeffs: tuple[float, ...]
                  ) -> torch.Tensor:
    """The 19 kHz pilot loop (JAX phaselock.pilot_pll_run); coeffs (pb0,
    pa1, pa2, lf_b0, lf_b1, w_lo, w_hi). Returns the pre-update phases."""
    _check("pilot_pll_run", x, state, torch.float32)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = build.library().sdr_pilot_pll_run(
            x.data_ptr(), out.data_ptr(), state.data_ptr(), x.shape[0], x.shape[1], *coeffs,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "pilot_pll_run", x)
    pilot_pll_run.launches += 1
    return out


pll_run.launches = 0  # kernel launches since the last reset
ref_pll_run.launches = 0
pilot_pll_run.launches = 0
