"""IIR filters as doubling scans: the first-order RC lowpass and the biquad.

Reference: sdrbase/dsp/filterrc.{h,cpp} (the one-pole RC lowpass of FM
deemphasis), sdrbase/dsp/recursivefilters.{h,cpp} (the 2nd-order band-pass).
A 1st-order IIR is the EMA scan; a biquad's feedback is a product of 2×2
companion matrices, scanned in log2(T) whole-block steps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .scanops import _doubling_scan, ema


class Iir1State(NamedTuple):
    y1: torch.Tensor  # (...,) previous output


def make_iir1(device: torch.device, batch_shape=()) -> Iir1State:
    return Iir1State(torch.zeros(batch_shape, dtype=torch.float32, device=device))


def rc_lowpass(
    state: Iir1State, x: torch.Tensor, timeconst_samples: float
) -> tuple[Iir1State, torch.Tensor]:
    """y[t] = a·y[t−1] + (1 − a)·x[t], a = exp(−1/timeconst) — the
    LowPassFilterRC of FM deemphasis (filterrc.cpp)."""
    a = float(np.exp(-1.0 / timeconst_samples))
    y = ema(x, 1.0 - a, state.y1)
    return Iir1State(y[..., -1].clone()), y


class BiquadState(NamedTuple):
    s: torch.Tensor  # (..., 2) [y[t-1], y[t-2]]


def make_biquad(device: torch.device, batch_shape=()) -> BiquadState:
    return BiquadState(torch.zeros((*batch_shape, 2), dtype=torch.float32, device=device))


def _affine2_compose(f: tuple, g: tuple) -> tuple:
    """g∘f for s -> M·s + v with 2×2 M, f applied first: (Mg·Mf, Mg·vf + vg)."""
    f00, f01, f10, f11, fv0, fv1 = f
    g00, g01, g10, g11, gv0, gv1 = g
    return (g00 * f00 + g01 * f10, g00 * f01 + g01 * f11,
            g10 * f00 + g11 * f10, g10 * f01 + g11 * f11,
            g00 * fv0 + g01 * fv1 + gv0, g10 * fv0 + g11 * fv1 + gv1)


def biquad(
    state: BiquadState, x: torch.Tensor, b: tuple[float, float, float], a: tuple[float, float],
) -> tuple[BiquadState, torch.Tensor]:
    """y[t] = b0 x[t] + b1 x[t−1] + b2 x[t−2] − a1 y[t−1] − a2 y[t−2].

    The feed-forward part is a 3-tap FIR (zero history, as the JAX
    function); the feedback s[t] = M·s[t−1] + (u[t], 0) with
    M = [[−a1, −a2], [1, 0]] is scanned as affine maps."""
    b0, b1, b2 = b
    a1, a2 = a
    zero = torch.zeros_like(x[..., :2])
    xm1 = torch.cat([zero[..., :1], x[..., :-1]], dim=-1)
    xm2 = torch.cat([zero, x[..., :-2]], dim=-1)
    u = b0 * x + b1 * xm1 + b2 * xm2
    full = lambda v: torch.full_like(u, v)
    m00, m01, m10, m11, v0, v1 = _doubling_scan(
        (full(-a1), full(-a2), full(1.0), full(0.0), u, torch.zeros_like(u)), _affine2_compose)
    s0, s1 = state.s[..., 0:1], state.s[..., 1:2]
    y = m00 * s0 + m01 * s1 + v0
    return BiquadState(torch.stack([y[..., -1], y[..., -2]], dim=-1)), y.to(torch.float32)


def bandpass_biquad_coeffs(f0: float, fs: float, r: float = 0.97):
    """SecondOrderRecursiveFilter's band-pass at f0 (recursivefilters.cpp)."""
    w0 = 2.0 * np.pi * f0 / fs
    return (1.0 - r, 0.0, -(1.0 - r)), (-2.0 * r * np.cos(w0), r * r)
