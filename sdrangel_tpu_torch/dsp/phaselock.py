"""Phase- and frequency-locked loops.

Reference: sdrbase/dsp/phaselockcomplex.{h,cpp} (the loop of synchronous
AM), sdrbase/dsp/phaselock.{h,cpp} (the 19 kHz pilot loop of broadcast FM
stereo), sdrbase/dsp/freqlockcomplex.cpp (the FLL).

A PLL's loop filter feeds back every sample, so pll_run, ref_pll_run and
pilot_pll_run are serial recurrences. On the card each is one call of
K-PLL (kernels/pll_scan.py), whose serial part runs one thread per channel
(pll_run's phase detector and carrier run in parallel around it); on the
CPU each runs its plain version here, a Python loop over time with
whole-batch tensor ops, which is also the card tests' oracle. Both round
every operation in float32 in the JAX scan's order (JAX
sdrangel_tpu/dsp/phaselock.py); jnp.mod is a floor-mod built on the exact
fmod, and JAX's weak-typed π and 2π are float32 values. The FLL is
block-parallel (an EMA scan and a prefix sum) and stays plain PyTorch on
both devices.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..kernels import pll_scan
from .scanops import ema

PI_F = float(np.float32(np.pi))
TWO_PI_F = float(np.float32(2.0 * np.pi))


def _floor_mod(x: torch.Tensor, y: float | torch.Tensor) -> torch.Tensor:
    """jnp.mod(x, y) for y > 0: the exact fmod, moved into [0, y)."""
    r = torch.fmod(x, y)
    return torch.where(r < 0.0, r + y, r)


def _phase_error(xr: torch.Tensor, xi: torch.Tensor, c: torch.Tensor, s: torch.Tensor):
    """arg(x · conj(e^{jθ})) from x's parts and (cos θ, sin θ)."""
    return torch.atan2(xi * c - xr * s, xr * c + xi * s)


def _columns(x: torch.Tensor) -> list[torch.Tensor]:
    return list(x.t().contiguous().unbind(0))


# -- plain versions of K-PLL's entry points (x (C, T), state (S, C)) --------

def pll_plain(x: torch.Tensor, state: torch.Tensor, g1: float, g2: float):
    """The 2nd-order loop in split form. Returns (carrier, state').

    arg(x · conj(e^{jθ})) = wrap(arg x − θ) for x ≠ 0, so arg x is taken
    for the whole block before the loop and the carrier e^{jθ[n]} from the
    stacked pre-update phases after it; the loop keeps only the subtract,
    the wrap, the update and the floor-mod. An exact-zero sample takes the
    rotated product's detector instead: the signs of its zero products make
    that 0 or ±π, not −θ, as in JAX's scan. The constants are 0-dim f32
    tensors: the same values as Python floats, at half the dispatch cost."""
    phase, freq = state.unbind(0)
    pi, neg_pi, two_pi, g1, g2 = (torch.tensor(v, dtype=torch.float32, device=x.device)
                                  for v in (PI_F, -PI_F, TWO_PI_F, g1, g2))
    theta_x = _columns(torch.atan2(x.imag, x.real))
    zero = (x.real == 0.0) & (x.imag == 0.0)
    zero_at = zero.any(0).tolist()
    phases = []
    for i, tx in enumerate(theta_x):
        phases.append(phase)
        err = tx - phase
        err = torch.where(err > pi, err - two_pi, torch.where(err < neg_pi, err + two_pi, err))
        if zero_at[i]:
            rotated = _phase_error(x.real[:, i], x.imag[:, i], torch.cos(phase), torch.sin(phase))
            err = torch.where(zero[:, i], rotated, err)
        freq = freq + g2 * err
        phase = phase + freq + g1 * err
        phase = _floor_mod(phase + pi, two_pi) - pi
    theta = torch.stack(phases, -1)
    return torch.complex(torch.cos(theta), torch.sin(theta)), torch.stack([phase, freq])


def ref_pll_plain(x: torch.Tensor, state: torch.Tensor, coeffs: tuple[float, ...]):
    """PhaseLockComplex's biquad loop, sample by sample: the carrier is
    emitted before the update. Returns (carrier, state')."""
    b0, b1, b2, a1, a2 = coeffs
    v0, v1, v2, phi = state.unbind(0)
    cs, ss = [], []
    for xr, xi in zip(_columns(x.real), _columns(x.imag)):
        c, s = torch.cos(phi), torch.sin(phi)
        cs.append(c)
        ss.append(s)
        dphi = _phase_error(xr, xi, c, s)
        v2n, v1n = v1, v0
        v0n = dphi - v1n * a1 - v2n * a2
        phin = v0n * b0 + v1n * b1 + v2n * b2
        over, under = phin > TWO_PI_F, phin < -TWO_PI_F
        safe = torch.where(phin == 0.0, 1.0, phin)
        scale = torch.where(over, (phin - TWO_PI_F) / safe,
                            torch.where(under, (phin + TWO_PI_F) / safe, 1.0))
        phi = torch.where(over, phin - TWO_PI_F, torch.where(under, phin + TWO_PI_F, phin))
        v0, v1, v2 = v0n * scale, v1n * scale, v2n * scale
    return (torch.complex(torch.stack(cs, -1), torch.stack(ss, -1)),
            torch.stack([v0, v1, v2, phi]))


_F999, _F001 = float(np.float32(0.999)), float(np.float32(0.001))


def pilot_pll_plain(x: torch.Tensor, state: torch.Tensor, coeffs: tuple[float, ...]):
    """The 19 kHz pilot loop, sample by sample. Returns (pre-update
    phases, state')."""
    pb0, pa1, pa2, lf_b0, lf_b1, w_lo, w_hi = coeffs
    phase, freq, i1, i2, q1, q2, x1, lock = state.unbind(0)
    phases = []
    for xi in _columns(x):
        phases.append(phase)
        ps, pc = torch.sin(phase), torch.cos(phase)
        fi = pb0 * (ps * xi) - pa1 * i1 - pa2 * i2
        fq = pb0 * (pc * xi) - pa1 * q1 - pa2 * q2
        i2, i1, q2, q1 = i1, fi, q1, fq
        err = torch.where(fi > torch.abs(fq), fq / torch.clamp(fi, min=1e-20),
                          torch.where(fq > 0.0, 1.0, -1.0))
        lock = _F999 * lock + _F001 * fi
        freq = torch.clamp(freq + lf_b0 * err + lf_b1 * x1, w_lo, w_hi)
        x1 = err
        phase = _floor_mod(phase + freq, TWO_PI_F)
    return torch.stack(phases, -1), torch.stack([phase, freq, i1, i2, q1, q2, x1, lock])


def _run(kernel: Callable, plain: Callable, x: torch.Tensor, fields: tuple, *args):
    """One loop over x (..., T) from the state fields (each (...,)): K-PLL on
    the card, the plain version on the CPU. Returns (out (..., T), new
    fields)."""
    batch = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    state = torch.stack([f.reshape(-1).to(torch.float32) for f in fields]).contiguous()
    if x.device.type == "cpu":
        out, state = plain(x2, state, *args)
    else:  # the kernel updates its private copy of the state in place
        out = kernel(x2, state, *args)
    return out.reshape(*batch, x.shape[-1]), tuple(s.reshape(batch) for s in state.unbind(0))


class PLLState(NamedTuple):
    phase: torch.Tensor  # (...,) f32 radians
    freq: torch.Tensor  # (...,) f32 radians/sample


def make_pll(device: torch.device, batch_shape=()) -> PLLState:
    z = torch.zeros(batch_shape, dtype=torch.float32, device=device)
    return PLLState(z, z.clone())


def pll_gains(sample_rate: float, loop_bw_hz: float = 100.0, damping: float = 0.707
              ) -> tuple[float, float]:
    """(g1, g2) of the 2nd-order loop (PhaseLockComplex's
    computeCoefficients semantics): ω_n = 2π·bw/fs, g1 = 2ζω_n, g2 = ω_n²,
    designed in float64, float32 values."""
    wn = 2.0 * np.pi * loop_bw_hz / sample_rate
    return float(np.float32(2.0 * damping * wn)), float(np.float32(wn * wn))


def pll_run(
    state: PLLState, x: torch.Tensor, sample_rate: float, loop_bw_hz: float = 100.0,
    damping: float = 0.707,
) -> tuple[PLLState, torch.Tensor]:
    """Track the dominant carrier of x (..., T) complex64 with the standard
    2nd-order loop (`pll_gains`); returns e^{jθ[n]} per sample."""
    out, fields = _run(pll_scan.pll_run, pll_plain, x, tuple(state),
                       *pll_gains(sample_rate, loop_bw_hz, damping))
    return PLLState(*fields), out


class RefPLLState(NamedTuple):
    """PhaseLockComplex's biquad registers (phaselockcomplex.cpp reset())."""

    v0: torch.Tensor  # (...,) f32 lower register
    v1: torch.Tensor
    v2: torch.Tensor
    phi: torch.Tensor  # (...,) f32 phiHat


def make_ref_pll(device: torch.device, batch_shape=()) -> RefPLLState:
    return RefPLLState(*(torch.zeros(batch_shape, dtype=torch.float32, device=device)
                         for _ in range(4)))


def ref_pll_coeffs(wn: float = 0.05, zeta: float = 0.707, loop_gain: float = 1000.0
                   ) -> tuple[float, ...]:
    """(b0, b1, b2, a1, a2) of PhaseLockComplex::computeCoefficients, float32."""
    t1 = loop_gain / (wn * wn)
    t2 = 2.0 * zeta / wn - 1.0 / loop_gain
    a0 = 1.0 + t1 / 2.0
    return tuple(float(np.float32(v)) for v in (
        2.0 * loop_gain * (1.0 + t2 / 2.0) / a0, 2.0 * loop_gain * 2.0 / a0,
        2.0 * loop_gain * (1.0 - t2 / 2.0) / a0, -t1 / a0, (-1.0 + t1 / 2.0) / a0))


def ref_pll_run(
    state: RefPLLState, x: torch.Tensor, wn: float = 0.05, zeta: float = 0.707,
    loop_gain: float = 1000.0,
) -> tuple[RefPLLState, torch.Tensor]:
    """The reference's PhaseLockComplex::feed (phaselockcomplex.cpp:55-160),
    the test-only parity mode of synchronous AM: per sample the carrier
    e^{j·phiHat[n−1]} is emitted first, then the phase error drives the
    active-PI biquad (amdemod.cpp:86 constants) with the ±2π register
    rescaling."""
    out, fields = _run(pll_scan.ref_pll_run, ref_pll_plain, x, tuple(state),
                       ref_pll_coeffs(wn, zeta, loop_gain))
    return RefPLLState(*fields), out


class PilotPLLState(NamedTuple):
    phase: torch.Tensor
    freq: torch.Tensor  # radians/sample
    phasor_i1: torch.Tensor  # 2-pole phasor lowpass delay line (I)
    phasor_i2: torch.Tensor
    phasor_q1: torch.Tensor  # … (Q)
    phasor_q2: torch.Tensor
    loop_x1: torch.Tensor  # loop-filter previous phase error
    lock_avg: torch.Tensor  # smoothed pilot level (filtered I)


def make_pilot_pll(freq_hz: float, sample_rate: float, device: torch.device,
                   batch_shape=()) -> PilotPLLState:
    w0 = float(np.float32(2.0 * np.pi * freq_hz / sample_rate))
    z = lambda: torch.zeros(batch_shape, dtype=torch.float32, device=device)
    return PilotPLLState(z(), torch.full(batch_shape, w0, dtype=torch.float32, device=device),
                         *(z() for _ in range(6)))


def pilot_pll_coeffs(freq_hz: float, sample_rate: float, bandwidth_hz: float = 50.0
                     ) -> tuple[float, ...]:
    """(pb0, pa1, pa2, lf_b0, lf_b1, w_lo, w_hi) of the pilot loop
    (phaselock.cpp:24-90), designed in float64, float32 values."""
    bw = bandwidth_hz / sample_rate
    p1 = np.exp(-1.146 * bw * 2.0 * np.pi)
    p2 = np.exp(-5.331 * bw * 2.0 * np.pi)
    q1 = np.exp(-0.1153 * bw * 2.0 * np.pi)
    return tuple(float(np.float32(v)) for v in (
        1.0 - (p1 + p2) + p1 * p2, -(p1 + p2), p1 * p2,
        0.62 * bw * 2.0 * np.pi, -0.62 * bw * 2.0 * np.pi * q1,
        2.0 * np.pi * (freq_hz - bandwidth_hz) / sample_rate,
        2.0 * np.pi * (freq_hz + bandwidth_hz) / sample_rate))


def pilot_pll_run(
    state: PilotPLLState, x: torch.Tensor, freq_hz: float, sample_rate: float,
    bandwidth_hz: float = 50.0,
) -> tuple[PilotPLLState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's type-2 4th-order pilot loop (PhaseLock ctor + process,
    phaselock.cpp:24-230) over a real MPX x (..., T) float32. Returns
    (state', cos θ, cos 2θ, cos 3θ), the references locked to the pilot and
    its 38 and 57 kHz harmonics; state.lock_avg is the lock level."""
    phases, fields = _run(pll_scan.pilot_pll_run, pilot_pll_plain, x.to(torch.float32),
                          tuple(state), pilot_pll_coeffs(freq_hz, sample_rate, bandwidth_hz))
    # the detector locks sin θ onto the pilot; shifted by π/2, a pilot
    # A·cos(ω₀t + φ) gives cos(k·(ω₀t + φ)) directly
    phases = phases - float(np.float32(np.pi / 2.0))
    return (PilotPLLState(*fields), torch.cos(phases), torch.cos(2.0 * phases),
            torch.cos(3.0 * phases))


class FLLState(NamedTuple):
    phi: torch.Tensor  # (...,) oscillator phase
    fhat: torch.Tensor  # (...,) smoothed instantaneous frequency (rad/sample)
    phi_x1: torch.Tensor  # (...,) previous input phase (delta-arg carry)


def make_fll(device: torch.device, batch_shape=()) -> FLLState:
    return FLLState(*(torch.zeros(batch_shape, dtype=torch.float32, device=device)
                      for _ in range(3)))


def fll_run(state: FLLState, x: torch.Tensor, sample_rate: float
            ) -> tuple[FLLState, torch.Tensor, torch.Tensor]:
    """FreqLockComplex::feed (freqlockcomplex.cpp:64-80), block-parallel: the
    wrapped delta-arg of the input, smoothed by the one-pole EMA
    (α = 10/fs), integrated into the oscillator phase by a prefix sum.
    x (..., T) complex64. Returns (state', e^{jφ[n]}, f̂[n] rad/sample)."""
    phix = torch.atan2(x.imag, x.real)
    prev = torch.cat([state.phi_x1[..., None], phix[..., :-1]], dim=-1)
    ef = _floor_mod(phix - prev + PI_F, TWO_PI_F) - PI_F
    fhat = ema(ef, 10.0 / float(sample_rate), state.fhat)
    phi = state.phi[..., None] + torch.cumsum(fhat, dim=-1)
    y = torch.polar(torch.ones_like(phi), phi)
    return (FLLState(_floor_mod(phi[..., -1], TWO_PI_F), fhat[..., -1].clone(),
                     phix[..., -1].clone()), y, fhat)
