"""Numerically-controlled oscillator on a 32-bit phase wheel.

Reference: sdrbase/dsp/nco.{h,cpp} — integer phase accumulator, nextIQ()
returning e^{+iφ}. The phase is held in int64 and masked to 32 bits after
every add and multiply, which is exact uint32 wraparound; the wrapped phase
is cast to float32 before the sin/cos, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_WHEEL_BITS = 32
_MASK = (1 << _WHEEL_BITS) - 1


class NCOState(NamedTuple):
    phase: torch.Tensor  # (...,) int64 in [0, 2^32) — the wheel position


def make_nco(device: torch.device) -> NCOState:
    return NCOState(torch.zeros((), dtype=torch.int64, device=device))


def freq_to_increment(freq, sample_rate) -> np.ndarray:
    """Per-sample uint32 phase increment for f/fs (host side, float64)."""
    turns = np.asarray(freq, dtype=np.float64) / np.asarray(sample_rate, dtype=np.float64)
    inc = np.round((turns % 1.0) * (1 << _WHEEL_BITS)).astype(np.int64)
    return (inc & _MASK).astype(np.uint32)


def nco_block(
    state: NCOState, increment, length: int
) -> tuple[NCOState, torch.Tensor]:
    """e^{+iφ[n]} for one block, φ[n] = φ0 + inc·(n+1): the reference NCO
    increments before it reads (nco.cpp nextIQ -> nextPhase).

    increment: uint32 value(s) broadcast against state.phase.
    Returns (state', iq (..., length) complex64).
    """
    dev = state.phase.device
    inc = torch.as_tensor(np.asarray(increment, dtype=np.int64), device=dev)
    n = torch.arange(1, length + 1, dtype=torch.int64, device=dev)
    phase = (state.phase[..., None] + ((inc[..., None] * n) & _MASK)) & _MASK
    ang = phase.to(torch.float32) * np.float32(2.0 * np.pi / (1 << _WHEEL_BITS))
    iq = torch.polar(torch.ones_like(ang), ang)
    new_phase = (state.phase + ((inc * length) & _MASK)) & _MASK
    return NCOState(new_phase), iq


def mix_block(
    state: NCOState, x: torch.Tensor, increment
) -> tuple[NCOState, torch.Tensor]:
    """x · e^{+iφ[n]} — the `c *= m_nco.nextIQ()` idiom (nfmdemod.cpp:153)."""
    state, iq = nco_block(state, increment, x.shape[-1])
    return state, x * iq
