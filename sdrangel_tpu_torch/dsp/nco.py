"""Numerically-controlled oscillator on a 32-bit phase wheel.

Reference: sdrbase/dsp/nco.{h,cpp} — integer phase accumulator, nextIQ()
returning e^{+iφ}. The phase is held in int64 and masked to 32 bits after
every add and multiply, which is exact uint32 wraparound; the wrapped phase
is cast to float32 before the sin/cos, as in the JAX package.

Increments come two ways, as in the JAX package: `freq_to_increment` on the
host in float64 for a configured offset, and `freq_to_increment_traced` in
float32 on the tensors' own device for per-block overrides (one per channel
of a bank), so an override never waits for the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_WHEEL_BITS = 32
_MASK = (1 << _WHEEL_BITS) - 1


class NCOState(NamedTuple):
    phase: torch.Tensor  # (...,) int64 in [0, 2^32) — the wheel position


def make_nco(device: torch.device, batch_shape=()) -> NCOState:
    return NCOState(torch.zeros(batch_shape, dtype=torch.int64, device=device))


def freq_to_increment(freq, sample_rate) -> np.ndarray:
    """Per-sample uint32 phase increment for f/fs (host side, float64)."""
    turns = np.asarray(freq, dtype=np.float64) / np.asarray(sample_rate, dtype=np.float64)
    inc = np.round((turns % 1.0) * (1 << _WHEEL_BITS)).astype(np.int64)
    return (inc & _MASK).astype(np.uint32)


def freq_to_increment_ref_quant(freq, sample_rate) -> np.ndarray:
    """The reference NCO's tuning grid (nco.cpp:48-52): the 4096-entry
    LUT's increment (freq·4096)/fs truncated toward zero, so an offset lands
    on a multiple of fs/4096 (5000 Hz at 96 kHz mixes 4992.1875 Hz). As
    whole LUT steps on the 2^32 wheel, the wheel visits the reference's
    LUT indices exactly. A test-only parity mode (AM's `ref_nco_quant`)."""
    steps = np.trunc(
        np.asarray(freq, np.float64) * 4096.0 / np.asarray(sample_rate, np.float64)
    ).astype(np.int64)
    return ((steps << (_WHEEL_BITS - 12)) & _MASK).astype(np.uint32)


def freq_to_increment_traced(freq: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """The JAX `nco.freq_to_increment_traced` (nco.py:58-62) on tensors, as
    it runs inside jit — which is how every JAX caller runs it: XLA turns the
    division by the constant rate into a product with its f32 reciprocal, so
    turns = remainder(f · f32(1/fs), 1) in f32, times 2^32, truncated to a
    uint32 value held in int64. A tiny negative offset's f32 remainder
    rounds to 1.0; 2^32 then saturates to 2^32 − 1 as JAX's uint32
    conversion does on the CPU."""
    recip = float(np.float32(1.0) / np.float32(sample_rate))
    turns = torch.remainder(freq.to(torch.float32) * recip, 1.0)
    inc = (turns * float(1 << _WHEEL_BITS)).to(torch.int64)
    return torch.clamp(inc, max=_MASK)


def channel_increment(offset_hz, input_offset: float, channel_rate: float,
                      device: torch.device, host=freq_to_increment):
    """The increment that mixes a channel down by its offset: the configured
    `input_offset` through `host` (float64 on the host), or a per-block
    override `offset_hz` (a number, or a tensor of the batch shape) as the
    f32 increment on `device`, as the JAX demods' traced path does."""
    if offset_hz is None:
        return host(-input_offset, channel_rate)
    offset = torch.as_tensor(offset_hz, dtype=torch.float32, device=device)
    return freq_to_increment_traced(-offset, channel_rate)


def nco_block(
    state: NCOState, increment, length: int
) -> tuple[NCOState, torch.Tensor]:
    """e^{+iφ[n]} for one block, φ[n] = φ0 + inc·(n+1): the reference NCO
    increments before it reads (nco.cpp nextIQ -> nextPhase).

    increment: uint32 value(s) — host integers, or an int64 tensor (any
    batch shape, e.g. from `freq_to_increment_traced`) — broadcast against
    state.phase. Returns (state', iq (..., length) complex64).
    """
    dev = state.phase.device
    if isinstance(increment, torch.Tensor):
        inc = increment.to(device=dev, dtype=torch.int64) & _MASK
    else:
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


# -- LUT parity mode: the reference's quantized oscillator, bit for bit ----

TABLE_SIZE = 4096  # nco.h: the reference's cos table
_LUT = np.cos(2.0 * np.pi * np.arange(TABLE_SIZE) / TABLE_SIZE).astype(np.float32)


class NCOLutState(NamedTuple):
    phase: torch.Tensor  # (...,) int64 in [0, TABLE_SIZE)


def make_nco_lut(device: torch.device, batch_shape=(), phase0: int = 0) -> NCOLutState:
    return NCOLutState(torch.full(batch_shape, phase0, dtype=torch.int64, device=device))


def lut_increment(freq: float, sample_rate: float) -> int:
    """Integer truncation as in NCO::setFreq (nco.cpp:48-52)."""
    return int((freq * TABLE_SIZE) / sample_rate)


def nco_lut_block(
    state: NCOLutState, increment: int, length: int
) -> tuple[NCOLutState, torch.Tensor]:
    """The reference oscillator: it steps, then reads (nextPhase before the
    table lookup, nco.h:45-55), cos from the 4096-entry table. The JAX
    function's int32 increment·n wraps; TABLE_SIZE divides 2^32, so the
    int64 product reduced mod TABLE_SIZE lands on the same table entries."""
    dev = state.phase.device
    n = torch.arange(1, length + 1, dtype=torch.int64, device=dev)
    phases = torch.remainder(state.phase[..., None] + increment * n, TABLE_SIZE)
    lut = torch.from_numpy(_LUT).to(dev)
    re = lut[phases]
    im = -lut[torch.remainder(phases + TABLE_SIZE // 4, TABLE_SIZE)]
    new_phase = torch.remainder(state.phase + increment * length, TABLE_SIZE)
    return NCOLutState(new_phase), torch.complex(re, im)
