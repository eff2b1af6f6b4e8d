"""Squelch gate with delay-line semantics (nfmdemod.cpp:178-240): a counter
ramps up while the open condition holds (clamped at 2·gate) and down
otherwise (clamped at 0); the channel is open while count > gate, and audio
is read `gate` samples back from a delay line written with the (zeroed when
closed) demod, so the gate's attack chops the leading edge."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .scanops import saturating_counter


class SquelchState(NamedTuple):
    count: torch.Tensor  # (...,) saturating counter
    delay: torch.Tensor  # (..., gate) delayed audio tail


def make_state(gate: int, device: torch.device, batch_shape=()) -> SquelchState:
    return SquelchState(
        torch.zeros(batch_shape, dtype=torch.float32, device=device),
        torch.zeros((*batch_shape, gate), dtype=torch.float32, device=device),
    )


def gate_block(
    state: SquelchState, audio: torch.Tensor, open_cond: torch.Tensor, gate: int,
) -> tuple[SquelchState, torch.Tensor, torch.Tensor]:
    """audio (..., T) float32; open_cond (..., T) bool.
    Returns (state', gated audio delayed by `gate`, squelch-open mask)."""
    deltas = torch.where(open_cond, 1.0, -1.0)
    counts = saturating_counter(deltas, 0.0, 2.0 * gate, state.count)
    is_open = counts > gate
    written = torch.where(open_cond, audio, 0.0)
    ext = torch.cat([state.delay, written], dim=-1)
    gated = torch.where(is_open, ext[..., : audio.shape[-1]], 0.0)
    return SquelchState(counts[..., -1].clone(), ext[..., audio.shape[-1]:].clone()), gated, is_open
