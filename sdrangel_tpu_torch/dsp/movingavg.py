"""Windowed moving average with a block-boundary carry
(sdrbase/util/movingaverage.h): the exact N-sample mean, not an EMA. The
carry is the previous N inputs; each output sums its own window, so the
result does not drift with the block's running sum."""

from __future__ import annotations

from typing import NamedTuple

import torch


class MovingAvgState(NamedTuple):
    window: torch.Tensor  # (..., N) last N inputs, oldest first


def make_state(length: int, device: torch.device) -> MovingAvgState:
    return MovingAvgState(torch.zeros(length, dtype=torch.float32, device=device))


def moving_average(
    state: MovingAvgState, x: torch.Tensor
) -> tuple[MovingAvgState, torch.Tensor]:
    """avg[t] = mean of the N samples ending at x[t] (through the carry).
    x (..., T) float32. Returns (state', avg (..., T))."""
    n = state.window.shape[-1]
    ext = torch.cat([state.window, x], dim=-1)
    sums = ext[..., 1:].unfold(-1, n, 1).sum(-1)
    return MovingAvgState(ext[..., x.shape[-1]:].clone()), sums / n
