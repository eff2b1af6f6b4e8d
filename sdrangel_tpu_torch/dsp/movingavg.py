"""Windowed moving average with a block-boundary carry
(sdrbase/util/movingaverage.h): the exact N-sample mean, not an EMA. The
carry is the previous N inputs, so the result does not drift with the
block's running sum.

Two forms, chosen by the window length. A short window (the NFM squelch's
32) sums each window in float32. A long one (the AM volume normaliser's
4800, the SSB MagAGC's 6144) would cost T·N adds that way, so it differences
a float64 cumulative sum: O(T), and within float32 rounding of the exact
mean, where the JAX package's float32 cumulative sum drifts with the
block's running total (ROADMAP.md §3, "Long moving averages")."""

from __future__ import annotations

from typing import NamedTuple

import torch

#: windows longer than this take the cumulative-sum form
LONG_WINDOW = 64


class MovingAvgState(NamedTuple):
    window: torch.Tensor  # (..., N) last N inputs, oldest first


def make_state(length: int, device: torch.device, batch_shape=(), fill: float = 0.0
               ) -> MovingAvgState:
    return MovingAvgState(
        torch.full((*batch_shape, length), fill, dtype=torch.float32, device=device))


def moving_average(
    state: MovingAvgState, x: torch.Tensor
) -> tuple[MovingAvgState, torch.Tensor]:
    """avg[t] = mean of the N samples ending at x[t] (through the carry).
    x (..., T) float32. Returns (state', avg (..., T))."""
    n = state.window.shape[-1]
    ext = torch.cat([state.window, x], dim=-1)
    if n <= LONG_WINDOW:
        avg = ext[..., 1:].unfold(-1, n, 1).sum(-1) / n
    else:
        c = torch.cumsum(ext.to(torch.float64), dim=-1)
        avg = ((c[..., n:] - c[..., :-n]) / n).to(torch.float32)
    return MovingAvgState(ext[..., x.shape[-1]:].clone()), avg
