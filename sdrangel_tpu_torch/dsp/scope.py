"""Scope ops, headless: the projections (sdrbase/dsp/projector.h:25-31)
and the triggers (sdrgui/dsp/scopevisng.h:516-534: a projection with a
level, an edge and a holdoff)."""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class Projection(enum.Enum):
    REAL = "real"
    IMAG = "imag"
    MAG_LIN = "maglin"
    MAG_SQ = "magsq"
    MAG_DB = "magdb"
    PHASE = "phase"
    DPHASE = "dphase"


def project(x: torch.Tensor, kind: Projection) -> torch.Tensor:
    """x (..., T) complex64 -> (..., T) float32 trace."""
    if kind is Projection.REAL:
        return x.real.clone()
    if kind is Projection.IMAG:
        return x.imag.clone()
    magsq = x.real ** 2 + x.imag ** 2
    if kind is Projection.MAG_SQ:
        return magsq
    if kind is Projection.MAG_LIN:
        return torch.sqrt(magsq)
    if kind is Projection.MAG_DB:
        return 10.0 * torch.log10(torch.clamp(magsq, min=1e-30))
    phase = torch.atan2(x.imag, x.real) / float(np.float32(np.pi))
    if kind is Projection.PHASE:
        return phase
    if kind is Projection.DPHASE:
        d = torch.diff(phase, dim=-1, prepend=phase[..., :1])
        d = torch.where(d < -1.0, d + 2.0, d)
        return torch.where(d > 1.0, d - 2.0, d)
    raise ValueError(kind)


@dataclasses.dataclass(frozen=True)
class TriggerCondition:
    projection: Projection = Projection.REAL
    level: float = 0.0
    positive_edge: bool = True
    holdoff: int = 0  # samples the condition must hold


def find_trigger(x: torch.Tensor, cond: TriggerCondition) -> torch.Tensor:
    """The first index (int32, per leading index of x (..., T)) where the
    projected trace crosses `level` on the chosen edge and, with a holdoff,
    stays across it for `holdoff` samples; -1 where the block has none."""
    above = project(x, cond.projection) >= cond.level
    if not cond.positive_edge:
        above = ~above
    prev = torch.cat([torch.zeros_like(above[..., :1]), above[..., :-1]], dim=-1)
    edges = above & ~prev
    if cond.holdoff > 1:
        # all of above[i : i + holdoff], by a windowed count; the JAX
        # function's cumsum form pads to T + 1 and raises on any block
        h, t = cond.holdoff, above.shape[-1]
        runs = torch.zeros_like(above)
        if t >= h:
            runs[..., :t - h + 1] = above.to(torch.int32).unfold(-1, h, 1).sum(-1) >= h
        edges = edges & runs
    idx = torch.argmax(edges.to(torch.int32), dim=-1)
    return torch.where(edges.any(dim=-1), idx, -1).to(torch.int32)


def capture(x: torch.Tensor, cond: TriggerCondition, length: int, pre: int = 0
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """A triggered capture: (trigger index, the `length` samples of x that
    start `pre` samples before the trigger, edge samples repeated past
    either end of the block)."""
    idx = find_trigger(x, cond)
    last = x.shape[-1] - 1
    start = torch.clamp(torch.where(idx < 0, 0, idx - pre), 0, last).to(torch.int64)
    offs = torch.arange(length, device=x.device)
    gather = torch.clamp(start[..., None] + offs, 0, last)
    return idx, torch.gather(x, -1, gather)
