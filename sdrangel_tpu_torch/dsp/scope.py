"""Scope projections (sdrbase/dsp/projector.h:25-31), headless."""

from __future__ import annotations

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
