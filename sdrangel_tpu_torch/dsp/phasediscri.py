"""FM phase discriminator (sdrbase/dsp/phasediscri.h phaseDiscriminatorDelta,
:61-78): atan2 phase per sample, differentiated with ±2π wrap, so deviation
in units of the sample rate maps to ±1, times fmScaling. The carry is the
previous block's last sample; it starts at 1+0j, which pins the reference's
uninitialized previous argument to 0."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DiscriminatorState(NamedTuple):
    prev: torch.Tensor  # (...,) complex64 — previous sample


def make_state(device: torch.device) -> DiscriminatorState:
    return DiscriminatorState(torch.ones((), dtype=torch.complex64, device=device))


# float32 constants of the reference, as Python floats holding the f32 values
_PI_F = float(np.float32(3.14159265))  # PI_FLOAT (phasediscri.h:169)
_PIBY2_F = float(np.float32(1.5707963))  # PIBY2_FLOAT (phasediscri.h:170)
_K = float(np.float32(0.28))


def atan2_approx2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The reference's atan2_approximation2 (phasediscri.h:172-197),
    |error| < 0.005 rad — the test-only parity mode."""
    zero = torch.zeros((), dtype=torch.float32, device=y.device)
    x_safe = torch.where(x == 0.0, 1.0, x)
    z = y / x_safe
    small = torch.abs(z) < 1.0
    z_small = torch.where(small, z, zero)
    z_big = torch.where(small, 2.0, z)  # keeps z·z + 0.28 benign
    atan_small = z_small / (1.0 + _K * z_small * z_small)
    atan_small = atan_small + torch.where(
        x < 0.0, torch.where(y < 0.0, -_PI_F, _PI_F), zero)
    atan_big = _PIBY2_F - z_big / (z_big * z_big + _K)
    atan_big = atan_big - torch.where(y < 0.0, _PI_F, zero)
    res = torch.where(small, atan_small, atan_big)
    on_axis = torch.where(y > 0.0, _PIBY2_F, torch.where(y == 0.0, zero, -_PIBY2_F))
    return torch.where(x == 0.0, on_axis, res)


def discriminator_delta(
    state: DiscriminatorState, x: torch.Tensor, fm_scaling: float, approx: bool = False,
) -> tuple[DiscriminatorState, torch.Tensor, torch.Tensor]:
    """out = wrap(Δ atan2)/π · fmScaling. x (..., T) complex64.
    Returns (state', demod, magsq), both (..., T) float32. approx=True uses
    the reference's atan2_approximation2 instead of the exact atan2."""
    at2 = atan2_approx2 if approx else torch.atan2
    ext = torch.cat([state.prev[..., None], x], dim=-1)
    args = at2(ext.imag, ext.real)
    dev = torch.diff(args, dim=-1) / float(np.float32(np.pi))
    dev = torch.where(dev < -1.0, dev + 2.0, dev)
    dev = torch.where(dev > 1.0, dev - 2.0, dev)
    magsq = x.real ** 2 + x.imag ** 2
    return DiscriminatorState(x[..., -1].clone()), dev * fm_scaling, magsq
