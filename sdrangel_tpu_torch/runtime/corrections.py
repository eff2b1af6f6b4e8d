"""Automatic DC offset and IQ imbalance correction
(DSPDeviceSourceEngine::iqCorrections, dspdevicesourceengine.cpp:175-250).

Per-block statistics fold into cross-block EMAs carried in state; a block is
corrected with the estimates entering it (one block of lag).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CorrectionsState(NamedTuple):
    dc: torch.Tensor  # () complex64 DC estimate
    phi: torch.Tensor  # () float32 phase-imbalance estimate
    amp: torch.Tensor  # () float32 amplitude-ratio estimate


def make_state(device: torch.device) -> CorrectionsState:
    return CorrectionsState(
        torch.zeros((), dtype=torch.complex64, device=device),
        torch.zeros((), dtype=torch.float32, device=device),
        torch.ones((), dtype=torch.float32, device=device),
    )


def apply(
    state: CorrectionsState, x: torch.Tensor, dc_correction: bool, iq_correction: bool,
    alpha: float = 0.1,
) -> tuple[CorrectionsState, torch.Tensor]:
    if not dc_correction and not iq_correction:
        return state, x
    dc_new = (1 - alpha) * state.dc + alpha * torch.mean(x)
    y = x - state.dc if dc_correction else x
    phi, amp = state.phi, state.amp
    if iq_correction:
        i, q = y.real, y.imag
        ii = torch.mean(i * i)
        iq = torch.mean(i * q)
        phi = (1 - alpha) * state.phi + alpha * (iq / torch.clamp(ii, min=1e-30))
        i2 = i - state.phi * q
        ii2 = torch.mean(i2 * i2)
        qq2 = torch.mean(q * q)
        amp = (1 - alpha) * state.amp + alpha * torch.sqrt(
            torch.clamp(ii2, min=1e-30) / torch.clamp(qq2, min=1e-30))
        y = torch.complex(i2, q * state.amp)
    return CorrectionsState(dc_new, phi, amp), y
