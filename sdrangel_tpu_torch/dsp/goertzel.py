"""Goertzel tone detectors as matrix products: the CTCSS bank and the AF
squelch.

Reference: sdrbase/dsp/ctcssdetector.cpp runs u0 = in + coef·u0 − u1 per
sample over N-sample frames and takes u0² + u1² − coef·u0·u1 at the frame
end, which equals |Σ_n x[n] e^{−jωn}|². That power is computed here directly
as two products of the framed input with cos/sin bases, the whole tone bank
in one (N × J) contraction per frame. sdrbase/dsp/afsquelch.cpp is the same
detector over two test tones with a moving average of frame powers and an
attack/decay counter.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .scanops import saturating_counter

# The 32 EIA standard CTCSS tones (ctcssdetector.cpp:29-61).
CTCSS_TONES = np.array(
    [
        67.0, 71.9, 74.4, 77.0, 79.7, 82.5, 85.4, 88.5,
        91.5, 94.8, 97.4, 100.0, 103.5, 107.2, 110.9, 114.8,
        118.8, 123.0, 127.3, 131.8, 136.5, 141.3, 146.2, 151.4,
        156.7, 162.2, 167.9, 173.8, 179.9, 186.2, 192.8, 203.5,
    ],
    dtype=np.float64,
)


@functools.lru_cache(maxsize=16)
def _basis(tones: tuple, fs: float, n: int, device: torch.device) -> torch.Tensor:
    """(N, 2J) float32 [cos | sin] bases of the tones, designed in float64."""
    w = 2.0 * np.pi * np.asarray(tones, dtype=np.float64) / fs
    t = np.arange(n, dtype=np.float64)[:, None] * w[None, :]
    return torch.from_numpy(
        np.concatenate([np.cos(t), np.sin(t)], axis=1).astype(np.float32)).to(device)


def goertzel_power(x_frames: torch.Tensor, tones, fs: float) -> torch.Tensor:
    """Per-frame, per-tone Goertzel power. x_frames (..., F, N) float32;
    returns (..., F, J), the reference's u0²+u1²−coef·u0·u1 at frame ends."""
    tones = tuple(float(f) for f in tones)
    cs = x_frames @ _basis(tones, float(fs), x_frames.shape[-1], x_frames.device)
    c, s = cs[..., :len(tones)], cs[..., len(tones):]
    return c * c + s * s


class CtcssResult(NamedTuple):
    detected: torch.Tensor  # (..., F) bool
    tone_index: torch.Tensor  # (..., F) int32 argmax tone


def ctcss_detect(x_frames: torch.Tensor, fs: float) -> CtcssResult:
    """CTCSSDetector::evaluatePower (ctcssdetector.cpp:190-210): detected
    when the strongest tone's power exceeds the bank's mean power + 2.0."""
    p = goertzel_power(x_frames, CTCSS_TONES, fs)
    max_p, idx = torch.max(p, dim=-1)
    return CtcssResult(max_p > p.mean(dim=-1) + 2.0, idx.to(torch.int32))


class AFSquelchState(NamedTuple):
    """Carried across blocks: the moving-average window of per-tone frame
    powers and the attack/decay counter with the open flag
    (afsquelch.cpp:200-240)."""

    avg_window: torch.Tensor  # (..., nb_avg, J) recent frame powers
    squelch_count: torch.Tensor  # (...,) float32
    is_open: torch.Tensor  # (...,) bool


def make_af_squelch(device: torch.device, nb_avg: int = 128, n_tones: int = 2,
                    batch_shape=()) -> AFSquelchState:
    return AFSquelchState(
        torch.zeros((*batch_shape, nb_avg, n_tones), dtype=torch.float32, device=device),
        torch.zeros(batch_shape, dtype=torch.float32, device=device),
        torch.zeros(batch_shape, dtype=torch.bool, device=device),
    )


def af_squelch_run(
    state: AFSquelchState, x_frames: torch.Tensor, fs: float, threshold: float,
    samples_attack: int, samples_decay: int, tones=(1000.0, 6000.0),
) -> tuple[AFSquelchState, torch.Tensor]:
    """The AF squelch over framed audio (..., F, N). A frame opens when the
    higher tone's averaged power is the weaker one and min/max < threshold
    (afsquelch.cpp:218-236); attack and decay through the saturating counter.
    Returns (state', open (..., F) bool)."""
    p = goertzel_power(x_frames, tones, fs)  # (..., F, J)
    nb_avg = state.avg_window.shape[-2]
    f = p.shape[-2]
    ext = torch.cat([state.avg_window, p], dim=-2)
    c = torch.cumsum(ext, dim=-2)
    c = torch.cat([torch.zeros_like(c[..., :1, :]), c], dim=-2)
    sums = c[..., nb_avg + 1:, :] - c[..., 1:f + 1, :]  # (..., F, J) windowed sums
    max_p, max_idx = torch.max(sums, dim=-1)
    min_p, min_idx = torch.min(sums, dim=-1)
    open_cond = (min_p / torch.clamp(max_p, min=1e-30) < threshold) & (min_idx > max_idx)
    counts = saturating_counter(torch.where(open_cond, 1.0, -1.0), 0.0,
                                float(samples_attack + samples_decay), state.squelch_count)
    is_open = counts >= samples_attack
    return (AFSquelchState(ext[..., f:, :].clone(), counts[..., -1].clone(),
                           is_open[..., -1].clone()), is_open)
