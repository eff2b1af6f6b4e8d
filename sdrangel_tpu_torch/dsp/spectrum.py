"""Spectrum tap — the SpectrumVis math, headless (spectrumvis.cpp:77-200):
windowed fixed-size FFT frames, power re²+im², averaging none / moving /
fixed, display `mult·log2(v) + ofs` (or linear), buckets reordered
negative frequencies first."""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .fftwindow import Function, window


@dataclasses.dataclass(frozen=True, eq=False)
class SpectrumConfig:
    fft_size: int = 1024
    window: Function = Function.HANNING
    averaging_mode: str = "none"  # none | moving | fixed
    averaging_n: int = 16
    linear: bool = False
    positive_only: bool = False
    overlap: int = 0  # refill size = fft_size - overlap

    @functools.cached_property
    def win(self) -> np.ndarray:
        return window(self.window, self.fft_size)

    @property
    def mult(self) -> float:
        return 10.0 / np.log2(10.0)  # dB from log2 power

    @property
    def pow_fft_div(self) -> float:
        return float(self.fft_size * self.fft_size)


class SpectrumState(NamedTuple):
    avg_sum: torch.Tensor  # (fft_size,) running average accumulator
    avg_count: torch.Tensor  # () frames accumulated (fixed mode)


def make_state(cfg: SpectrumConfig, device: torch.device) -> SpectrumState:
    return SpectrumState(
        torch.zeros(cfg.fft_size, dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
    )


@functools.lru_cache(maxsize=None)
def _device_window(cfg: SpectrumConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(cfg.win).to(device)


def _moving_weights(n_frames: int, alpha: float, device: torch.device) -> torch.Tensor:
    """Weights of the closed-form EMA over a block's frames: acc' =
    (1−α)^F·acc + Σ_i α(1−α)^{F−1−i}·p_i, as [(1−α)^F, w_0 … w_{F−1}]."""
    decay = (1.0 - alpha) ** np.arange(n_frames, -1, -1, dtype=np.float64)
    w = np.concatenate([decay[:1], alpha * decay[1:]]).astype(np.float32)
    return torch.from_numpy(w).to(device)


def power_spectrum(
    state: SpectrumState, x: torch.Tensor, cfg: SpectrumConfig
) -> tuple[SpectrumState, torch.Tensor]:
    """x (..., T) complex64, T ≥ fft_size. Returns (state', display spectrum
    (..., fft_size) float32) of the block's last frame after averaging."""
    n = cfg.fft_size
    if cfg.overlap:
        if not 0 < cfg.overlap < n:
            raise ValueError(f"overlap must be in (0, fft_size); got {cfg.overlap}")
        frames = x.unfold(-1, n, n - cfg.overlap)
    else:
        frames = x[..., : (x.shape[-1] // n) * n].reshape(*x.shape[:-1], -1, n)
    spec = torch.fft.fft(frames * _device_window(cfg, x.device), dim=-1)
    p = spec.real ** 2 + spec.imag ** 2

    if cfg.averaging_mode == "moving":
        w = _moving_weights(p.shape[-2], 1.0 / cfg.averaging_n, x.device)
        acc = w[0] * state.avg_sum + torch.einsum("f,...fn->...n", w[1:], p)
        p_disp = acc
        new_state = SpectrumState(acc, state.avg_count)
    elif cfg.averaging_mode == "fixed":
        total = state.avg_sum + p.sum(dim=-2)
        count = state.avg_count + p.shape[-2]
        p_disp = total / torch.clamp(count, min=1).to(torch.float32)
        reset = count >= cfg.averaging_n
        new_state = SpectrumState(
            torch.where(reset, 0.0, total), torch.where(reset, 0, count).to(torch.int32))
    else:
        p_disp = p[..., -1, :]
        new_state = state

    if cfg.linear:
        v = p_disp / cfg.pow_fft_div
    else:
        # the offset normalizes a full-scale tone to 0 dBFS
        v = cfg.mult * torch.log2(torch.clamp(p_disp, min=1e-30)) - 20.0 * np.log2(n) * (
            10.0 / np.log2(10.0)) / 10.0
    half = n // 2
    if cfg.positive_only:
        v = torch.repeat_interleave(v[..., :half], 2, dim=-1)
    else:
        v = torch.cat([v[..., half:], v[..., :half]], dim=-1)
    return new_state, v


def histogram_decay(hist: np.ndarray, spectrum_db: np.ndarray, lo_db: float = -100.0,
                    hi_db: float = 0.0, decay: int = 1, stroke: int = 30) -> np.ndarray:
    """The GLSpectrum histogram, headless (glspectrum.h:135-174): hist is a
    (power bins, fft_size) uint8 intensity grid; each new display spectrum
    strokes the cell its dB value falls into, every cell decays toward zero,
    and bins below the floor do not stroke. numpy on the host: the session
    calls it once per published block on display-sized data."""
    n_bins = hist.shape[0]
    in_range = spectrum_db >= lo_db
    idx = np.clip(((spectrum_db - lo_db) * (n_bins / (hi_db - lo_db))).astype(np.int32),
                  0, n_bins - 1)
    h = hist.astype(np.int32) - decay
    h[idx[in_range], np.arange(len(idx))[in_range]] += stroke
    return np.clip(h, 0, 255).astype(np.uint8)
