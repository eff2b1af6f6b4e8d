"""Synthetic I/Q generator (testsourcethread.cpp:219-266): an NCO carrier
with none/AM/FM modulation by an audio tone. Deterministic for any start
sample, so consecutive blocks join without a phase seam."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TestSourceConfig:
    __test__ = False  # not a pytest class

    sample_rate: float = 768_000.0
    carrier_freq: float = 0.0  # carrier offset from centre
    modulation: str = "none"  # none | am | fm
    tone_freq: float = 1000.0  # AF tone
    am_depth: float = 0.5  # AM modulation factor (0..1)
    fm_deviation: float = 5000.0  # Hz
    amplitude: float = 0.5  # full-scale fraction
    dc_factor: float = 0.0  # DC offset on I (fraction of full scale)
    i_factor: float = 0.0  # amplitude imbalance: I rail scaled by (1+i_factor)
    phase_imbalance: float = 0.0  # Q' = Q + imb*I


def generate(cfg: TestSourceConfig, n: int, start_sample: int = 0) -> np.ndarray:
    """n complex64 samples starting at sample `start_sample` of the stream."""
    t = (start_sample + np.arange(n, dtype=np.float64)) / cfg.sample_rate
    carrier_phase = 2.0 * np.pi * cfg.carrier_freq * t
    af = np.sin(2.0 * np.pi * cfg.tone_freq * t)
    if cfg.modulation == "am":
        c = np.exp(1j * carrier_phase) * ((af * cfg.am_depth + 1.0) * 0.5)
    elif cfg.modulation == "fm":
        # integrated deviation (testsourcethread.cpp fmPhasor accumulation)
        dphase = 2.0 * np.pi * cfg.fm_deviation * (
            -np.cos(2.0 * np.pi * cfg.tone_freq * t)) / (2.0 * np.pi * cfg.tone_freq)
        c = np.exp(1j * (carrier_phase + dphase))
    elif cfg.modulation == "none":
        c = np.exp(1j * carrier_phase)
    else:
        raise ValueError(cfg.modulation)
    re = c.real * cfg.amplitude * (1.0 + cfg.i_factor)
    im = c.imag * cfg.amplitude + cfg.phase_imbalance * re
    re = re + cfg.dc_factor * cfg.amplitude
    return (re + 1j * im).astype(np.complex64)


def to_iq_int16(c: np.ndarray) -> np.ndarray:
    """complex samples in [-1, 1) -> (T, 2) int16 with saturation."""
    out = np.empty((len(c), 2), dtype=np.int16)
    out[:, 0] = np.clip(c.real * 32768.0, -32768, 32767)
    out[:, 1] = np.clip(c.imag * 32768.0, -32768, 32767)
    return out
