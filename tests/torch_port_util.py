"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Caps torch's CPU threads so several pytest-xdist workers do not
oversubscribe the machine, and holds the comparison metrics the tests share.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

torch.set_num_threads(2)

CPU = torch.device("cpu")
GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"
_MANIFEST = json.loads((GOLDEN_DIR / "manifest.json").read_text())


def load_golden(name: str) -> np.ndarray:
    entry = _MANIFEST[name]
    dtype, ext = (np.int16, ".i16") if entry["dtype"] == "int16" else (np.float32, ".f32")
    arr = np.fromfile(GOLDEN_DIR / (name + ext), dtype=dtype)
    assert len(arr) == entry["count"]
    return arr


def load_golden_iq(name: str) -> np.ndarray:
    flat = load_golden(name)
    return flat[0::2].astype(np.float64) + 1j * flat[1::2].astype(np.float64)


def fit_snr(golden, ours, skip: int = 256) -> tuple[float, complex]:
    """Least-squares complex scale fit of ours onto golden: (snr dB, scale)."""
    n = min(len(golden), len(ours))
    a = np.asarray(golden[skip:n], dtype=np.complex128)
    b = np.asarray(ours[skip:n], dtype=np.complex128)
    s = np.vdot(b, a) / max(abs(np.vdot(b, b)), 1e-30)
    err = a - s * b
    snr = 10 * np.log10(abs(np.vdot(s * b, s * b)) / max(abs(np.vdot(err, err)), 1e-30))
    return float(snr), complex(s)


def best_lag(golden, ours, lags, skip: int = 256):
    results = [(lag, *fit_snr(golden[max(0, lag):], ours[max(0, -lag):], skip)) for lag in lags]
    return max(results, key=lambda t: t[1])


def agreement_db(ref, ours) -> float:
    """Energy of ref over the energy of (ours − ref), in dB; no fitting."""
    ref = np.asarray(ref, np.float64)
    err = np.asarray(ours, np.float64) - ref
    return float(10 * np.log10(np.sum(ref ** 2) / max(np.sum(err ** 2), 1e-300)))


def tone_snr(audio, tone_hz: float, fs: float) -> float:
    """Power within ±4 bins of the tone over the rest of the spectrum, in dB."""
    n = len(audio)
    audio = audio - audio.mean()
    spec = np.abs(np.fft.rfft(audio * np.hanning(n))) ** 2
    freqs = np.fft.rfftfreq(n, 1.0 / fs)
    tone_bins = np.abs(freqs - tone_hz) < 4.0 * fs / n
    return float(10.0 * np.log10(spec[tone_bins].sum() / max(spec[~tone_bins].sum(), 1e-30)))


def t(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor (a copy, so read-only inputs are fine)."""
    return torch.from_numpy(np.array(a))


def n(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()
