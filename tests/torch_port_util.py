"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Caps torch's CPU threads so several pytest-xdist workers do not
oversubscribe the machine, and holds the comparison metrics the tests share.
"""

from __future__ import annotations

import ast
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


def real_best_lag(golden, ours, lags, skip: int):
    """The lag of the best real least-squares scale fit of ours onto golden:
    (lag, snr dB, scale), as test_reference_golden._real_best_lag."""
    def fit(a, b):
        m = min(len(a), len(b))
        a, b = np.asarray(a[skip:m], float), np.asarray(b[skip:m], float)
        s = np.dot(b, a) / max(np.dot(b, b), 1e-30)
        err = a - s * b
        return (10 * np.log10(max(np.dot(s * b, s * b), 1e-30) / max(np.dot(err, err), 1e-30)),
                s)
    return max(((lag, *fit(golden[max(0, lag):], ours[max(0, -lag):])) for lag in lags),
               key=lambda r: r[1])


def code_without_docstrings(path: pathlib.Path) -> str:
    """A module's AST with every docstring dropped: equal for a port's copy
    whose code is its JAX original's and whose docs differ."""
    tree = ast.parse(pathlib.Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def stop_orphaned_jax_device_sets() -> int:
    """Stop every JAX-package device set still running in this process.

    XLA's CPU collectives need all of a mesh's device threads at once: a
    JAX worker thread left running by an earlier test in the same process
    (tests/test_api.py::test_tx_device_set_flow leaves its Tx set running)
    starves one participant, and the rendezvous aborts the process after
    40 s. Tests that run JAX programs across the 8 virtual devices call this
    first; the sets it finds belong to tests that have finished."""
    import gc
    import sys

    jsession = sys.modules.get("sdrangel_tpu.runtime.session")
    if jsession is None:
        return 0
    kinds = (jsession.DeviceSet, jsession.TxDeviceSet)
    # type() rather than isinstance(): the latter reads __class__, which
    # wakes deprecation shims living in the heap
    running = [o for o in gc.get_objects() if type(o) in kinds and o.running]
    for ds in running:
        ds.stop()
    return len(running)
