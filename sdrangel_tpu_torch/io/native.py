"""ctypes bindings for the native .sdriq loader (native/sdriq_loader.cc).

The loader maps the capture and copies wrapped block reads out of it in C++
(int16 straight, 24-bit shifted to 16, or scaled to float32), the role of
the reference's file source thread (filesourcethread.cpp:188-195). It is
host I/O, not a kernel, and library code: `python -m sdrangel_tpu_torch
demod --in` reads captures through the NumPy memmap (io/sdriq.py).

The port builds the same source as the JAX package (sdrangel_tpu/io/native.py)
with g++ into its git-ignored kernels/_build/, under a name keyed on a hash
of the source and the flags, to a temporary file that is then renamed, so
concurrent processes never load a half-written library; the JAX package's
native/libsdriq.so is neither written nor loaded here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "sdriq_loader.cc")
BUILD_DIR = os.path.join(_PKG, "kernels", "_build")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib = None  # CDLL once loaded; False = the build failed (g++ is not retried)


def library_path() -> str:
    """Where the loader is built: keyed on the source and the flags."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsdriq_{h.hexdigest()[:16]}.so")


def _load():
    global _lib
    if _lib is not None:
        if _lib is False:
            raise OSError("native loader unavailable (earlier build failed)")
        return _lib
    try:
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                           capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
    except Exception:
        _lib = False
        raise
    lib.sdriq_open.restype = ctypes.c_void_p
    lib.sdriq_open.argtypes = [ctypes.c_char_p]
    lib.sdriq_sample_rate.restype = ctypes.c_int32
    lib.sdriq_sample_rate.argtypes = [ctypes.c_void_p]
    lib.sdriq_center_frequency.restype = ctypes.c_uint64
    lib.sdriq_center_frequency.argtypes = [ctypes.c_void_p]
    lib.sdriq_sample_size.restype = ctypes.c_uint32
    lib.sdriq_sample_size.argtypes = [ctypes.c_void_p]
    lib.sdriq_n_samples.restype = ctypes.c_uint64
    lib.sdriq_n_samples.argtypes = [ctypes.c_void_p]
    lib.sdriq_read_f32.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
                                   ctypes.POINTER(ctypes.c_float)]
    lib.sdriq_read_i16.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
                                   ctypes.POINTER(ctypes.c_int16)]
    lib.sdriq_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


class NativeSdriq:
    """A mapped .sdriq capture with wrapped block reads."""

    def __init__(self, path: str):
        lib = _load()
        self._lib = lib
        self._h = lib.sdriq_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path}")
        self.sample_rate = lib.sdriq_sample_rate(self._h)
        self.center_frequency = lib.sdriq_center_frequency(self._h)
        self.sample_size = lib.sdriq_sample_size(self._h)
        self.n_samples = lib.sdriq_n_samples(self._h)

    def read_f32(self, start: int, count: int) -> np.ndarray:
        """(count, 2) float32 in [-1, 1) from `start`, looping at the end."""
        out = np.empty((count, 2), dtype=np.float32)
        self._lib.sdriq_read_f32(self._h, start, count,
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out

    def read_i16(self, start: int, count: int) -> np.ndarray:
        """(count, 2) int16 from `start`, looping at the end (24-bit: >> 8)."""
        out = np.empty((count, 2), dtype=np.int16)
        self._lib.sdriq_read_i16(self._h, start, count,
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
        return out

    def close(self) -> None:
        if self._h:
            self._lib.sdriq_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
