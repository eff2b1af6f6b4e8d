"""Build and load the port's CUDA kernels.

Every `kernels/csrc/*.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into one
shared library with a plain C interface, loaded with ctypes. The library goes
to `kernels/_build/` (git-ignored) under a name keyed on a hash of the
sources and flags; it is built at first use, to a temporary file that is then
renamed, so concurrent processes never load a half-written library. Nothing
is fetched: the build needs only the checkout and the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: str  # the loaded shared library
    seconds: float  # nvcc wall time of the build that made the library
    ptxas: str  # nvcc's -Xptxas -v report (registers, shared memory, spills)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsdr_kernels_{h.hexdigest()[:16]}.so")


@functools.lru_cache(maxsize=None)
def build() -> BuildInfo:
    """Compile the kernels unless this source hash is already built. The
    report of the build that made the library is kept beside it."""
    so = _library_path()
    log = so + ".log"
    if os.path.exists(so):
        seconds, ptxas = "0", ""
        if os.path.exists(log):
            with open(log) as f:
                seconds, _, ptxas = f.read().partition("\n")
        return BuildInfo(so, float(seconds), ptxas)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    with open(f"{log}.{os.getpid()}.tmp", "w") as f:
        f.write(f"{seconds}\n{proc.stderr}")
    os.replace(f"{log}.{os.getpid()}.tmp", log)
    os.replace(tmp, so)
    return BuildInfo(so, seconds, proc.stderr)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's signature set."""
    lib = ctypes.CDLL(build().path)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sdr_flat_decimate.restype = i32
    lib.sdr_flat_decimate.argtypes = [
        i32, p, i64, p, p, i32, i32, ctypes.c_float, p, i64, p,
    ]
    lib.sdr_flat_decimate_smem_bytes.restype = i64
    lib.sdr_flat_decimate_smem_bytes.argtypes = [i32, i32, i32]
    lib.sdr_flat_decimate_tc.restype = i32
    lib.sdr_flat_decimate_tc.argtypes = [p, i64, p, i64, p, i32, i32, p, i64, p]
    lib.sdr_flat_decimate_tc_smem_bytes.restype = i64
    lib.sdr_flat_decimate_tc_smem_bytes.argtypes = [i32]
    lib.sdr_flat_decimate_tc_blocks_per_sm.restype = i32
    lib.sdr_flat_decimate_tc_blocks_per_sm.argtypes = [i32]
    lib.sdr_cuda_error_string.restype = ctypes.c_char_p
    lib.sdr_cuda_error_string.argtypes = [i32]
    return lib
