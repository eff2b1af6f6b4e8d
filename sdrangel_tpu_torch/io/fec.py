"""GF(256) Cauchy Reed-Solomon erasure coding — the CM256 role.

Reference: the SDRdaemon transport protects each UDP superframe of 128
original blocks with `nbFECBlocks` parity blocks via the external cm256cc
library (Cauchy Reed-Solomon over GF(256)); any k of n received blocks
reconstruct the frame (plugins/samplesource/sdrdaemonsource/
sdrdaemonsourcebuffer.h:27-85).

Two implementations of the same field/matrix (prim poly 0x11D, Cauchy
C[i,j] = 1/(x_j ^ y_i)): the native SSSE3 split-table codec
(native/fec_gf256.cc, built on first use — the cm256cc-region-ops role)
and a NumPy fallback (encode = log-domain Cauchy matmul; decode = GF(256)
Gaussian elimination). fec_encode/fec_decode dispatch to the native path
when the toolchain is present; both are parity-tested against each other.

The port's own copy of the JAX package's module (sdrangel_tpu/io/fec.py),
held equal to it by tests/test_torch_dvbs_copies.py. It is a host codec and
stays on the host. It builds the same source, native/fec_gf256.cc, with g++
into the port's git-ignored kernels/_build/, under a name keyed on a hash of
the source and the flags, to a temporary file that is then renamed, so
concurrent processes never load a half-written library; the JAX package's
native/libfecgf256.so is neither written nor loaded here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "fec_gf256.cc")
BUILD_DIR = os.path.join(_PKG, "kernels", "_build")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib = None  # CDLL once loaded; False = load failed (don't retry g++ per call)


def library_path() -> str:
    """Where the native codec is built: keyed on the source and the flags."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfecgf256_{h.hexdigest()[:16]}.so")


def _load_native():
    global _lib
    if _lib is not None:
        if _lib is False:
            raise OSError("native FEC unavailable (earlier build failed)")
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
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.fec_encode.restype = None
    lib.fec_encode.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32,
                               ctypes.c_int32, u8p]
    lib.fec_decode.restype = ctypes.c_int32
    lib.fec_decode.argtypes = [u8p, u8p, ctypes.c_int32, ctypes.c_int32,
                               u8p, ctypes.POINTER(ctypes.c_int32),
                               ctypes.c_int32]
    _lib = lib
    return lib


def native_available() -> bool:
    if os.environ.get("SDRANGEL_TPU_NO_NATIVE_FEC"):
        return False
    try:
        _load_native()
        return True
    except Exception:
        return False

_PRIM_POLY = 0x11D  # x^8+x^4+x^3+x^2+1


def _build_tables():
    exp = np.zeros(512, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _PRIM_POLY
    exp[255:510] = exp[:255]
    return exp, log


_EXP, _LOG = _build_tables()


def gf_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    out = _EXP[(_LOG[a] + _LOG[b]) % 255]
    return np.where((a == 0) | (b == 0), 0, out).astype(np.uint8)


def gf_inv(a: int) -> int:
    assert a != 0
    return int(_EXP[255 - _LOG[a]])


def _cauchy_matrix(rows: int, cols: int) -> np.ndarray:
    """C[i,j] = 1/(x_i ^ y_j) with disjoint x,y sets (always invertible on
    any square submatrix — the Cauchy property CM256 relies on)."""
    assert rows + cols <= 256
    x = np.arange(cols, dtype=np.int32)  # data identities 0..cols-1
    y = np.arange(cols, cols + rows, dtype=np.int32)
    m = np.zeros((rows, cols), dtype=np.uint8)
    for i in range(rows):
        for j in range(cols):
            m[i, j] = gf_inv(int(x[j]) ^ int(y[i]))
    return m


def _mat_vec_blocks(mat: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """GF(256) matrix (r×k) times k data blocks (k×L bytes) -> (r×L)."""
    r, k = mat.shape
    out = np.zeros((r, blocks.shape[1]), dtype=np.uint8)
    for i in range(r):
        acc = np.zeros(blocks.shape[1], dtype=np.uint8)
        for j in range(k):
            c = int(mat[i, j])
            if c:
                acc ^= gf_mul(np.full(1, c, np.uint8), blocks[j])
        out[i] = acc
    return out


def fec_encode(data_blocks: np.ndarray, n_fec: int) -> np.ndarray:
    """data_blocks: (k, L) uint8. Returns (n_fec, L) parity blocks."""
    if native_available():
        data = np.ascontiguousarray(data_blocks, dtype=np.uint8)
        k, L = data.shape
        parity = np.empty((n_fec, L), dtype=np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        _lib.fec_encode(data.ctypes.data_as(u8p), k, L, n_fec,
                        parity.ctypes.data_as(u8p))
        return parity
    return fec_encode_py(data_blocks, n_fec)


def fec_encode_py(data_blocks: np.ndarray, n_fec: int) -> np.ndarray:
    """NumPy encode (kept as oracle + toolchain-free fallback)."""
    k = data_blocks.shape[0]
    mat = _cauchy_matrix(n_fec, k)
    return _mat_vec_blocks(mat, data_blocks)


def fec_decode(
    received: dict[int, np.ndarray], k: int, block_len: int
) -> np.ndarray | None:
    """received: {index: block} where index < k are data blocks and index >= k
    are parity blocks (k + fec_row). Returns (k, L) recovered data or None if
    fewer than k blocks arrived."""
    if native_available():
        return _fec_decode_native(received, k, block_len)
    return fec_decode_py(received, k, block_len)


def _fec_decode_native(
    received: dict[int, np.ndarray], k: int, block_len: int
) -> np.ndarray | None:
    if len(received) < k:
        return None
    data = np.zeros((k, block_len), dtype=np.uint8)
    missing = np.ones(k, dtype=np.uint8)
    for i, b in received.items():
        if i < k:
            data[i] = b
            missing[i] = 0
    n_miss = int(missing.sum())
    if n_miss == 0:
        return data
    rows = sorted(i - k for i in received if i >= k)[:n_miss]
    if len(rows) < n_miss:
        return None
    parity = np.stack([received[k + r] for r in rows]).astype(np.uint8)
    rows_arr = np.asarray(rows, dtype=np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = _lib.fec_decode(
        data.ctypes.data_as(u8p), missing.ctypes.data_as(u8p), k, block_len,
        np.ascontiguousarray(parity).ctypes.data_as(u8p),
        rows_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(rows))
    return data if rc == 0 else None


def fec_decode_py(
    received: dict[int, np.ndarray], k: int, block_len: int
) -> np.ndarray | None:
    """NumPy decode (oracle + fallback)."""
    if len(received) < k:
        return None
    have_data = {i: b for i, b in received.items() if i < k}
    missing = [i for i in range(k) if i not in have_data]
    if not missing:
        return np.stack([have_data[i] for i in range(k)])
    parity = {i - k: b for i, b in received.items() if i >= k}
    use_rows = sorted(parity.keys())[: len(missing)]
    if len(use_rows) < len(missing):
        return None
    full = _cauchy_matrix(max(use_rows) + 1, k)
    # Each used parity row: p_r = sum_j C[r,j] d_j
    # -> sum_{j in missing} C[r,j] d_j = p_r ^ sum_{j known} C[r,j] d_j
    rhs = []
    sub = np.zeros((len(use_rows), len(missing)), dtype=np.uint8)
    for ri, r in enumerate(use_rows):
        acc = parity[r].copy()
        for j, b in have_data.items():
            c = int(full[r, j])
            if c:
                acc = acc ^ gf_mul(np.full(1, c, np.uint8), b)
        rhs.append(acc)
        for mi, j in enumerate(missing):
            sub[ri, mi] = full[r, j]
    rhs = np.stack(rhs)  # (m, L)

    # Gaussian elimination over GF(256) on [sub | rhs]
    m = len(missing)
    sub = sub.astype(np.uint8).copy()
    for col in range(m):
        piv = None
        for row in range(col, m):
            if sub[row, col] != 0:
                piv = row
                break
        if piv is None:
            return None
        if piv != col:
            sub[[col, piv]] = sub[[piv, col]]
            rhs[[col, piv]] = rhs[[piv, col]]
        inv = gf_inv(int(sub[col, col]))
        sub[col] = gf_mul(np.full(m, inv, np.uint8), sub[col])
        rhs[col] = gf_mul(np.full(1, inv, np.uint8), rhs[col])
        for row in range(m):
            if row != col and sub[row, col] != 0:
                c = int(sub[row, col])
                sub[row] ^= gf_mul(np.full(m, c, np.uint8), sub[col])
                rhs[row] ^= gf_mul(np.full(1, c, np.uint8), rhs[col])

    out = np.zeros((k, block_len), dtype=np.uint8)
    for i, b in have_data.items():
        out[i] = b
    for mi, j in enumerate(missing):
        out[j] = rhs[mi]
    return out
