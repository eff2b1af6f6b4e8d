"""Polyphase DFT filter-bank channelizer: all M channels of a uniform grid
c·fs/M in one pass, in place of a half-band tree per channel
(sdrbase/dsp/downchannelizer.cpp:250-287).

Math (critically sampled analysis, output rate fs/M per channel, frame-end
alignment):
    y_c[n] = (x ⊛ g_c)[nM + M−1],   g_c[m] = h[m]·e^{+j2πcm/M}
so channel c is "bandpass at +c·fs/M, then ÷M" exactly; `oracle_channel`
is that convolution in numpy. Splitting m = qM + r gives
v[n, k] = Σ_q h̃[q, k]·x_ext[(n+q)M + k], with h̃ the (P, M)-reshaped
prototype reversed along both axes, then y[n] = DFT_k(v[n])·tw with the
per-channel twiddle tw_c = e^{−j2πc/M}. The carried state is the last
(P−1)·M input samples.

Here the tap contraction runs over a strided window view of the frames and
the DFT across branches is `torch.fft.fft`; `analyze_select` replaces the
DFT by a partial-DFT matrix product when only some channels are wanted.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def prototype(m: int, taps_per_branch: int = 12, beta: float = 9.0,
              cutoff_scale: float = 1.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass of length M·P cut at (fs/2M)·scale, with
    unit DC gain (a DC input gives 1.0 on channel 0). At 12 taps/branch:
    ≤0.25 dB droop at ±0.35·fs/M and ≤−85 dB adjacent-band leakage."""
    n = m * taps_per_branch
    t = np.arange(n) - (n - 1) / 2.0
    fc = 0.5 / m * cutoff_scale
    h = 2.0 * fc * np.sinc(2.0 * fc * t) * np.kaiser(n, beta)
    return (h / h.sum()).astype(np.float32)


class PfbState(NamedTuple):
    tail: torch.Tensor  # (..., (P-1)·M) complex64 input history


def make_state(m: int, device: torch.device, taps_per_branch: int = 12,
               batch_shape=()) -> PfbState:
    return PfbState(torch.zeros(
        (*batch_shape, (taps_per_branch - 1) * m), dtype=torch.complex64, device=device))


@functools.lru_cache(maxsize=None)
def _branch_taps(h_bytes: bytes, m: int, device: torch.device) -> torch.Tensor:
    """h̃ as (M, P): branch k's P taps, both axes of the (P, M) form reversed."""
    h = np.frombuffer(h_bytes, dtype=np.float32)
    h2 = np.reshape(h, (-1, m))[::-1, ::-1]
    return torch.from_numpy(np.ascontiguousarray(h2.T)).to(device)


def _polyphase(state: PfbState, x: torch.Tensor, m: int, h: np.ndarray):
    """(ext, v): v[..., n, k] = Σ_q h̃[q, k]·frames[..., n+q, k]."""
    h = np.asarray(h, dtype=np.float32)
    p = len(h) // m
    if len(h) != p * m:
        raise ValueError(f"prototype length {len(h)} is not a multiple of M={m}")
    t = x.shape[-1]
    if t % m:
        raise ValueError(f"block length {t} must be a multiple of M={m}")
    ext = torch.cat([state.tail, x], dim=-1)
    frames = torch.view_as_real(ext).reshape(*ext.shape[:-1], p - 1 + t // m, m, 2)
    windows = frames.unfold(-3, p, 1)  # (..., F, M, 2, P): q on the last axis
    v = torch.einsum("...fkcq,kq->...fkc", windows, _branch_taps(h.tobytes(), m, x.device))
    return ext, torch.view_as_complex(v.contiguous())


def analyze(state: PfbState, x: torch.Tensor, m: int,
            h: np.ndarray | None = None) -> tuple[PfbState, torch.Tensor]:
    """x (..., T) complex64 with T a multiple of M. Returns (state',
    (..., T/M, M)): frame n, channel c = the signal centred at c·fs/M
    (c mod M, so c = M−1 is −fs/M), decimated by M."""
    h = prototype(m) if h is None else h
    ext, v = _polyphase(state, x, m, h)
    y = torch.fft.fft(v, dim=-1) * _twiddles(m, x.device)
    return PfbState(ext[..., x.shape[-1]:].clone()), y


@functools.lru_cache(maxsize=None)
def _twiddles(m: int, device: torch.device) -> torch.Tensor:
    """e^{−j2πc/M} per channel c, uploaded once: a pageable upload per block
    would make the host wait for the work queued before it."""
    tw = np.exp(-2j * np.pi * np.arange(m) / m).astype(np.complex64)
    return torch.from_numpy(tw).to(device)


def channel_freqs(m: int, fs: float) -> np.ndarray:
    """Centre frequency of each analysis channel (c mod M convention)."""
    c = np.arange(m)
    c = np.where(c <= m // 2, c, c - m)
    return c * fs / m


def oracle_channel(x: np.ndarray, m: int, c: int,
                   h: np.ndarray | None = None) -> np.ndarray:
    """NumPy oracle: channel c = np.convolve(x, h·e^{+j2πc·/M}) sampled at
    nM+M−1 (frame-end alignment, zero history — `analyze` from make_state)."""
    if h is None:
        h = prototype(m)
    g = h * np.exp(2j * np.pi * c * np.arange(len(h)) / m)
    full = np.convolve(x.astype(np.complex128), g.astype(np.complex128))
    return full[m - 1::m][: len(x) // m].astype(np.complex64)


def analyze_select(state: PfbState, x: torch.Tensor, m: int, sel,
                   h: np.ndarray | None = None) -> tuple[PfbState, torch.Tensor]:
    """`analyze` restricted to grid channels `sel`: the length-M DFT becomes
    one (F, M) @ (M, C) partial-DFT product that writes only the C wanted
    channels. Returns (state', (..., T/M, C))."""
    h = prototype(m) if h is None else h
    ext, v = _polyphase(state, x, m, h)
    sel = np.asarray(sel)
    k = np.arange(m)
    # DFT row for channel c, the per-channel twiddle folded in
    w = np.exp(-2j * np.pi * np.outer(k, sel) / m) * np.exp(-2j * np.pi * sel / m)[None, :]
    y = v @ torch.from_numpy(w.astype(np.complex64)).to(x.device)
    return PfbState(ext[..., x.shape[-1]:].clone()), y
