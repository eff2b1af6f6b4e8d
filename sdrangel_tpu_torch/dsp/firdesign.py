"""FIR designers (host-side numpy) and the block FIR applier.

Designers: the windowed-sinc lowpass (Lowpass<T>::create), its spectral
inversion (Highpass<T>::create), the lowpass∗highpass bandpass, the Kaiser
lowpass (wfir.cpp), the reference's exact Bandpass<T>::create design
(bandpass.h:15-76) and the response its ring-walk filter actually applies
(bandpass.h:78-121). Application is a stride-1 valid correlation with a
carried (ntaps-1) tail, over a real or a complex block.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _hamming(n: int) -> np.ndarray:
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))


def lowpass(ntaps: int, cutoff: float) -> np.ndarray:
    """Windowed-sinc lowpass, cutoff in cycles/sample (0..0.5): Hamming
    window, unity DC gain (Lowpass<T>::create)."""
    if ntaps % 2 != 1:
        raise ValueError("odd tap count keeps the filter symmetric")
    m = ntaps // 2
    k = np.arange(ntaps, dtype=np.float64) - m
    with np.errstate(invalid="ignore", divide="ignore"):
        h = np.where(k == 0, 2.0 * cutoff, np.sin(2.0 * np.pi * cutoff * k) / (np.pi * k))
    h *= _hamming(ntaps)
    return (h / h.sum()).astype(np.float32)


def highpass(ntaps: int, cutoff: float) -> np.ndarray:
    """Spectral inversion of the lowpass (Highpass<T>::create)."""
    h = -lowpass(ntaps, cutoff).astype(np.float64)
    h[ntaps // 2] += 1.0
    return h.astype(np.float32)


def bandpass(ntaps: int, f_lo: float, f_hi: float) -> np.ndarray:
    """Bandpass [f_lo, f_hi] (cycles/sample) as lowpass(f_hi) ∗ highpass(f_lo)
    collapsed into one tap set of the configured length, normalised to unity
    gain at the geometric centre (Bandpass<T>::create convolves the two)."""
    h = np.convolve(lowpass(ntaps, f_hi).astype(np.float64),
                    highpass(ntaps, f_lo).astype(np.float64))
    start = (len(h) - ntaps) // 2
    h = h[start:start + ntaps]
    w = 2.0 * np.pi * np.sqrt(f_lo * f_hi)
    gain = np.abs(np.sum(h * np.exp(-1j * w * (np.arange(ntaps) - ntaps // 2))))
    return (h / gain).astype(np.float32)


def kaiser_lowpass(ntaps: int, cutoff: float, atten_db: float = 60.0) -> np.ndarray:
    """Kaiser-window lowpass (WFIR::BasicFIR LPF + wKaiser, wfir.cpp:26-78),
    cutoff in cycles/sample, β from Kaiser's attenuation formula."""
    if atten_db > 50.0:
        beta = 0.1102 * (atten_db - 8.7)
    elif atten_db >= 21.0:
        beta = 0.5842 * (atten_db - 21.0) ** 0.4 + 0.07886 * (atten_db - 21.0)
    else:
        beta = 0.0
    k = np.arange(ntaps, dtype=np.float64) - (ntaps - 1) / 2.0
    with np.errstate(invalid="ignore"):
        h = np.where(k == 0, 2.0 * cutoff, np.sin(2.0 * np.pi * cutoff * k) / (np.pi * k))
    h = h * np.kaiser(ntaps, beta)
    return (h / h.sum()).astype(np.float32)


def nfm_mod_bandpass(ntaps: int, fs: float, f_lo: float, f_hi: float) -> np.ndarray:
    """The reference Bandpass<Real>::create design (bandpass.h:15-76),
    including its normalization by the near-zero DC tap sum (a large
    passband gain). Returns the full symmetric ntaps response, unscaled."""
    if ntaps % 2 != 1:
        raise ValueError("ntaps must be odd")
    wcl = 2.0 * np.pi * f_lo / fs
    wch = 2.0 * np.pi * f_hi / fs
    n2 = ntaps // 2 + 1
    i = np.arange(n2, dtype=np.float64)
    d = i - (ntaps - 1) / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        lp = np.sin(d * wch) / (d * np.pi)
        hp = -np.sin(d * wcl) / (d * np.pi)
    lp[n2 - 1] = wch / np.pi
    hp[n2 - 1] = -(wcl / np.pi)
    hp[n2 - 1] += 1.0
    win = 0.54 + 0.46 * np.cos(2.0 * np.pi * d / ntaps)
    taps = -(lp * win + hp * win)
    taps[n2 - 1] += 1.0
    taps = taps / (taps[:-1].sum() * 2.0 + taps[-1])
    return np.concatenate([taps[:-1], taps[::-1]]).astype(np.float32)


def bandpass_ring_kernel(ntaps: int, fs: float, f_lo: float, f_hi: float) -> np.ndarray:
    """The FIR the reference's Bandpass<T>::filter actually applies: its ring
    walk (bandpass.h:78-121) starts at ptr-1, so tap t0 multiplies the newest
    two samples, t1..t[c-1] ages 2..c and ntaps-1..c+2, and the centre tap
    lands at age c+1 — a one-sample-asymmetric kernel. Oriented for
    `fir_apply` (tap k at delay ntaps-1-k), unscaled."""
    full = nfm_mod_bandpass(ntaps, fs, f_lo, f_hi)
    n2 = ntaps // 2 + 1
    t = full[:n2].astype(np.float64)
    c = np.zeros(ntaps, np.float64)  # index = age (delay in samples)
    c[0] = t[0]
    c[1] = t[0]
    c[2:n2] = t[1:n2 - 1]
    c[n2] = t[n2 - 1]
    ages = np.arange(n2 + 1, ntaps)
    c[ages] = t[ntaps - ages]
    return c[::-1].astype(np.float32)


class FirState(NamedTuple):
    tail: torch.Tensor  # (..., ntaps-1)


def make_state(ntaps: int, device: torch.device, batch_shape=(),
               dtype: torch.dtype = torch.float32) -> FirState:
    return FirState(torch.zeros((*batch_shape, ntaps - 1), dtype=dtype, device=device))


def fir_apply(
    state: FirState, x: torch.Tensor, taps: torch.Tensor
) -> tuple[FirState, torch.Tensor]:
    """y[n] = Σ_k taps[k]·ext[n + k], ext = [tail | x], over a real float32
    or a complex64 (..., T) block; taps (L,) float32.

    Computed as an FFT convolution, for accuracy: on the NFM audio
    bandpass (301 taps) a direct f32 correlation agreed with a float64
    reference to 130.2 dB, the FFT form to 137.4 dB, and only the latter
    keeps the nfm48 golden in atan2 parity mode above its 130 dB bound
    (CPU measurements).
    """
    ext = torch.cat([state.tail, x], dim=-1)
    l_taps = taps.shape[-1]
    n_fft = 1 << (ext.shape[-1] + l_taps - 2).bit_length()
    if ext.is_complex():
        spec = torch.fft.fft(ext, n_fft, dim=-1) * torch.fft.fft(taps.flip(-1), n_fft)
        y = torch.fft.ifft(spec, n_fft, dim=-1)
    else:
        spec = torch.fft.rfft(ext, n_fft, dim=-1) * torch.fft.rfft(taps.flip(-1), n_fft)
        y = torch.fft.irfft(spec, n_fft, dim=-1)
    y = y[..., l_taps - 1 : l_taps - 1 + x.shape[-1]]
    return FirState(ext[..., x.shape[-1]:].clone()), y
