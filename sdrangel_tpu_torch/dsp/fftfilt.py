"""FFT fast-convolution channel filters (overlap-add).

Reference: sdrbase/dsp/fftfilt.{h,cpp} — accumulates flen/2 samples, FFTs
[chunk | zeros], multiplies by the frequency-domain filter, IFFTs, emits the
first half plus the saved overlap and saves the second half (runFilt
fftfilt.cpp:261-282; runSSB :285-326 zeroes the rejected sideband; runDSB
:328; runAsym :361). The designers (create_filter :108, the DSB lowpass
:149, the asymmetric pair :193, the root-raised cosine) are host-side
numpy, as in the JAX package.

A block of T samples is (T/hop, hop) frames; the frames go through one
batched `torch.fft` each way, and the overlap-add between consecutive
frames is a shift along the frame axis. Only one hop of state crosses a
block boundary, and the hop grid stays relative to the stream's start.
The run_* functions take the response as a tensor on x's device; a
demodulator uploads its filter once per (config, device) and caches it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Designers (host-side numpy, at configure time)
# ---------------------------------------------------------------------------


def _fsinc(fc: float, i: int | np.ndarray, length: int) -> np.ndarray:
    """Shifted sinc as in fftfilt::fsinc (fftfilt.cpp:87-94)."""
    n = np.asarray(i, dtype=np.float64)
    arg = n - length / 2.0
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(arg == 0.0, 2.0 * fc, np.sin(2.0 * np.pi * fc * arg) / (np.pi * arg))


def _blackman(i: np.ndarray, length: int) -> np.ndarray:
    n = np.asarray(i, dtype=np.float64)
    return (0.42 - 0.50 * np.cos(2.0 * np.pi * n / length)
            + 0.08 * np.cos(4.0 * np.pi * n / length))


def _normalize_peak(h_freq: np.ndarray, half_only: bool = True) -> np.ndarray:
    scale = np.abs(h_freq[: len(h_freq) // 2] if half_only else h_freq).max()
    return h_freq if scale == 0 else h_freq / scale


def create_filter(f1: float, f2: float, flen: int = 1024) -> np.ndarray:
    """Bandpass [f1, f2] (frequencies as fractions of the sample rate) as a
    length-`flen` frequency response (fftfilt::create_filter)."""
    flen2 = flen // 2
    i = np.arange(flen2)
    ht = np.zeros(flen2, dtype=np.float64)
    if f2 != 0:
        ht += _fsinc(f2, i, flen2)
    if f1 != 0:
        ht -= _fsinc(f1, i, flen2)
    if f1 != 0 and f2 < f1:
        ht[flen2 // 2] += 1.0  # highpass = delta - lowpass
    ht *= _blackman(i, flen2)
    h = np.zeros(flen, dtype=np.complex128)
    h[:flen2] = ht
    return _normalize_peak(np.fft.fft(h)).astype(np.complex64)


def create_dsb_filter(f2: float, flen: int = 1024) -> np.ndarray:
    """Lowpass at f2 for DSB (fftfilt::create_dsb_filter)."""
    flen2 = flen // 2
    i = np.arange(flen2)
    h = np.zeros(flen, dtype=np.complex128)
    h[:flen2] = _fsinc(f2, i, flen2) * _blackman(i, flen2)
    return _normalize_peak(np.fft.fft(h)).astype(np.complex64)


def create_asym_filter(fopp: float, fin: float, flen: int = 1024
                       ) -> tuple[np.ndarray, np.ndarray]:
    """In-band and opposite-band pair for vestigial sideband
    (fftfilt::create_asym_filter)."""
    return create_dsb_filter(fin, flen), create_dsb_filter(fopp, flen)


def create_rrc_filter(fb: float, alpha: float, flen: int = 1024) -> np.ndarray:
    """Root-raised-cosine built directly in the frequency domain
    (fftfilt::create_rrc_filter / frrc): fb the symbol rate and alpha the
    rolloff, as fractions of the sample rate."""
    f = np.fft.fftfreq(flen)  # i/flen, then (i - flen)/flen past flen/2
    a = np.abs(f)
    lo, hi = fb * (1.0 - alpha) / 2.0, fb * (1.0 + alpha) / 2.0
    with np.errstate(invalid="ignore"):
        edge = np.sqrt(0.5 * (1.0 + np.cos(np.pi / (fb * alpha) * (a - lo))))
    h = np.where(a <= lo, 1.0, np.where(a < hi, edge, 0.0))
    return _normalize_peak(h, half_only=False).astype(np.complex64)


# ---------------------------------------------------------------------------
# Runtime: batched overlap-add
# ---------------------------------------------------------------------------


class FftFiltState(NamedTuple):
    overlap: torch.Tensor  # (..., flen/2) complex64 carried overlap tail


def make_state(flen: int, device: torch.device, batch_shape=()) -> FftFiltState:
    return FftFiltState(
        torch.zeros((*batch_shape, flen // 2), dtype=torch.complex64, device=device))


def _ssb_multiplier(h: torch.Tensor, usb: bool, get_dc: bool) -> torch.Tensor:
    """runSSB's per-bin multiplier (fftfilt.cpp:285-326): the kept
    sideband's bins 1..flen/2-1 (usb) or flen/2+1..flen-1 (lsb) take the
    filter, the other sideband is zeroed, the Nyquist bin flen/2 passes
    unfiltered in both branches, and DC is filtered or zeroed per getDC."""
    hop = h.shape[-1] // 2
    mult = torch.zeros_like(h)
    if usb:
        mult[1:hop] = h[1:hop]
    else:
        mult[hop + 1:] = h[hop + 1:]
    mult[hop] = 1.0
    if get_dc:
        mult[0] = h[0]
    return mult


def _asym_multiplier(h_in: torch.Tensor, h_opp: torch.Tensor, usb: bool) -> torch.Tensor:
    """runAsym's multiplier (fftfilt.cpp:344-361): the in-band half takes
    h_in, the opposite half h_opp; its loops cover bins 1..flen/2-1 of each
    half, so the Nyquist bin passes unfiltered, and DC always takes h_in."""
    hop = h_in.shape[-1] // 2
    lower, upper = (h_in, h_opp) if usb else (h_opp, h_in)
    mult = torch.cat([lower[:hop], upper[hop:]])
    mult[hop] = 1.0
    mult[0] = h_in[0]
    return mult


def _overlap_add(state: FftFiltState, x: torch.Tensor, mult: torch.Tensor
                 ) -> tuple[FftFiltState, torch.Tensor]:
    flen = mult.shape[-1]
    hop = flen // 2
    t = x.shape[-1]
    if t % hop:
        raise ValueError(f"block of {t} samples must be a multiple of flen/2={hop}")
    frames = x.reshape(*x.shape[:-1], t // hop, hop)
    y = torch.fft.ifft(torch.fft.fft(frames, n=flen, dim=-1) * mult, dim=-1)
    first, second = y[..., :hop], y[..., hop:]
    prev = torch.cat([state.overlap[..., None, :], second[..., :-1, :]], dim=-2)
    out = (first + prev).reshape(*x.shape[:-1], t)
    return FftFiltState(second[..., -1, :].clone()), out


def run_filt(state: FftFiltState, x: torch.Tensor, h_freq: torch.Tensor
             ) -> tuple[FftFiltState, torch.Tensor]:
    """Overlap-add filter (fftfilt::runFilt). x (..., T) complex64 with T a
    multiple of flen/2; h_freq (flen,) complex64 on x's device.
    Returns (state', y (..., T))."""
    return _overlap_add(state, x, h_freq)


def run_ssb(state: FftFiltState, x: torch.Tensor, h_freq: torch.Tensor, usb: bool,
            get_dc: bool = False) -> tuple[FftFiltState, torch.Tensor]:
    """SSB filter (fftfilt::runSSB): the kept sideband takes the filter,
    the rejected one (and DC unless get_dc) is zeroed."""
    return _overlap_add(state, x, _ssb_multiplier(h_freq, usb, get_dc))


def run_dsb(state: FftFiltState, x: torch.Tensor, h_freq: torch.Tensor
            ) -> tuple[FftFiltState, torch.Tensor]:
    """DSB: both sidebands filtered (fftfilt::runDSB)."""
    return _overlap_add(state, x, h_freq)


def run_asym(state: FftFiltState, x: torch.Tensor, h_in: torch.Tensor, h_opp: torch.Tensor,
             usb: bool) -> tuple[FftFiltState, torch.Tensor]:
    """Asymmetric / vestigial filtering (fftfilt::runAsym): the in-band
    sideband takes h_in, the opposite sideband h_opp."""
    return _overlap_add(state, x, _asym_multiplier(h_in, h_opp, usb))
