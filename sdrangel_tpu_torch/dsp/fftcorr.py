"""FFT cross/auto-correlation.

Reference: sdrbase/dsp/fftcorr.{h,cpp} — overlap-processed correlation of two
complex streams via forward FFT, conjugate multiply, inverse FFT (used by
the channel analyzer family). Block form: both inputs frame into fft-size
chunks with 50 % overlap; the correlation of each frame is
ifft(fft(a)·conj(fft(b))), by torch.fft on the blocks' device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class FftCorrState(NamedTuple):
    tail_a: torch.Tensor  # (..., fft_size/2) complex64
    tail_b: torch.Tensor


def make_state(fft_size: int = 1024, batch_shape=(), device: torch.device | str = "cuda"
               ) -> FftCorrState:
    z = torch.zeros((*batch_shape, fft_size // 2), dtype=torch.complex64, device=device)
    return FftCorrState(z, z)


def state_from_numpy(tree, device: torch.device | str) -> FftCorrState:
    """The JAX FftCorrState (fetched as numpy) as this module's."""
    return FftCorrState(*(torch.from_numpy(np.array(t, np.complex64)).to(device)
                          for t in tree))


def state_to_numpy(state: FftCorrState) -> FftCorrState:
    return FftCorrState(*(t.cpu().numpy() for t in state))


def correlate_block(
    state: FftCorrState, a: torch.Tensor, b: torch.Tensor, fft_size: int = 1024
) -> tuple[FftCorrState, torch.Tensor]:
    """Windowless overlap correlation: frames of fft_size/2 new samples with
    the previous half in front. a, b (..., T) complex64, T a multiple of
    fft_size/2. Returns (state', corr (..., T/(fft_size/2), fft_size)
    complex64): the raw ifft's lags, lag 0 at index 0, negative lags
    wrapped."""
    hop = fft_size // 2
    t = a.shape[-1]
    if t % hop:
        raise ValueError(f"block length {t} is no multiple of the hop {hop}")

    def frames(x, tail):
        ext = torch.cat([tail, x], dim=-1)
        return ext.unfold(-1, fft_size, hop), ext[..., t:]

    fa, tail_a = frames(a, state.tail_a)
    fb, tail_b = frames(b, state.tail_b)
    corr = torch.fft.ifft(torch.fft.fft(fa, dim=-1) * torch.fft.fft(fb, dim=-1).conj(), dim=-1)
    return FftCorrState(tail_a, tail_b), corr.to(torch.complex64)


def autocorrelate_block(
    state: FftCorrState, x: torch.Tensor, fft_size: int = 1024
) -> tuple[FftCorrState, torch.Tensor]:
    return correlate_block(state, x, x, fft_size)
