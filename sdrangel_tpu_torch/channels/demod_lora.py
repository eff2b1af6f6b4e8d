"""LoRa chirp demodulator.

Reference: plugins/channelrx/demodlora/lorademod.cpp (`feed`): NCO mix →
resample to the LoRa bandwidth → multiply by the conjugate base chirp →
FFT argmax (`detect()`), the symbol being the peak bin. Here the de-chirp
and the FFT run over whole symbol frames, every frame of a block at once.
"""

from __future__ import annotations

import dataclasses
import functools
from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch

from ..dsp import nco, resampler
from .demod_nfm import _device_taps


@dataclasses.dataclass(frozen=True, eq=False)
class LoRaConfig:
    channel_rate: float
    input_offset: float = 0.0
    bandwidth: float = 125000.0  # chip rate
    spread_factor: int = 7  # a symbol is 2^SF chips
    block_in: int = 0  # input samples a block (0 -> auto); a multiple of
    # block_factor() when the engine drives it

    @property
    def n_bins(self) -> int:
        return 1 << self.spread_factor

    def block_factor(self) -> int:
        """Engine blocks are multiples of this: p·2^SF input samples give
        q·2^SF chips, whole dechirp frames a block."""
        p = Fraction(self.channel_rate / self.bandwidth).limit_denominator(1 << 16).numerator
        return p * self.n_bins

    @functools.cached_property
    def resamp_plan(self) -> resampler.ResamplerPlan:
        block = self.block_in
        if not block:
            block = self.block_factor()
            while block < 4096:
                block *= 2
        return resampler.make_plan(self.channel_rate, self.bandwidth, block)

    @functools.cached_property
    def base_downchirp(self) -> np.ndarray:
        """The conjugate of the base upchirp over one symbol (2^SF chips)."""
        n = self.n_bins
        k = np.arange(n, dtype=np.float64)
        phase = 2.0 * np.pi * (k * k / (2.0 * n) - k / 2.0)
        return np.exp(-1j * phase).astype(np.complex64)


class LoRaState(NamedTuple):
    nco: nco.NCOState
    resamp: resampler.ResamplerState


def make_state(cfg: LoRaConfig, device: torch.device, batch_shape=()) -> LoRaState:
    return LoRaState(nco=nco.make_nco(device, batch_shape),
                     resamp=resampler.init_state(cfg.resamp_plan, device, batch_shape))


class LoRaOutputs(NamedTuple):
    symbols: torch.Tensor  # (..., F) int32 peak bin of each symbol frame
    magnitudes: torch.Tensor  # (..., F) float32 peak magnitude
    snr_est: torch.Tensor  # (..., F) float32 peak over the mean


def process(state: LoRaState, x: torch.Tensor, cfg: LoRaConfig) -> tuple[LoRaState, LoRaOutputs]:
    """Chip-aligned demod: the registry's block factor makes the chips of a
    block a whole number of symbols, so frames stay aligned across blocks
    with no partial symbol carried."""
    nco_state, xm = nco.mix_block(
        state.nco, x, nco.freq_to_increment(-cfg.input_offset, cfg.channel_rate))
    resamp_state, chips = resampler.resample_block(state.resamp, xm, cfg.resamp_plan)
    n = cfg.n_bins
    if chips.shape[-1] % n:
        raise ValueError(
            f"block yields {chips.shape[-1]} chips — not a multiple of 2^SF={n}; dropped "
            f"remainder chips would desynchronize symbol framing (size block_in via the "
            f"registry block_factor)")
    frames = chips.reshape(*chips.shape[:-1], chips.shape[-1] // n, n)
    spec = torch.fft.fft(frames * _device_taps(cfg, "base_downchirp", x.device), dim=-1).abs()
    mags, symbols = torch.max(spec, dim=-1)
    snr = mags / torch.clamp(torch.mean(spec, dim=-1), min=1e-12)
    return LoRaState(nco_state, resamp_state), LoRaOutputs(symbols.to(torch.int32), mags, snr)


def make_symbol_chirps(symbols: np.ndarray, cfg: LoRaConfig) -> np.ndarray:
    """LoRa upchirps of the given symbol values at the chip rate (numpy, for
    closing the loop in tests and on the card)."""
    n = cfg.n_bins
    k = np.arange(n, dtype=np.float64)
    out = []
    for s in symbols:
        kk = (k + float(s)) % n
        phase = 2.0 * np.pi * (kk * kk / (2.0 * n) - kk / 2.0)
        out.append(np.exp(1j * phase))
    return np.concatenate(out).astype(np.complex64)
