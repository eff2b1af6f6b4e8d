"""Channel analyzer: a filtered channel with spectrum and scope taps.

Reference: plugins/channelrx/chanalyzer/chanalyzer.{h,cpp}: NCO mix → the
SSB or DSB fftfilt (ssbFftLen 1024) → ScopeVis and SpectrumVis. The debug
and measurement channel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..dsp import fftfilt, nco, spectrum
from ..dsp.fftwindow import Function
from .demod_nfm import _device_taps


@dataclasses.dataclass(frozen=True, eq=False)
class ChanAnalyzerConfig:
    channel_rate: float
    input_offset: float = 0.0
    bandwidth: float = 5000.0
    low_cutoff: float = 300.0
    ssb: bool = False
    usb: bool = True
    fft_len: int = 1024  # chanalyzer.h:37 ssbFftLen
    spectrum_size: int = 1024

    @functools.cached_property
    def filter_freq(self) -> np.ndarray:
        if self.ssb:
            return fftfilt.create_filter(self.low_cutoff / self.channel_rate,
                                         self.bandwidth / self.channel_rate, self.fft_len)
        return fftfilt.create_dsb_filter(self.bandwidth / self.channel_rate, self.fft_len)

    @functools.cached_property
    def spectrum_cfg(self) -> spectrum.SpectrumConfig:
        return spectrum.SpectrumConfig(fft_size=self.spectrum_size, window=Function.HANNING,
                                       averaging_mode="moving", averaging_n=8)


class ChanAnalyzerState(NamedTuple):
    nco: nco.NCOState
    fft: fftfilt.FftFiltState
    spec: spectrum.SpectrumState


def make_state(cfg: ChanAnalyzerConfig, device: torch.device, batch_shape=()
               ) -> ChanAnalyzerState:
    return ChanAnalyzerState(
        nco=nco.make_nco(device, batch_shape),
        fft=fftfilt.make_state(cfg.fft_len, device, batch_shape),
        spec=spectrum.make_state(cfg.spectrum_cfg, device),
    )


class ChanAnalyzerOutputs(NamedTuple):
    iq: torch.Tensor  # the filtered channel (the scope's feed)
    spectrum: torch.Tensor  # display spectrum
    channel_power_db: torch.Tensor


def process(state: ChanAnalyzerState, x: torch.Tensor, cfg: ChanAnalyzerConfig
            ) -> tuple[ChanAnalyzerState, ChanAnalyzerOutputs]:
    nco_state, xm = nco.mix_block(
        state.nco, x, nco.freq_to_increment(-cfg.input_offset, cfg.channel_rate))
    h = _device_taps(cfg, "filter_freq", x.device)
    if cfg.ssb:
        fft_state, y = fftfilt.run_ssb(state.fft, xm, h, usb=cfg.usb)
    else:
        fft_state, y = fftfilt.run_filt(state.fft, xm, h)
    spec_state, sp = spectrum.power_spectrum(state.spec, y, cfg.spectrum_cfg)
    power = torch.mean(y.real ** 2 + y.imag ** 2, dim=-1)
    power_db = 10.0 * torch.log10(torch.clamp(power, min=1e-30))
    return (ChanAnalyzerState(nco_state, fft_state, spec_state),
            ChanAnalyzerOutputs(y, sp, power_db))
