"""UDPSrc: an Rx channel that forwards the channel's I/Q or its
demodulated stream.

Reference: plugins/channelrx/udpsrc/udpsrc.{h,cpp}: NCO mix → resample to
the output rate → optional AGC → a branch per format (I/Q, mono, LSB/USB
through fftfilt, the NFM discriminator, the AM magnitude; udpsrc.h:200-313)
→ UDPSink datagrams. This is the device part: the formatted stream of each
block. Sending it over UDP is the egress of ROADMAP.md queue 1, item 12.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..dsp import agc, fftfilt, movingavg, nco, phasediscri, resampler
from .demod_nfm import _auto_block, _device_taps

#: device-side output formats: iq carries the complex stream, the others
#: the scalar branch
FORMATS = ("iq", "mono", "lsb", "usb", "nfm", "am")


@dataclasses.dataclass(frozen=True, eq=False)
class UdpSrcConfig:
    channel_rate: float
    input_offset: float = 0.0
    output_sample_rate: float = 48_000.0  # udpsrc.h m_outputSampleRate
    rf_bandwidth: float = 12_500.0
    fmt: str = "iq"  # FORMATS
    gain: float = 1.0
    squelch_db: float = -60.0
    squelch_enabled: bool = True
    agc_enable: bool = False  # MagAGC ahead of the format branch (udpsrc.cpp)
    fm_deviation: float = 2500.0
    fft_len: int = 1024
    audio_active: bool = False  # reserved: the reverse audio path (udpsink role)
    block_in: int = 0

    @functools.cached_property
    def resampler_plan(self) -> resampler.ResamplerPlan:
        block = self.block_in or _auto_block(self.channel_rate, self.output_sample_rate)
        return resampler.make_plan(self.channel_rate, self.output_sample_rate, block,
                                   cutoff=self.rf_bandwidth / 2.0)

    @functools.cached_property
    def ssb_filter(self) -> np.ndarray:
        return fftfilt.create_filter(
            0.0, (self.rf_bandwidth / 2.0) / self.output_sample_rate, self.fft_len)

    @functools.cached_property
    def agc_config(self) -> agc.MagAGCConfig:
        return agc.MagAGCConfig(order_r=1.0, threshold_enable=False)


class UdpSrcState(NamedTuple):
    nco: nco.NCOState
    resamp: resampler.ResamplerState
    mavg: movingavg.MovingAvgState
    fft: fftfilt.FftFiltState
    discri: phasediscri.DiscriminatorState
    agc: agc.MagAGCState


class UdpSrcOutputs(NamedTuple):
    iq: torch.Tensor  # (..., T_out) complex64, the resampled channel stream
    scalar: torch.Tensor  # (..., T_out) float32, the demod branch (mono/nfm/am/ssb re+im)
    power: torch.Tensor  # (...,) mean magsq
    squelch_open: torch.Tensor  # (...,) bool


def make_state(cfg: UdpSrcConfig, device: torch.device, batch_shape=()) -> UdpSrcState:
    return UdpSrcState(
        nco=nco.make_nco(device, batch_shape),
        resamp=resampler.init_state(cfg.resampler_plan, device, batch_shape),
        mavg=movingavg.make_state(480, device, batch_shape),
        fft=fftfilt.make_state(cfg.fft_len, device, batch_shape),
        discri=phasediscri.make_state(device, batch_shape),
        agc=agc.make_state(cfg.agc_config, device, batch_shape),
    )


def process(state: UdpSrcState, x: torch.Tensor, cfg: UdpSrcConfig, offset_hz=None,
            squelch_db=None) -> tuple[UdpSrcState, UdpSrcOutputs]:
    """(state, iq (..., block_in) complex64) -> (state', UdpSrcOutputs).
    offset_hz / squelch_db override the cfg fields for this block, as in
    demod_nfm.process."""
    if cfg.fmt not in FORMATS:
        raise ValueError(f"udpsrc fmt {cfg.fmt!r}; choose from {FORMATS}")
    inc = nco.channel_increment(offset_hz, cfg.input_offset, cfg.channel_rate, x.device)
    nco_state, xm = nco.mix_block(state.nco, x, inc)
    resamp_state, ci = resampler.resample_block(state.resamp, xm, cfg.resampler_plan)

    magsq = ci.real ** 2 + ci.imag ** 2
    mavg_state, avg = movingavg.moving_average(state.mavg, magsq)
    level = 10.0 ** ((cfg.squelch_db if squelch_db is None else squelch_db) / 10.0)
    gate = avg >= level if cfg.squelch_enabled else torch.ones_like(avg, dtype=torch.bool)

    agc_state, fft_state, discri_state = state.agc, state.fft, state.discri
    if cfg.agc_enable:
        agc_state, ci, _, _ = agc.mag_agc(state.agc, ci, cfg.agc_config)
    ci = torch.where(gate, ci, 0.0) * cfg.gain

    if cfg.fmt in ("lsb", "usb"):
        fft_state, filt = fftfilt.run_ssb(
            state.fft, ci, _device_taps(cfg, "ssb_filter", x.device), usb=cfg.fmt == "usb")
        scalar = filt.real + filt.imag  # udpsrc.cpp's USB/LSB sum
        iq_out = filt
    elif cfg.fmt == "nfm":
        # fs/(2·dev): discriminator_delta works in units of π, so the full
        # deviation maps to ±1.0, as in demod_nfm
        discri_state, demod, _ = phasediscri.discriminator_delta(
            state.discri, ci, cfg.output_sample_rate / (2.0 * cfg.fm_deviation))
        scalar = torch.where(gate, demod, 0.0)
        iq_out = ci
    elif cfg.fmt == "am":
        scalar = torch.sqrt(magsq) * cfg.gain
        scalar = torch.where(gate, scalar - torch.mean(scalar, dim=-1, keepdim=True), 0.0)
        iq_out = ci
    else:  # iq / mono
        scalar = ci.real.contiguous()
        iq_out = ci

    outs = UdpSrcOutputs(iq=iq_out, scalar=scalar, power=torch.mean(magsq, dim=-1),
                         squelch_open=torch.any(gate, dim=-1))
    return (UdpSrcState(nco_state, resamp_state, mavg_state, fft_state, discri_state,
                        agc_state), outs)
