"""SSB/DSB demodulator (plugins/channelrx/demodssb/ssbdemod.cpp, feed
:147-280).

NCO mix → resample to the audio rate (2 taps per phase, cutoff 1.5×|bw|) →
a one-sample aligner → fftfilt runSSB (1024 points, band edges from
lowCutoff and bandwidth, USB or LSB) or runDSB → MagAGC with its squelch →
the step-down delay line, read with the current step value → volume/4 →
mono (re+im)·0.7, or binaural (..., T, 2).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..dsp import agc, fftfilt, nco, resampler
from .demod_nfm import _auto_block, _per_channel


@dataclasses.dataclass(frozen=True, eq=False)
class SSBConfig:
    channel_rate: float
    input_offset: float = 0.0
    audio_rate: float = 48000.0
    bandwidth: float = 3000.0  # signed in the reference; the sign picks the sideband
    low_cutoff: float = 300.0
    usb: bool = True
    dsb: bool = False
    volume: float = 1.0
    agc_enable: bool = True
    agc_power_threshold_db: float = -40.0
    agc_threshold_gate: int = 4  # milliseconds (ssbdemod.cpp:505)
    agc_time_log2: int = 7  # nbSamples = (rate/1000) << this
    audio_binaural: bool = False
    audio_flip_channels: bool = False
    audio_mute: bool = False
    fft_len: int = 1024  # ssbdemod.h ssbFftLen
    block_in: int = 0  # input samples per block (0 -> auto from the resampler ratio)

    @functools.cached_property
    def resampler_plan(self) -> resampler.ResamplerPlan:
        block = self.block_in or _auto_block(self.channel_rate, self.audio_rate)
        # ssbdemod.cpp:381: create(16, inputRate, bandwidth·1.5, 2.0), short
        # legs at 1.5× the SSB bandwidth
        return resampler.make_plan(self.channel_rate, self.audio_rate, block,
                                   cutoff=abs(self.bandwidth) * 1.5, nb_taps_per_phase=2.0)

    @functools.cached_property
    def filter_freq(self) -> np.ndarray:
        f_hi = abs(self.bandwidth) / self.audio_rate
        if self.dsb:
            return fftfilt.create_dsb_filter(f_hi, self.fft_len)
        return fftfilt.create_filter(self.low_cutoff / self.audio_rate, f_hi, self.fft_len)

    @functools.cached_property
    def agc_config(self) -> agc.MagAGCConfig:
        # ssbdemod.cpp:497-533: nbSamples = (audioRate/1000) << agcTimeLog2;
        # resize(nb, nb/2, agcTarget); stepDownDelay = nb; the gate in
        # milliseconds; agcTarget 3276.8 of 32768 full scale is 0.1 here
        nb = int(self.audio_rate / 1000) << self.agc_time_log2
        return agc.MagAGCConfig(
            order_r=0.1, history_size=nb,
            threshold=10.0 ** (self.agc_power_threshold_db / 10.0),
            threshold_enable=self.agc_enable,
            gate=int(self.audio_rate / 1000) * self.agc_threshold_gate,
            step_length=nb // 2, step_down_delay=nb, clamping=False)


class SSBState(NamedTuple):
    nco: nco.NCOState
    resamp: resampler.ResamplerState
    fft: fftfilt.FftFiltState
    agc: agc.MagAGCState
    #: the squelch delay line (ssbdemod.cpp:222-225): levelled samples are
    #: written, and audio reads them stepDownDelay samples later times the
    #: current step value, so the release cuts the tail and keeps the attack
    delay: torch.Tensor
    #: the one-sample aligner: the resampler's stream leads the reference's
    #: by one sample, and the sideband filter's OLA is framing-sensitive
    #: (its brickwall response outlasts the hop), so the filter's feed is
    #: delayed by one sample to restore the reference's framing (the ssb96
    #: golden: 60 dB without it, 118 dB with it)
    align: torch.Tensor


def make_state(cfg: SSBConfig, device: torch.device, batch_shape=()) -> SSBState:
    """A channel's state; with batch_shape (C,), a bank of C channels."""
    return SSBState(
        nco=nco.make_nco(device, batch_shape),
        resamp=resampler.init_state(cfg.resampler_plan, device, batch_shape),
        fft=fftfilt.make_state(cfg.fft_len, device, batch_shape),
        agc=agc.make_state(cfg.agc_config, device, batch_shape),
        delay=torch.zeros((*batch_shape, cfg.agc_config.step_down_delay),
                          dtype=torch.complex64, device=device),
        align=torch.zeros((*batch_shape, 1), dtype=torch.complex64, device=device),
    )


@functools.lru_cache(maxsize=None)
def _device_filter(cfg: SSBConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(cfg.filter_freq).to(device)


def process(
    state: SSBState, x: torch.Tensor, cfg: SSBConfig, offset_hz=None, volume=None,
) -> tuple[SSBState, torch.Tensor]:
    """(state, iq (..., block_in) complex64) -> (state', audio): mono
    (..., block_out), binaural (..., block_out, 2). offset_hz / volume
    override the cfg fields for this block, as in demod_nfm.process."""
    inc = nco.channel_increment(offset_hz, cfg.input_offset, cfg.channel_rate, x.device)
    nco_state, xm = nco.mix_block(state.nco, x, inc)
    resamp_state, ci = resampler.resample_block(state.resamp, xm, cfg.resampler_plan)
    ext = torch.cat([state.align, ci], dim=-1)
    ci, align_state = ext[..., :-1], ext[..., -1:].clone()

    h = _device_filter(cfg, x.device)
    if cfg.dsb:
        fft_state, filt = fftfilt.run_dsb(state.fft, ci, h)
    else:
        fft_state, filt = fftfilt.run_ssb(state.fft, ci, h, usb=cfg.usb)

    if cfg.agc_enable:
        agc_state, leveled, _, ramp = agc.mag_agc(state.agc, filt, cfg.agc_config)
        t = filt.shape[-1]
        ext = torch.cat([state.delay, leveled], dim=-1)
        leveled, new_delay = ext[..., :t] * ramp, ext[..., t:].clone()
    else:
        # AGC off passes the filter's output through. The reference at this
        # version mutes instead (its step value is never advanced,
        # ssbdemod.cpp:216-225 with agc.cpp:196-207); the JAX package keeps
        # the passthrough, and so does the port
        agc_state, leveled, new_delay = state.agc, filt, state.delay

    # m_volume = settings.m_volume / 4.0 (ssbdemod.cpp:493-494)
    vol = 0.0 if cfg.audio_mute else (
        cfg.volume if volume is None else _per_channel(volume, x)) / 4.0
    if cfg.audio_binaural:
        left, right = leveled.real, leveled.imag
        if cfg.audio_flip_channels:
            left, right = right, left
        vol = vol[..., None] if isinstance(vol, torch.Tensor) else vol
        audio = torch.stack([left, right], dim=-1) * vol
    else:
        audio = (leveled.real + leveled.imag) * 0.7 * vol  # ssbdemod.cpp:245
    return SSBState(nco_state, resamp_state, fft_state, agc_state, new_delay,
                    align_state), audio
