"""Tx modulators: NFM, AM, SSB and WFM.

Reference: plugins/channeltx/mod{nfm,am,ssb,wfm}/*.cpp — per sample: pull
the AF (tone, file, keyer), modulateSample, Interpolator to the channel
rate, then the carrier NCO (`ci *= m_carrierNco.nextIQ()`). Block form, as
in the JAX package (sdrangel_tpu/channels/modulators.py): the 48 kHz AF
block is modulated at the audio rate, interpolated to the channel rate by
the resampler's interpolation schedule and shifted by the carrier NCO; WFM
interpolates first and modulates at the channel rate. The UpChannelizer
(dsp/interpolators.py) then places the channel in the device band.

The FM phase is the running sum of the phase steps with a carried phase.
The port sums it in float64 (JAX: a float32 cumulative sum, whose error
grows with the block), so the card and the CPU give the same phase to f32
rounding; ROADMAP.md §3 records the divergence.

The ATV modulator (ATVModConfig, atv_modulate) waits for ATV: ROADMAP.md
queue 1, item 6.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..dsp import fftfilt, firdesign, nco, resampler

_TWO_PI = 2.0 * np.pi


def _up_plan(audio_rate: float, channel_rate: float, block_af: int,
             cutoff: float | None = None) -> resampler.ResamplerPlan:
    """The AF-to-channel-rate interpolator every channeltx modulator creates:
    Interpolator::create(48, audioRate, bw, 3.0) (nfmmod.cpp:423,
    ammod.cpp:407, ssbmod.cpp:659, wfmmod.cpp:427); make_plan clamps the
    cutoff below the input Nyquist."""
    return resampler.make_plan(audio_rate, channel_rate, block_af, cutoff=cutoff,
                               phase_steps=48, nb_taps_per_phase=3.0)


def _mod_inc(cfg, offset_hz, device: torch.device):
    """The carrier NCO's increment: cfg.input_offset on the host in float64,
    or an override (a number, or a tensor of the batch shape) as the f32
    increment JAX computes under jit."""
    if offset_hz is None:
        return nco.freq_to_increment(cfg.input_offset, cfg.channel_rate)
    offset = torch.as_tensor(offset_hz, dtype=torch.float32, device=device)
    return nco.freq_to_increment_traced(offset, cfg.channel_rate)


def _integrate(phase0: torch.Tensor, dphi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(phase0[..., None] + running sum of dphi (..., T), the last phase
    wrapped to [0, 2π)), summed in float64, returned as float32."""
    phase = phase0.to(torch.float64)[..., None] + torch.cumsum(dphi.to(torch.float64), dim=-1)
    return phase.to(torch.float32), torch.remainder(phase[..., -1], _TWO_PI).to(torch.float32)


def _phasor(phase: torch.Tensor, amplitude: float) -> torch.Tensor:
    """amplitude · e^{iφ} as complex64."""
    return torch.polar(torch.ones_like(phase), phase) * amplitude


# ---------------------------------------------------------------------------
# NFM / WFM — frequency modulation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class FMModConfig:
    channel_rate: float
    input_offset: float = 0.0
    audio_rate: float = 48000.0
    fm_deviation: float = 5000.0
    af_bandwidth: float = 3000.0  # AF filter before modulation
    rf_bandwidth: float = 12500.0
    amplitude: float = 0.891  # -1 dB, as the reference modulators
    block_af: int = 4096
    #: AF chain: "lowpass", a unity-gain lowpass with the 2π·f_dev/fs phase
    #: step (the WFM modulator's convention, wfmmod.cpp:142); "nfm_ref", the
    #: NFM modulator's own chain — its Bandpass(300..af_bw) with the
    #: near-zero-DC-sum normalisation, folded with the π/378 phase step
    #: (nfmmod.cpp:177) as a /756 on the taps, so fmDeviation settings carry
    #: over 1:1
    af_filter: str = "lowpass"
    #: CTCSS sub-audible tone (nfmmod.cpp:170-172): the phase step mixes
    #: 0.85·af + 0.15·378·ctcss
    ctcss_on: bool = False
    ctcss_freq: float = 88.5

    @functools.cached_property
    def up(self) -> resampler.ResamplerPlan:
        return _up_plan(self.audio_rate, self.channel_rate, self.block_af,
                        cutoff=self.rf_bandwidth / 2.2)

    @functools.cached_property
    def af_taps(self) -> np.ndarray:
        if self.af_filter == "nfm_ref":
            # (f_dev/fs)·bp(t)·(π/378) = (2π·f_dev/fs)·bp(t)/756, bp the
            # response the reference's ring walk applies
            return firdesign.bandpass_ring_kernel(
                301, self.audio_rate, 300.0, self.af_bandwidth) / 756.0
        return firdesign.lowpass(301, self.af_bandwidth / self.audio_rate)


class FMModState(NamedTuple):
    af_filter: firdesign.FirState
    phase: torch.Tensor  # (...,) float32 carried FM phase (radians)
    up: resampler.ResamplerState
    nco: nco.NCOState
    ctcss_phase: torch.Tensor  # (...,) float32 carried CTCSS tone phase


def make_fm_state(cfg: FMModConfig, device: torch.device, batch_shape=()) -> FMModState:
    """A channel's state; with batch_shape (C,), a bank of C channels."""
    return FMModState(
        firdesign.make_state(len(cfg.af_taps), device, batch_shape),
        torch.zeros(batch_shape, dtype=torch.float32, device=device),
        resampler.init_state(cfg.up, device, batch_shape),
        nco.make_nco(device, batch_shape),
        torch.zeros(batch_shape, dtype=torch.float32, device=device),
    )


@functools.lru_cache(maxsize=None)
def _device_af_taps(cfg: FMModConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(cfg.af_taps).to(device)


def fm_modulate(
    state: FMModState, af: torch.Tensor, cfg: FMModConfig, offset_hz=None
) -> tuple[FMModState, torch.Tensor]:
    """af (..., block_af) float32 in [-1, 1] -> (state', iq (...,
    block_af·q/p) complex64 at the channel rate). offset_hz overrides
    cfg.input_offset, per channel for a bank."""
    fir_state, af_f = firdesign.fir_apply(state.af_filter, af, _device_af_taps(cfg, af.device))
    ctcss_phase = state.ctcss_phase
    if cfg.ctcss_on:
        # (f_dev/fs)·(0.85·bp + 0.15·378·c)·(π/378) = (2π·f_dev/fs)·(0.85·bp/756
        # + 0.15·c/2); the taps carry the /756
        inc = np.float32(_TWO_PI * cfg.ctcss_freq / cfg.audio_rate)
        ph = state.ctcss_phase[..., None] + inc * torch.arange(
            1, af.shape[-1] + 1, dtype=torch.float32, device=af.device)
        af_f = 0.85 * af_f + 0.075 * torch.cos(ph)
        ctcss_phase = torch.remainder(ph[..., -1], _TWO_PI)
    dphi = (_TWO_PI * cfg.fm_deviation / cfg.audio_rate) * af_f
    phase, new_phase = _integrate(state.phase, dphi)
    up_state, up = resampler.resample_block(state.up, _phasor(phase, cfg.amplitude), cfg.up)
    nco_state, out = nco.mix_block(state.nco, up, _mod_inc(cfg, offset_hz, af.device))
    return FMModState(fir_state, new_phase, up_state, nco_state, ctcss_phase), out


@dataclasses.dataclass(frozen=True, eq=False)
class NFMModConfig(FMModConfig):
    """The NFM Tx channel: FM through the reference NFMMod AF chain
    (plugins/channeltx/modnfm/nfmmod.cpp:162-182)."""

    af_filter: str = "nfm_ref"


# ---------------------------------------------------------------------------
# AM
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class AMModConfig:
    channel_rate: float
    input_offset: float = 0.0
    audio_rate: float = 48000.0
    mod_factor: float = 0.5  # modulation depth (ammod.cpp:165)
    rf_bandwidth: float = 12500.0
    amplitude: float = 0.5
    block_af: int = 4096

    @functools.cached_property
    def up(self) -> resampler.ResamplerPlan:
        return _up_plan(self.audio_rate, self.channel_rate, self.block_af,
                        cutoff=self.rf_bandwidth / 2.2)


class AMModState(NamedTuple):
    up: resampler.ResamplerState
    nco: nco.NCOState


def make_am_state(cfg: AMModConfig, device: torch.device, batch_shape=()) -> AMModState:
    return AMModState(resampler.init_state(cfg.up, device, batch_shape),
                      nco.make_nco(device, batch_shape))


def am_modulate(
    state: AMModState, af: torch.Tensor, cfg: AMModConfig, offset_hz=None
) -> tuple[AMModState, torch.Tensor]:
    """The envelope (af·m + 1)·A (ammod.cpp:165), interpolated and mixed."""
    env = (af * cfg.mod_factor + 1.0) * cfg.amplitude
    up_state, up = resampler.resample_block(state.up, env.to(torch.complex64), cfg.up)
    nco_state, out = nco.mix_block(state.nco, up, _mod_inc(cfg, offset_hz, af.device))
    return AMModState(up_state, nco_state), out


# ---------------------------------------------------------------------------
# SSB
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class SSBModConfig:
    channel_rate: float
    input_offset: float = 0.0
    audio_rate: float = 48000.0
    bandwidth: float = 3000.0
    low_cutoff: float = 300.0
    usb: bool = True
    amplitude: float = 0.891
    fft_len: int = 1024
    block_af: int = 4096

    @functools.cached_property
    def up(self) -> resampler.ResamplerPlan:
        return _up_plan(self.audio_rate, self.channel_rate, self.block_af,
                        cutoff=self.bandwidth)

    @functools.cached_property
    def filter_freq(self) -> np.ndarray:
        return fftfilt.create_filter(
            self.low_cutoff / self.audio_rate, self.bandwidth / self.audio_rate, self.fft_len)


class SSBModState(NamedTuple):
    fft: fftfilt.FftFiltState
    up: resampler.ResamplerState
    nco: nco.NCOState


def make_ssb_state(cfg: SSBModConfig, device: torch.device, batch_shape=()) -> SSBModState:
    return SSBModState(
        fftfilt.make_state(cfg.fft_len, device, batch_shape),
        resampler.init_state(cfg.up, device, batch_shape),
        nco.make_nco(device, batch_shape),
    )


@functools.lru_cache(maxsize=None)
def _device_ssb_filter(cfg: SSBModConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(cfg.filter_freq).to(device)


def ssb_modulate(
    state: SSBModState, af: torch.Tensor, cfg: SSBModConfig, offset_hz=None
) -> tuple[SSBModState, torch.Tensor]:
    """Real audio to the analytic SSB signal through runSSB (ssbmod.cpp
    pullAF), interpolated and mixed."""
    fft_state, ssb = fftfilt.run_ssb(state.fft, af.to(torch.complex64),
                                     _device_ssb_filter(cfg, af.device), usb=cfg.usb)
    up_state, up = resampler.resample_block(state.up, ssb * cfg.amplitude, cfg.up)
    nco_state, out = nco.mix_block(state.nco, up, _mod_inc(cfg, offset_hz, af.device))
    return SSBModState(fft_state, up_state, nco_state), out


# ---------------------------------------------------------------------------
# WFM — FM with a wide deviation and an RF filter
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class WFMModConfig:
    channel_rate: float
    input_offset: float = 0.0
    audio_rate: float = 48000.0
    fm_deviation: float = 75000.0
    af_bandwidth: float = 15000.0
    rf_bandwidth: float = 180000.0
    amplitude: float = 0.891
    fft_len: int = 1024
    block_af: int = 4096

    @functools.cached_property
    def up(self) -> resampler.ResamplerPlan:
        # wfmmod.cpp:454 create(48, audioRate, rfBw/2.2, 3.0); the cutoff
        # exceeds the audio Nyquist for a wide rfBw and make_plan clamps it
        return _up_plan(self.audio_rate, self.channel_rate, self.block_af,
                        cutoff=self.rf_bandwidth / 2.2)

    @functools.cached_property
    def rf_filter(self) -> np.ndarray:
        # wfmmod.cpp:455-457: the band form create_filter(-rfBw/2, +rfBw/2)
        fc = 0.5 * self.rf_bandwidth / self.channel_rate
        return fftfilt.create_filter(-fc, fc, self.fft_len)


class WFMModState(NamedTuple):
    up: resampler.ResamplerState
    phase: torch.Tensor  # (...,) float32 carried FM phase (radians)
    fft: fftfilt.FftFiltState
    nco: nco.NCOState


def make_wfm_state(cfg: WFMModConfig, device: torch.device, batch_shape=()) -> WFMModState:
    return WFMModState(
        resampler.init_state(cfg.up, device, batch_shape),
        torch.zeros(batch_shape, dtype=torch.float32, device=device),
        fftfilt.make_state(cfg.fft_len, device, batch_shape),
        nco.make_nco(device, batch_shape),
    )


@functools.lru_cache(maxsize=None)
def _device_rf_filter(cfg: WFMModConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(cfg.rf_filter).to(device)


def wfm_modulate(
    state: WFMModState, af: torch.Tensor, cfg: WFMModConfig, offset_hz=None
) -> tuple[WFMModState, torch.Tensor]:
    """The reference WFM order (wfmmod.cpp pull:110-160): interpolate the AF
    to the channel rate, FM-modulate there with the 2π·f_dev/fs step
    (:142), filter with the ±rfBw/2 overlap-add band filter, mix. (At the
    audio rate the wide deviation would alias.)"""
    up_state, afi = resampler.resample_block(state.up, af.to(torch.complex64), cfg.up)
    dphi = (_TWO_PI * cfg.fm_deviation / cfg.channel_rate) * afi.real
    phase, new_phase = _integrate(state.phase, dphi)
    fft_state, rf = fftfilt.run_filt(state.fft, _phasor(phase, cfg.amplitude),
                                     _device_rf_filter(cfg, af.device))
    nco_state, out = nco.mix_block(state.nco, rf, _mod_inc(cfg, offset_hz, af.device))
    return WFMModState(up_state, new_phase, fft_state, nco_state), out
