"""Broadcast FM: the stereo multiplex and the RDS baseband
(plugins/channelrx/demodbfm/bfmdemod.cpp, feed :116-260).

NCO mix → the ±rfBw/2 fftfilt (DSB) → the magsq squelch with an rfBw/10
attack → the phase discriminator → the MPX. The 19 kHz pilot is taken with
a narrow complex (analytic) bandpass, as the JAX package does: its unit
phasor z/|z| is e^{jθ}, and the 38 and 57 kHz references are its powers,
so the stereo and RDS downmixes need no per-sample loop (the scan-based
pilot PLL stays in dsp/phaselock.py). The MPX is delayed by the pilot
filter's group delay; mono (L+R) and the 38 kHz product-demodulated L−R go
through the audio resampler, then the 50 µs deemphasis per channel; the
57 kHz downmix goes through a ±2.4 kHz lowpass and a resampler to 9.5 kHz
(8 samples per RDS symbol) for a host decoder.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch

from ..dsp import fftfilt, firdesign, iir, nco, phasediscri, resampler
from ..dsp.scanops import saturating_counter
from .demod_nfm import _device_taps, _per_channel

PILOT_FREQ = 19000.0
RDS_SYMBOL_RATE = 1187.5
RDS_SPS = 8  # samples per symbol in the emitted RDS baseband


def _numerator(in_rate: float, out_rate: float) -> int:
    return Fraction(in_rate / out_rate).limit_denominator(1 << 20).numerator


@dataclasses.dataclass(frozen=True, eq=False)
class BFMConfig:
    channel_rate: float  # e.g. 192000 or 384000
    input_offset: float = 0.0
    audio_rate: float = 48000.0
    rf_bandwidth: float = 180000.0
    af_bandwidth: float = 15000.0
    fm_deviation: float = 75000.0
    squelch_db: float = -60.0
    volume: float = 1.0
    audio_stereo: bool = True
    deemphasis_us: float = 50.0
    rds_active: bool = False
    fft_len: int = 1024
    block_in: int = 0  # input samples per block (0 -> auto, see mono_plan)

    @functools.cached_property
    def rf_filter(self) -> np.ndarray:
        return fftfilt.create_dsb_filter(0.5 * self.rf_bandwidth / self.channel_rate,
                                         self.fft_len)

    @functools.cached_property
    def pilot_taps(self) -> np.ndarray:
        """The complex analytic bandpass at 19 kHz (±400 Hz). Its group
        delay is padded to a multiple of the mono resampler's input stride
        p, so the MPX delayed by as much stays on the resampler's output
        grid (a fractional output-sample shift no integer lag absorbs)."""
        p = self.mono_plan.p
        gd = -(-250 // p) * p
        n = 2 * gd + 1
        lp = firdesign.lowpass(n, 400.0 / self.channel_rate).astype(np.float64)
        k = np.arange(n) - n // 2
        return (2.0 * lp * np.exp(1j * 2.0 * np.pi * PILOT_FREQ / self.channel_rate * k)
                ).astype(np.complex64)

    @functools.cached_property
    def mono_plan(self) -> resampler.ResamplerPlan:
        block = self.block_in
        if not block:  # whole fft hops and both resamplers' numerators
            block = math.lcm(self.fft_len // 2, _numerator(self.channel_rate, self.audio_rate),
                             _numerator(self.channel_rate, RDS_SYMBOL_RATE * RDS_SPS), 4)
            while block < 4096:
                block *= 2
        return resampler.make_plan(self.channel_rate, self.audio_rate, block,
                                   cutoff=self.af_bandwidth)

    @functools.cached_property
    def rds_plan(self) -> resampler.ResamplerPlan:
        return resampler.make_plan(self.channel_rate, RDS_SYMBOL_RATE * RDS_SPS,
                                   self.mono_plan.block_in, cutoff=2400.0)

    @functools.cached_property
    def rds_prefilter(self) -> np.ndarray:
        """±2.4 kHz lowpass at the channel rate ahead of the ~40× RDS
        decimation (the rdsdemod.cpp filter_lp_2400_iq role)."""
        return firdesign.lowpass(801, 2400.0 / self.channel_rate)

    @property
    def fm_scaling(self) -> float:
        return self.channel_rate / (2.0 * self.fm_deviation)


class BFMState(NamedTuple):
    nco: nco.NCOState
    fft: fftfilt.FftFiltState
    squelch_count: torch.Tensor
    discri: phasediscri.DiscriminatorState
    pilot_fir: firdesign.FirState  # complex tail of the pilot filter's input
    mpx_delay: torch.Tensor  # the MPX delayed by the pilot filter's group delay
    mono_resamp: resampler.ResamplerState
    stereo_resamp: resampler.ResamplerState
    rds_fir: firdesign.FirState
    rds_resamp: resampler.ResamplerState
    deemph_l: iir.Iir1State
    deemph_r: iir.Iir1State


def make_state(cfg: BFMConfig, device: torch.device, batch_shape=()) -> BFMState:
    n_taps = len(cfg.pilot_taps)
    return BFMState(
        nco=nco.make_nco(device, batch_shape),
        fft=fftfilt.make_state(cfg.fft_len, device, batch_shape),
        squelch_count=torch.zeros(batch_shape, dtype=torch.float32, device=device),
        discri=phasediscri.make_state(device, batch_shape),
        pilot_fir=firdesign.make_state(n_taps, device, batch_shape, torch.complex64),
        mpx_delay=torch.zeros((*batch_shape, (n_taps - 1) // 2), dtype=torch.float32,
                              device=device),
        mono_resamp=resampler.init_state(cfg.mono_plan, device, batch_shape),
        stereo_resamp=resampler.init_state(cfg.mono_plan, device, batch_shape),
        rds_fir=firdesign.make_state(len(cfg.rds_prefilter), device, batch_shape,
                                     torch.complex64),
        rds_resamp=resampler.init_state(cfg.rds_plan, device, batch_shape),
        deemph_l=iir.make_iir1(device, batch_shape),
        deemph_r=iir.make_iir1(device, batch_shape),
    )


def _complex_fir(state: firdesign.FirState, x_real: torch.Tensor, cfg: BFMConfig):
    """The real MPX through the complex pilot taps: two real FIRs over one
    extended buffer. The state keeps the tail complex, as the JAX state."""
    n = len(cfg.pilot_taps)
    ext = torch.cat([state.tail.real, x_real], dim=-1)
    tail = firdesign.FirState(ext[..., :n - 1])
    taps = _device_taps(cfg, "pilot_taps", x_real.device)
    _, yr = firdesign.fir_apply(tail, x_real, taps.real.contiguous())
    _, yi = firdesign.fir_apply(tail, x_real, taps.imag.contiguous())
    new_tail = ext[..., x_real.shape[-1]:].to(torch.complex64)
    return firdesign.FirState(new_tail), torch.complex(yr, yi)


class BFMOutputs(NamedTuple):
    audio: torch.Tensor  # (..., A, 2) stereo float32
    rds_baseband: torch.Tensor  # (..., R) complex64 at 9500 Hz (8 samples per symbol)
    pilot_level: torch.Tensor  # (...,) mean pilot magnitude (the lock indicator)


def process(state: BFMState, x: torch.Tensor, cfg: BFMConfig, offset_hz=None,
            squelch_db=None, volume=None) -> tuple[BFMState, BFMOutputs]:
    """(state, iq (..., block_in) complex64) -> (state', BFMOutputs).
    offset_hz / squelch_db / volume override the cfg fields for this block,
    as in demod_nfm.process."""
    squelch_db = cfg.squelch_db if squelch_db is None else _per_channel(squelch_db, x)
    inc = nco.channel_increment(offset_hz, cfg.input_offset, cfg.channel_rate, x.device)
    nco_state, xm = nco.mix_block(state.nco, x, inc)
    fft_state, rf = fftfilt.run_filt(state.fft, xm, _device_taps(cfg, "rf_filter", x.device))

    magsq = rf.real ** 2 + rf.imag ** 2
    attack = cfg.rf_bandwidth / 10.0  # bfmdemod.cpp:148 squelch attack
    counts = saturating_counter(torch.where(magsq >= 10.0 ** (squelch_db / 10.0), 1.0, -1.0),
                                0.0, attack, state.squelch_count)
    discri_state, demod = phasediscri.discriminator_conj(state.discri, rf, cfg.fm_scaling)
    demod = torch.where(counts > attack / 2.0, demod, 0.0)  # the MPX

    # the pilot and its harmonics; the MPX is delayed by the linear-phase
    # pilot filter's (ntaps − 1)/2 so the references stay aligned with it
    pilot_state, z = _complex_fir(state.pilot_fir, demod, cfg)
    mpx_ext = torch.cat([state.mpx_delay, demod], dim=-1)
    demod = mpx_ext[..., :demod.shape[-1]]
    mag = torch.abs(z)
    unit = z / torch.clamp(mag, min=1e-9)
    e2 = unit * unit  # e^{j2θ}: the 38 kHz reference
    e3 = e2 * unit  # e^{j3θ}: the 57 kHz reference

    mono_state, mono_c = resampler.resample_block(
        state.mono_resamp, demod.to(torch.complex64), cfg.mono_plan)
    # L−R: the 38 kHz DSB subcarrier is sin(2θ) for a sin(θ) pilot (ITU-R
    # BS.450); the analytic pilot is ∝ −i·e^{iθ}, so the recovered term is
    # +Im(e2) (a cos/cos multiplex would be orthogonal to broadcasts)
    stereo_state, stereo_c = resampler.resample_block(
        state.stereo_resamp, (demod * 2.0 * e2.imag).to(torch.complex64), cfg.mono_plan)
    mono, diff = mono_c.real, stereo_c.real
    left, right = (mono + diff, mono - diff) if cfg.audio_stereo else (mono, mono)
    tau = cfg.deemphasis_us * 1e-6 * cfg.audio_rate
    dl_state, left = iir.rc_lowpass(state.deemph_l, left, tau)
    dr_state, right = iir.rc_lowpass(state.deemph_r, right, tau)
    vol = cfg.volume if volume is None else _per_channel(volume, x)
    if isinstance(vol, torch.Tensor):
        vol = vol[..., None]  # over the (A, 2) frame axes
    audio = torch.stack([left, right], dim=-1) * vol

    # RDS: the coherent 57 kHz downmix, ±2.4 kHz, 8 samples per symbol
    rds_fir_state, rds_bb = firdesign.fir_apply(
        state.rds_fir, demod.to(torch.complex64) * torch.conj(e3),
        _device_taps(cfg, "rds_prefilter", x.device))
    rds_state, rds_out = resampler.resample_block(state.rds_resamp, rds_bb, cfg.rds_plan)

    new_state = BFMState(
        nco=nco_state, fft=fft_state, squelch_count=counts[..., -1].clone(),
        discri=discri_state, pilot_fir=pilot_state,
        mpx_delay=mpx_ext[..., demod.shape[-1]:].clone(), mono_resamp=mono_state,
        stereo_resamp=stereo_state, rds_fir=rds_fir_state, rds_resamp=rds_state,
        deemph_l=dl_state, deemph_r=dr_state,
    )
    return new_state, BFMOutputs(audio, rds_out, mag.mean(dim=-1))


def meters(state: BFMState, cfg: BFMConfig, dyn: dict) -> dict:
    return {"squelch": state.squelch_count > cfg.rf_bandwidth / 20.0}
