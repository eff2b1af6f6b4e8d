"""AM demodulator, envelope detection (plugins/channelrx/demodam/amdemod.cpp,
processOneSample :152-260).

NCO mix by the channel offset → polyphase resample to the audio rate →
power squelch on a 1024-sample magsq average → the envelope √magsq
normalised by its audioRate/10 trailing mean, (env − mean)/mean, so that
loudness follows the modulation depth and not the carrier level → the
squelch gate (480 samples) → the 300..rfBw/2 audio bandpass (the reference
ring filter's response /301) or a block-mean DC removal → volume.

PLL-synchronous AM (`sync_am`, amdemod.cpp:191-251) replaces the envelope:
the PLL (K-PLL on the card) locks a carrier to the channel, the mix
j·ci·conj(carrier) goes through a one-sample aligner, the SSB (0..rfBw) or
DSB fftfilt with DC dropped and the sync MagAGC, and the audio is
(re + im)·4. `ref_pll_parity` swaps in the reference's exact
PhaseLockComplex loop behind its 200 Hz complex prefilter. `AMState` holds
every field of the JAX AMState under its name, so a JAX state carries
across whole.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..dsp import agc, fftfilt, firdesign, movingavg, nco, phaselock, resampler, squelch
from .demod_nfm import _auto_block, _device_taps, _per_channel

_SQUELCH_GATE = 480  # 10 ms at 48 kHz (the amdemod squelch gate)


@dataclasses.dataclass(frozen=True, eq=False)
class AMConfig:
    channel_rate: float
    input_offset: float = 0.0
    audio_rate: float = 48000.0
    rf_bandwidth: float = 5000.0
    squelch_db: float = -40.0
    volume: float = 1.0
    audio_mute: bool = False
    bandpass_enable: bool = True  # the 300..rfBw/2 audio bandpass
    sync_am: bool = False  # PLL-synchronous detection
    sync_usb: bool = True  # the sideband the sync mode keeps (SSB filter)
    sync_dsb: bool = False  # SyncAMDSB: double-sideband sync detection
    block_in: int = 0  # input samples per block (0 -> auto from the resampler ratio)
    # test-only: the reference's exact PhaseLockComplex loop (wn 0.05, zeta
    # 0.707, K 1000, amdemod.cpp:86) behind its 101-tap 200 Hz complex
    # prefilter (amdemod.cpp:85,194)
    ref_pll_parity: bool = False
    # test-only: delay the sync fftfilt's feed by this many samples, which
    # moves its overlap-add framing to the reference's squelch-open instant
    # (amdemod.cpp:187-191)
    sync_frame_offset: int = 0
    # test-only: the reference's fs/4096 NCO tuning grid
    # (nco.freq_to_increment_ref_quant)
    ref_nco_quant: bool = False

    @functools.cached_property
    def resampler_plan(self) -> resampler.ResamplerPlan:
        block = self.block_in or _auto_block(self.channel_rate, self.audio_rate)
        # cutoff rf/2.2 as amdemod.cpp:370
        return resampler.make_plan(
            self.channel_rate, self.audio_rate, block, cutoff=self.rf_bandwidth / 2.2)

    @functools.cached_property
    def bandpass_taps(self) -> np.ndarray:
        # Bandpass::create(301, rate, 300, rfBandwidth/2) (amdemod.cpp:373)
        # through the ring-walk response, with the /301 of amdemod.cpp:249:
        # together they carry the reference's loudness over exactly
        return firdesign.bandpass_ring_kernel(
            301, self.audio_rate, 300.0, self.rf_bandwidth / 2.0) / 301.0

    @functools.cached_property
    def sync_fft_len(self) -> int:
        return 2048 if self.sync_dsb else 1024

    @functools.cached_property
    def sync_filter(self) -> np.ndarray:
        """The sync sideband filter (amdemod.cpp:72-73): SSBFilter over
        0..rfBandwidth, or DSBFilter over 2·rfBandwidth at twice the length
        with its DC bin zeroed (runDSB(..., false))."""
        if self.sync_dsb:
            h = np.array(fftfilt.create_dsb_filter(
                (2.0 * self.rf_bandwidth) / self.audio_rate, 2048))
            h[0] = 0.0
            return h
        return fftfilt.create_filter(0.0, self.rf_bandwidth / self.audio_rate, 1024)

    @functools.cached_property
    def pll_prefilter_taps(self) -> np.ndarray:
        return firdesign.lowpass(101, 200.0 / self.audio_rate)  # amdemod.cpp:85

    @functools.cached_property
    def sync_agc_config(self) -> agc.MagAGCConfig:
        # syncAMAGC (amdemod.cpp:59,74-75): MagAGC(12000, R=0.1, threshold
        # off), resize(12000, 6000, 0.1)
        return agc.MagAGCConfig(order_r=0.1, history_size=12000, threshold_enable=False,
                                step_length=6000, step_down_delay=12000)


class AMState(NamedTuple):
    nco: nco.NCOState
    resamp: resampler.ResamplerState
    mavg: movingavg.MovingAvgState
    squelch: squelch.SquelchState
    bandpass: firdesign.FirState
    pll: phaselock.PLLState
    pll_fir: firdesign.FirState  # ref_pll_parity: the 200 Hz complex prefilter
    ref_pll: phaselock.RefPLLState  # ref_pll_parity: the biquad registers
    sync_delay: torch.Tensor  # (..., sync_frame_offset) complex64 framing delay
    #: the one-sample aligner of the mixed stream (the port's resampler
    #: leads the reference's stream by one sample, and the sync sideband
    #: filter's overlap-add is framing-sensitive)
    sync_align: torch.Tensor
    fft: fftfilt.FftFiltState
    agc: agc.MagAGCState
    #: the envelope's volume normaliser (SimpleAGC, amdemod.cpp:58,469: an
    #: audioRate/10 window starting at 0.003)
    vol_agc: movingavg.MovingAvgState


def make_state(cfg: AMConfig, device: torch.device, batch_shape=()) -> AMState:
    """A channel's state; with batch_shape (C,), a bank of C channels."""
    return AMState(
        nco=nco.make_nco(device, batch_shape),
        resamp=resampler.init_state(cfg.resampler_plan, device, batch_shape),
        mavg=movingavg.make_state(1024, device, batch_shape),
        squelch=squelch.make_state(_SQUELCH_GATE, device, batch_shape),
        bandpass=firdesign.make_state(len(cfg.bandpass_taps), device, batch_shape),
        pll=phaselock.make_pll(device, batch_shape),
        pll_fir=firdesign.make_state(len(cfg.pll_prefilter_taps), device, batch_shape,
                                     torch.complex64),
        ref_pll=phaselock.make_ref_pll(device, batch_shape),
        sync_delay=torch.zeros((*batch_shape, cfg.sync_frame_offset), dtype=torch.complex64,
                               device=device),
        sync_align=torch.zeros((*batch_shape, 1), dtype=torch.complex64, device=device),
        fft=fftfilt.make_state(cfg.sync_fft_len, device, batch_shape),
        agc=agc.make_state(cfg.sync_agc_config, device, batch_shape),
        vol_agc=movingavg.make_state(int(cfg.audio_rate / 10), device, batch_shape,
                                     fill=0.003),
    )


def _sync_demod(state: AMState, ci: torch.Tensor, cfg: AMConfig):
    """The synchronous branch (amdemod.cpp:191-251): carrier lock, the mix
    j·ci·conj(carrier), the one-sample aligner and the framing delay, the
    sideband fftfilt with DC dropped, the sync MagAGC, (re + im)·4.
    Returns (the state's sync fields, demod)."""
    fields = {}
    if cfg.ref_pll_parity:  # the mix keeps the unfiltered ci
        fields["pll_fir"], s_f = firdesign.fir_apply(
            state.pll_fir, ci, _device_taps(cfg, "pll_prefilter_taps", ci.device))
        fields["ref_pll"], carrier = phaselock.ref_pll_run(state.ref_pll, s_f)
    else:
        fields["pll"], carrier = phaselock.pll_run(state.pll, ci, cfg.audio_rate)
    mixed = 1j * ci * torch.conj(carrier)
    ext = torch.cat([state.sync_align, mixed], dim=-1)
    mixed, fields["sync_align"] = ext[..., :-1], ext[..., -1:].clone()
    if cfg.sync_frame_offset:
        ext = torch.cat([state.sync_delay, mixed], dim=-1)
        mixed = ext[..., :mixed.shape[-1]]
        fields["sync_delay"] = ext[..., mixed.shape[-1]:].clone()
    h = _device_taps(cfg, "sync_filter", ci.device)
    if cfg.sync_dsb:  # DC is zeroed in the filter itself
        fields["fft"], filtered = fftfilt.run_dsb(state.fft, mixed, h)
    else:
        fields["fft"], filtered = fftfilt.run_ssb(state.fft, mixed, h, usb=cfg.sync_usb,
                                                  get_dc=False)
    fields["agc"], leveled, _, _ = agc.mag_agc(state.agc, filtered, cfg.sync_agc_config)
    return fields, (leveled.real + leveled.imag) * 4.0


def process(
    state: AMState, x: torch.Tensor, cfg: AMConfig, offset_hz=None, squelch_db=None,
    volume=None,
) -> tuple[AMState, torch.Tensor]:
    """(state, iq (..., block_in) complex64) -> (state', audio (..., block_out)).

    offset_hz / squelch_db / volume override the cfg fields for this block,
    each a number or a tensor of the batch shape, as in demod_nfm.process."""
    squelch_db = cfg.squelch_db if squelch_db is None else _per_channel(squelch_db, x)
    inc = nco.channel_increment(
        offset_hz, cfg.input_offset, cfg.channel_rate, x.device,
        nco.freq_to_increment_ref_quant if cfg.ref_nco_quant else nco.freq_to_increment)
    nco_state, xm = nco.mix_block(state.nco, x, inc)
    resamp_state, ci = resampler.resample_block(state.resamp, xm, cfg.resampler_plan)

    magsq = ci.real ** 2 + ci.imag ** 2
    mavg_state, avg = movingavg.moving_average(state.mavg, magsq)
    if cfg.sync_am:
        fields, demod = _sync_demod(state, ci, cfg)
    else:
        env = torch.sqrt(magsq)
        # the reference feeds its normaliser the envelope delayed by 50 ms
        # and only while the squelch is open (amdemod.cpp:242-243); the JAX
        # package and the port feed the current envelope, unconditionally:
        # equal once the gate has settled
        fields = {}
        fields["vol_agc"], env_mean = movingavg.moving_average(state.vol_agc, env)
        demod = (env - env_mean) / torch.clamp(env_mean, min=1e-9)
    squelch_state, gated, _ = squelch.gate_block(
        state.squelch, demod, avg >= 10.0 ** (squelch_db / 10.0), _SQUELCH_GATE)

    if cfg.bandpass_enable:
        bp_state, audio = firdesign.fir_apply(
            state.bandpass, gated, _device_taps(cfg, "bandpass_taps", x.device))
    else:  # DC removal by the block mean (the reference runs an IIR DC block)
        bp_state = state.bandpass
        audio = gated - gated.mean(dim=-1, keepdim=True)

    vol = cfg.volume if volume is None else _per_channel(volume, x)
    audio = audio * (0.0 if cfg.audio_mute else vol)
    return state._replace(nco=nco_state, resamp=resamp_state, mavg=mavg_state,
                          squelch=squelch_state, bandpass=bp_state, **fields), audio


def meters(state: AMState, cfg: AMConfig, dyn: dict) -> dict:
    return {"squelch": state.squelch.count > _SQUELCH_GATE}
