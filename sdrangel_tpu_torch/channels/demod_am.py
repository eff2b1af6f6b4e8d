"""AM demodulator, envelope detection (plugins/channelrx/demodam/amdemod.cpp,
processOneSample :152-260).

NCO mix by the channel offset → polyphase resample to the audio rate →
power squelch on a 1024-sample magsq average → the envelope √magsq
normalised by its audioRate/10 trailing mean, (env − mean)/mean, so that
loudness follows the modulation depth and not the carrier level → the
squelch gate (480 samples) → the 300..rfBw/2 audio bandpass (the reference
ring filter's response /301) or a block-mean DC removal → volume.

PLL-synchronous AM (`sync_am`) and its reference-exact loop
(`ref_pll_parity`) need the per-sample PLL recurrences, which are not
ported yet (ROADMAP.md, queue 1, item 6: AM-sync); those settings raise
NotImplementedError. `AMState` carries the envelope path's fields under the
JAX package's names, so a JAX AM state carries across by name; its
sync-mode fields are dropped on the way.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..dsp import firdesign, movingavg, nco, resampler, squelch
from .demod_nfm import _auto_block, _per_channel

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
    sync_am: bool = False  # PLL-synchronous detection (not ported)
    block_in: int = 0  # input samples per block (0 -> auto from the resampler ratio)
    # test-only: the reference's exact PhaseLockComplex loop (not ported)
    ref_pll_parity: bool = False
    # test-only: the reference's fs/4096 NCO tuning grid
    # (nco.freq_to_increment_ref_quant)
    ref_nco_quant: bool = False

    def __post_init__(self):
        if self.sync_am or self.ref_pll_parity:
            raise NotImplementedError(
                "sync_am and ref_pll_parity need the per-sample PLL recurrences, which "
                "wait for the AM-sync port (ROADMAP.md, queue 1, item 6)")

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


class AMState(NamedTuple):
    nco: nco.NCOState
    resamp: resampler.ResamplerState
    mavg: movingavg.MovingAvgState
    squelch: squelch.SquelchState
    bandpass: firdesign.FirState
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
        vol_agc=movingavg.make_state(int(cfg.audio_rate / 10), device, batch_shape,
                                     fill=0.003),
    )


@functools.lru_cache(maxsize=None)
def _device_bandpass(cfg: AMConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(cfg.bandpass_taps).to(device)


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
    env = torch.sqrt(magsq)
    # the reference feeds its normaliser the envelope delayed by 50 ms and
    # only while the squelch is open (amdemod.cpp:242-243); the JAX package
    # and the port feed the current envelope, unconditionally: equal once
    # the gate has settled
    vol_state, env_mean = movingavg.moving_average(state.vol_agc, env)
    demod = (env - env_mean) / torch.clamp(env_mean, min=1e-9)
    squelch_state, gated, _ = squelch.gate_block(
        state.squelch, demod, avg >= 10.0 ** (squelch_db / 10.0), _SQUELCH_GATE)

    if cfg.bandpass_enable:
        bp_state, audio = firdesign.fir_apply(
            state.bandpass, gated, _device_bandpass(cfg, x.device))
    else:  # DC removal by the block mean (the reference runs an IIR DC block)
        bp_state = state.bandpass
        audio = gated - gated.mean(dim=-1, keepdim=True)

    vol = cfg.volume if volume is None else _per_channel(volume, x)
    audio = audio * (0.0 if cfg.audio_mute else vol)
    return state._replace(nco=nco_state, resamp=resamp_state, mavg=mavg_state,
                          squelch=squelch_state, bandpass=bp_state,
                          vol_agc=vol_state), audio


def meters(state: AMState, cfg: AMConfig, dyn: dict) -> dict:
    return {"squelch": state.squelch.count > _SQUELCH_GATE}
