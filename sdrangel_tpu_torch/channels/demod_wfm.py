"""WFM (wideband FM) demodulator (plugins/channelrx/demodwfm/wfmdemod.cpp,
feed :90-180).

NCO mix → the ±rfBw/2 fftfilt band filter at the channel rate (1024
points) → phase discriminator at the channel rate → power squelch on a
1024-sample magsq average → polyphase resample to the audio rate → real
part × volume. Unlike NFM, the discriminator runs at the wide channel rate,
before the audio resampler.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..dsp import fftfilt, movingavg, nco, phasediscri, resampler
from .demod_nfm import _auto_block, _per_channel


@dataclasses.dataclass(frozen=True, eq=False)
class WFMConfig:
    channel_rate: float
    input_offset: float = 0.0
    audio_rate: float = 48000.0
    rf_bandwidth: float = 180000.0
    af_bandwidth: float = 15000.0
    fm_deviation: float = 75000.0
    squelch_db: float = -60.0
    volume: float = 1.0
    audio_mute: bool = False
    fft_len: int = 1024
    block_in: int = 0  # input samples per block (0 -> auto from the resampler ratio)
    ref_atan2_approx: bool = False  # test-only: the reference's atan2 approximation

    @functools.cached_property
    def rf_filter(self) -> np.ndarray:
        # create_filter(-rfBw/2, +rfBw/2), the band form of wfmdemod.cpp:296-298
        fc = 0.5 * self.rf_bandwidth / self.channel_rate
        return fftfilt.create_filter(-fc, fc, self.fft_len)

    @functools.cached_property
    def resampler_plan(self) -> resampler.ResamplerPlan:
        block = self.block_in or _auto_block(self.channel_rate, self.audio_rate)
        hop = self.fft_len // 2  # the block also feeds the OLA filter
        while block % hop:
            block *= 2
        return resampler.make_plan(self.channel_rate, self.audio_rate, block,
                                   cutoff=self.af_bandwidth)

    @property
    def fm_scaling(self) -> float:
        return self.channel_rate / (2.0 * self.fm_deviation)


class WFMState(NamedTuple):
    nco: nco.NCOState
    fft: fftfilt.FftFiltState
    mavg: movingavg.MovingAvgState
    discri: phasediscri.DiscriminatorState
    resamp: resampler.ResamplerState


def make_state(cfg: WFMConfig, device: torch.device, batch_shape=()) -> WFMState:
    """A channel's state; with batch_shape (C,), a bank of C channels."""
    return WFMState(
        nco=nco.make_nco(device, batch_shape),
        fft=fftfilt.make_state(cfg.fft_len, device, batch_shape),
        mavg=movingavg.make_state(1024, device, batch_shape),
        discri=phasediscri.make_state(device, batch_shape),
        resamp=resampler.init_state(cfg.resampler_plan, device, batch_shape),
    )


@functools.lru_cache(maxsize=None)
def _device_rf_filter(cfg: WFMConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(cfg.rf_filter).to(device)


def process(
    state: WFMState, x: torch.Tensor, cfg: WFMConfig, offset_hz=None, squelch_db=None,
    volume=None,
) -> tuple[WFMState, torch.Tensor]:
    """(state, iq (..., block_in) complex64) -> (state', audio (..., block_out)).
    offset_hz / squelch_db / volume override the cfg fields for this block,
    as in demod_nfm.process."""
    squelch_db = cfg.squelch_db if squelch_db is None else _per_channel(squelch_db, x)
    inc = nco.channel_increment(offset_hz, cfg.input_offset, cfg.channel_rate, x.device)
    nco_state, xm = nco.mix_block(state.nco, x, inc)
    fft_state, rf = fftfilt.run_filt(state.fft, xm, _device_rf_filter(cfg, x.device))
    discri_state, demod, magsq = phasediscri.discriminator_delta(
        state.discri, rf, cfg.fm_scaling, approx=cfg.ref_atan2_approx)
    mavg_state, avg = movingavg.moving_average(state.mavg, magsq)
    demod = torch.where(avg >= 10.0 ** (squelch_db / 10.0), demod, 0.0)
    resamp_state, audio_c = resampler.resample_block(
        state.resamp, demod.to(torch.complex64), cfg.resampler_plan)
    vol = cfg.volume if volume is None else _per_channel(volume, x)
    audio = audio_c.real * (0.0 if cfg.audio_mute else vol)
    return WFMState(nco_state, fft_state, mavg_state, discri_state, resamp_state), audio


def meters(state: WFMState, cfg: WFMConfig, dyn: dict) -> dict:
    """The squelch from the demod's own moving-average window, against the
    live threshold when one is given."""
    sq = dyn.get("squelch_db", cfg.squelch_db)
    if isinstance(sq, torch.Tensor):
        sq = sq.to(state.mavg.window.device)
    return {"squelch": state.mavg.window.mean(dim=-1) >= 10.0 ** (sq / 10.0)}
