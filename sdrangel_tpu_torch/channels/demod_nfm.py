"""NFM demodulator (plugins/channelrx/demodnfm/nfmdemod.cpp:140-330).

NCO mix by the channel offset → polyphase resample to the audio rate →
phase discriminator → power squelch (32-sample moving average of magsq
against the level) writing through the squelch-gate delay line → 301-tap
audio bandpass (the reference's ring-walk response) → volume. One pure
function (state, iq block) -> (state', audio block).

The AF "delta" squelch and the CTCSS gate need the Goertzel detectors, which
are not ported yet (ROADMAP.md, queue 1: goertzel/CTCSS); those settings
raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import functools
from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch

from ..dsp import firdesign, movingavg, nco, phasediscri, resampler, squelch


@dataclasses.dataclass(frozen=True, eq=False)
class NFMConfig:
    channel_rate: float  # input rate from the channelizer
    input_offset: float = 0.0  # residual frequency offset (Hz)
    audio_rate: float = 48000.0
    rf_bandwidth: float = 12500.0
    af_bandwidth: float = 3000.0
    fm_deviation: float = 5000.0
    squelch_db: float = -40.0  # power squelch threshold (dB)
    squelch_gate_ms: float = 50.0
    delta_squelch: bool = False  # AF squelch instead of power squelch
    ctcss_on: bool = False
    ctcss_index: int = 0  # 0 = none; 1..32 selects a CTCSS tone
    volume: float = 1.0
    audio_mute: bool = False
    block_in: int = 0  # input samples per block (0 -> auto from the resampler ratio)
    ref_atan2_approx: bool = False  # test-only: the reference's atan2 approximation

    def __post_init__(self):
        if self.delta_squelch or self.ctcss_on:
            raise NotImplementedError(
                "delta_squelch and ctcss_on need the Goertzel detectors, which wait "
                "for the goertzel/CTCSS port (ROADMAP.md, queue 1)")

    @functools.cached_property
    def resampler_plan(self) -> resampler.ResamplerPlan:
        block = self.block_in or _auto_block(self.channel_rate, self.audio_rate)
        # cutoff rf/2.2 as nfmdemod.cpp:425 (the per-stage golden measured
        # 137 dB at /2.2 against 41 dB at /2.0)
        return resampler.make_plan(
            self.channel_rate, self.audio_rate, block, cutoff=self.rf_bandwidth / 2.2)

    @functools.cached_property
    def squelch_gate_samples(self) -> int:
        return max(1, int(self.audio_rate * self.squelch_gate_ms / 1000.0))

    @functools.cached_property
    def bandpass_taps(self) -> np.ndarray:
        # Bandpass::create(301, rate, 300, afBW) through the ring-walk filter
        # (nfmdemod.cpp:429), renormalized to unity gain at the geometric
        # centre of the passband
        k = firdesign.bandpass_ring_kernel(
            301, self.audio_rate, 300.0, self.af_bandwidth).astype(np.float64)
        w = 2.0 * np.pi * np.sqrt(300.0 * self.af_bandwidth) / self.audio_rate
        gain = np.abs(np.sum(k * np.exp(-1j * w * np.arange(len(k)))))
        return (k / gain).astype(np.float32)

    @property
    def fm_scaling(self) -> float:
        return self.audio_rate / (2.0 * self.fm_deviation)  # deviation -> full scale


def _auto_block(in_rate: float, out_rate: float) -> int:
    """Smallest power-of-two multiple ≥ 4096 of the ratio's numerator p."""
    block = Fraction(in_rate / out_rate).limit_denominator(1 << 20).numerator
    while block < 4096:
        block *= 2
    return block


class NFMState(NamedTuple):
    nco: nco.NCOState
    resamp: resampler.ResamplerState
    discri: phasediscri.DiscriminatorState
    mavg: movingavg.MovingAvgState
    squelch: squelch.SquelchState
    bandpass: firdesign.FirState


def make_state(cfg: NFMConfig, device: torch.device, batch_shape=()) -> NFMState:
    """A channel's state; with batch_shape (C,), a bank of C channels."""
    return NFMState(
        nco=nco.make_nco(device, batch_shape),
        resamp=resampler.init_state(cfg.resampler_plan, device, batch_shape),
        discri=phasediscri.make_state(device, batch_shape),
        mavg=movingavg.make_state(32, device, batch_shape),  # nfmdemod.h m_movingAverage
        squelch=squelch.make_state(cfg.squelch_gate_samples, device, batch_shape),
        bandpass=firdesign.make_state(len(cfg.bandpass_taps), device, batch_shape),
    )


@functools.lru_cache(maxsize=None)
def _device_bandpass(cfg: NFMConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(cfg.bandpass_taps).to(device)


def process(
    state: NFMState, x: torch.Tensor, cfg: NFMConfig, offset_hz=None,
    squelch_db=None, volume=None,
) -> tuple[NFMState, torch.Tensor]:
    """(state, iq (..., block_in) complex64) -> (state', audio (..., block_out)).

    offset_hz / squelch_db / volume override the matching cfg fields for
    this block (live settings changes, nfmdemod.cpp handleMessage). Each is
    a number, or a tensor of the batch shape (one value per channel of a
    bank). An offset override goes through the float32 increment on the
    tensors' device, as the JAX function's traced path does; without one the
    configured offset takes the host float64 path."""
    squelch_db = cfg.squelch_db if squelch_db is None else _per_channel(squelch_db, x)
    inc = nco.channel_increment(offset_hz, cfg.input_offset, cfg.channel_rate, x.device)
    nco_state, xm = nco.mix_block(state.nco, x, inc)
    resamp_state, ci = resampler.resample_block(state.resamp, xm, cfg.resampler_plan)
    discri_state, demod, magsq = phasediscri.discriminator_delta(
        state.discri, ci, cfg.fm_scaling, approx=cfg.ref_atan2_approx)
    mavg_state, avg_magsq = movingavg.moving_average(state.mavg, magsq)
    squelch_state, gated, _ = squelch.gate_block(
        state.squelch, demod, avg_magsq >= 10.0 ** (squelch_db / 10.0),
        cfg.squelch_gate_samples)
    bp_state, audio = firdesign.fir_apply(
        state.bandpass, gated, _device_bandpass(cfg, x.device))
    vol = cfg.volume if volume is None else _per_channel(volume, x)
    audio = audio * (0.0 if cfg.audio_mute else vol)
    return NFMState(nco_state, resamp_state, discri_state, mavg_state,
                    squelch_state, bp_state), audio


def _per_channel(value, x: torch.Tensor):
    """A per-channel tensor override broadcast along the sample axis."""
    if isinstance(value, torch.Tensor) and value.dim():
        return value.to(x.device)[..., None]
    return value


def meters(state: NFMState, cfg: NFMConfig, dyn: dict) -> dict:
    """The gate state as the report's squelch meter (nfmdemod.h:153-170)."""
    return {"squelch": state.squelch.count > cfg.squelch_gate_samples}
