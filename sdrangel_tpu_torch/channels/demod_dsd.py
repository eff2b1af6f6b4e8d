"""DSD front end: 4-level FSK digital-voice symbol recovery.

Reference: plugins/channelrx/demoddsd/dsddemod.cpp (`feed`): NCO mix →
resample to 48 kHz → FM discriminator × demodGain → squelch gate and delay
line → the external DSDcc decoder (DMR/D-Star/YSF framing, AMBE vocoding).
The vocoder and trunking stacks stay outside, as in the reference; this
module goes up to the symbol layer DSDcc consumes: the discriminator at 48
kHz, the 32-sample magsq average and squelch, a symbol-rate lowpass,
Gardner-tracked symbol instants at 4800 baud (dsp/symsync.py) and 4-level
slicing into dibits. The frame sync over the dibits is channels/dsdsync.py,
run by the session on the host.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..dsp import firdesign, movingavg, nco, phasediscri, resampler, squelch, symsync
from .demod_nfm import _auto_block, _device_taps


@dataclasses.dataclass(frozen=True, eq=False)
class DSDConfig:
    channel_rate: float
    input_offset: float = 0.0
    audio_rate: float = 48000.0  # discriminator rate (DSDcc works at 48k)
    rf_bandwidth: float = 12500.0
    fm_deviation: float = 3500.0  # ±3.5 kHz outer symbol (DMR/YSF class)
    symbol_rate: float = 4800.0
    squelch_db: float = -60.0
    block_in: int = 0

    @property
    def sps(self) -> int:
        return int(self.audio_rate / self.symbol_rate)  # 10 at 48k/4800

    @functools.cached_property
    def resampler_plan(self) -> resampler.ResamplerPlan:
        block = self.block_in or _auto_block(self.channel_rate, self.audio_rate)
        cutoff = self.rf_bandwidth / 2.2  # dsddemod.cpp:451
        plan = resampler.make_plan(self.channel_rate, self.audio_rate, block, cutoff=cutoff)
        # the symbol synchronizer needs whole symbols in the audio block
        mult = self.sps // math.gcd(plan.block_out, self.sps)
        if mult > 1:
            plan = resampler.make_plan(self.channel_rate, self.audio_rate, block * mult,
                                       cutoff=cutoff)
        return plan

    @functools.cached_property
    def shaping_taps(self) -> np.ndarray:
        # symbol-rate lowpass ahead of the slicer (the reference's RRC role)
        return firdesign.lowpass(81, 0.75 * self.symbol_rate / self.audio_rate)

    @property
    def fm_scaling(self) -> float:
        # the outer symbol (±3 sub-deviations) maps to ±1.0, the reference's
        # demodGain normalization
        return self.audio_rate / (2.0 * self.fm_deviation)


class DSDState(NamedTuple):
    nco: nco.NCOState
    resamp: resampler.ResamplerState
    discri: phasediscri.DiscriminatorState
    mavg: movingavg.MovingAvgState
    squelch: squelch.SquelchState
    shaping: firdesign.FirState
    sym: symsync.SymSyncState


_SQUELCH_GATE = 480


def make_state(cfg: DSDConfig, device: torch.device, batch_shape=()) -> DSDState:
    return DSDState(
        nco=nco.make_nco(device, batch_shape),
        resamp=resampler.init_state(cfg.resampler_plan, device, batch_shape),
        discri=phasediscri.make_state(device, batch_shape),
        mavg=movingavg.make_state(32, device, batch_shape),
        squelch=squelch.make_state(_SQUELCH_GATE, device, batch_shape),
        shaping=firdesign.make_state(81, device, batch_shape),
        sym=symsync.make_state(device, batch_shape, sps=cfg.sps),
    )


class DSDOutputs(NamedTuple):
    dibits: torch.Tensor  # (..., n_sym) int32 in {0, 1, 2, 3} (DSDcc's convention)
    soft_symbols: torch.Tensor  # (..., n_sym) float32 discriminator levels
    squelch_open: torch.Tensor  # (...,) bool, at the block's last sample


def process(state: DSDState, x: torch.Tensor, cfg: DSDConfig) -> tuple[DSDState, DSDOutputs]:
    """(state, iq (..., block_in) complex64) -> (state', DSDOutputs)."""
    nco_state, xm = nco.mix_block(
        state.nco, x, nco.freq_to_increment(-cfg.input_offset, cfg.channel_rate))
    resamp_state, ci = resampler.resample_block(state.resamp, xm, cfg.resampler_plan)
    discri_state, demod, magsq = phasediscri.discriminator_delta(
        state.discri, ci, cfg.fm_scaling)
    mavg_state, avg = movingavg.moving_average(state.mavg, magsq)
    open_cond = avg >= 10.0 ** (cfg.squelch_db / 10.0)
    squelch_state, gated, is_open = squelch.gate_block(
        state.squelch, demod, open_cond, _SQUELCH_GATE)
    shaping_state, shaped = firdesign.fir_apply(
        state.shaping, gated, _device_taps(cfg, "shaping_taps", x.device))
    sym_state, symbols = symsync.synchronize_block(
        state.sym, shaped.to(torch.complex64), cfg.sps)
    soft = symbols.real.contiguous()
    # 4-level slicer, thresholds at 0 and ±2/3 of the outer level (DSDcc's
    # dibits: +3 -> 0b01, +1 -> 0b00, -1 -> 0b10, -3 -> 0b11)
    outer = torch.clamp(torch.mean(soft.abs(), dim=-1, keepdim=True) * 1.5, min=1e-6)
    level = soft / outer
    dibits = torch.where(level > 2.0 / 3.0, 1, torch.where(
        level > 0.0, 0, torch.where(level > -2.0 / 3.0, 2, 3))).to(torch.int32)
    return (DSDState(nco_state, resamp_state, discri_state, mavg_state, squelch_state,
                     shaping_state, sym_state),
            DSDOutputs(dibits, soft, is_open[..., -1].clone()))
