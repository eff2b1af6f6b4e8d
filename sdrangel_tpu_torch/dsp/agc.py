"""AGC: the magnitude AGC with power squelch and smootherstep ramps.

Reference: sdrbase/dsp/agc.{h,cpp} — MagAGC::feedAndGetValue
(agc.cpp:98-175): gain u0 = R/avg(magsq) (power mode) or R/√avg (magnitude
mode), optional clamping, a power-threshold squelch with a gate counter and
a step-down delay, attack and release as smootherstep ramps over stepLength
samples. All at the audio rate, as whole-block operations:
  1. the magsq moving average (movingavg.py, the long-window form);
  2. the gate and step-down-delay counters as saturating scans
     (scanops.py);
  3. the step-up/step-down ramp pair as one saturating counter whose value
     is the ramp position (the reference mirrors its two counters into each
     other at every flip, agc.cpp:149-175, so one position suffices);
  4. smootherstep(x) = 6x⁵ − 15x⁴ + 10x³ (stepfunctions.h:24-35).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .movingavg import MovingAvgState, moving_average
from .movingavg import make_state as make_mavg
from .scanops import saturating_counter


def smootherstep(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 0.0, 1.0)
    return x * x * x * (x * (6.0 * x - 15.0) + 10.0)


class MagAGCState(NamedTuple):
    mavg: MovingAvgState
    gate_counter: torch.Tensor  # (...,) samples above threshold (up to gate)
    count: torch.Tensor  # (...,) samples since signal (up to stepDownDelay)
    ramp: torch.Tensor  # (...,) ramp position in [0, stepLength]


class MagAGCConfig(NamedTuple):
    order_r: float = 1.0  # target magnitude R
    history_size: int = 4800  # averaging length (attack)
    threshold: float = 0.0  # squelch threshold on the magsq average
    threshold_enable: bool = True
    gate: int = 4  # samples over threshold before the squelch opens
    step_length: int = 2400  # ramp length (at most 50 ms at 48 kHz, agc.cpp:51)
    step_down_delay: int = 4800  # release delay
    squared: bool = False  # power (True) or magnitude (False) mode
    clamping: bool = False
    clamp_max: float = 1.0


def make_state(cfg: MagAGCConfig, device: torch.device, batch_shape=()) -> MagAGCState:
    return MagAGCState(
        mavg=make_mavg(cfg.history_size, device, batch_shape),
        gate_counter=torch.zeros(batch_shape, dtype=torch.float32, device=device),
        count=torch.full(batch_shape, float(cfg.step_down_delay), dtype=torch.float32,
                         device=device),
        ramp=torch.zeros(batch_shape, dtype=torch.float32, device=device),
    )


def mag_agc(
    state: MagAGCState, x: torch.Tensor, cfg: MagAGCConfig
) -> tuple[MagAGCState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """MagAGC over a complex block x (..., T) complex64.

    Returns (state', y, magsq, ramp): y gain-controlled (and squelch-gated
    when threshold_enable), ramp the per-sample smootherstep step value
    (getStepValue), which SSB multiplies into its delayed sample a second
    time (ssbdemod.cpp:225)."""
    magsq = x.real ** 2 + x.imag ** 2
    mavg_state, avg = moving_average(state.mavg, magsq)
    avg = torch.clamp(avg, min=1e-30)
    u0 = cfg.order_r / avg if cfg.squared else cfg.order_r / torch.sqrt(avg)
    if cfg.clamping:
        inst = magsq if cfg.squared else torch.sqrt(magsq)
        u0 = torch.where(inst > cfg.clamp_max, cfg.clamp_max / torch.clamp(inst, min=1e-30), u0)

    if not cfg.threshold_enable:
        return (MagAGCState(mavg_state, state.gate_counter, state.count, state.ramp),
                x * u0, magsq, torch.ones_like(u0))

    # the squelch (agc.cpp:128-175): gateCounter climbs while over the
    # threshold (clamped at gate) and resets under it; count resets once
    # the gate has passed and climbs otherwise (clamped at the delay)
    over = magsq > cfg.threshold
    gate_counts = saturating_counter(
        torch.where(over, 1.0, -float(cfg.gate)), 0.0, float(cfg.gate), state.gate_counter)
    counts = saturating_counter(
        torch.where(gate_counts >= cfg.gate, -float(cfg.step_down_delay), 1.0),
        0.0, float(cfg.step_down_delay), state.count)
    ramps = saturating_counter(
        torch.where(counts < cfg.step_down_delay, 1.0, -1.0),
        0.0, float(cfg.step_length), state.ramp)
    gain_ramp = smootherstep(ramps / float(cfg.step_length))
    new_state = MagAGCState(mavg_state, gate_counts[..., -1].clone(), counts[..., -1].clone(),
                            ramps[..., -1].clone())
    return new_state, x * (u0 * gain_ramp), magsq, gain_ramp
