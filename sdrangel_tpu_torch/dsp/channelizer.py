"""Down-channelizer: the frequency plan and the stage cascade.

Reference: sdrbase/dsp/downchannelizer.{h,cpp} — `createFilterChain`
(downchannelizer.cpp:250-287) picks Lower/Upper/Centre half-band stages
(order 48) until the channel no longer fits in a half of the shrinking band,
leaving a residual offset for the channel NCO; `feed` (:50-91) runs the
stages. Here each stage is a ±fs/4 rotation plus an order-48 ÷2 half-band
(`decimators.hb_decimate2`) on the whole block.

A bank of channels shares one stage depth; each channel's rotation signs
are per-channel data, so one batched cascade runs the whole bank
(`channelize_bank`), or only its distinct sign paths over one shared
stream (`channelize_bank_unique`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import decimators as dec
from .hbfilter import DOWNCHANNELIZER_ORDER


@dataclasses.dataclass(frozen=True)
class ChannelPlan:
    """Result of the frequency-plan recursion."""

    signs: tuple[int, ...]  # per-stage quarter-shift: +1 (lower), -1 (upper), 0 (centre)
    decimation: int  # 2^len(signs)
    channel_rate: float  # input rate / decimation
    residual_offset: float  # remaining offset for the channel NCO (Hz)


def plan_channel(
    in_rate: float, requested_rate: float, requested_offset: float
) -> ChannelPlan:
    """The createFilterChain recursion (downchannelizer.cpp:250-287)."""
    req_half = requested_rate / 2.0
    chan_start = requested_offset - req_half
    chan_end = requested_offset + req_half

    def contains(sig_start, sig_end, s, e):
        return sig_end > sig_start and e > s and sig_start <= s and sig_end >= e

    signs: list[int] = []
    sig_start, sig_end = -in_rate / 2.0, in_rate / 2.0
    while True:
        bw = sig_end - sig_start
        rot = bw / 4.0
        if contains(sig_start, sig_start + bw / 2.0, chan_start, chan_end):
            signs.append(+1)  # lower half: rotate +fs/4, keep [start, mid]
            sig_end = sig_start + bw / 2.0
        elif contains(sig_end - bw / 2.0, sig_end, chan_start, chan_end):
            signs.append(-1)  # upper half: rotate -fs/4, keep [mid, end]
            sig_start = sig_end - bw / 2.0
        elif contains(sig_start + rot, sig_end - rot, chan_start, chan_end):
            signs.append(0)  # centre half
            sig_start, sig_end = sig_start + rot, sig_end - rot
        else:
            break
    k = len(signs)
    return ChannelPlan(
        signs=tuple(signs),
        decimation=1 << k,
        channel_rate=in_rate / (1 << k),
        residual_offset=(chan_end + chan_start) / 2.0 - (sig_end + sig_start) / 2.0,
    )


def init_state(
    n_stages: int, device: torch.device, order: int = DOWNCHANNELIZER_ORDER, batch_shape=(),
) -> dec.CascadeState:
    return dec.init_state(n_stages, device, order, batch_shape)


def channelize(
    state: dec.CascadeState, x: torch.Tensor, plan: ChannelPlan,
    order: int = DOWNCHANNELIZER_ORDER,
) -> tuple[dec.CascadeState, torch.Tensor]:
    """One channel: x (..., T) complex64 -> (state', y (..., T / 2^stages))."""
    return dec.run_stages(state, x, plan.signs, order)


def channelize_bank(
    state: dec.CascadeState, x: torch.Tensor, signs: np.ndarray,
    order: int = DOWNCHANNELIZER_ORDER,
) -> tuple[dec.CascadeState, torch.Tensor]:
    """A bank with a shared stage depth. x (C, T) complex64 — one stream per
    channel (or the same block broadcast); signs (C, n_stages) from each
    channel's plan, each stage's rotations a cached period
    (`decimators.rotate_bank`). Returns (state', y (C, T / 2^n_stages))."""
    taps = dec._device_taps(order, x.device)
    tails = list(state.tails)
    y = x
    for k, stage in enumerate(np.asarray(signs).T.tolist()):
        y = dec.rotate_bank(y, tuple(stage))
        tails[k], y = dec.hb_decimate2(tails[k], y, taps)
    return dec.CascadeState(tuple(tails)), y


def channelize_bank_unique(
    state: dec.CascadeState, bb: torch.Tensor, signs: np.ndarray,
    order: int = DOWNCHANNELIZER_ORDER,
) -> tuple[dec.CascadeState, torch.Tensor]:
    """A bank over ONE shared stream, run once per distinct sign path and
    gathered back to channel order at the decimated rate. bb (T,) complex64;
    signs (C, n_stages); state has leading dim U = `unique_paths(signs)`.
    Returns (state', y (C, T / 2^n_stages))."""
    uniq, inverse = np.unique(np.asarray(signs), axis=0, return_inverse=True)
    xb = bb.expand(len(uniq), bb.shape[-1])
    state, y_u = channelize_bank(state, xb, uniq, order)
    return state, y_u[torch.from_numpy(inverse.reshape(-1)).to(bb.device)]


def unique_paths(signs: np.ndarray) -> int:
    return len(np.unique(np.asarray(signs), axis=0))
