"""Half-band ×2^k interpolation and the UpChannelizer — the Tx mirror of
the decimators and the channelizer.

Reference: sdrbase/dsp/interpolators.h:104-130 (the device ×2..×64
cascades), sdrbase/dsp/upchannelizer.{h,cpp} (the pull-model interpolation
tree with centre/lower/upper placement, order 96),
IntHalfbandFilterEO::myInterpolate (inthalfbandfiltereo.h:712-745).

One ×2 stage is the JAX package's zero-stuffed correlation with the taps
times 2 (its `conv_general_dilated` with lhs_dilation 2), written as its two
polyphase branches: the even-index taps make one dense correlation over the
input, and the odd-index taps of a half-band filter hold only the centre
tap, so the other branch is the input delayed, exactly. A stage carries a
tail of (L+1)//2+1 input samples and emits the JAX stage's last 2T outputs.
The UpChannelizer runs a Rx plan's stages deepest first, each ×2 followed by
the opposite quarter-rate rotation, which moves the channel from DC into the
half the Rx plan selected.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import decimators as dec
from .channelizer import ChannelPlan
from .decimators import CascadeState
from .hbfilter import UPCHANNELIZER_ORDER, hb_taps

#: the device cascade's order at every stage (the reference shrinks it to
#: 32 and 16 up the chain; JAX keeps 64 throughout)
DEVICE_ORDER = 64


@functools.lru_cache(maxsize=None)
def _branches(order: int) -> tuple[np.ndarray, int]:
    """(dense branch taps, delay of the centre branch) for one ×2 stage.

    With h2 = 2·h (L taps, L odd) and ext = [tail | x], the JAX stage's
    output 2q is Σ_j h2[2j+1]·ext[q+2+j] and its output 2q+1 is
    Σ_j h2[2j]·ext[q+2+j]. The odd-index taps are all zero but the centre,
    h2[(L-1)/2] = 1, so output 2q is ext[q+2+d] with d = (L-1)/4."""
    h2 = 2.0 * hb_taps(order).astype(np.float64)
    odd = h2[1::2]
    d = int(np.flatnonzero(odd)[0])
    if np.count_nonzero(odd) != 1 or odd[d] != 1.0:
        raise ValueError(f"order {order}: not a half-band filter with a 0.5 centre tap")
    return h2[0::2].astype(np.float32), d


@functools.lru_cache(maxsize=None)
def _device_branch(order: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_branches(order)[0]).to(device).view(1, 1, -1)


def hb_interpolate2(
    tail: torch.Tensor, x: torch.Tensor, order: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """One ×2 half-band stage: (tail (..., S), x (..., T) complex64) ->
    (tail', y (..., 2T)). The zero-stuffing's 6 dB loss is made up by the
    ×2 gain (myInterpolateZeroStuffing semantics)."""
    dense = _device_branch(order, x.device)
    delay = _branches(order)[1]
    t = x.shape[-1]
    ext = torch.cat([tail, x], dim=-1)
    batch = ext.shape[:-1]
    win = ext[..., 2:]  # both branches read ext[q+2+j]
    lanes = torch.view_as_real(win).movedim(-1, 0).reshape(-1, 1, win.shape[-1])
    filtered = F.conv1d(lanes, dense).reshape(2, *batch, t)  # outputs 2q+1
    filtered = torch.complex(filtered[0], filtered[1])
    delayed = win[..., delay:delay + t]  # outputs 2q: the centre tap, a delay
    y = torch.stack([delayed, filtered], dim=-1).reshape(*batch, 2 * t)
    return ext[..., t:].clone(), y


def init_state(n_stages: int, device: torch.device, batch_shape=(),
               order: int = UPCHANNELIZER_ORDER) -> CascadeState:
    """Zero tails of (L+1)//2+1 = order//2+1 input samples per ×2 stage."""
    return CascadeState(tuple(
        torch.zeros((*batch_shape, order // 2 + 1), dtype=torch.complex64, device=device)
        for _ in range(n_stages)))


def upchannelize(
    state: CascadeState, x: torch.Tensor, plan: ChannelPlan,
    order: int = UPCHANNELIZER_ORDER,
) -> tuple[CascadeState, torch.Tensor]:
    """One channel: the plan's stages deepest first, each ×2 then the
    opposite of the Rx stage's rotation. x (..., T) at the channel rate ->
    (state', y (..., T·2^stages)) at the baseband rate."""
    tails = list(state.tails)
    y = x
    for k in reversed(range(len(plan.signs))):
        tails[k], y = hb_interpolate2(tails[k], y, order)
        if plan.signs[k]:
            y = dec.rotate(y, dec._rotation_base(-plan.signs[k], x.device))
    return CascadeState(tuple(tails)), y


def upchannelize_bank(
    state: CascadeState, x: torch.Tensor, signs: np.ndarray,
    order: int = UPCHANNELIZER_ORDER,
) -> tuple[CascadeState, torch.Tensor]:
    """A bank with a shared stage depth, one batched cascade: x (C, T) at
    the common channel rate; signs (C, n_stages), each channel's plan as
    data; the state's tails carry the leading C axis. Returns (state',
    y (C, T·2^n_stages))."""
    signs = np.asarray(signs)
    tails = list(state.tails)
    y = x
    for k in reversed(range(signs.shape[1])):
        tails[k], y = hb_interpolate2(tails[k], y, order)
        y = dec.rotate_bank(y, tuple(int(-s) for s in signs[:, k]))
    return CascadeState(tuple(tails)), y


def interpolate_cascade(
    state: CascadeState, x: torch.Tensor, log2_interp: int, order: int = DEVICE_ORDER,
) -> tuple[CascadeState, torch.Tensor]:
    """The device ×2^k interpolation to the DAC rate (interpolators.h
    cascades), k order-64 stages. x (..., T) -> (state', y (..., T·2^k))."""
    tails = list(state.tails)
    y = x
    for k in range(log2_interp):
        tails[k], y = hb_interpolate2(tails[k], y, order)
    return CascadeState(tuple(tails)), y
