"""Half-band ÷2^k decimation: the flat composed-filter form on K1, and the
staged cascade as plain torch.

Reference: sdrbase/dsp/decimators.h decimateN_{cen,inf,sup} chained
IntHalfbandFilterEO stages. Placements (devicesamplesource.cpp:84-110): cen
keeps the band at DC; inf/sup rotate ±fs/4 per stage until the wanted band
sits at DC. Every stage has unity passband gain in float32.

The device decimator is the flat form: the k stages composed into one LTI
filter h_eq = h ∗ (h↑2) ∗ (h↑4) ∗ … split into 2^k polyphase legs, run by the
K1 kernel (kernels/flat_decimate.py) — one pass over the input. inf/sup
placements pull each stage's rotation to the input, so they become an input
modulation of period 4·2^k and complex legs (`flat_rotated`). The staged
cascade (`decimate_cascade`) serves the channelizer and the log2_decim = 0
path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.flat_decimate import flat_decimate
from .hbfilter import DECIMATORS_ORDER, hb_taps


class CascadeState(NamedTuple):
    """Carried filter tails, one per ÷2 stage: tails[k] is (..., L-1)
    complex64, the last L-1 input samples of stage k (L = order-1 taps)."""

    tails: tuple[torch.Tensor, ...]


def placement_schedule(log2_decim: int, fc_pos: str) -> tuple[int, ...]:
    """Quarter-rate rotation sign per stage (+1 = +fs/4, -1 = -fs/4, 0 = none).

    Greedy residual tracking of the wanted-band offset
    (devicesamplesource.cpp:84-110) reproduces the reference cascades, e.g.
    ÷16 inf = [Inf, Sup, Sup, Cen] (decimators.h:829-960).
    """
    if fc_pos == "cen" or log2_decim == 0:
        return (0,) * log2_decim
    sign = {"inf": -1, "sup": +1}[fc_pos]
    if log2_decim < 3:
        target = sign / float(1 << (log2_decim + 1))
    else:
        target = sign / float(1 << log2_decim)
    signs = []
    residual = target  # wanted-band centre in units of the current rate
    for _ in range(log2_decim):
        s = +1 if residual < 0 else (-1 if residual > 0 else 0)
        signs.append(s)
        residual = (residual + s / 4.0) * 2.0
    if residual != 0.0:
        raise ValueError(f"placement schedule failed: {log2_decim=} {fc_pos=}")
    return tuple(signs)


@functools.lru_cache(maxsize=None)
def _rotation_base(sign: int, device: torch.device) -> torch.Tensor:
    """One period of e^{i·sign·π/2·n}: [1, i·sign, -1, -i·sign]."""
    base = np.array([1, 1j * sign, -1, -1j * sign], dtype=np.complex64)
    return torch.from_numpy(base).to(device)


def rotate(x: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """x (..., T) times a periodic pattern (P,) tiled along T (P divides T)."""
    p = pattern.shape[0]
    if x.shape[-1] % p:
        raise ValueError(f"block length {x.shape[-1]} must be a multiple of {p}")
    return (x.reshape(*x.shape[:-1], -1, p) * pattern).reshape(x.shape)


def hb_decimate2(
    tail: torch.Tensor, x: torch.Tensor, taps: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One ÷2 half-band stage: y[m] = Σ_k h[k]·ext[2m + k], ext = [tail, x].

    tail (..., L-1), x (..., T) complex64, T even; taps (L,) float32.
    Returns (tail', y (..., T/2)).
    """
    ext = torch.cat([tail, x], dim=-1)
    batch = ext.shape[:-1]
    lanes = torch.view_as_real(ext).movedim(-1, 0).reshape(-1, 1, ext.shape[-1])
    y = F.conv1d(lanes, taps.view(1, 1, -1), stride=2)  # correlation
    y = y.reshape(2, *batch, y.shape[-1])
    return ext[..., x.shape[-1]:].clone(), torch.complex(y[0], y[1])


def init_state(
    log2_decim: int, device: torch.device, order: int = DECIMATORS_ORDER, batch_shape=(),
) -> CascadeState:
    return CascadeState(tuple(
        torch.zeros((*batch_shape, order - 2), dtype=torch.complex64, device=device)
        for _ in range(log2_decim)
    ))


@functools.lru_cache(maxsize=None)
def _device_taps(order: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(hb_taps(order)).to(device)


def run_stages(
    state: CascadeState, x: torch.Tensor, signs: tuple[int, ...], order: int,
) -> tuple[CascadeState, torch.Tensor]:
    """÷2 stages in turn, each after its ±fs/4 rotation (sign 0: none)."""
    taps = _device_taps(order, x.device)
    tails = list(state.tails)
    y = x
    for k, sign in enumerate(signs):
        if sign:
            y = rotate(y, _rotation_base(sign, x.device))
        tails[k], y = hb_decimate2(tails[k], y, taps)
    return CascadeState(tuple(tails)), y


def decimate_cascade(
    state: CascadeState, x: torch.Tensor, log2_decim: int, fc_pos: str = "cen",
    order: int = DECIMATORS_ORDER,
) -> tuple[CascadeState, torch.Tensor]:
    """The ÷2^k cascade stage by stage, with the placement rotations.

    x (..., T) complex64, T a multiple of 4·2^k. Returns (state', y (..., T/2^k)).
    """
    return run_stages(state, x, placement_schedule(log2_decim, fc_pos), order)


def decimate_reference_oracle(
    x: np.ndarray, log2_decim: int, fc_pos: str = "cen", order: int = DECIMATORS_ORDER
) -> np.ndarray:
    """NumPy oracle: the same cascade, sequential, in float64."""
    h = hb_taps(order).astype(np.float64)
    signs = placement_schedule(log2_decim, fc_pos)
    y = x.astype(np.complex128)
    for k in range(log2_decim):
        if signs[k] != 0:
            n = np.arange(y.shape[-1])
            y = y * np.exp(1j * signs[k] * np.pi / 2.0 * n)
        ext = np.concatenate([np.zeros(len(h) - 1, dtype=np.complex128), y])
        y = np.convolve(ext, h[::-1], mode="valid")[::2]  # correlation
    return y.astype(np.complex64)


# ---------------------------------------------------------------------------
# Flat (single-stage) form: y[M] = Σ_l h_eq[l]·x[2^k·M − D + l],
# D = (order−2)·(2^k − 1), as 2^k polyphase legs on the output grid.
# ---------------------------------------------------------------------------


class FlatState(NamedTuple):
    """tail: the last 2^k·(t_leg−1) input samples — complex64 (n,) on the
    float path (stored modulated for inf/sup), or raw int16 (n, 2) on the
    fused i16 ingest path (`decimate_flat_raw`). K1 takes it and the next
    block as two pointers, so the block is never copied to put the tail in
    front (a block of any strides is made contiguous first, a no-op for the
    contiguous blocks the pipelines pass); the new tail is a clone of the
    block's last n samples (a small concatenation only for a block shorter
    than n)."""

    tail: torch.Tensor


@functools.lru_cache(maxsize=8)
def flat_equivalent_filter(log2_decim: int, order: int = DECIMATORS_ORDER) -> np.ndarray:
    h = hb_taps(order).astype(np.float64)
    h_eq = np.array([1.0])
    for s in range(log2_decim):
        up = np.zeros(((len(h) - 1) << s) + 1)
        up[:: 1 << s] = h
        h_eq = np.convolve(h_eq, up)
    return h_eq


@functools.lru_cache(maxsize=8)
def flat_legs(log2_decim: int, order: int = DECIMATORS_ORDER) -> np.ndarray:
    """(2^k, t_leg) float32 polyphase legs of h_eq, front-padded so the leg
    correlation lands on the streaming cascade's output grid."""
    r = 1 << log2_decim
    h_eq = flat_equivalent_filter(log2_decim, order)
    d = (order - 2) * (r - 1)  # cascade group history
    padded = np.concatenate([np.zeros((-d) % r), h_eq])
    t_leg = -(-len(padded) // r)
    full = np.zeros(t_leg * r)
    full[: len(padded)] = padded
    return full.reshape(t_leg, r).T.astype(np.float32)


@functools.lru_cache(maxsize=32)
def flat_rotated(
    log2_decim: int, fc_pos: str, order: int = DECIMATORS_ORDER
) -> tuple[np.ndarray, np.ndarray]:
    """(legs (2^k, t_leg) complex64, pattern (4·2^k,) complex64) for inf/sup.

    Pulling each stage's ±fs/4 rotation to the input turns the rotated
    cascade into input modulation e^{jΩn} · one LTI filter G · ÷2^k, with
    Ω = Σ_m s_m(π/2)/2^m. G is read off the float64 oracle's impulse
    responses, so orientation and alignment are exact by construction.
    """
    r = 1 << log2_decim
    signs = placement_schedule(log2_decim, fc_pos)
    omega = sum(s * (np.pi / 2.0) / (1 << m) for m, s in enumerate(signs))
    d = (order - 2) * (r - 1)
    l_full_eq = d + 1  # support of the composed filter
    g = np.zeros(l_full_eq, dtype=np.complex128)
    n_in = l_full_eq + 8 * r
    for n0 in range(r):
        x = np.zeros(n_in, dtype=np.complex128)
        x[n0] = 1.0
        y = decimate_reference_oracle(x, log2_decim, fc_pos, order).astype(np.complex128)
        for m in range(len(y)):
            i = n0 + d - r * m
            if 0 <= i < l_full_eq:
                g[i] = y[m] * np.exp(-1j * omega * n0)
    padded = np.concatenate([np.zeros((-d) % r, np.complex128), g])
    t_leg = -(-len(padded) // r)
    full = np.zeros(t_leg * r, np.complex128)
    full[: len(padded)] = padded
    legs = full.reshape(t_leg, r).T.astype(np.complex64)
    pattern = np.exp(1j * omega * np.arange(4 * r)).astype(np.complex64)
    return legs, pattern


@functools.lru_cache(maxsize=None)
def _device_legs(
    log2_decim: int, fc_pos: str, device: torch.device, order: int = DECIMATORS_ORDER
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """(legs_re, legs_im, pattern) on `device`; the last two are None for cen."""
    if fc_pos == "cen":
        return torch.from_numpy(flat_legs(log2_decim, order)).to(device), None, None
    legs, pattern = flat_rotated(log2_decim, fc_pos, order)
    return (
        torch.from_numpy(np.ascontiguousarray(legs.real)).to(device),
        torch.from_numpy(np.ascontiguousarray(legs.imag)).to(device),
        torch.from_numpy(pattern).to(device),
    )


def flat_tail_len(log2_decim: int, order: int = DECIMATORS_ORDER) -> int:
    return (1 << log2_decim) * (flat_legs(log2_decim, order).shape[1] - 1)


def init_flat_state(
    log2_decim: int, device: torch.device, raw: bool = False,
    order: int = DECIMATORS_ORDER,
) -> FlatState:
    """Zero tail: complex64 (n,), or int16 (n, 2) for `decimate_flat_raw`."""
    n = flat_tail_len(log2_decim, order)
    if raw:
        return FlatState(torch.zeros((n, 2), dtype=torch.int16, device=device))
    return FlatState(torch.zeros(n, dtype=torch.complex64, device=device))


def _next_tail(state: FlatState, x: torch.Tensor) -> FlatState:
    """The carried tail after block x: the last n samples of [tail | x]."""
    n = state.tail.shape[0]
    if x.shape[0] >= n:
        return FlatState(x[x.shape[0] - n:].clone())
    return FlatState(torch.cat([state.tail[x.shape[0]:], x]))


def decimate_flat_any(
    state: FlatState, x: torch.Tensor, log2_decim: int, fc_pos: str = "cen",
    order: int = DECIMATORS_ORDER,
) -> tuple[FlatState, torch.Tensor]:
    """Flat ÷2^k for any placement on K1. x (T,) complex64; T a multiple of
    2^k (cen) or 4·2^k (inf/sup), any strides. Returns (state', y (T/2^k,)
    complex64)."""
    if log2_decim == 0:
        return state, x
    legs_re, legs_im, pattern = _device_legs(log2_decim, fc_pos, x.device, order)
    x = x.contiguous()  # K1 reads the block in place
    if pattern is not None:
        x = rotate(x, pattern)  # the tail is stored modulated
    y = flat_decimate(torch.view_as_real(x), legs_re, legs_im,
                      tail=torch.view_as_real(state.tail))
    return _next_tail(state, x), torch.view_as_complex(y)


def decimate_flat(
    state: FlatState, x: torch.Tensor, log2_decim: int, order: int = DECIMATORS_ORDER
) -> tuple[FlatState, torch.Tensor]:
    """The cen placement of `decimate_flat_any`."""
    return decimate_flat_any(state, x, log2_decim, "cen", order)


def decimate_flat_raw(
    state: FlatState, raw: torch.Tensor, log2_decim: int, order: int = DECIMATORS_ORDER
) -> tuple[FlatState, torch.Tensor]:
    """Fused i16 ingest + flat cen ÷2^k: raw (T, 2) int16 goes straight to
    K1, which scales by 1/32768 as it reads; the tail is carried as raw
    int16, so no float copy of the capture is ever made. raw may have any
    strides. Returns (state', y (T/2^k,) complex64)."""
    legs_re, _, _ = _device_legs(log2_decim, "cen", raw.device, order)
    raw = raw.contiguous()  # K1 reads the block in place
    y = flat_decimate(raw, legs_re, tail=state.tail)
    return _next_tail(state, raw), torch.view_as_complex(y)


class FlatIqState(NamedTuple):
    """tail: (..., 2^k·(t_leg−1), 2) float32, the carried raw I/Q."""

    tail: torch.Tensor


def init_flat_iq_state(
    log2_decim: int, device: torch.device, batch_shape=(), order: int = DECIMATORS_ORDER,
) -> FlatIqState:
    return FlatIqState(torch.zeros((*batch_shape, flat_tail_len(log2_decim, order), 2),
                                   dtype=torch.float32, device=device))


def flat_iq_state_from_numpy(tail: np.ndarray, device: torch.device) -> FlatIqState:
    """The JAX FlatIqState's tail (fetched as numpy) as this module's."""
    return FlatIqState(torch.from_numpy(np.array(tail, np.float32)).to(device))


def flat_iq_state_to_numpy(state: FlatIqState) -> np.ndarray:
    """The tail in the JAX FlatIqState's layout: (..., n, 2) float32."""
    return state.tail.cpu().numpy()


def decimate_flat_iq(
    state: FlatIqState, x_iq: torch.Tensor, log2_decim: int, order: int = DECIMATORS_ORDER,
) -> tuple[FlatIqState, torch.Tensor]:
    """Layout-native flat cen ÷2^k: x_iq (..., T, 2) float32, interleaved I/Q
    in storage order, T a multiple of 2^k. Each stream is one call of K1's
    f32 real-leg form on the block and its carried tail as two pointers, so
    nothing is transposed or copied ahead of the kernel (the JAX function's
    one NWC conv). Returns (state', y_iq (..., T/2^k, 2) float32)."""
    if log2_decim == 0:
        return state, x_iq
    if x_iq.dtype != torch.float32 or x_iq.shape[-1] != 2:
        raise TypeError(f"x_iq must be (..., T, 2) float32, got {x_iq.dtype} "
                        f"{tuple(x_iq.shape)}")
    legs_re, _, _ = _device_legs(log2_decim, "cen", x_iq.device, order)
    x_iq = x_iq.contiguous()  # K1 reads the block in place
    n, t = state.tail.shape[-2], x_iq.shape[-2]
    if t >= n:
        tail = x_iq[..., t - n:, :].clone()
    else:
        tail = torch.cat([state.tail[..., t:, :], x_iq], dim=-2)
    if x_iq.dim() == 2:
        return FlatIqState(tail), flat_decimate(x_iq, legs_re, tail=state.tail)
    blocks = x_iq.reshape(-1, t, 2)
    tails = state.tail.reshape(-1, n, 2)
    y = torch.stack([flat_decimate(b, legs_re, tail=tl) for b, tl in zip(blocks, tails)])
    return FlatIqState(tail), y.reshape(*x_iq.shape[:-2], t // (1 << log2_decim), 2)
