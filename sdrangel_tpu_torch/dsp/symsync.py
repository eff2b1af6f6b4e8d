"""Symbol timing synchronizer (Gardner), the liquid-dsp symsync role
(sdrbase/dsp/symsync.{h,cpp}).

The stream is oversampled at `sps` samples a symbol. A block-level Gardner
detector measures the mean timing error over every symbol of the block (one
reduction, no per-symbol loop); a loop filter carried between blocks moves
the fractional phase; symbols are gathered at the corrected instant.
Per-symbol feedback becomes per-block feedback, which holds while the clock
offset is far below a symbol per block.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SymSyncState(NamedTuple):
    mu: torch.Tensor  # (...,) timing phase in samples, in [0, 2·sps)
    freq: torch.Tensor  # (...,) timing frequency error (samples a symbol)
    tail: torch.Tensor  # (..., 2·sps) complex64 carried look-ahead samples


def make_state(device: torch.device, batch_shape=(), sps: int = 10) -> SymSyncState:
    # mu starts mid-window (= sps), away from both edges. It is carried
    # continuously, clamped and never wrapped: a wrap at a block seam drops
    # or repeats a whole symbol
    return SymSyncState(
        torch.full(batch_shape, float(sps), dtype=torch.float32, device=device),
        torch.zeros(batch_shape, dtype=torch.float32, device=device),
        torch.zeros((*batch_shape, 2 * sps), dtype=torch.complex64, device=device),
    )


def synchronize_block(
    state: SymSyncState, x: torch.Tensor, sps: int, loop_gain: float = 0.05,
) -> tuple[SymSyncState, torch.Tensor]:
    """x (..., T) complex64 at sps samples a symbol, T a multiple of sps.
    Returns (state', symbols (..., T/sps)) taken at the tracked instant:
    exactly T/sps symbols a block, none lost at a seam (the 2·sps carried
    tail holds the mid and next look-ahead). Gardner's error is
    e = Re[(y_k − y_{k−1})·conj(y_mid)], > 0 when the sample is late."""
    if x.shape[-1] % sps:
        raise ValueError(f"block of {x.shape[-1]} samples is no multiple of sps={sps}")
    ext = torch.cat([state.tail, x], dim=-1)
    n_sym = x.shape[-1] // sps
    base = torch.arange(n_sym, device=x.device) * sps
    # round half to even, as jnp.round
    idx = base + torch.round(state.mu).to(torch.int64)[..., None]

    def at(offset: int) -> torch.Tensor:
        return torch.gather(ext, -1, (idx + offset).expand(*ext.shape[:-1], n_sym))

    on_time, nxt, mid = at(0), at(sps), at(sps // 2)
    d = nxt - on_time
    err = torch.mean(d.real * mid.real + d.imag * mid.imag, dim=-1)
    freq = state.freq + 0.1 * loop_gain * err
    # continuous phase clamped to the tail window: wrapping at a seam would
    # slip a whole symbol
    mu = torch.clamp(state.mu + loop_gain * err * sps + freq, 0.0, 2.0 * sps - 1.01)
    return SymSyncState(mu, freq, ext[..., x.shape[-1]:].clone()), nxt
