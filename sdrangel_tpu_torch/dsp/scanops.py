"""Parallel forms of the reference's per-sample recurrences: the saturating
counter (nfmdemod.cpp:178-240 squelch gate) and the one-pole EMA
(filterrc.cpp, freqlockcomplex.cpp).

The map x -> clamp(x + a, l, h) is closed under composition, so the
recurrence count[t] = clamp(count[t-1] + d[t], lo, hi) is an inclusive scan
over (a, l, h) triples; y -> d·y + a likewise over (d, a) pairs. Both run as
a Hillis–Steele doubling scan: log2(T) whole-block steps (16 for a
49,152-sample audio block), never a per-sample loop.
"""

from __future__ import annotations

import math

import torch

Triple = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _clamp_compose(f: Triple, g: Triple) -> Triple:
    """g∘f, f applied first: x -> clamp(clamp(x + af, lf, hf) + ag, lg, hg)."""
    af, lf, hf = f
    ag, lg, hg = g
    return af + ag, torch.clamp(lf + ag, lg, hg), torch.clamp(hf + ag, lg, hg)


def _doubling_scan(elems: tuple[torch.Tensor, ...], compose) -> tuple[torch.Tensor, ...]:
    """Inclusive scan of a tuple of (..., T) tensors along the last axis."""
    t = elems[0].shape[-1]
    for step in (1 << s for s in range(math.ceil(math.log2(max(t, 1))))):
        # positions ≥ step compose with the prefix ending `step` earlier;
        # the first `step` positions already hold their full prefix
        done = compose(tuple(e[..., :-step] for e in elems), tuple(e[..., step:] for e in elems))
        elems = tuple(torch.cat([e[..., :step], c], dim=-1) for e, c in zip(elems, done))
    return elems


def saturating_counter(
    deltas: torch.Tensor, lo: float, hi: float, init: torch.Tensor
) -> torch.Tensor:
    """count[t] = clamp(count[t-1] + deltas[t], lo, hi), count[-1] = init.

    deltas (..., T); init (...,). Returns the (..., T) float32 series."""
    a = deltas.to(torch.float32)
    a, l, h = _doubling_scan((a, torch.full_like(a, lo), torch.full_like(a, hi)),
                             _clamp_compose)
    return torch.clamp(init[..., None] + a, l, h)


def _ema_compose(f: tuple, g: tuple) -> tuple:
    """g∘f for the affine maps y -> d·y + a, f applied first."""
    df, af = f
    dg, ag = g
    return df * dg, af * dg + ag


def ema(x: torch.Tensor, alpha: float, init: torch.Tensor) -> torch.Tensor:
    """y[t] = (1 − alpha)·y[t−1] + alpha·x[t], y[−1] = init (JAX
    scanops.ema, scanops.py:104-115). x (..., T) float32; init (...,)."""
    add = (x * alpha).to(torch.float32)
    d, a = _doubling_scan((torch.full_like(add, 1.0 - alpha), add), _ema_compose)
    return init[..., None] * d + a
