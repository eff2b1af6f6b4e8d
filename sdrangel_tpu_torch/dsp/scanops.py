"""Parallel form of the reference's per-sample saturating counter
(nfmdemod.cpp:178-240 squelch gate).

The map x -> clamp(x + a, l, h) is closed under composition, so the
recurrence count[t] = clamp(count[t-1] + d[t], lo, hi) is an inclusive scan
over (a, l, h) triples. It runs as a Hillis–Steele doubling scan: log2(T)
whole-block steps (16 for a 49,152-sample audio block), never a per-sample
loop.
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


def saturating_counter(
    deltas: torch.Tensor, lo: float, hi: float, init: torch.Tensor
) -> torch.Tensor:
    """count[t] = clamp(count[t-1] + deltas[t], lo, hi), count[-1] = init.

    deltas (..., T); init (...,). Returns the (..., T) float32 series."""
    a = deltas.to(torch.float32)
    l = torch.full_like(a, lo)
    h = torch.full_like(a, hi)
    t = a.shape[-1]
    for step in (1 << s for s in range(math.ceil(math.log2(max(t, 1))))):
        # positions ≥ step compose with the prefix ending `step` earlier;
        # the first `step` positions already hold their full prefix
        ca, cl, ch = _clamp_compose(
            (a[..., :-step], l[..., :-step], h[..., :-step]),
            (a[..., step:], l[..., step:], h[..., step:]),
        )
        a = torch.cat([a[..., :step], ca], dim=-1)
        l = torch.cat([l[..., :step], cl], dim=-1)
        h = torch.cat([h[..., :step], ch], dim=-1)
    return torch.clamp(init[..., None] + a, l, h)
