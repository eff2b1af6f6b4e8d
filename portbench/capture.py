"""The benchmark's traffic: an i16 I/Q capture of NFM carriers over white
noise, made from the seed on the device.

One general generator reads a traffic file's `carriers` and `noise_dbfs`.
The carriers sit at the cell's channel frequencies: the seed picks
`count` of them, no two closer than `min_spacing_hz`, uniformly among
every such choice; it deals `count` of the fixed `levels_dbfs` out to them in its own order,
and draws each carrier's tone and deviation in their ranges, so every
seed carries the same set of sizes and levels. Each carrier is FM by
one tone; the noise is complex Gaussian of the stated total power; the
sum is quantized to int16 as the ADC would. Blocks of the ring are
consecutive stretches of one signal.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


#: draws of carrier places before a traffic's spacing is taken as unmet
TRIES = 100_000


@dataclasses.dataclass(frozen=True)
class Carrier:
    freq_hz: float
    level_dbfs: float
    tone_hz: float
    deviation_hz: float
    tone_phase: float
    phase: float


def draw_carriers(spec: dict, frequencies_hz, seed: int) -> list[Carrier]:
    """`spec` (a traffic file's `carriers`) on the cell's channel
    frequencies, as the seed draws them."""
    rng = np.random.default_rng([seed, 0])
    freqs = np.array(sorted(set(float(f) for f in frequencies_hz)))
    count, spacing = spec["count"], spec["min_spacing_hz"]
    for _ in range(TRIES):  # uniform over the choices that keep the spacing
        chosen = freqs[np.sort(rng.choice(len(freqs), size=count, replace=False))]
        if np.all(np.diff(chosen) >= spacing - 1e-6):
            break
    else:
        raise ValueError(f"no {count} of {freqs.tolist()} found {spacing} Hz apart")
    levels = rng.choice(np.asarray(spec["levels_dbfs"], np.float64), size=count, replace=False)
    tone = rng.uniform(*spec["tone_hz"], size=count)
    dev = rng.uniform(*spec["deviation_hz"], size=count)
    phases = rng.uniform(0, 2 * math.pi, size=(2, count))
    return [Carrier(float(f), float(lv), float(t), float(d), float(p0), float(p1))
            for f, lv, t, d, p0, p1 in zip(chosen, levels, tone, dev, *phases)]


def _turns(n: torch.Tensor, freq: float, rate: float) -> torch.Tensor:
    """frac(freq·n/rate) in float64, exact for every n of a capture."""
    return torch.remainder(n * (freq / rate), 1.0)


def block(index: int, length: int, rate: float, carriers: list[Carrier], noise_dbfs: float,
          noise: torch.Generator, device) -> torch.Tensor:
    """Block `index` of the capture: (length, 2) int16, the signal in
    float64 on `device`, the noise drawn from `noise` in one call."""
    n = index * length + torch.arange(length, dtype=torch.float64, device=device)
    phase = torch.zeros(length, dtype=torch.float64, device=device)
    re = torch.zeros_like(phase)
    im = torch.zeros_like(phase)
    for c in carriers:
        phase = (2 * math.pi * _turns(n, c.freq_hz, rate) + c.phase
                 + c.deviation_hz / c.tone_hz
                 * torch.sin(2 * math.pi * _turns(n, c.tone_hz, rate) + c.tone_phase))
        amp = 10.0 ** (c.level_dbfs / 20.0)
        re += amp * torch.cos(phase)
        im += amp * torch.sin(phase)
    sigma = math.sqrt(10.0 ** (noise_dbfs / 10.0) / 2.0)
    iq = torch.stack([re, im], dim=-1)
    iq += sigma * torch.randn((length, 2), generator=noise, dtype=torch.float64, device=device)
    return torch.round(iq * 32768.0).clamp(-32768, 32767).to(torch.int16)


def ring(traffic: dict, frequencies_hz, rate: float, length: int, seed: int, device
         ) -> torch.Tensor:
    """The cell's ring of `traffic["ring_blocks"]` blocks: (R, length, 2)
    int16 on `device`."""
    carriers = draw_carriers(traffic["carriers"], frequencies_hz, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty((traffic["ring_blocks"], length, 2), dtype=torch.int16, device=device)
    for r in range(out.shape[0]):
        out[r] = block(r, length, rate, carriers, traffic["noise_dbfs"], gen, device)
    return out
