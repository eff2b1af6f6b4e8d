"""Polyphase rational resampler — the audio-rate decimator.

Reference: sdrbase/dsp/interpolator.{h,cpp} — a 16-phase windowed-sinc
prototype (createPolyphaseLowPass, interpolator.cpp:7-55) and a fractional
`distance` recurrence that picks the phase leg per output
(Interpolator::decimate, interpolator.h:23-35).

For in/out = p/q the per-output input window and phase leg repeat every q
outputs and p inputs, so a block of m'·p inputs is m' windows of L samples
(stride p) times a static (q, L) kernel matrix: one matmul. The carried state
is the ntaps-1 input tail. Only the decimation direction (in_rate ≥
out_rate, the Rx path) is here; Tx interpolation waits for the Tx port.
"""

from __future__ import annotations

import dataclasses
import functools
from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch


def create_polyphase_lowpass(
    phase_steps: int,
    gain: float,
    sample_rate: float,
    cutoff: float,
    nb_taps_per_phase: float = 4.5,
) -> np.ndarray:
    """Interpolator::createPolyphaseLowPass (interpolator.cpp:20-55):
    (phase_steps, ntaps_per_phase) legs, each with unit DC gain."""
    ntaps = int(nb_taps_per_phase * phase_steps)
    if ntaps % 2 != 0:
        ntaps += 1
    total = ntaps * phase_steps
    n = np.arange(total, dtype=np.float64)
    window = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (total - 1))
    m = (total - 1) // 2
    fw = 2.0 * np.pi * cutoff / sample_rate
    k = n - m
    with np.errstate(invalid="ignore", divide="ignore"):
        taps = np.where(k == 0, fw / np.pi, np.sin(k * fw) / (k * np.pi)) * window
    dc = taps[m] + 2.0 * taps[m + 1 :].sum()
    taps = taps * (gain / dc)
    legs = taps.reshape(-1, phase_steps).T  # output phase p uses taps[p::phases]
    legs = legs / legs.sum(axis=1, keepdims=True)  # interpolator.cpp:103-110
    return legs.astype(np.float32)


class ResamplerState(NamedTuple):
    tail: torch.Tensor  # (..., ntaps-1) complex64 carried input samples


@dataclasses.dataclass(frozen=True, eq=False)
class ResamplerPlan:
    """Host-precomputed schedule for one block size."""

    in_rate: float
    out_rate: float
    block_in: int  # input samples per block (multiple of p)
    block_out: int  # outputs per block (= block_in * q / p)
    ntaps: int
    phase_steps: int
    taps: np.ndarray  # (phase_steps, ntaps) float32
    start_idx: np.ndarray  # (block_out,) int32 — first input sample of each output
    phase: np.ndarray  # (block_out,) int32 — phase leg per output
    p: int = 1
    q: int = 1

    @functools.cached_property
    def residue_kernels(self) -> np.ndarray:
        """(q, L) float32: row j is output residue j's phase leg, flipped to
        the reference's newest-first ring order and placed at start_idx[j]."""
        starts = self.start_idx[: self.q]
        legs = self.taps[:, ::-1]
        sel = legs[self.phase[: self.q]]
        k = np.zeros((self.q, int(starts.max()) + self.ntaps), dtype=np.float32)
        for j in range(self.q):
            k[j, starts[j] : starts[j] + self.ntaps] = sel[j]
        return k


def make_plan(
    in_rate: float,
    out_rate: float,
    block_in: int,
    cutoff: float | None = None,
    phase_steps: int = 16,
    nb_taps_per_phase: float = 4.5,
) -> ResamplerPlan:
    """The reference-exact decimation schedule.

    Simulates Interpolator::decimate's recurrence (per input `distance -= 1`;
    whenever distance < 1 emit phase floor(distance·phaseSteps), clamped at
    0, then distance += in/out) in integer units of 1/q, over one steady
    period. The stream reproduces the reference's from its output 1 on.
    """
    if in_rate < out_rate:
        raise NotImplementedError(
            "interpolation (in_rate < out_rate) is the Tx path, which waits for "
            "the Tx port (ROADMAP.md, queue 1)")
    frac = Fraction(in_rate / out_rate).limit_denominator(1 << 20)
    p, q = frac.numerator, frac.denominator
    if block_in % p:
        raise ValueError(f"block_in={block_in} must be a multiple of p={p} "
                         f"(in_rate/out_rate={p}/{q})")
    if cutoff is None:
        cutoff = 0.4 * min(out_rate, in_rate)
    cutoff = min(cutoff, 0.45 * min(out_rate, in_rate))  # anti-alias guard
    legs16 = create_polyphase_lowpass(
        phase_steps, 1.0, phase_steps * in_rate, cutoff, nb_taps_per_phase)
    block_out = block_in * q // p
    d = 0  # distance · q
    n = 0
    emitted: list[tuple[int, int]] = []
    while n < 3 * p + 1 and len(emitted) < 2 * q + 2:
        d -= q
        if d < q:
            emitted.append((n, max((phase_steps * d) // q, 0)))
            d += p
        n += 1
    # one steady period: the q outputs emitted over inputs [p, 2p)
    base = [(nn - p, ph) for (nn, ph) in emitted if p <= nn < 2 * p]
    if len(base) != q:
        raise RuntimeError(f"resampler schedule has no steady period: {p=} {q=}")
    j = np.arange(block_out, dtype=np.int64)
    base_n = np.asarray([b[0] for b in base], np.int64)
    base_ph = np.asarray([b[1] for b in base], np.int32)
    return ResamplerPlan(
        in_rate=in_rate,
        out_rate=out_rate,
        block_in=block_in,
        block_out=block_out,
        ntaps=legs16.shape[1],
        phase_steps=phase_steps,
        taps=legs16,
        start_idx=(base_n[j % q] + (j // q) * p).astype(np.int32),
        phase=base_ph[j % q].astype(np.int32),
        p=p,
        q=q,
    )


def init_state(plan: ResamplerPlan, device: torch.device, batch_shape=()) -> ResamplerState:
    return ResamplerState(torch.zeros(
        (*batch_shape, plan.ntaps - 1), dtype=torch.complex64, device=device))


@functools.lru_cache(maxsize=None)
def _device_kernels(plan: ResamplerPlan, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(plan.residue_kernels).to(device)


def resample_block(
    state: ResamplerState, x: torch.Tensor, plan: ResamplerPlan
) -> tuple[ResamplerState, torch.Tensor]:
    """(state, x (..., block_in) complex64) -> (state', y (..., block_out)).

    Output q·m' + j = ⟨K_j, ext[m'·p : m'·p + L]⟩ with ext = [tail | x].
    """
    if x.shape[-1] != plan.block_in:
        raise ValueError(f"block of {x.shape[-1]} samples, plan expects {plan.block_in}")
    k_mat = _device_kernels(plan, x.device)  # (q, L)
    l_full = k_mat.shape[1]
    m_per = plan.block_out // plan.q
    ext = torch.cat([state.tail, x], dim=-1)
    lanes = torch.view_as_real(ext).movedim(-1, 0)  # (2, ..., N) real/imag
    need = (m_per - 1) * plan.p + l_full
    if lanes.shape[-1] < need:
        lanes = torch.nn.functional.pad(lanes, (0, need - lanes.shape[-1]))
    windows = lanes.unfold(-1, l_full, plan.p)[..., :m_per, :]  # (2, ..., m', L)
    out = torch.matmul(windows, k_mat.t())  # (2, ..., m', q)
    out = out.reshape(*out.shape[:-2], plan.block_out)
    return ResamplerState(ext[..., plan.block_in:].clone()), torch.complex(out[0], out[1])
