"""Tx pipeline — the DSPDeviceSinkEngine role.

Reference (SURVEY.md §3.5): the device sink pulls; channel sources push
through UpChannelizer trees; DSPDeviceSinkEngine::work merges several
channels by summing and dividing by their count; the filesink records the
device-rate stream as .sdriq. Per block: AF blocks (one stacked upload) →
the modulators → the UpChannelizer placement → sum/÷n merge → the device
×2^k interpolation (order 64) → int16 by clip and truncation, as the JAX
TxPipeline (sdrangel_tpu/runtime/tx.py) does it, on the pipeline's
`torch.device`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..channels import modulators as mods
from ..channels import registry
from ..dsp import channelizer as chan
from ..dsp import interpolators as interp
from .engine import fetch, pin_f32_precision, resolve_device
from .state import tree_from_numpy, tree_to_numpy

#: AF samples per block at 48 kHz (the JAX Tx session's fixed block)
BLOCK_AF = 4096

#: uri -> (make_state, modulate); the configs are registry.TX_KINDS
MOD_FUNCS = {
    "sdrangel.channeltx.modnfm": (mods.make_fm_state, mods.fm_modulate),
    "sdrangel.channeltx.modam": (mods.make_am_state, mods.am_modulate),
    "sdrangel.channeltx.modssb": (mods.make_ssb_state, mods.ssb_modulate),
    "sdrangel.channeltx.modwfm": (mods.make_wfm_state, mods.wfm_modulate),
}


@dataclasses.dataclass(frozen=True, eq=False)
class TxChannelSpec:
    uri: str  # registry key, e.g. "sdrangel.channeltx.modnfm"
    frequency_offset: float  # channel centre relative to the baseband centre
    settings: dict  # modulator config overrides
    requested_rate: float = 48000.0


@dataclasses.dataclass(frozen=True, eq=False)
class TxDeviceConfig:
    sample_rate: float  # the DAC rate
    log2_interp: int = 0
    center_frequency: float = 0.0

    @property
    def baseband_rate(self) -> float:
        return self.sample_rate / (1 << self.log2_interp)


@dataclasses.dataclass(frozen=True, eq=False)
class _Group:
    """Channels of one kind, stage depth and settings: one batched modulate
    and one UpChannelizer bank, the residual offsets and rotation signs as
    data."""

    idxs: tuple[int, ...]
    cfg: Any  # the first channel's config with input_offset 0
    make_state: Any
    modulate: Any
    signs: np.ndarray  # (C, n_stages)
    residuals: np.ndarray  # (C,) float32 carrier-NCO offsets


class TxPipeline:
    """The per-block Tx step on one torch device: AF blocks in, device-rate
    int16 I/Q out.

    sink: the device sink (DAC rate, ×2^k); channels: the modulator
    channels; device: where every tensor of the pipeline lives — the card
    unless the caller asks for the CPU; without a card, "cuda" raises."""

    def __init__(self, sink: TxDeviceConfig, channels: list[TxChannelSpec],
                 block_af: int = BLOCK_AF, device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        pin_f32_precision()
        if not channels:
            raise ValueError("a Tx pipeline needs at least one channel")
        self.sink = sink
        self.specs = channels
        self.block_af = block_af
        # the Rx frequency plan places each channel (the reference's
        # UpChannelizer runs the same createFilterChain, upchannelizer.cpp)
        self.plans = [chan.plan_channel(sink.baseband_rate, c.requested_rate,
                                        c.frequency_offset) for c in channels]
        self.mod_cfgs = []
        for spec, plan in zip(channels, self.plans):
            registry.check_kind(spec.uri, "tx")
            cfg = registry.TX_KINDS[spec.uri](
                channel_rate=plan.channel_rate, input_offset=plan.residual_offset,
                block_af=block_af, **spec.settings)
            cfg.up  # the interpolation schedule: a rate the block cannot hold raises here
            self.mod_cfgs.append(cfg)
        self.groups = [
            _Group(idxs, dataclasses.replace(self.mod_cfgs[idxs[0]], input_offset=0.0),
                   *MOD_FUNCS[channels[idxs[0]].uri],
                   np.array([self.plans[i].signs for i in idxs], np.int64).reshape(len(idxs), -1),
                   np.asarray([self.plans[i].residual_offset for i in idxs], np.float32))
            for idxs in registry.bank_groups(
                (c.uri, len(p.signs), c.settings) for c, p in zip(channels, self.plans))]
        dev = self.device
        self._rows = [torch.tensor(g.idxs, device=dev) for g in self.groups]
        self._residuals = [torch.from_numpy(g.residuals).to(dev) for g in self.groups]

    @property
    def device_block(self) -> int:
        """Device-rate samples per AF block: the channel-rate block, through
        the UpChannelizer and the ×2^k cascade. (The JAX property floors the
        resampler's ratio and reads 786,432 where 819,200 come out at 9.6 MS/s
        ×64; ROADMAP.md §3.)"""
        cfg, plan = self.mod_cfgs[0], self.plans[0]
        return (cfg.up.block_out * plan.decimation) << self.sink.log2_interp

    def init_state(self) -> dict:
        dev = self.device
        return {
            "mod": [g.make_state(g.cfg, dev, (len(g.idxs),)) for g in self.groups],
            "up": [interp.init_state(g.signs.shape[1], dev, (len(g.idxs),))
                   for g in self.groups],
            "dev": interp.init_state(self.sink.log2_interp, dev, order=interp.DEVICE_ORDER),
        }

    def state_from_numpy(self, tree: dict) -> dict:
        """The JAX TxPipeline's state (fetched as numpy, e.g. with
        jax.tree.map(np.asarray, state)) as this pipeline's state: the
        modulator states, the UpChannelizer tails and the device tails,
        matched by name against `init_state()`."""
        return tree_from_numpy(self.init_state(), tree)

    def state_to_numpy(self, state: dict) -> dict:
        """This pipeline's state as numpy in the JAX package's field types
        (NCO phases as uint32)."""
        return tree_to_numpy(state)

    def step(self, state: dict, af: torch.Tensor) -> tuple[dict, torch.Tensor]:
        """af: (channels, block_af) float32 on the pipeline's device, one row
        per channel in the pipeline's order. Returns (state', (device_block,
        2) int16)."""
        if af.device.type != self.device.type:
            raise ValueError(f"AF block on {af.device}, pipeline on {self.device}")
        mod_states, up_states, merged = [], [], None
        for g, group in enumerate(self.groups):
            rows = af if len(self.groups) == 1 else af.index_select(0, self._rows[g])
            mstate, iq = group.modulate(state["mod"][g], rows, group.cfg, self._residuals[g])
            ustate, bb = interp.upchannelize_bank(state["up"][g], iq, group.signs)
            mod_states.append(mstate)
            up_states.append(ustate)
            contrib = bb.sum(dim=0)
            merged = contrib if merged is None else merged + contrib
        if len(self.specs) > 1:  # the sum/÷n merge (dspdevicesinkengine work loop)
            merged = merged / len(self.specs)
        dev_state, out = interp.interpolate_cascade(
            state["dev"], merged, self.sink.log2_interp, order=interp.DEVICE_ORDER)
        # clip x·32768 and truncate toward zero, as JAX's astype(int16)
        i16 = (torch.view_as_real(out) * 32768.0).clamp(-32768.0, 32767.0).to(torch.int16)
        return {"mod": mod_states, "up": up_states, "dev": dev_state}, i16

    def upload(self, afs: list[np.ndarray]) -> torch.Tensor:
        """The channels' AF blocks as one (C, block_af) float32 tensor on the
        pipeline's device: one stacked copy (pinned and asynchronous on the
        card)."""
        t = torch.from_numpy(np.stack(afs).astype(np.float32, copy=False))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def run(self, af_source, n_blocks: int, state: dict | None = None):
        """af_source(block_idx, channel_idx, count) -> float32 AF block.
        Yields (device_block, 2) int16 numpy blocks, read back one block
        behind, so the host reads block N while block N+1 is queued."""
        state = self.init_state() if state is None else state
        pending = None
        for b in range(n_blocks):
            af = self.upload([af_source(b, c, self.block_af) for c in range(len(self.specs))])
            state, out = self.step(state, af)
            if pending is not None:
                yield fetch(pending)
            pending = out
        if pending is not None:
            yield fetch(pending)
        self.final_state = state
