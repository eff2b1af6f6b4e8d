"""The channel-bank gear of the JAX package's parallel/sharded.py on one card.

The JAX gear runs a demod bank over a (time × channel) device mesh:
the i16 capture is decimated ÷2^k with the filter history handed between
time shards, the baseband is all-gathered, optionally split by one
polyphase DFT bank (`pfb_m`), and each demod of the bank takes its channel
with its own residual offset on its NCO. Its headline configuration (the
bench's `chainpfb` / `chainsharded` gear) is 12.288 MS/s ÷64 → PFB-4 →
16 NFM.

On one card (n_time = n_channel = 1) every collective is an identity: the
halo carried into the block is the previous block's own tail, the
frame-sharded analysis is the whole analysis, and the all-gather returns
the local baseband. What is left is one program per block:

  cen:     the block and the raw int16 carry's tail → K1-TC (tensor cores)
           as two pointers, with no copy of the block
  inf/sup: ingest → the flat decimator on K1's complex legs, the carried
           tail injected and modulated as the JAX `_cascade_with_halo` does
  pfb_m:   `pfb.analyze` over the baseband, each demod's grid channel
           taken with `index_select` (the JAX one-hot product only dodges
           a TPU gather compile)
  else:    the baseband broadcast to the bank, plus `chan_stages` centre
           half-band stages (`channelizer.channelize_bank`)
  then:    one batched `process` call per bank group, offsets per channel.

A mesh larger than 1×1 and the all-to-all gear (`pfb_all_to_all`) raise
NotImplementedError: several cards wait in ROADMAP.md's `parallel/` queue.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.profiler import record_function

from ..channels.registry import REGISTRY
from ..dsp import channelizer as chan
from ..dsp import decimators as dec
from ..dsp import pfb as pfbmod
from ..dsp import spectrum as dsp_spectrum
from ..dsp.hbfilter import DECIMATORS_ORDER
from ..dsp.types import iq_raw_to_complex64
from ..kernels.flat_decimate_tc import flat_decimate_tc
from ..runtime.engine import _from_numpy, _to_numpy, pin_f32_precision, resolve_device

NFM_URI = "sdrangel.channel.nfmdemod"
#: the step's layers, each a torch.profiler range, so that a profiled run
#: splits the step's time by layer (profile_product --gear bank reads them)
LAYERS = ("gear ÷2^k decimator", "gear spectrum tap", "gear PFB analysis",
          "gear channel select", "gear demod bank")
_MULTI_CARD = ("several cards wait for the port of parallel/ over torch.distributed "
               "(ROADMAP.md, queue 1, item 7)")


def halo_samples(log2_decim: int, order: int = DECIMATORS_ORDER) -> int:
    """Input-rate halo H covering the whole cascade's filter history:
    (L−1)(2^k − 1) with L = order−1 taps, rounded up to a multiple of 4·2^k
    so rotation patterns and stage strides stay aligned."""
    if log2_decim == 0:
        return 0
    l_taps = order - 1
    need = (l_taps - 1) * ((1 << log2_decim) - 1)
    align = 4 << log2_decim
    return ((need + align - 1) // align + 1) * align


def _cascade_with_halo(x: torch.Tensor, carry: torch.Tensor, log2: int, fc_pos: str
                       ) -> torch.Tensor:
    """÷2^k of one block x (T, 2) int16 whose predecessor's last H raw
    samples are `carry` (H, 2) int16. Returns the baseband (T/2^k,) complex64.

    The block length must be a multiple of 4·2^k, so the rotation pattern of
    inf/sup starts at phase 0 at every block boundary."""
    if x.shape[0] % (4 << log2):
        raise ValueError(f"block of {x.shape[0]} samples must be a multiple of "
                         f"{4 << log2} (=4·2^log2_decim) for rotation phase alignment")
    tail_len = dec.flat_tail_len(log2)
    if tail_len > carry.shape[0]:
        raise ValueError(f"halo {carry.shape[0]} shorter than flat tail {tail_len}")
    tail = carry[carry.shape[0] - tail_len:]
    if fc_pos == "cen":
        legs, _, _ = dec._device_legs(log2, "cen", x.device)
        return torch.view_as_complex(flat_decimate_tc(x, legs, tail=tail))
    # the flat inf/sup state stores its tail modulated by the rotation
    # pattern; the tail sits at positions [-tail_len, 0) before the block,
    # where the pattern has phase 0
    _, _, pattern = dec._device_legs(log2, fc_pos, x.device)
    idx = torch.arange(-tail_len, 0, device=x.device) % pattern.shape[0]
    state = dec.FlatState(iq_raw_to_complex64(tail) * pattern[idx])
    _, y = dec.decimate_flat_any(state, iq_raw_to_complex64(x), log2, fc_pos)
    return y


@dataclasses.dataclass(frozen=True, eq=False)
class BankGroup:
    """One homogeneous slice of the demod bank."""

    uri: str
    count: int  # channels of this kind
    settings: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedPipelineConfig:
    """The demod-bank gear's configuration, field for field the JAX one
    except `time_axis_channels`, which only splits a bank over a mesh.
    Default bank: n_channels NFM demods."""

    n_time: int
    n_channel: int
    device_rate: float = 12_288_000.0  # /64 -> 192 kHz baseband (integer ratio to 48k audio)
    log2_decim: int = 6
    fc_pos: str = "cen"
    n_channels: int = 64  # default-bank size
    chan_stages: int = 0  # extra per-channel ÷2 stages after the device cascade
    #: uniform-grid gear: M > 0 runs one polyphase DFT bank (dsp/pfb.py) over
    #: the baseband; each demod takes its grid channel by index and absorbs
    #: the residual on its NCO. Channel rate becomes baseband_rate / pfb_m.
    #: Mutually exclusive with chan_stages.
    pfb_m: int = 0
    pfb_all_to_all: bool = False  # the multi-card axis-swap gear (not ported)
    pfb_taps: int = 12  # PFB prototype taps per branch
    block: int = 1 << 20  # device-rate samples per step
    bank: tuple[BankGroup, ...] | None = None  # heterogeneous bank override
    #: optional baseband spectrum tap: a SpectrumConfig makes step() return a
    #: 4th output, the block's unaveraged display frame (the caller averages)
    spectrum: object | None = None

    @property
    def baseband_rate(self) -> float:
        return self.device_rate / (1 << self.log2_decim)

    @functools.cached_property
    def groups(self) -> tuple[BankGroup, ...]:
        if self.bank is not None:
            return tuple(self.bank)
        # bench default: squelch open, minimal attack so short runs produce audio
        return (BankGroup(NFM_URI, self.n_channels,
                          {"squelch_db": -100.0, "squelch_gate_ms": 1.0}),)

    @functools.cached_property
    def demod_cfgs(self) -> tuple:
        """Per-group demod configs bound to the post-channelizer rate."""
        if self.pfb_m:
            if self.chan_stages:
                raise ValueError("pfb_m and chan_stages are mutually exclusive")
            rate = self.baseband_rate / self.pfb_m
            block_in = (self.block >> self.log2_decim) // self.pfb_m
        else:
            rate = self.baseband_rate / (1 << self.chan_stages)
            block_in = (self.block >> self.log2_decim) >> self.chan_stages
        cfgs = []
        for g in self.groups:
            kind = REGISTRY[g.uri]
            kwargs = dict(channel_rate=rate, input_offset=0.0, **g.settings)
            if any(f.name == "block_in" for f in dataclasses.fields(kind.config_cls)):
                kwargs["block_in"] = block_in
            cfgs.append(kind.config_cls(**kwargs))
        return tuple(cfgs)

    @functools.cached_property
    def demod_cfg(self):
        """Single-group convenience accessor (the homogeneous-bank case)."""
        (cfg,) = self.demod_cfgs
        return cfg


def _validate_bank(cfg: ShardedPipelineConfig) -> None:
    if cfg.n_time != 1 or cfg.n_channel != 1:
        raise NotImplementedError(
            f"a {cfg.n_time}x{cfg.n_channel} mesh: this gear runs on one card; "
            + _MULTI_CARD)
    if cfg.pfb_all_to_all:
        raise NotImplementedError("the pfb_all_to_all gear trades frames for channels "
                                  "between cards; " + _MULTI_CARD)
    for g in cfg.groups:
        kind = REGISTRY.get(g.uri)
        if kind is None:
            raise ValueError(f"unknown channel kind {g.uri!r}")
        if kind.output != "audio":
            raise ValueError(f"the bank gear supports audio kinds; {g.uri} is data")
        if "offset_hz" not in kind.dynamic_fields:
            raise ValueError(f"{g.uri} does not take offset_hz per block")


def grid_split(cfg: ShardedPipelineConfig, offsets: np.ndarray):
    """PFB-gear helper: absolute channel offsets (Hz) -> (grid index mod M,
    residual Hz for the demod NCO)."""
    spacing = cfg.baseband_rate / cfg.pfb_m
    idx = np.rint(np.asarray(offsets) / spacing).astype(np.int64)
    residual = (np.asarray(offsets) - idx * spacing).astype(np.float32)
    return (idx % cfg.pfb_m).astype(np.int32), residual


def build_sharded_step(cfg: ShardedPipelineConfig, device: torch.device | str = "cuda"):
    """Returns (step, init_fn) with the JAX call signature:
    step(state, x, carry, offsets[, pfb_idx]) -> (state', audio, carry'[, spectrum]).

    x: (block, 2) int16 on the gear's device. carry: (H, 2) int16 — the
    previous block's last H raw samples (JAX holds them as (2, H) float32;
    see `state_from_numpy`). offsets: per-channel Hz — one (C,) float32
    tensor for a single-group bank, a tuple per group otherwise; with pfb_m
    they are the residuals of `grid_split` and pfb_idx the grid indices.
    audio: (C, A) float32, or a tuple per group.

    device defaults to cuda and raises without a card; nothing falls back to
    the CPU, which only the tests ask for. TF32 is turned off, as
    `RxPipeline` does."""
    _validate_bank(cfg)
    dev = resolve_device(device)
    pin_f32_precision()
    halo = halo_samples(cfg.log2_decim)
    kinds = [REGISTRY[g.uri] for g in cfg.groups]
    demod_cfgs = cfg.demod_cfgs
    single = len(cfg.groups) == 1
    if cfg.block % (4 << cfg.log2_decim):
        raise ValueError(f"block {cfg.block} must be a multiple of {4 << cfg.log2_decim}")
    if cfg.pfb_m and (cfg.block >> cfg.log2_decim) % cfg.pfb_m:
        raise ValueError(f"block {cfg.block}: the baseband must hold whole PFB frames "
                         f"of {cfg.pfb_m}")
    h = pfbmod.prototype(cfg.pfb_m, cfg.pfb_taps) if cfg.pfb_m else None
    scfg = (dataclasses.replace(cfg.spectrum, averaging_mode="none")
            if cfg.spectrum is not None else None)
    decimate, spectrum, analysis, select, demod = (
        functools.partial(record_function, name) for name in LAYERS)

    def step(state, x, carry, offsets, pfb_idx=None):
        if x.device.type != dev.type or x.dtype != torch.int16 or x.shape != (cfg.block, 2):
            raise ValueError(f"x must be ({cfg.block}, 2) int16 on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        if single and not isinstance(offsets, (tuple, list)):
            offsets = (offsets,)
        if cfg.pfb_m:
            if pfb_idx is None:
                raise ValueError("pfb_m set: pass pfb_idx (see grid_split)")
            if single and not isinstance(pfb_idx, (tuple, list)):
                pfb_idx = (pfb_idx,)
            state, pfb_state = state

        with decimate():
            if halo:
                bb = _cascade_with_halo(x, carry, cfg.log2_decim, cfg.fc_pos)
                new_carry = x[x.shape[0] - halo:].clone()
            else:
                bb, new_carry = iq_raw_to_complex64(x), carry

        spec = None
        if scfg is not None:  # stateless display frame of the block
            with spectrum():
                _, spec = dsp_spectrum.power_spectrum(
                    dsp_spectrum.make_state(scfg, dev), bb, scfg)

        if cfg.pfb_m:
            with analysis():
                pfb_state, ych = pfbmod.analyze(pfb_state, bb, cfg.pfb_m, h)  # (F, M)

        new_states, audios = [], []
        for g, (kind, gcfg) in enumerate(zip(kinds, demod_cfgs)):
            cstate, dstate = state[g]
            with select():
                if cfg.pfb_m:
                    idx = torch.as_tensor(pfb_idx[g], device=dev).to(torch.int64)
                    xb = ych.index_select(-1, idx).t()  # (C, F)
                else:
                    xb = bb.expand(cfg.groups[g].count, bb.shape[-1])
                    if cfg.chan_stages:
                        signs = np.zeros((cfg.groups[g].count, cfg.chan_stages), int)
                        cstate, xb = chan.channelize_bank(cstate, xb, signs)
            with demod():
                dstate, audio = kind.process(dstate, xb, gcfg, offset_hz=offsets[g])
            new_states.append((cstate, dstate))
            audios.append(audio)
        out_state = tuple(new_states)
        if cfg.pfb_m:
            out_state = (out_state, pfb_state)
        audio = audios[0] if single else tuple(audios)
        if spec is None:
            return out_state, audio, new_carry
        return out_state, audio, new_carry, spec

    def init_fn():
        return _state_structure(cfg, dev), torch.zeros(
            (max(halo, 1), 2), dtype=torch.int16, device=dev)

    return step, init_fn


def _group_state_structure(cfg: ShardedPipelineConfig, device: torch.device):
    """Per-group (channelizer state, demod state), batch dim = group count."""
    out = []
    for g, gcfg in zip(cfg.groups, cfg.demod_cfgs):
        kind = REGISTRY[g.uri]
        cstate = chan.init_state(cfg.chan_stages, device, batch_shape=(g.count,))
        out.append((cstate, kind.make_state(gcfg, device, batch_shape=(g.count,))))
    return tuple(out)


def _state_structure(cfg: ShardedPipelineConfig, device: torch.device):
    groups = _group_state_structure(cfg, device)
    if cfg.pfb_m:
        return (groups, pfbmod.make_state(cfg.pfb_m, device, cfg.pfb_taps))
    return groups


def state_from_numpy(cfg: ShardedPipelineConfig, tree, carry, device: torch.device | str):
    """The JAX gear's (state, carry), fetched as numpy (e.g. with
    jax.tree.map(np.asarray, ...)), as this gear's. Fields are matched by
    name; JAX fields the port does not carry (the NFM Goertzel and CTCSS
    states) are dropped. The (2, H) float32 carry, which holds int16 samples
    / 32768, becomes the (H, 2) int16 raw carry by an exact ×32768."""
    dev = resolve_device(device)
    state = _from_numpy(_state_structure(cfg, dev), tree)
    raw = np.round(np.asarray(carry, np.float64).T * 32768.0)
    if np.any(raw < -32768) or np.any(raw > 32767):
        raise ValueError("carry holds values outside the int16 range ×1/32768")
    return state, torch.from_numpy(np.ascontiguousarray(raw.astype(np.int16))).to(dev)


def state_to_numpy(state, carry):
    """This gear's (state, carry) in the JAX gear's types: NCO phases as
    uint32 and the carry as (2, H) float32."""
    c = carry.cpu().numpy().astype(np.float32) / 32768.0
    return _to_numpy(state), np.ascontiguousarray(c.T)
