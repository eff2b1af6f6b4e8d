"""The channel-bank gears of the JAX package's parallel/sharded.py on a
(time × channel) mesh of torch devices (parallel/mesh.py).

A gear runs a demod bank over the mesh: the i16 capture is split over
"time", each time shard decimates ÷2^k its own slice with its left
neighbour's last raw samples as the carried tail (the halo ring), and the
bank's channels are split over "channel", or over both axes when every
group divides over the whole mesh (`channel_split`). Two gears, as in JAX:

  all-gather (build_sharded_step): the basebands are all-gathered over
      "time"; with `pfb_m` each shard analyses its own chunk of frames of
      one polyphase DFT bank with a (P−1)·M halo taken from the gathered
      baseband, and the chunks are all-gathered over both axes; each demod
      takes its grid channel with `index_select` (the JAX one-hot product
      only dodged a TPU gather compile). Without `pfb_m` the baseband is
      broadcast to the bank, plus `chan_stages` centre half-band stages.
  all-to-all (build_a2a_step, `pfb_all_to_all`): no gather of the
      baseband; a second ring hands each time shard its PFB halo, each
      column analyses its sub-chunk of the shard's frames, and one
      all_to_all over both axes trades frames for channels: shard d gets
      every frame of grid channels [d·M/D, (d+1)·M/D), D shards in all.

Each time shard's cascade is K1-TC (cen: the shard and its received raw
halo as two pointers) or K1's complex legs (inf/sup). Every shard computes
its own cascade, analysis and bank chunk, as each of JAX's devices does,
also where several shards sit on one device. The next block's carry is the ring's wrap-around, received by time
row 0: the last time shard's raw tail. A 1×1 mesh, or a bare device, is
the one-card program: every collective is the identity.

A step's state holds only this process's shards (`GearState`); audio comes
back as the rows this process holds (`step.rows`, all of them in one
process), on the mesh's home device. `state_from_numpy`/`state_to_numpy`
move the JAX gear's global state and carry in and out.
"""

from __future__ import annotations

import dataclasses
import functools
import logging

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
from .mesh import Mesh, make_mesh

NFM_URI = "sdrangel.channel.nfmdemod"
#: the step's layers, each a torch.profiler range, so that a profiled run
#: splits the step's time by layer (profile_product --gear bank reads them)
LAYERS = (DECIMATE, COLLECTIVES, SPECTRUM, ANALYSIS, SELECT, DEMOD) = (
    "gear ÷2^k decimator", "gear collectives", "gear spectrum tap", "gear PFB analysis",
    "gear channel select", "gear demod bank")

_log = logging.getLogger(__name__)


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
    """÷2^k of one shard x (T, 2) int16 whose predecessor's last H raw
    samples are `carry` (H, 2) int16. Returns the baseband (T/2^k,) complex64.

    The shard length must be a multiple of 4·2^k, so the rotation pattern of
    inf/sup starts at phase 0 at every shard boundary."""
    if x.shape[0] % (4 << log2):
        raise ValueError(f"shard of {x.shape[0]} samples must be a multiple of "
                         f"{4 << log2} (=4·2^log2_decim) for rotation phase alignment")
    tail_len = dec.flat_tail_len(log2)
    if tail_len > carry.shape[0]:
        raise ValueError(f"halo {carry.shape[0]} shorter than flat tail {tail_len}")
    tail = carry[carry.shape[0] - tail_len:]
    if fc_pos == "cen":
        legs, _, _ = dec._device_legs(log2, "cen", x.device)
        return torch.view_as_complex(flat_decimate_tc(x, legs, tail=tail))
    # the flat inf/sup state stores its tail modulated by the rotation
    # pattern; the tail sits at positions [-tail_len, 0) before the shard,
    # where the pattern has phase 0
    _, _, pattern = dec._device_legs(log2, fc_pos, x.device)
    idx = torch.arange(-tail_len, 0, device=x.device) % pattern.shape[0]
    state = dec.FlatState(iq_raw_to_complex64(tail) * pattern[idx])
    _, y = dec.decimate_flat_any(state, iq_raw_to_complex64(x), log2, fc_pos)
    return y


def _pfb_with_halo(seg: torch.Tensor, m: int, h: np.ndarray) -> torch.Tensor:
    """The analysis of one frame chunk whose first (P−1)·M samples are its
    halo, injected as the carried tail: (F, M)."""
    ph = len(h) - m
    _, y = pfbmod.analyze(pfbmod.PfbState(seg[:ph]), seg[ph:], m, h)
    return y


@dataclasses.dataclass(frozen=True, eq=False)
class BankGroup:
    """One homogeneous slice of the demod bank."""

    uri: str
    count: int  # channels of this kind (multiple of the mesh channel axis)
    settings: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedPipelineConfig:
    """The demod-bank gear's configuration, field for field the JAX one.
    Default bank: n_channels NFM demods."""

    n_time: int
    n_channel: int
    device_rate: float = 12_288_000.0  # /64 -> 192 kHz baseband (integer ratio to 48k audio)
    log2_decim: int = 6
    fc_pos: str = "cen"
    n_channels: int = 64  # default-bank size (multiple of n_channel)
    chan_stages: int = 0  # extra per-channel ÷2 stages after the device cascade
    #: uniform-grid gear: M > 0 runs one polyphase DFT bank (dsp/pfb.py) over
    #: the baseband; each demod takes its grid channel by index and absorbs
    #: the residual on its NCO. Channel rate becomes baseband_rate / pfb_m.
    #: Mutually exclusive with chan_stages.
    pfb_m: int = 0
    #: the axis-swap gear: frame-sharded analysis and one all_to_all over
    #: both axes in place of the baseband all_gather (build_a2a_step)
    pfb_all_to_all: bool = False
    pfb_taps: int = 12  # PFB prototype taps per branch
    block: int = 1 << 20  # device-rate samples per step (global)
    bank: tuple[BankGroup, ...] | None = None  # heterogeneous bank override
    #: split the bank over both mesh axes in place of repeating each
    #: channel chunk on every time shard; None = when every group count
    #: divides over n_time·n_channel
    time_axis_channels: bool | None = None
    #: optional baseband spectrum tap: a SpectrumConfig makes step() return a
    #: 4th output, the block's unaveraged display frame (the caller averages)
    spectrum: object | None = None

    @functools.cached_property
    def channel_split(self) -> int:
        """Shards each channel group is split across (n_channel or
        n_time·n_channel)."""
        full = self.n_time * self.n_channel
        if self.time_axis_channels is None:
            ok = all(g.count % full == 0 for g in self.groups)
            return full if ok else self.n_channel
        if self.time_axis_channels:
            for g in self.groups:
                if g.count % full:
                    raise ValueError(
                        f"time_axis_channels needs group counts divisible by "
                        f"n_time*n_channel={full}; {g.uri} has {g.count}")
            return full
        return self.n_channel

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
    if cfg.pfb_all_to_all:
        if not cfg.pfb_m:
            raise ValueError("pfb_all_to_all requires pfb_m")
        full = cfg.n_time * cfg.n_channel
        if cfg.pfb_m % full:
            raise ValueError(f"pfb_m={cfg.pfb_m} must divide over the mesh "
                             f"(n_time*n_channel={full})")
        for g in cfg.groups:
            if g.count % full:
                raise ValueError(f"pfb_all_to_all group {g.uri} count {g.count} must be "
                                 f"a multiple of n_time*n_channel={full}")
        if cfg.channel_split != full:
            raise ValueError("pfb_all_to_all splits channels over BOTH axes")
    for g in cfg.groups:
        kind = REGISTRY.get(g.uri)
        if kind is None:
            raise ValueError(f"unknown channel kind {g.uri!r}")
        if kind.output != "audio":
            raise ValueError(f"the bank gear supports audio kinds; {g.uri} is data")
        if "offset_hz" not in kind.dynamic_fields:
            raise ValueError(f"{g.uri} does not take offset_hz per block")
        if g.count % cfg.n_channel:
            raise ValueError(f"group {g.uri} count {g.count} must be a multiple of the "
                             f"channel mesh axis {cfg.n_channel}")


def grid_split(cfg: ShardedPipelineConfig, offsets: np.ndarray):
    """PFB-gear helper: absolute channel offsets (Hz) -> (grid index mod M,
    residual Hz for the demod NCO)."""
    spacing = cfg.baseband_rate / cfg.pfb_m
    idx = np.rint(np.asarray(offsets) / spacing).astype(np.int64)
    residual = (np.asarray(offsets) - idx * spacing).astype(np.float32)
    return (idx % cfg.pfb_m).astype(np.int32), residual


def a2a_placement(cfg: ShardedPipelineConfig, offsets_per_group):
    """Host-side channel placement for the all-to-all gear: shard d receives
    grid channels [d·M/D, (d+1)·M/D), so each demod goes to the shard that
    owns its grid channel. Returns (orders, local_idx, residuals): group g's
    channels in placement order `orders[g]` (audio rows come back in it),
    each one's index into its shard's grid chunk, and its residual offset.
    ValueError when a group does not split evenly over the shards."""
    d_total = cfg.n_time * cfg.n_channel
    sz = cfg.pfb_m // d_total
    orders, locals_, residuals = [], [], []
    for g, offs in zip(cfg.groups, offsets_per_group):
        idx, res = grid_split(cfg, np.asarray(offs))
        dev = idx // sz
        order = np.argsort(dev, kind="stable").astype(np.int64)
        cg = g.count // d_total
        if not np.array_equal(dev[order], np.repeat(np.arange(d_total), cg)):
            raise ValueError(
                f"group {g.uri}: grid channels {sorted(set(idx.tolist()))} "
                f"cannot be balanced over {d_total} devices "
                f"({cg}/device needed); retune or use the all_gather gear")
        orders.append(order)
        locals_.append((idx[order] % sz).astype(np.int32))
        residuals.append(res[order].astype(np.float32))
    return orders, locals_, residuals


@dataclasses.dataclass
class GearState:
    """A gear's state on this process's shards. `units[(chunk, shard)]` is
    the per-group (channelizer, demod) state of bank chunk `chunk` — rows
    [chunk·n_g, (chunk+1)·n_g) of group g, n_g = count / channel_split —
    on shard (t, c); `pfb[shard]` is the all-gather PFB gear's analysis
    tail, the same on every shard."""

    units: dict
    pfb: dict


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if hasattr(first, "_fields"):
        return type(first)(*(_tree_map(fn, *parts) for parts in zip(*trees)))
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*trees))
    raise TypeError(f"unexpected state node {type(first)}")


def _mesh_of(cfg: ShardedPipelineConfig, target) -> Mesh:
    """The gear's mesh: `target` itself, or a bare device as a mesh of one
    shard (a larger configuration then lacks devices, as in JAX)."""
    mesh = target if isinstance(target, Mesh) else make_mesh(
        cfg.n_time, cfg.n_channel, [resolve_device(target)])
    if (mesh.n_time, mesh.n_channel) != (cfg.n_time, cfg.n_channel):
        raise ValueError(f"a {cfg.n_time}x{cfg.n_channel} configuration on a "
                         f"{mesh.n_time}x{mesh.n_channel} mesh")
    return mesh


class _Gear:
    """What both gears share: the shard layout, the input split, the
    time-sharded cascade with its halo ring, the bank, the output rows."""

    def __init__(self, cfg: ShardedPipelineConfig, mesh: Mesh, split: int):
        self.cfg, self.mesh = cfg, mesh
        self.halo = halo_samples(cfg.log2_decim)
        self.kinds = [REGISTRY[g.uri] for g in cfg.groups]
        self.single = len(cfg.groups) == 1
        self.per_chunk = [g.count // split for g in cfg.groups]
        self.shard_len = cfg.block // cfg.n_time
        if cfg.block % (cfg.n_time * (4 << cfg.log2_decim)):
            raise ValueError(f"block {cfg.block} must split over n_time={cfg.n_time} in "
                             f"multiples of {4 << cfg.log2_decim}")
        if self.halo > self.shard_len:
            raise ValueError(f"a time shard of {self.shard_len} samples is shorter than "
                             f"the halo {self.halo}")
        full = split == cfg.n_time * cfg.n_channel
        # (bank chunk, shard) for each local shard
        self.units = [(mesh.index(k) if full else k[1], k) for k in mesh.local]
        chunks = sorted({chunk for chunk, _ in self.units})
        self.rows = tuple(np.concatenate([np.arange(c * n, (c + 1) * n) for c in chunks])
                          for n in self.per_chunk)

    def init_units(self) -> dict:
        return {(chunk, k): _group_state_structure(self.cfg, self.mesh.device(k),
                                                   self.per_chunk)
                for chunk, k in self.units}

    def shards(self, x) -> dict:
        """x as this process's time shards {(t, c): (block/n_time, 2) int16
        on the shard's device}: a whole block (any device) or the shards
        themselves (hostfeed)."""
        mesh, want = self.mesh, (self.shard_len, 2)
        if isinstance(x, dict):
            if set(x) != set(mesh.local):
                raise ValueError(f"x holds shards {sorted(x)}, this process {mesh.local}")
            for k, v in x.items():
                if v.dtype != torch.int16 or tuple(v.shape) != want or v.device != mesh.device(k):
                    raise ValueError(f"shard {k} must be {want} int16 on {mesh.device(k)}, "
                                     f"got {v.dtype} {tuple(v.shape)} on {v.device}")
            return x
        if x.dtype != torch.int16 or tuple(x.shape) != (self.cfg.block, 2):
            raise ValueError(f"x must be ({self.cfg.block}, 2) int16, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        return {k: x[k[0] * self.shard_len:(k[0] + 1) * self.shard_len].to(
            mesh.device(k), non_blocking=True) for k in mesh.local}

    def decimate(self, xs: dict, carry: torch.Tensor):
        """(basebands {(t, c): (T/n_time/2^k,) complex64}, the next carry):
        each shard decimated with its left neighbour's raw tail (time row 0:
        the carry) injected as its history."""
        cfg, mesh = self.cfg, self.mesh
        if not self.halo:
            with record_function(DECIMATE):
                return {k: iq_raw_to_complex64(x) for k, x in xs.items()}, carry
        with record_function(COLLECTIVES):
            left = mesh.ring_shift({k: x[x.shape[0] - self.halo:] for k, x in xs.items()})
        with record_function(DECIMATE):
            bb = {k: _cascade_with_halo(
                xs[k], carry.to(mesh.device(k), non_blocking=True) if k[0] == 0 else left[k],
                cfg.log2_decim, cfg.fc_pos) for k in mesh.local}
        return bb, self.wrap(left)

    def wrap(self, received: dict) -> torch.Tensor | None:
        """The ring's wrap-around, received by time row 0: the next block's
        carry (None on a process that holds no shard of time row 0)."""
        row0 = [k for k in self.mesh.local if k[0] == 0]
        return received[row0[0]].clone() if row0 else None

    def bank(self, units: dict, take, offsets) -> tuple[dict, list]:
        """Each shard's demods on its input: `take(chunk, shard, g,
        channelizer state)` gives (channelizer state', the (n, F) input);
        returns the new units and per group {chunk: audio}, a chunk's audio
        taken from the first shard that holds it."""
        cfg = self.cfg
        new_units, audios = {}, [{} for _ in cfg.groups]
        for chunk, k in self.units:
            states = []
            for g, (kind, gcfg) in enumerate(zip(self.kinds, cfg.demod_cfgs)):
                cstate, dstate = units[chunk, k][g]
                with record_function(SELECT):
                    cstate, xb = take(chunk, k, g, cstate)
                    off = self.chunk_of(offsets[g], chunk, k, g)
                with record_function(DEMOD):
                    dstate, audio = kind.process(dstate, xb, gcfg, offset_hz=off)
                states.append((cstate, dstate))
                audios[g].setdefault(chunk, audio)
            new_units[chunk, k] = tuple(states)
        return new_units, audios

    def chunk_of(self, value, chunk: int, k, g: int) -> torch.Tensor:
        """Bank chunk `chunk`'s entries of group g's per-channel argument
        (tensor or array), on shard k's device."""
        n = self.per_chunk[g]
        return torch.as_tensor(value)[chunk * n:(chunk + 1) * n].to(self.mesh.device(k),
                                                                     non_blocking=True)

    def rows_out(self, audios: list):
        """This process's rows of each group, chunk order, on the home device."""
        home = self.mesh.home
        out = []
        for by_chunk in audios:
            parts = [by_chunk[c].to(home, non_blocking=True) for c in sorted(by_chunk)]
            out.append(parts[0] if len(parts) == 1 else torch.cat(parts, dim=0))
        return out[0] if self.single else tuple(out)

    def per_group(self, value):
        return (value,) if self.single and not isinstance(value, (tuple, list)) else value


def build_sharded_step(cfg: ShardedPipelineConfig, mesh: Mesh | torch.device | str = "cuda"):
    """Returns (step, init_fn) with the JAX call signature:
    step(state, x, carry, offsets[, pfb_idx]) -> (state', audio, carry'[, spectrum]).

    mesh: a `Mesh` of cfg's shape, or a bare device for 1×1 (default cuda,
    which raises without a card; nothing falls back to the CPU). x: (block,
    2) int16, or this process's shards (hostfeed). carry: (H, 2) int16 — the
    previous block's last H raw samples (JAX holds them as (2, H) float32;
    see `state_from_numpy`). offsets: per-channel Hz — one (C,) tensor for a
    single-group bank, a tuple per group otherwise; with pfb_m they are the
    residuals of `grid_split` and pfb_idx the grid indices. audio: (rows, A)
    float32 per group, the rows `step.rows[g]` this process holds (all of
    them in one process). With cfg.pfb_all_to_all, dispatches to
    build_a2a_step. TF32 is turned off, as `RxPipeline` does."""
    mesh = _mesh_of(cfg, mesh)
    if cfg.pfb_all_to_all:
        return build_a2a_step(cfg, mesh)
    _validate_bank(cfg)
    pin_f32_precision()
    gear = _Gear(cfg, mesh, cfg.channel_split)
    d_total = mesh.size
    frame_sharded = True
    if cfg.pfb_m:
        if (cfg.block >> cfg.log2_decim) % cfg.pfb_m:
            raise ValueError(f"block {cfg.block}: the baseband must hold whole PFB frames "
                             f"of {cfg.pfb_m}")
        f_total = (cfg.block >> cfg.log2_decim) // cfg.pfb_m
        frame_sharded = f_total % d_total == 0
        if not frame_sharded:
            _log.warning(
                "sharded PFB gear DEGRADED to replicated analysis: %d frames/block do not "
                "divide over %d devices (block=%d, log2_decim=%d, pfb_m=%d); every device "
                "repeats the full analysis. Use a block multiple of %d to frame-shard.",
                f_total, d_total, cfg.block, cfg.log2_decim, cfg.pfb_m,
                (cfg.pfb_m << cfg.log2_decim) * d_total)
    m = cfg.pfb_m
    h = pfbmod.prototype(m, cfg.pfb_taps) if m else None
    ph = (cfg.pfb_taps - 1) * m
    scfg = (dataclasses.replace(cfg.spectrum, averaging_mode="none")
            if cfg.spectrum is not None else None)

    def step(state: GearState, x, carry, offsets, pfb_idx=None):
        offsets = gear.per_group(offsets)
        if m:
            if pfb_idx is None:
                raise ValueError("pfb_m set: pass pfb_idx (see grid_split)")
            pfb_idx = gear.per_group(pfb_idx)
        bb, new_carry = gear.decimate(gear.shards(x), carry)
        with record_function(COLLECTIVES):
            full = mesh.all_gather_time(bb)  # (T/2^k,) on every shard

        spec = None
        if scfg is not None:  # stateless display frame of the block
            with record_function(SPECTRUM):
                home = mesh.local[0]
                _, spec = dsp_spectrum.power_spectrum(
                    dsp_spectrum.make_state(scfg, mesh.device(home)), full[home], scfg)

        pfb_out = dict(state.pfb)
        if m:
            with record_function(ANALYSIS):
                if frame_sharded and d_total > 1:
                    # shard d analyses frame chunk d with its (P−1)·M halo
                    # from the gathered baseband; the tail stays replicated
                    f_dev = full[mesh.local[0]].shape[0] // m // d_total
                    pieces = {}
                    for k in mesh.local:
                        ext = torch.cat([state.pfb[k].tail, full[k]])
                        pfb_out[k] = pfbmod.PfbState(ext[-ph:].clone())
                        start = mesh.index(k) * f_dev * m
                        pieces[k] = _pfb_with_halo(ext[start:start + f_dev * m + ph], m, h)
                else:  # one shard, or frames that do not split: every shard analyses all
                    pieces = None
                    ych = {}
                    for k in mesh.local:
                        pfb_out[k], ych[k] = pfbmod.analyze(state.pfb[k], full[k], m, h)
            if pieces is not None:
                with record_function(COLLECTIVES):
                    ych = mesh.all_gather(pieces)  # (F, M) on every shard

        def take(chunk, k, g, cstate):
            n = gear.per_chunk[g]
            if m:
                idx = gear.chunk_of(pfb_idx[g], chunk, k, g)
                return cstate, ych[k].index_select(-1, idx.to(torch.int64)).t()
            xb = full[k].expand(n, full[k].shape[-1])
            if cfg.chan_stages:
                signs = np.zeros((n, cfg.chan_stages), int)
                cstate, xb = chan.channelize_bank(cstate, xb, signs)
            return cstate, xb

        units, audios = gear.bank(state.units, take, offsets)
        out = (GearState(units, pfb_out), gear.rows_out(audios), new_carry)
        return out if spec is None else (*out, spec)

    def init_fn():
        pfb = ({k: pfbmod.make_state(m, mesh.device(k), cfg.pfb_taps) for k in mesh.local}
               if m else {})
        return GearState(gear.init_units(), pfb), torch.zeros(
            (max(gear.halo, 1), 2), dtype=torch.int16, device=mesh.home)

    step.rows = gear.rows
    # static degraded-mode flag (see the build-time warning above)
    step.replicated_analysis = bool(m) and not frame_sharded
    return step, init_fn


def build_a2a_step(cfg: ShardedPipelineConfig, mesh: Mesh | torch.device | str = "cuda"):
    """The all-to-all gear: the time-sharded cascade, a PFB halo ring over
    "time", each column's sub-chunk of its shard's frames analysed, one
    all_to_all over both axes (frames for channels), the demods of each
    shard's grid chunk. step(state, x, carry, residuals[, local_idx]) ->
    (state', audio, carry'[, spectrum]); carry = (cascade tail (H, 2) int16,
    PFB tail ((P−1)·M,) complex64).

    residuals: per group (count,) Hz in placement order (a2a_placement);
    local_idx: per group (count,) indices into the owning shard's grid chunk
    (tensors: a retune within a chunk changes no program); None = identity
    (the single group with count == M). audio rows are in placement order.
    The spectrum frame is the last time shard's last frame."""
    mesh = _mesh_of(cfg, mesh)
    _validate_bank(cfg)
    pin_f32_precision()
    gear = _Gear(cfg, mesh, mesh.size)
    m, n_time, n_channel = cfg.pfb_m, cfg.n_time, cfg.n_channel
    h = pfbmod.prototype(m, cfg.pfb_taps)
    ph = (cfg.pfb_taps - 1) * m
    bb_total = cfg.block >> cfg.log2_decim
    if bb_total % (n_time * m * n_channel):
        raise ValueError(
            f"block {cfg.block}: baseband frames ({bb_total}/{m}) must split over "
            f"n_time*n_channel={mesh.size} for the frame-sharded analysis")
    if cfg.spectrum is not None and (bb_total // n_time) % cfg.spectrum.fft_size:
        raise ValueError(
            f"spectrum tap in the a2a gear: per-shard baseband ({bb_total}//{n_time}) must "
            f"be a multiple of the display fft size {cfg.spectrum.fft_size} so the global "
            f"frame grid aligns with the shard grid (pick a block multiple of "
            f"{cfg.spectrum.fft_size * n_time << cfg.log2_decim})")
    scfg = (dataclasses.replace(cfg.spectrum, averaging_mode="none", overlap=0)
            if cfg.spectrum is not None else None)
    f_col = bb_total // n_time // m // n_channel
    last = (n_time - 1, 0)

    def step(state: GearState, x, carry, residuals, local_idx=None):
        casc_carry, pfb_carry = carry
        residuals = gear.per_group(residuals)
        if local_idx is not None:
            local_idx = gear.per_group(local_idx)
        bb, new_casc = gear.decimate(gear.shards(x), casc_carry)

        spec = None
        if scfg is not None:
            # the display frame grid aligns with the time shards, so the
            # block's last frame is the last time shard's last frame
            with record_function(SPECTRUM):
                v = None
                if last in bb:
                    _, v = dsp_spectrum.power_spectrum(
                        dsp_spectrum.make_state(scfg, mesh.device(last)), bb[last], scfg)
            with record_function(COLLECTIVES):
                spec = mesh.from_shard(last, v, (scfg.fft_size,), torch.float32)

        with record_function(COLLECTIVES):
            left = mesh.ring_shift({k: b[b.shape[0] - ph:] for k, b in bb.items()})
        with record_function(ANALYSIS):
            pieces = {}
            for k in mesh.local:
                halo = pfb_carry.to(mesh.device(k), non_blocking=True) if k[0] == 0 else left[k]
                # the columns split the shard's frames: each analyses its own
                start = k[1] * f_col * m
                pieces[k] = _pfb_with_halo(torch.cat([halo, bb[k]])[start:start + f_col * m + ph],
                                           m, h)
        with record_function(COLLECTIVES):
            mine = mesh.all_to_all(pieces)  # (F_total, M/D): this shard's grid chunk

        def take(chunk, k, g, cstate):
            if local_idx is None:  # identity: demod i of the chunk = channel i
                return cstate, mine[k].t()
            idx = gear.chunk_of(local_idx[g], chunk, k, g)
            return cstate, mine[k].index_select(-1, idx.to(torch.int64)).t()

        units, audios = gear.bank(state.units, take, residuals)
        out = (GearState(units, {}), gear.rows_out(audios), (new_casc, gear.wrap(left)))
        return out if spec is None else (*out, spec)

    def init_fn():
        return GearState(gear.init_units(), {}), (
            torch.zeros((max(gear.halo, 1), 2), dtype=torch.int16, device=mesh.home),
            torch.zeros(ph, dtype=torch.complex64, device=mesh.home))

    step.rows = gear.rows
    step.replicated_analysis = False
    return step, init_fn


def _group_state_structure(cfg: ShardedPipelineConfig, device: torch.device,
                           counts: list[int] | None = None):
    """Per-group (channelizer state, demod state), batch dim = the group's
    channels on one shard (`counts`, default the whole group)."""
    out = []
    for g, gcfg, n in zip(cfg.groups, cfg.demod_cfgs,
                          counts or [g.count for g in cfg.groups]):
        kind = REGISTRY[g.uri]
        cstate = chan.init_state(cfg.chan_stages, device, batch_shape=(n,))
        out.append((cstate, kind.make_state(gcfg, device, batch_shape=(n,))))
    return tuple(out)


def state_from_numpy(cfg: ShardedPipelineConfig, tree, carry, mesh: Mesh | torch.device | str):
    """The JAX gear's global (state, carry), fetched as numpy (e.g. with
    jax.tree.map(np.asarray, ...)), as this gear's on `mesh` (or a bare
    device): each chunk of channels goes to the shards that hold it. Fields
    are matched by name. The (2, H) float32 carry, which holds int16 samples
    / 32768, becomes the (H, 2) int16 raw carry by an exact ×32768; the
    all-to-all gear's PFB carry (2, (P−1)·M) becomes complex64."""
    mesh = _mesh_of(cfg, mesh)
    a2a = cfg.pfb_all_to_all
    split = mesh.size if a2a else cfg.channel_split
    gear = _Gear(cfg, mesh, split)
    cpu = torch.device("cpu")
    groups_np = tree[0] if (cfg.pfb_m and not a2a) else tree
    groups = _from_numpy(_group_state_structure(cfg, cpu), groups_np)
    units = {}
    for chunk, k in gear.units:
        dev = mesh.device(k)
        units[chunk, k] = tuple(
            _tree_map(lambda v, n=n: v[chunk * n:(chunk + 1) * n].to(dev), grp)
            for grp, n in zip(groups, gear.per_chunk))
    pfb = {}
    if cfg.pfb_m and not a2a:
        tail = _from_numpy(pfbmod.make_state(cfg.pfb_m, cpu, cfg.pfb_taps), tree[1])
        pfb = {k: pfbmod.PfbState(tail.tail.to(mesh.device(k))) for k in mesh.local}
    casc = _raw_carry(carry[0] if a2a else carry).to(mesh.home)
    if a2a:
        c = np.asarray(carry[1], np.float32)
        casc = (casc, torch.from_numpy((c[0] + 1j * c[1]).astype(np.complex64)).to(mesh.home))
    return GearState(units, pfb), casc


def _raw_carry(carry) -> torch.Tensor:
    raw = np.round(np.asarray(carry, np.float64).T * 32768.0)
    if np.any(raw < -32768) or np.any(raw > 32767):
        raise ValueError("carry holds values outside the int16 range ×1/32768")
    return torch.from_numpy(np.ascontiguousarray(raw.astype(np.int16)))


def state_to_numpy(state: GearState, carry):
    """This gear's (state, carry) as the JAX gear's global ones: every chunk
    of channels joined back in order (this process must hold them all),
    NCO phases as uint32, the carry as (2, H) float32 (the all-to-all gear's
    as its pair, the PFB tail as (2, (P−1)·M) float32)."""
    per_chunk: dict = {}
    for (chunk, _), groups in sorted(state.units.items(), key=lambda kv: kv[0][0]):
        per_chunk.setdefault(chunk, groups)
    if sorted(per_chunk) != list(range(len(per_chunk))):
        raise ValueError(f"this process holds chunks {sorted(per_chunk)}, not all of them")
    chunks = [per_chunk[c] for c in range(len(per_chunk))]
    joined = _tree_map(lambda *vs: torch.cat([v.cpu() for v in vs]), *chunks)
    tree = _to_numpy(joined)
    if state.pfb:
        tree = (tree, _to_numpy(next(iter(state.pfb.values()))))

    def raw(c):
        a = c.cpu().numpy().astype(np.float32) / 32768.0
        return np.ascontiguousarray(a.T)

    if isinstance(carry, tuple):
        p = carry[1].cpu().numpy()
        return tree, (raw(carry[0]), np.stack([p.real, p.imag]).astype(np.float32))
    return tree, raw(carry)
