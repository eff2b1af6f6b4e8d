"""Rx pipeline engine — the DSPDeviceSourceEngine role.

Per block: ingest (int16 → K1 directly on the fused i16 path, else
normalize + DC/IQ correction), the ÷2^k device decimation on K1, then for
each channel the channelizer cascade and the demodulator, plus the spectrum
and scope taps of the baseband. Everything runs on the pipeline's
`torch.device`; on the card the ops queue asynchronously, and `run` reads
block N back while block N+1 is already queued. A block's outputs leave the
device packed into one float32 vector (`step_packed`), so reading them back
is one copy (`fetch`), however many channels and meters the block holds.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Any

import numpy as np
import torch

from ..channels.registry import REGISTRY
from ..dsp import channelizer as chan
from ..dsp import decimators as dec
from ..dsp import scope as dsp_scope
from ..dsp import spectrum as dsp_spectrum
from ..dsp.types import INPUT_FORMATS, iq_raw_to_complex64
from . import corrections


def pin_f32_precision() -> None:
    """Full float32 on the card: cuDNN convs default to TF32 (~3 decimal
    digits), which would put a noise floor on every conv of the chain."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device: torch.device | str) -> torch.device:
    """The pipeline's device, as given. A cuda device without a usable card
    raises; nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is False")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceConfig:
    """File/synthetic device front end (the filesource/testsource role)."""

    sample_rate: float  # device (pre-decimation) rate
    center_frequency: float = 0.0
    log2_decim: int = 0  # device decimation (decimators.h cascades)
    fc_pos: str = "cen"  # cen | inf | sup (devicesamplesource.cpp:84-110)
    dc_correction: bool = False
    iq_correction: bool = False
    input_format: str = "i16"  # i16 | u8 | i8 | i12 | i24 (ADC width policy)

    @property
    def baseband_rate(self) -> float:
        return self.sample_rate / (1 << self.log2_decim)


@dataclasses.dataclass(frozen=True, eq=False)
class ChannelSpec:
    """One channel attached to the device set."""

    uri: str  # registry key, e.g. "sdrangel.channel.nfmdemod"
    frequency_offset: float  # channel centre relative to baseband centre
    settings: dict  # demod settings overrides (config dataclass fields)
    requested_rate: float = 48000.0  # bandwidth the demod wants from the channelizer


class RxPipeline:
    """The per-block Rx step on one torch device.

    frontend: the device front end; channels: the attached channels;
    device: where every tensor of the pipeline lives — the card unless the
    caller asks for the CPU; without a card, "cuda" raises.
    """

    def __init__(
        self,
        frontend: DeviceConfig,
        channels: list[ChannelSpec],
        device: torch.device | str = "cuda",
        block_size: int | None = None,
        spectrum_cfg: dsp_spectrum.SpectrumConfig | None = None,
    ):
        self.device = resolve_device(device)
        pin_f32_precision()
        self.frontend = frontend
        self.channel_specs = channels
        # per-channel frequency plans (downchannelizer.cpp:250-287)
        self.plans = [
            chan.plan_channel(frontend.baseband_rate, c.requested_rate, c.frequency_offset)
            for c in channels
        ]
        self.kinds = [REGISTRY[c.uri] for c in channels]
        self.base_block = self._solve_block_size(block_size)
        self.demod_cfgs = []
        for spec, plan, kind in zip(channels, self.plans, self.kinds):
            kw = dict(channel_rate=plan.channel_rate, input_offset=plan.residual_offset,
                      **spec.settings)
            # the channel analyzer and ATV have no block-coupled resampler
            if any(f.name == "block_in" for f in dataclasses.fields(kind.config_cls)):
                kw["block_in"] = self.base_block >> len(plan.signs)
            self.demod_cfgs.append(kind.config_cls(**kw))
        self.spectrum_cfg = spectrum_cfg or dsp_spectrum.SpectrumConfig(
            fft_size=1024, averaging_mode="moving", averaging_n=8)
        # i16 cen capture without corrections: the raw int16 block goes
        # straight into K1, which applies the 1/32768 ingest scale itself
        self.fused_ingest = (
            frontend.input_format == "i16" and frontend.fc_pos == "cen"
            and frontend.log2_decim > 0
            and not frontend.dc_correction and not frontend.iq_correction
        )

    def _solve_block_size(self, requested: int | None) -> int:
        """Baseband block length divisible as every stage needs: ×4 for the
        rotation patterns, ×2^stages for each channel's cascade, for a kind
        that resamples to 48 kHz the resampler's rational numerator p at the
        channel rate, and, for a kind that runs an fftfilt, its hop
        (fft_len/2) at the channel rate and, through a 48 kHz resampler, at
        the audio rate."""
        need = 4 << self.frontend.log2_decim
        for spec, plan, kind in zip(self.channel_specs, self.plans, self.kinds):
            k = len(plan.signs)
            frac = Fraction(plan.channel_rate / 48000.0).limit_denominator(1 << 20)
            p = frac.numerator
            need = math.lcm(need, 4 << k)
            if kind.needs_audio_ratio:
                need = math.lcm(need, p << k)
            if kind.needs_fft_hop:
                # the fftfilt runs at the channel rate (WFM) or the audio
                # rate (SSB): whole hops at both
                hop = _config_field(kind.config_cls, spec.settings, "fft_len") // 2
                need = math.lcm(need, hop << k)
                if kind.needs_audio_ratio:
                    need = math.lcm(need, (p * hop // math.gcd(frac.denominator, hop)) << k)
            if kind.block_factor is not None:
                need = math.lcm(need, kind.block_factor(plan.channel_rate, spec.settings) << k)
        block = need
        target = requested or (1 << 17)
        while block < target:
            block *= 2
        if (block << self.frontend.log2_decim) > (1 << 25):
            raise ValueError(
                f"block of {block << self.frontend.log2_decim} device samples "
                f"needed to satisfy rate divisibility — pick rates with smaller "
                f"rational factors vs 48 kHz (plans: {self.plans})")
        return block

    @property
    def device_block(self) -> int:
        return self.base_block << self.frontend.log2_decim

    # -- state ---------------------------------------------------------------

    def init_state(self) -> dict:
        k = self.frontend.log2_decim
        return {
            "corr": corrections.make_state(self.device),
            "spectrum": dsp_spectrum.make_state(self.spectrum_cfg, self.device),
            "dev_casc": (
                dec.init_flat_state(k, self.device, raw=self.fused_ingest)
                if k else dec.init_state(0, self.device)
            ),
            "chan": [chan.init_state(len(p.signs), self.device) for p in self.plans],
            "demod": [
                kind.make_state(cfg, self.device)
                for kind, cfg in zip(self.kinds, self.demod_cfgs)
            ],
        }

    def state_from_numpy(self, tree: dict) -> dict:
        """The JAX RxPipeline's state (fetched as numpy, e.g. with
        jax.tree.map(np.asarray, state)) as this pipeline's state. Fields are
        matched by name against `init_state()`, so every field the port's
        states hold crosses over, sync AM's, the AF squelch's, broadcast
        FM's and the data channels' included. A complex64 flat tail
        becomes the fused-ingest int16 raw tail (×32768, exact for values
        that came from int16)."""
        return _from_numpy(self.init_state(), tree)

    def state_to_numpy(self, state: dict) -> dict:
        """This pipeline's state as numpy in the JAX package's field types:
        NCO phases as uint32, the int16 raw tail as the complex64 tail."""
        return _to_numpy(state)

    def default_dyn(self) -> list[dict]:
        """Per-channel overrides initialized from the bound configs."""
        dyn = []
        for kind, cfg in zip(self.kinds, self.demod_cfgs):
            d = {}
            if "offset_hz" in kind.dynamic_fields:
                d["offset_hz"] = float(cfg.input_offset)
            if "squelch_db" in kind.dynamic_fields:
                d["squelch_db"] = float(cfg.squelch_db)
            if "volume" in kind.dynamic_fields:
                d["volume"] = float(cfg.volume)
            dyn.append(d)
        return dyn

    # -- the step ------------------------------------------------------------

    def step(self, state: dict, raw: torch.Tensor, dyn: list[dict] | None = None):
        """raw: (device_block, 2) raw ADC samples on the pipeline's device.
        dyn: optional per-channel overrides (see default_dyn).
        Returns (state', outs) with outs["channels"][i] = {audio, power,
        meters}, or for a data kind {data: {name: tensor}, power}."""
        f = self.frontend
        if raw.device.type != self.device.type:
            raise ValueError(f"raw block on {raw.device}, pipeline on {self.device}")
        if raw.dtype != INPUT_FORMATS[f.input_format][0]:
            raise TypeError(f"{f.input_format} capture must be {INPUT_FORMATS[f.input_format][0]}, "
                            f"got {raw.dtype}")
        corr_state = state["corr"]
        if self.fused_ingest:
            dev_state, bb = dec.decimate_flat_raw(state["dev_casc"], raw, f.log2_decim)
        else:
            x = iq_raw_to_complex64(raw, f.input_format)
            corr_state, x = corrections.apply(corr_state, x, f.dc_correction, f.iq_correction)
            if f.log2_decim:
                dev_state, bb = dec.decimate_flat_any(state["dev_casc"], x, f.log2_decim, f.fc_pos)
            else:  # no stage: the cascade of zero stages passes x through
                dev_state, bb = dec.decimate_cascade(state["dev_casc"], x, 0, f.fc_pos)

        chan_states, demod_states, outs = [], [], []
        for i, (plan, kind, cfg) in enumerate(zip(self.plans, self.kinds, self.demod_cfgs)):
            cstate, y = chan.channelize(state["chan"][i], bb, plan)
            d = dict(dyn[i]) if dyn is not None else {}
            dstate, result = kind.process(state["demod"][i], y, cfg, **d)
            entry = ({"data": kind.adapter(result)} if kind.output == "data"
                     else {"audio": result})
            # channel power meter (nfmdemod.h:153-170 magsq average)
            entry["power"] = torch.mean(y.real ** 2 + y.imag ** 2)
            if kind.meters is not None:
                entry.update(kind.meters(dstate, cfg, d))
            chan_states.append(cstate)
            demod_states.append(dstate)
            outs.append(entry)

        spec_state, bb_spectrum = dsp_spectrum.power_spectrum(
            state["spectrum"], bb, self.spectrum_cfg)
        head = bb[..., :1024]  # scope tap: the block head (ScopeVis role)
        scope = torch.stack([
            dsp_scope.project(head, dsp_scope.Projection.REAL),
            dsp_scope.project(head, dsp_scope.Projection.IMAG),
            dsp_scope.project(head, dsp_scope.Projection.MAG_DB),
        ])
        new_state = {
            "corr": corr_state, "dev_casc": dev_state, "chan": chan_states,
            "demod": demod_states, "spectrum": spec_state,
        }
        return new_state, {"channels": outs, "spectrum": bb_spectrum, "scope": scope}

    # -- packed outputs ------------------------------------------------------

    def step_packed(self, state: dict, raw: torch.Tensor, dyn: list[dict] | None = None):
        """`step` with the outputs tree packed into one float32 vector on the
        pipeline's device (see `pack_outs`); its layout is `out_layout`."""
        state, outs = self.step(state, raw, dyn)
        flat, layout = pack_outs(outs)
        self.out_layout = layout
        return state, flat

    def to_host(self, flat: torch.Tensor) -> dict:
        """One packed block's outputs as numpy: one device-to-host copy."""
        return unpack_outs(fetch(flat), self.out_layout)

    # -- host loop -----------------------------------------------------------

    def upload(self, raw: np.ndarray) -> torch.Tensor:
        """A host block as a tensor on the pipeline's device (pinned and
        asynchronous on the card)."""
        if not raw.flags.writeable or not raw.flags.c_contiguous:
            raw = np.array(raw)
        t = torch.from_numpy(raw)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def run(self, iq_source, n_blocks: int, state: dict | None = None):
        """Drive the pipeline. iq_source: (block_index, count) -> (count, 2)
        raw numpy block. Yields (block_index, host outputs), one block
        behind, so the host reads block N while block N+1 is queued."""
        state = self.init_state() if state is None else state
        pending = []
        for b in range(n_blocks):
            state, flat = self.step_packed(state, self.upload(iq_source(b, self.device_block)))
            pending.append((b, flat))
            if len(pending) > 1:
                idx, prev = pending.pop(0)
                yield idx, self.to_host(prev)
        for idx, prev in pending:
            yield idx, self.to_host(prev)
        self.final_state = state


# -- packed outputs -----------------------------------------------------------
#
# Float32 leaves travel as they are and booleans as 0/1. Integer leaves travel
# as their bits: int8/16/32 widened to int32, int64 as two words, each viewed
# as float32, so every value comes back exactly; the JAX engine's unpack_outs
# rounds integer leaves through float32 and loses values above 2^24.


@dataclasses.dataclass(frozen=True)
class OutLayout:
    skeleton: Any  # the outputs tree with each leaf replaced by its index
    leaves: tuple  # per leaf: (shape, torch dtype, float32 words)

    @property
    def size(self) -> int:
        return sum(words for _, _, words in self.leaves)


def _pack_leaf(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return x.reshape(-1)
    if x.dtype == torch.bool:
        return x.reshape(-1).to(torch.float32)
    if x.dtype == torch.int64:
        return x.reshape(-1).contiguous().view(torch.float32)
    if x.dtype in (torch.int8, torch.uint8, torch.int16, torch.int32):
        return x.reshape(-1).to(torch.int32).view(torch.float32)
    raise TypeError(f"cannot pack an output leaf of {x.dtype}")


def pack_outs(outs: Any) -> tuple[torch.Tensor, OutLayout]:
    """An outputs tree (dicts, lists and tensors on one device) as one flat
    float32 vector and the layout that `unpack_outs` reads it by."""
    leaves: list[torch.Tensor] = []

    def skeleton(node):
        if isinstance(node, dict):
            return {k: skeleton(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(skeleton(v) for v in node)
        leaves.append(node)
        return len(leaves) - 1

    tree = skeleton(outs)
    words = [_pack_leaf(x) for x in leaves]
    layout = OutLayout(tree, tuple((tuple(x.shape), x.dtype, w.numel())
                                   for x, w in zip(leaves, words)))
    return torch.cat(words), layout


def unpack_outs(flat: np.ndarray, layout: OutLayout) -> Any:
    """The outputs tree back from one packed vector, as numpy arrays."""
    if flat.shape != (layout.size,):
        raise ValueError(f"packed vector of {flat.shape}, layout holds {layout.size} words")
    leaves, pos = [], 0
    for shape, dtype, words in layout.leaves:
        w = flat[pos:pos + words]
        pos += words
        if dtype == torch.float32:
            leaf = w
        elif dtype == torch.bool:
            leaf = w != 0.0
        elif dtype == torch.int64:
            leaf = w.view(np.int64)
        else:
            leaf = w.view(np.int32).astype(torch.empty(0, dtype=dtype).numpy().dtype)
        leaves.append(leaf.reshape(shape))

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return leaves[node]

    return build(layout.skeleton)


def fetch(flat: torch.Tensor) -> np.ndarray:
    """A packed vector on the host. On the card: one non-blocking copy into
    pinned memory, waited for by an event on the calling thread's current
    stream — the stream its step was queued on — so a worker thread never
    waits on another thread's stream."""
    if flat.device.type != "cuda":
        return flat.numpy()
    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
    with torch.cuda.device(flat.device):
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    done.synchronize()
    return host.numpy()


def _config_field(config_cls: type, settings: dict, name: str):
    """A config field as the channel will bind it: the spec's override, else
    the dataclass default."""
    if name in settings:
        return settings[name]
    return next(f.default for f in dataclasses.fields(config_cls) if f.name == name)


def _from_numpy(template: Any, value: Any) -> Any:
    """`value` (a numpy tree) in the structure and dtypes of `template`."""
    if isinstance(template, torch.Tensor):
        a = np.asarray(value)
        if template.dtype == torch.int16 and np.iscomplexobj(a):  # fused-ingest tail
            a = np.round(np.stack([a.real, a.imag], axis=-1) * 32768.0)
        np_dtype = torch.empty(0, dtype=template.dtype).numpy().dtype
        t = torch.from_numpy(np.array(a, dtype=np_dtype, order="C")).to(template.device)
        if t.shape != template.shape:
            raise ValueError(f"state field shape {tuple(t.shape)}, expected {tuple(template.shape)}")
        return t
    if isinstance(template, dict):
        return {k: _from_numpy(v, value[k]) for k, v in template.items()}
    if hasattr(template, "_fields"):  # NamedTuple state: match fields by name
        return type(template)(*(
            _from_numpy(getattr(template, f), getattr(value, f)) for f in template._fields))
    if isinstance(template, (list, tuple)):
        if len(template) != len(value):
            raise ValueError(f"state has {len(value)} entries, expected {len(template)}")
        return type(template)(_from_numpy(t, v) for t, v in zip(template, value))
    raise TypeError(f"unexpected state node {type(template)}")


def _to_numpy(state: Any) -> Any:
    if isinstance(state, torch.Tensor):
        a = state.cpu().numpy()
        if a.dtype == np.int16:  # the fused-ingest raw tail
            return (a[..., 0].astype(np.float32) / 32768.0
                    + 1j * (a[..., 1].astype(np.float32) / 32768.0)).astype(np.complex64)
        if a.dtype == np.int64:  # NCO phase wheel
            return a.astype(np.uint32)
        return a
    if isinstance(state, dict):
        return {k: _to_numpy(v) for k, v in state.items()}
    if hasattr(state, "_fields"):
        return type(state)(*(_to_numpy(v) for v in state))
    if isinstance(state, (list, tuple)):
        return type(state)(_to_numpy(v) for v in state)
    raise TypeError(f"unexpected state node {type(state)}")
