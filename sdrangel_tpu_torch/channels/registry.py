"""Channel-type registry — the plugin-manager role (pluginmanager.{h,cpp}):
channel kinds keyed by the reference's URIs. The port registers the NFM,
AM, SSB, WFM and broadcast FM receivers and the data channels (channel
analyzer, LoRa, DSD, ATV, DATV and UDPSrc) in REGISTRY, and the NFM, AM, SSB
and WFM modulators of the Tx device sets in TX_KINDS (runtime/tx.py holds
their modulate functions). A kind or a session key the port does not carry
yet would stand in UNPORTED_KINDS or UNPORTED_KEYS with its ROADMAP item;
both are empty now.

The session and the REST server read the settable fields from here: each
kind's schema is derived from its config dataclass, so it cannot drift from
the code."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import math
from fractions import Fraction

import torch

from . import (chanalyzer, demod_am, demod_atv, demod_bfm, demod_datv, demod_dsd, demod_lora,
               demod_nfm, demod_ssb, demod_wfm, modulators, udpsrc)


@dataclasses.dataclass(frozen=True)
class ChannelKind:
    uri: str
    config_cls: type
    make_state: Callable[..., Any]
    process: Callable[..., Any]
    # "audio" (48 kHz demod) or "data" (symbols, video, I/Q); the bank gear
    # takes audio kinds only
    output: str = "audio"
    # the demod runs an fftfilt of its config's `fft_len`, so the block
    # must hold whole hops of it
    needs_fft_hop: bool = False
    # process kwargs a caller may override per block ("offset_hz",
    # "squelch_db", "volume"), the applySettings-on-a-running-channel path
    dynamic_fields: frozenset = frozenset()
    # (new_state, cfg, dyn) -> report meters from the channel's own state
    meters: Callable[[Any, Any, dict], dict] | None = None
    # (channel_rate, settings) -> a factor the block must hold at the
    # channel rate, for a demod whose own resamplers need it
    block_factor: Callable[[float, dict], int] | None = None
    # the block must make the channel-to-48 kHz ratio integral: the kinds
    # that resample to 48 kHz; the chanalyzer, LoRa and ATV do not
    needs_audio_ratio: bool = True
    # data kinds: Outputs -> {name: float32, int32 or bool tensor}, complex
    # outputs split into real planes on the device
    adapter: Callable[[Any], dict] | None = None
    # data kinds: the adapter's output names (the report schema's dataKeys)
    data_keys: tuple = ()
    # report sections the session adds on the host ("dsd": the frame sync,
    # "datv": the DVB-S FEC and TS demux)
    host_report_keys: tuple = ()


REGISTRY: dict[str, ChannelKind] = {}
#: uri -> config dataclass, for the settings schemas (Rx and Tx kinds)
CONFIG_CLASSES: dict[str, type] = {}
#: Tx kinds: uri -> modulator config dataclass
TX_KINDS: dict[str, type] = {}


def register(kind: ChannelKind) -> None:
    REGISTRY[kind.uri] = kind
    CONFIG_CLASSES[kind.uri] = kind.config_cls


def register_config(uri: str, config_cls: type) -> None:
    """A Tx kind: its settings schema comes from its config dataclass."""
    TX_KINDS[uri] = config_cls
    CONFIG_CLASSES[uri] = config_cls


#: config fields the pipeline binds (not settable over the API)
_PIPELINE_FIELDS = {"channel_rate", "input_offset", "block_in", "block_af"}
#: per-channel keys the session handles outside the demod and mod configs:
#: the offset goes to the channel plan; audioFile, audioUdp and audioRtp to
#: the audio egress (WAV, UDP, RTP); udpAddress, udpPort and udpFormat to
#: UDPSrc's data egress (io/udp.py FORMATS); datvContinuous to the DATV host
#: decode; and the Tx AF source keys (toneFrequency, afUdp, afFile, cwText,
#: cwWpm) to the Tx worker's AF source
SESSION_KEYS = {"inputFrequencyOffset", "audioFile", "audioUdp", "audioRtp", "toneFrequency",
                "afUdp", "afFile", "cwText", "cwWpm", "datvContinuous", "udpAddress",
                "udpPort", "udpFormat"}

#: the JAX package's channel kinds that the port does not carry yet
UNPORTED_KINDS: dict[str, str] = {}
#: the JAX session's per-channel keys that the port does not carry yet
UNPORTED_KEYS: dict[str, str] = {}


def get_demod(uri: str) -> ChannelKind:
    return REGISTRY[uri]


def settings_schema(uri: str) -> dict[str, dict]:
    """The kind's settable fields: name -> {type, default} (the role of the
    reference's per-plugin settings DTOs)."""
    schema = {}
    for f in dataclasses.fields(CONFIG_CLASSES[uri]):
        if f.name in _PIPELINE_FIELDS:
            continue
        default = None if f.default is dataclasses.MISSING else f.default
        schema[f.name] = {"type": getattr(f.type, "__name__", str(f.type)), "default": default}
    return schema


def requested_rate(uri: str, settings: dict) -> float:
    """The bandwidth a channel asks of the channelizer (the reference's
    demods ask through DSPConfigureChannelizer): the audio kinds the 48 kHz
    class; broadcast FM its whole MPX (pilot, stereo and RDS up to 57 kHz
    plus the deviation: rfBandwidth, 180 kHz by default in bfmdemod.cpp);
    the data channels theirs from their own signal parameters (DATV four
    samples a symbol)."""
    if uri == "sdrangel.channel.demoddatv":
        return 4.0 * float(settings.get("symbol_rate", 250_000.0))
    if uri == "sdrangel.channel.demodatv":
        return float(settings.get("rf_bandwidth", 6_000_000.0))
    if uri == "sdrangel.channel.lorademod":
        return 2.0 * float(settings.get("bandwidth", 125_000.0))
    if uri == "sdrangel.channel.chanalyzer":
        return max(48_000.0, 2.5 * float(settings.get("bandwidth", 5000.0)))
    if uri == "sdrangel.channel.bfm":
        return float(settings.get("rf_bandwidth", 180_000.0))
    return 48_000.0


def check_kind(uri: str, direction: str = "rx") -> None:
    """NotImplementedError for a kind the port does not carry yet (with its
    ROADMAP item), KeyError for a kind no device set of `direction` takes."""
    if uri in UNPORTED_KINDS:
        raise NotImplementedError(f"{uri} is not ported yet: {UNPORTED_KINDS[uri]}")
    if uri not in (TX_KINDS if direction == "tx" else REGISTRY):
        raise KeyError(f"{uri} is no {direction} channel kind")


def validate_settings(uri: str, settings: dict, direction: str = "rx") -> None:
    """Reject unknown setting keys up front (ValueError) rather than inside
    the worker at pipeline build; a key the port does not carry yet raises
    NotImplementedError naming its ROADMAP item."""
    check_kind(uri, direction)
    left_out = sorted(set(settings) & set(UNPORTED_KEYS))
    if left_out:
        raise NotImplementedError(
            f"channel settings {left_out} are not ported yet: "
            + "; ".join(sorted({UNPORTED_KEYS[k] for k in left_out})))
    allowed = set(settings_schema(uri)) | SESSION_KEYS
    unknown = set(settings) - allowed
    if unknown:
        raise ValueError(f"unknown settings for {uri}: {sorted(unknown)}; "
                         f"allowed: {sorted(allowed)}")


def report_schema(uri: str) -> dict:
    """A kind's channel report (the role of the reference's per-plugin
    report DTOs): the standard meters; a data kind adds its block count,
    its adapter's output names and its host report sections."""
    props = {
        "channelPowerDB": {"type": "number"},
        "squelch": {"type": "boolean"},
        "audioSampleRate": {"type": "number"},
        "audioSamples": {"type": "integer"},
    }
    kind = REGISTRY.get(uri)
    if kind is not None and kind.output == "data":
        props["dataBlocks"] = {"type": "integer"}
        props["dataKeys"] = {"type": "array", "items": {"type": "string"},
                             "enum": [list(kind.data_keys)]}
        props.update({key: {"type": "object"} for key in kind.host_report_keys})
    return {"type": "object", "properties": props}


_FULL_DYN = frozenset({"offset_hz", "squelch_db", "volume"})

register(ChannelKind(
    "sdrangel.channel.nfmdemod", demod_nfm.NFMConfig, demod_nfm.make_state,
    demod_nfm.process, dynamic_fields=_FULL_DYN, meters=demod_nfm.meters,
))
register(ChannelKind(
    "sdrangel.channel.amdemod", demod_am.AMConfig, demod_am.make_state,
    demod_am.process, dynamic_fields=_FULL_DYN, meters=demod_am.meters,
))
register(ChannelKind(
    "sdrangel.channel.ssbdemod", demod_ssb.SSBConfig, demod_ssb.make_state,
    demod_ssb.process, needs_fft_hop=True, dynamic_fields=frozenset({"offset_hz", "volume"}),
))
register(ChannelKind(
    "sdrangel.channel.wfmdemod", demod_wfm.WFMConfig, demod_wfm.make_state,
    demod_wfm.process, needs_fft_hop=True, dynamic_fields=_FULL_DYN,
    meters=demod_wfm.meters,
))


def _bfm_process_engine(state, x, cfg, **dyn):
    """Broadcast FM in the engine: its audio (stereo frames); the RDS
    baseband and the pilot level stay with demod_bfm.process's callers."""
    state, outs = demod_bfm.process(state, x, cfg, **dyn)
    return state, outs.audio


def _bfm_block_factor(channel_rate: float, settings: dict) -> int:
    """BFM's resamplers need the block to hold the mono (48 kHz) and RDS
    (9500 Hz) rational numerators, and whole fft hops."""
    p_mono = Fraction(channel_rate / 48_000.0).limit_denominator(1 << 20).numerator
    p_rds = Fraction(channel_rate / (demod_bfm.RDS_SYMBOL_RATE * demod_bfm.RDS_SPS)
                     ).limit_denominator(1 << 20).numerator
    return math.lcm(p_mono, p_rds, 512)


register(ChannelKind(
    "sdrangel.channel.bfm", demod_bfm.BFMConfig, demod_bfm.make_state, _bfm_process_engine,
    needs_fft_hop=True, dynamic_fields=_FULL_DYN, meters=demod_bfm.meters,
    block_factor=_bfm_block_factor,
))


# -- the data channels (reference plugins chanalyzer, demodlora, demoddsd,
# demodatv, demoddatv, udpsrc): their outputs leave the device as named arrays ----------


def _fields(outs) -> dict:
    """An Outputs NamedTuple whose fields are its data keys."""
    return dict(outs._asdict())


def _chanalyzer_adapter(outs: chanalyzer.ChanAnalyzerOutputs) -> dict:
    return {"iq_real": outs.iq.real, "iq_imag": outs.iq.imag, "spectrum": outs.spectrum,
            "channelPowerDB": outs.channel_power_db}


def _dsd_adapter(outs: demod_dsd.DSDOutputs) -> dict:
    return {"dibits": outs.dibits, "soft_symbols": outs.soft_symbols,
            "squelch_open": outs.squelch_open.to(torch.int32)}


def _udpsrc_adapter(outs: udpsrc.UdpSrcOutputs) -> dict:
    return {"iq_real": outs.iq.real, "iq_imag": outs.iq.imag, "scalar": outs.scalar,
            "squelch": outs.squelch_open}


def _lora_block_factor(channel_rate: float, settings: dict) -> int:
    return demod_lora.LoRaConfig(
        channel_rate=channel_rate, bandwidth=float(settings.get("bandwidth", 125_000.0)),
        spread_factor=int(settings.get("spread_factor", 7))).block_factor()


def _dsd_block_factor(channel_rate: float, settings: dict) -> int:
    """The 48 kHz stream splits into whole symbols (sps = 48000/4800 = 10):
    block·q/p audio samples divisible by 10 make the block a multiple of
    10·p/gcd(q, 10)."""
    frac = Fraction(channel_rate / 48_000.0).limit_denominator(1 << 20)
    return 10 * frac.numerator // math.gcd(frac.denominator, 10)


def _atv_block_factor(channel_rate: float, settings: dict) -> int:
    """Whole lines a block keep the line grid aligned to the block."""
    return demod_atv.ATVConfig(
        channel_rate=channel_rate, standard=str(settings.get("standard", "pal625")),
        lines=int(settings.get("lines", 0)), fps=float(settings.get("fps", 0.0)),
    ).samples_per_line


def _datv_block_factor(channel_rate: float, settings: dict) -> int:
    """Whole symbols a block."""
    return demod_datv.DATVConfig(
        channel_rate=channel_rate, symbol_rate=float(settings.get("symbol_rate", 250_000.0)),
    ).sps


register(ChannelKind(
    "sdrangel.channel.chanalyzer", chanalyzer.ChanAnalyzerConfig, chanalyzer.make_state,
    chanalyzer.process, needs_fft_hop=True, output="data", needs_audio_ratio=False,
    adapter=_chanalyzer_adapter, data_keys=("iq_real", "iq_imag", "spectrum", "channelPowerDB"),
))
register(ChannelKind(
    "sdrangel.channel.lorademod", demod_lora.LoRaConfig, demod_lora.make_state,
    demod_lora.process, block_factor=_lora_block_factor, output="data",
    needs_audio_ratio=False, adapter=_fields,
    data_keys=("symbols", "magnitudes", "snr_est"),
))
register(ChannelKind(
    "sdrangel.channel.dsddemod", demod_dsd.DSDConfig, demod_dsd.make_state, demod_dsd.process,
    block_factor=_dsd_block_factor, output="data", adapter=_dsd_adapter,
    data_keys=("dibits", "soft_symbols", "squelch_open"), host_report_keys=("dsd",),
))
register(ChannelKind(
    "sdrangel.channel.demodatv", demod_atv.ATVConfig, demod_atv.make_state, demod_atv.process,
    block_factor=_atv_block_factor, needs_fft_hop=True, output="data",
    needs_audio_ratio=False, adapter=_fields,
    data_keys=("lines", "sync_phase", "sync_quality"),
))
register(ChannelKind(
    "sdrangel.channel.demoddatv", demod_datv.DATVConfig, demod_datv.make_state,
    demod_datv.process, block_factor=_datv_block_factor, needs_fft_hop=True, output="data",
    needs_audio_ratio=False, adapter=_fields, data_keys=("soft_i", "soft_q"),
    host_report_keys=("datv",),
))
register(ChannelKind(
    "sdrangel.channel.udpsrc", udpsrc.UdpSrcConfig, udpsrc.make_state, udpsrc.process,
    needs_fft_hop=True, output="data", adapter=_udpsrc_adapter,
    data_keys=("iq_real", "iq_imag", "scalar", "squelch"),
    dynamic_fields=frozenset({"offset_hz", "squelch_db"}),
))


for _uri, _cfg in (("sdrangel.channeltx.modnfm", modulators.NFMModConfig),
                   ("sdrangel.channeltx.modam", modulators.AMModConfig),
                   ("sdrangel.channeltx.modssb", modulators.SSBModConfig),
                   ("sdrangel.channeltx.modwfm", modulators.WFMModConfig)):
    register_config(_uri, _cfg)
