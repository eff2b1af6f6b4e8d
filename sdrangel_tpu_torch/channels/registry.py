"""Channel-type registry — the plugin-manager role (pluginmanager.{h,cpp}):
channel kinds keyed by the reference's URIs. The port registers the NFM,
AM, SSB and WFM receivers (REGISTRY) and the NFM, AM, SSB and WFM
modulators of the Tx device sets (TX_KINDS; runtime/tx.py holds their
modulate functions); the other channels wait (ROADMAP.md, queue 1), and
naming one raises NotImplementedError with its queue item.

The session and the REST server read the settable fields from here: each
kind's schema is derived from its config dataclass, so it cannot drift from
the code."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from . import demod_am, demod_nfm, demod_ssb, demod_wfm, modulators


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
#: the offset goes to the channel plan, audioFile to the WAV egress, and
#: the Tx AF source keys (toneFrequency, afFile, cwText, cwWpm) to the Tx
#: worker's AF source
SESSION_KEYS = {"inputFrequencyOffset", "audioFile", "toneFrequency", "afFile", "cwText",
                "cwWpm"}

ITEM_OTHER_RX = ("ROADMAP.md queue 1, item 6 (the other channels: the other Rx channels, "
                 "their host decoders and ATV's modulator)")
ITEM_UDP_RTP = ("ROADMAP.md queue 1, item 12 (UDP/RTP egress and ingest: io/udp.py, "
                "io/rtp.py)")
#: the JAX package's channel kinds that the port does not carry yet
UNPORTED_KINDS = {
    uri: ITEM_OTHER_RX for uri in (
        "sdrangel.channel.bfm", "sdrangel.channel.chanalyzer",
        "sdrangel.channel.lorademod", "sdrangel.channel.dsddemod",
        "sdrangel.channel.demodatv", "sdrangel.channel.demoddatv",
        "sdrangel.channel.udpsrc", "sdrangel.channeltx.modatv")
}
#: the JAX session's per-channel keys that the port does not carry yet
UNPORTED_KEYS = {
    "audioUdp": ITEM_UDP_RTP, "audioRtp": ITEM_UDP_RTP, "udpAddress": ITEM_UDP_RTP,
    "udpPort": ITEM_UDP_RTP, "udpFormat": ITEM_UDP_RTP, "datvContinuous": ITEM_OTHER_RX,
    "afUdp": ITEM_UDP_RTP,
}


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
    report DTOs): every ported kind is an audio kind with the standard
    meters."""
    return {"type": "object", "properties": {
        "channelPowerDB": {"type": "number"},
        "squelch": {"type": "boolean"},
        "audioSampleRate": {"type": "number"},
        "audioSamples": {"type": "integer"},
    }}


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


for _uri, _cfg in (("sdrangel.channeltx.modnfm", modulators.NFMModConfig),
                   ("sdrangel.channeltx.modam", modulators.AMModConfig),
                   ("sdrangel.channeltx.modssb", modulators.SSBModConfig),
                   ("sdrangel.channeltx.modwfm", modulators.WFMModConfig)):
    register_config(_uri, _cfg)
