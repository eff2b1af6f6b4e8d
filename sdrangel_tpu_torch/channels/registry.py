"""Channel-type registry — the plugin-manager role (pluginmanager.{h,cpp}):
channel kinds keyed by the reference's URIs. The port registers the NFM,
AM, SSB and WFM receivers; the other Rx channels wait (ROADMAP.md,
queue 1)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from . import demod_am, demod_nfm, demod_ssb, demod_wfm


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


def register(kind: ChannelKind) -> None:
    REGISTRY[kind.uri] = kind


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
