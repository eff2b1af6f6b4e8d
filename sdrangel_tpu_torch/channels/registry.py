"""Channel-type registry — the plugin-manager role (pluginmanager.{h,cpp}):
channel kinds keyed by the reference's URIs. The port registers NFM; the
other Rx channels wait (ROADMAP.md, queue 1)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from . import demod_nfm


@dataclasses.dataclass(frozen=True)
class ChannelKind:
    uri: str
    config_cls: type
    make_state: Callable[..., Any]
    process: Callable[..., Any]
    # "audio" (48 kHz demod) or "data" (symbols, video, I/Q); the bank gear
    # takes audio kinds only
    output: str = "audio"
    # process kwargs a caller may override per block ("offset_hz",
    # "squelch_db", "volume"), the applySettings-on-a-running-channel path
    dynamic_fields: frozenset = frozenset()
    # (new_state, cfg, dyn) -> report meters from the channel's own state
    meters: Callable[[Any, Any, dict], dict] | None = None


REGISTRY: dict[str, ChannelKind] = {}


def register(kind: ChannelKind) -> None:
    REGISTRY[kind.uri] = kind


register(ChannelKind(
    "sdrangel.channel.nfmdemod", demod_nfm.NFMConfig, demod_nfm.make_state,
    demod_nfm.process, dynamic_fields=frozenset({"offset_hz", "squelch_db", "volume"}),
    meters=demod_nfm.meters,
))
