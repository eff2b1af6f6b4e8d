"""Session — the MainCore role (sdrsrv/maincore.{h,cpp}) for Rx and Tx
device sets.

A Session owns device sets, presets and stored commands, and is driven by
the REST API (api/server.py). A DeviceSet is one source and its channels; its
acquisition runs in a worker thread that streams file or synthetic blocks
through `RxPipeline` on the set's torch device (the DSPDeviceSourceEngine
thread) and publishes per-channel reports and audio. A TxDeviceSet is one
sink and its modulator channels; its worker thread pulls AF blocks (tone,
looped WAV, CW keyer, UDP datagrams) through `TxPipeline` (the
DSPDeviceSinkEngine thread) and records the device-rate stream to a .sdriq.

Live reconfiguration (webapiadaptersrv.cpp:1637 → nfmdemod.cpp
applySettings; downchannelizer.cpp:111-189): dynamic knobs (an in-passband
inputFrequencyOffset, squelch_db, volume) reach the running pipeline every
block as per-block overrides. Static changes (bandwidths, rates, channels
added or removed, device settings) bump a generation counter; the worker
reads back the blocks it has queued, rebuilds the pipeline and goes on from
the same stream position.

Each block's outputs leave the device as one packed vector; `publish_every`
blocks are read back with one copy, one block behind the newest queued
block, as `RxPipeline.run` reads them. Two behaviours differ from the JAX
session on purpose:
- at publish_every=1 the JAX worker reads back the block it has just queued
  (session.py:942-947) and so waits for it; here the read-back stays one
  block behind;
- a generation bump with blocks pending makes the JAX worker drop the whole
  burst (session.py:956, 987-989); here every pending block is published to
  the channels it was computed for, and only the part of a channel removed
  since is dropped.

A data channel (chanalyzer, LoRa, DSD, ATV, DATV, UDPSrc) publishes its
newest block's arrays (`latest_data`, the data route of api/server.py);
every block of a burst is published in order, so the host stages see each
block: the DSD frame sync (channels/dsdsync.py) and the DATV decode, which
buffers the soft symbols and runs the DVB-S FEC and the TS demux over them
(channels/demod_datv.recover_ts, channels/tsdemux.py).

The daemon source (an Rx set's `daemonsource`) takes a remote radio's I/Q
as FEC superframes over UDP (io/daemon.py) into the pipeline; the daemon
sink (a Tx set's `daemonsink`) sends a Tx set's device-rate stream out the
same way. Two things differ from the JAX session: a thread of the daemon
source receives and decodes the superframes, so the socket is drained while
the worker waits on the card (the JAX worker reads the socket between
blocks), and the DATV decode runs outside the set's lock.

A channel's audio goes to a WAV file (audioFile), raw UDP mono16
datagrams (audioUdp, io/udp.py) and RTP L16 packets with RTCP (audioRtp,
io/rtp.py), the AudioNetSink role; a UDPSrc channel with udpAddress and
udpPort streams its formatted output as datagrams (udpFormat); a Tx channel
with afUdp takes its audio from mono16 datagrams. Presets are exported and
imported as JSON or as the reference's Base64-TLV blob (runtime/refpreset.py).

An Rx set with `sharded` runs the channel-bank gears of parallel/sharded.py
on a (mesh_time × mesh_channel) mesh in place of `RxPipeline`: the card's
visible devices for a cuda session (or the group's, after
`parallel.mesh.init_distributed`), every shard on the CPU for a cpu session.
Each process feeds only the time rows it holds (parallel/hostfeed.py) and
publishes only the channel rows it holds; `run_blocks` stops every process
of a mesh at the same block.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import json
import logging
import math
import os
import platform
import queue
import socket
import subprocess
import threading
import time
import wave
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..channels import demod_datv, dsdsync, registry, tsdemux
from ..channels.registry import REGISTRY
from ..dsp import spectrum as dsp_spectrum
from ..dsp.types import INPUT_FORMATS
from ..io import daemon, rtp, sdriq, testsource, udp
from ..parallel import hostfeed
from ..parallel import mesh as meshmod
from ..parallel import sharded as shmod
from . import refpreset
from .engine import ChannelSpec, DeviceConfig, RxPipeline, fetch, resolve_device, unpack_outs
from .fifo import BlockFifo
from .tx import BLOCK_AF, TxChannelSpec, TxDeviceConfig, TxPipeline

_log = logging.getLogger(__name__)

#: available source kinds (the DeviceEnumerator role: software sources only)
SOURCE_KINDS = {
    "testsource": "synthetic carrier generator (AM/FM/none + impairments)",
    "filesource": ".sdriq or raw cu8/cs8/cs16 capture replay (loops at EOF)",
    "daemonsource": "UDP superframe + FEC network ingest (io/daemon.py)",
}
#: available sink kinds
SINK_KINDS = {
    "filesink": ".sdriq recording of the device-rate stream",
    "daemonsink": "UDP superframe + FEC network egress (io/daemon.py)",
}


@dataclasses.dataclass(eq=False)
class ChannelState:
    uri: str
    frequency_offset: float
    settings: dict
    # live report fields (the channel report endpoint)
    channel_power_db: float = -120.0
    audio_sample_rate: int = 48000
    squelch: bool = False
    audio_samples: int = 0
    # published audio blocks not yet drained (the AudioFifo role)
    audio: list = dataclasses.field(default_factory=list, repr=False)
    # data channels: blocks published, the newest block's arrays, and the
    # host's decode of them (the DSD frame sync's "dsd" report)
    data_blocks: int = 0
    latest_data: dict | None = dataclasses.field(default=None, repr=False)
    host_report: dict | None = None
    dsd_sync: "DsdHostSync | None" = dataclasses.field(default=None, repr=False)
    datv: "DatvHostDecode | None" = dataclasses.field(default=None, repr=False)


class DsdHostSync:
    """The frame sync over a DSD channel's dibit stream, the first stage
    DSDcc runs for the reference (dsddecoder.h:61-63 getSyncType,
    getFrameTypeText): DMR/YSF/D-Star sync correlation and frame typing,
    AMBE voice-frame slicing (the hand-off to the vocoder, which stays
    outside) and NXDN/dPMR typing (dsddemod.cpp:655-682), fed each block's
    dibits in order."""

    def __init__(self):
        self.searcher = dsdsync.SyncSearcher()
        self.voice = dsdsync.VoiceExtractor()
        self.nxdn = dsdsync.NxdnDpmrDecoder()
        self.frames: list = []

    def feed(self, dibits: np.ndarray) -> dict:
        """One block's dibits in; the channel's "dsd" report out."""
        dibits = dibits.reshape(-1)
        hits = self.searcher.feed(dibits)
        frames = self.voice.feed(dibits, hits)
        if frames:
            self.frames = (self.frames + frames)[-32:]
        self.nxdn.feed(dibits, hits)
        report = self.searcher.report()
        report["ambeFrameCount"] = self.voice.total
        report["ambeFrames"] = list(self.frames)
        report.update(self.nxdn.report())
        return report


#: soft bits to buffer before the DATV host decode's first pass
_DATV_DECODE_BITS = 120_000


class DatvHostDecode:
    """The DATV channel's host decode (the leansdr graph and ffmpeg-demux
    role of the reference's DATV plugin, datvdemod.cpp), as the JAX
    session's `_datv_host_decode` (session.py:1090-1145): every block's soft
    symbols are buffered in order; once enough are, the DVB-S FEC chain
    (demod_datv.recover_ts) and the TS demux run over the buffer and the
    programme map goes into the channel report.

    One-shot by default: one pass when the buffer first fills. With
    `datvContinuous` the pass runs again over the grown buffer whenever
    another _DATV_DECODE_BITS have arrived, and the buffer starts afresh
    once it holds 8× that (each window is decoded self-contained: the
    rotation, the bit alignment and the scrambler groups are found anew)."""

    def __init__(self):
        self.soft_i: list[np.ndarray] = []
        self.soft_q: list[np.ndarray] = []
        self.rounds = 0
        self.done = False

    def take(self, soft_i: np.ndarray, soft_q: np.ndarray, continuous: bool
             ) -> tuple[np.ndarray, np.ndarray, int] | None:
        """One block's soft symbols in; the buffer to decode now and its
        round number, or None while it is not time for a pass."""
        if self.done and not continuous:
            return None
        self.soft_i.append(soft_i.reshape(-1))
        self.soft_q.append(soft_q.reshape(-1))
        total_bits = 2 * sum(a.shape[-1] for a in self.soft_i)
        cap = 8 * _DATV_DECODE_BITS  # bounds each window's decode cost
        need = _DATV_DECODE_BITS * (1 + self.rounds if continuous else 1)
        if total_bits < cap and total_bits < need:
            return None
        self.done = True
        self.rounds += 1
        out = np.concatenate(self.soft_i), np.concatenate(self.soft_q), self.rounds
        if not continuous:
            self.soft_i, self.soft_q = [], []  # one-shot: keep only the report
        elif total_bits >= cap:
            self.soft_i, self.soft_q = [], []
            self.rounds = 0
        return out

    @staticmethod
    def decode(soft_i: np.ndarray, soft_q: np.ndarray, rounds: int, fec_rate: str) -> dict:
        """The channel's "datv" report of one pass: recover_ts's stats, the
        round, the demux summary and the pass's host seconds."""
        t0 = time.perf_counter()
        ts, stats = demod_datv.recover_ts(soft_i, soft_q, fec_rate=fec_rate, max_packets=2048)
        demux = tsdemux.TsDemux()
        demux.feed(ts)
        return {**stats, "rounds": rounds, "ts": demux.summary(),
                "hostSeconds": time.perf_counter() - t0}


class DaemonSource:
    """The daemonsource's ingest (plugins/samplesource/sdrdaemonsource role):
    a thread receives the UDP superframes, recovers lost blocks and queues
    each frame's int16 I/Q (io/daemon.DaemonReceiver), so the socket is
    drained while the worker waits on the card. `read` takes whole blocks
    from the queue; after `gap_s` with no frame it returns silence, as the
    reference's daemon source runs on with no signal."""

    def __init__(self, address: str, port: int, gap_s: float = 5.0):
        self.key = (address, port)
        self.gap_s = gap_s
        # a short socket timeout lets close() end the thread promptly
        self.rx = daemon.DaemonReceiver(address, port, timeout=0.25)
        # room for a burst: one Tx block is several superframes of 144
        # datagrams (the kernel caps the size at its rmem_max)
        self.rx._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 23)
        self.frames: queue.Queue = queue.Queue(maxsize=1024)
        self._closed = threading.Event()
        self._buf = np.zeros((0, 2), np.int16)
        self._thread = threading.Thread(target=self._receive, daemon=True)
        self._thread.start()

    @property
    def stats(self) -> daemon.FrameStats:
        return self.rx.assembler.stats

    def _receive(self) -> None:
        while not self._closed.is_set():
            try:
                iq, _meta = self.rx.recv_frame()
            except TimeoutError:
                continue
            except OSError:
                return  # the socket closed
            self.frames.put(iq)

    def read(self, count: int) -> np.ndarray:
        """The next `count` samples of the stream as (count, 2) int16."""
        buf = self._buf
        while buf.shape[0] < count:
            try:
                iq = self.frames.get(timeout=self.gap_s)
            except queue.Empty:
                iq = np.zeros((count - buf.shape[0], 2), np.int16)
            buf = np.concatenate([buf, iq], axis=0)
        self._buf = buf[count:]
        return buf[:count]

    def close(self) -> None:
        self._closed.set()
        self._thread.join(timeout=5.0)
        self.rx.close()


class DaemonSink:
    """The daemonsink's egress (plugins/samplesink/sdrdaemonsink role): the
    device-rate stream in whole superframes of payload_room // 4 samples
    (io/daemon.DaemonSender), the rest carried to the next block."""

    def __init__(self, sink: "SinkSettings"):
        self.sender = daemon.DaemonSender(
            sink.daemon_address, int(sink.daemon_port), n_fec=int(sink.daemon_fec),
            center_frequency=int(sink.center_frequency), sample_rate=int(sink.sample_rate),
            auto_fec=bool(sink.daemon_auto_fec))
        self.room = self.sender.payload_room // 4
        self.carry = np.zeros((0, 2), np.int16)

    def write(self, blk: np.ndarray) -> None:
        """(N, 2) int16 I/Q, or complex samples at full scale 1.0 (rounded
        and clipped to int16, as the JAX session does)."""
        if np.iscomplexobj(blk):
            blk = np.stack([np.clip(np.round(blk.real * 32768.0), -32768, 32767),
                            np.clip(np.round(blk.imag * 32768.0), -32768, 32767)],
                           axis=-1).astype(np.int16)
        buf = np.concatenate([self.carry, blk], axis=0)
        n_full = buf.shape[0] // self.room
        for k in range(n_full):
            self.sender.send_iq(buf[k * self.room:(k + 1) * self.room])
        self.carry = buf[n_full * self.room:]

    def close(self) -> None:
        self.sender.close()


@dataclasses.dataclass
class SourceSettings:
    """File or synthetic front end (filesource/testsource settings)."""

    kind: str = "testsource"  # testsource | filesource | daemonsource
    file_path: str = ""
    # filesource container: "sdriq" (16/24-bit) or a raw headerless capture
    # ("cu8" rtl_sdr, "cs8" hackrf, "cs16"); "auto" picks sdriq for .sdriq,
    # else the extension. Raw captures take rate and centre from here.
    file_format: str = "auto"
    # upload the whole capture to the device once at start (bounded by
    # file_preload_max_mb): playback then slices it on the device, with no
    # per-block host-to-device copy
    file_preload: bool = False
    file_preload_max_mb: int = 2048
    sample_rate: float = 768000.0
    center_frequency: float = 0.0
    log2_decim: int = 0
    fc_pos: str = "cen"
    dc_correction: bool = False
    iq_correction: bool = False
    throttle: bool = False  # pace blocks in real time
    # daemonsource: the UDP address and port its superframes arrive on
    daemon_address: str = "127.0.0.1"
    daemon_port: int = 9090
    # testsource
    modulation: str = "fm"
    carrier_freq: float = 0.0
    tone_freq: float = 1000.0
    amplitude: float = 0.5
    # spectrum tap (SpectrumVis config: spectrumvis.cpp:77-200)
    spectrum_fft_size: int = 1024
    spectrum_averaging: str = "moving"  # none | moving | fixed
    spectrum_averaging_n: int = 8
    spectrum_overlap: int = 0
    # non-empty: the device stream is recorded to this .sdriq (FileRecord)
    record_file: str = ""
    # the mesh-sharded bank (parallel/sharded.py) in place of RxPipeline
    sharded: bool = False
    mesh_time: int = 0  # 0 = the mesh's devices / mesh_channel
    mesh_channel: int = 1
    sharded_block: int = 0  # device-rate samples per step (0 = 2^17, aligned)
    # > 0: the bank's polyphase DFT grid of M channels (the PFB gear): an
    # offset snaps to the grid, its residual rides the demod's NCO
    sharded_pfb_m: int = 0
    # with sharded_pfb_m: the all-to-all gear, channels placed by grid chunk
    sharded_pfb_a2a: bool = False
    # > 0: acquisition ends itself after this many blocks (play once; the
    # processes of a mesh all stop at the same block)
    run_blocks: int = 0
    # blocks read back together, one copy per burst
    publish_every: int = 1


_FIELD_TYPES = {"str": str, "float": float, "int": int, "bool": bool}


def coerce_settings(target, settings: dict) -> dict:
    """Type-check and coerce a JSON settings dict against a dataclass
    instance: {field: value}; ValueError on an unknown field or a wrong type
    (the API's 400, as the reference's typed DTOs reject them at parse)."""
    fields = {f.name: f for f in dataclasses.fields(target)}
    out = {}
    for k, v in settings.items():
        f = fields.get(k)
        if f is None:
            raise ValueError(f"unknown device setting {k!r}; allowed: {sorted(fields)}")
        want = _FIELD_TYPES.get(f.type if isinstance(f.type, str) else f.type.__name__)
        if want is bool:
            if not isinstance(v, bool):
                raise ValueError(f"{k} must be a boolean, got {v!r}")
        elif want is float:
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(f"{k} must be a number, got {v!r}")
            v = float(v)
        elif want is int:
            if isinstance(v, bool) or not isinstance(v, int):
                raise ValueError(f"{k} must be an integer, got {v!r}")
        elif want is str and not isinstance(v, str):
            raise ValueError(f"{k} must be a string, got {v!r}")
        out[k] = v
    return out


def check_source(settings: dict) -> dict:
    """The device settings, their kind checked (ValueError on an unknown one)."""
    if settings.get("kind", "testsource") not in SOURCE_KINDS:
        raise ValueError(f"unknown source kind {settings['kind']!r}; "
                         f"available: {sorted(SOURCE_KINDS)}")
    return settings


def check_sink(settings: dict) -> dict:
    """The sink settings, their kind checked (ValueError on an unknown one)."""
    if settings.get("kind", "filesink") not in SINK_KINDS:
        raise ValueError(f"unknown sink kind {settings['kind']!r}; "
                         f"available: {sorted(SINK_KINDS)}")
    return settings


@dataclasses.dataclass
class _Egress:
    """A worker's open sinks, keyed by channel identity, each entry (the
    settings it was opened for, [sinks]): the WAV writers (audioFile), the
    network audio sinks (audioUdp, audioRtp; audionetsink.h:29-63) and
    UDPSrc's data egress (udpAddress, udpPort, udpFormat)."""

    wav: dict = dataclasses.field(default_factory=dict)
    net: dict = dataclasses.field(default_factory=dict)
    data: dict = dataclasses.field(default_factory=dict)

    def close(self) -> None:
        for table in (self.wav, self.net, self.data):
            for _, sinks in table.values():
                _close_all(sinks)
            table.clear()


def _close_all(sinks: list) -> None:
    """Close each sink, whatever the others do: a UDP sink flushes on
    close, and a flush to an address that fails (the write already recorded
    the error) must not leave the other channels' files and sockets open,
    as the JAX session guards each close."""
    for sink in sinks:
        with contextlib.suppress(Exception):
            sink.close()


def _reconcile(table: dict, live: dict, key_of: Callable, open_sinks: Callable) -> None:
    """Close the sinks of a channel removed or whose key changed, and open
    them for a channel with a key and none open (keyed by channel identity,
    so an unrelated settings change never truncates a live file)."""
    for cid in list(table):
        ch = live.get(cid)
        if ch is None or key_of(ch) != table[cid][0]:
            _close_all(table.pop(cid)[1])
    for cid, ch in live.items():
        key = key_of(ch)
        if key is not None and cid not in table:
            table[cid] = (key, open_sinks(key))


def _open_wav(path: str) -> list:
    w = wave.open(path, "wb")
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(48000)
    return [w]


def _net_key(ch: ChannelState) -> tuple | None:
    key = (ch.settings.get("audioUdp"), ch.settings.get("audioRtp"))
    return key if any(key) else None


def _open_net(key: tuple) -> list:
    """The UDP mono16 sink and the RTP L16 sender of "host:port" keys."""
    sinks = []
    if key[0]:
        host, port = key[0].rsplit(":", 1)
        sinks.append(udp.UdpSink(host, int(port), "mono16"))
    if key[1]:
        host, port = key[1].rsplit(":", 1)
        sinks.append(rtp.RtpAudioSender(host, int(port)))
    return sinks


def _udpsrc_key(ch: ChannelState) -> tuple | None:
    """(address, port, wire format) of a UDPSrc channel's data egress: iq16
    for the iq format, mono16 for the others, unless udpFormat says."""
    if ch.uri != "sdrangel.channel.udpsrc":
        return None
    addr, port = ch.settings.get("udpAddress"), ch.settings.get("udpPort")
    if not addr or not port:
        return None
    fmt = ch.settings.get("udpFormat",
                          "iq16" if ch.settings.get("fmt", "iq") == "iq" else "mono16")
    return (str(addr), int(port), str(fmt))


class DeviceSet:
    """One source and its channels (sdrsrv/device/deviceset.h:31-53), run on
    one torch device — the card unless the caller asks for the CPU. A
    channel's `audioFile`, `audioUdp` and `audioRtp` stream its audio to a
    WAV file, UDP and RTP while the set runs; a UDPSrc channel's
    `udpAddress`/`udpPort` stream its data."""

    direction = "rx"

    def __init__(self, index: int, device: torch.device | str = "cuda"):
        self.index = index
        self.device = resolve_device(device)
        self.source = SourceSettings()
        self.channels: list[ChannelState] = []
        self.running = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.audio_keep_blocks = 64
        self.blocks_processed = 0
        self.error = ""
        # settings generation: static changes bump it, and the worker
        # rebuilds the pipeline between blocks when it moves
        self._gen = 0
        # the wall seconds from the run's first queued block to its latest
        # publish (host clock), and the seconds of signal published over them
        self.elapsed_s = 0.0
        self.realtime_factor = 0.0
        self.spectrum: np.ndarray | None = None  # latest baseband spectrum (dB)
        self.scope: np.ndarray | None = None  # latest scope traces (3, 1024)
        # display history (GLSpectrum waterfall and decayed histogram)
        self.waterfall: list[np.ndarray] = []
        self.waterfall_keep = 64
        self.histogram: np.ndarray | None = None  # (100, fft_size) uint8
        # the daemon source, open while the worker runs (kept across
        # rebuilds), and its receiver's frame statistics (kept after a stop)
        self._daemon: DaemonSource | None = None
        self.daemon_stats: daemon.FrameStats | None = None
        # the all-to-all gear's fallback: a live retune whose grid channels no
        # longer balance over the shards makes the worker run the all-gather
        # gear for the rest of the generation (a static change retries a2a);
        # held as the generation it applies to
        self._a2a_fallback_gen = -1

    @property
    def a2a_fallback(self) -> bool:
        """True while the sharded worker runs the all-gather gear because the
        all-to-all gear could not place the current channel grid."""
        return self._a2a_fallback_gen == self._gen

    # -- configuration -------------------------------------------------------

    def add_channel(self, uri: str, settings: dict | None = None) -> int:
        settings = dict(settings or {})
        registry.validate_settings(uri, settings)
        offset = float(settings.pop("inputFrequencyOffset", 0.0))
        with self._lock:
            self.channels.append(ChannelState(uri, offset, settings))
            self._gen += 1
            return len(self.channels) - 1

    def remove_channel(self, index: int) -> None:
        with self._lock:
            del self.channels[index]
            self._gen += 1

    #: channel settings whose live changes reach the pipeline per block,
    #: where the kind takes them as per-block overrides
    _DYN_SETTINGS = frozenset({"squelch_db", "volume"})

    def update_channel(self, index: int, settings: dict) -> None:
        """Apply channel settings; a running pipeline takes them at the next
        block boundary (nfmdemod.cpp handleMessage/applySettings)."""
        with self._lock:
            ch = self.channels[index]
            registry.validate_settings(ch.uri, settings)
            dyn_fields = REGISTRY[ch.uri].dynamic_fields
            static_change = False
            if "inputFrequencyOffset" in settings:
                new_off = float(settings.pop("inputFrequencyOffset"))
                if new_off != ch.frequency_offset and "offset_hz" not in dyn_fields:
                    static_change = True
                # an in-passband retune rides the NCO; the worker bumps the
                # generation itself when the offset leaves the passband
                ch.frequency_offset = new_off
            for k, v in settings.items():
                if ch.settings.get(k) != v and k not in self._DYN_SETTINGS & dyn_fields:
                    static_change = True
            ch.settings.update(settings)
            if static_change:
                self._gen += 1

    def update_source(self, settings: dict) -> None:
        """Typed device-settings update (a wrong type is the API's 400)."""
        coerced = coerce_settings(self.source, check_source(settings))
        with self._lock:
            changed = False
            for k, v in coerced.items():
                if getattr(self.source, k) != v:
                    setattr(self.source, k, v)
                    changed = True
            if changed:
                self._gen += 1

    # -- acquisition ---------------------------------------------------------

    def start(self) -> None:
        if self.running:
            return
        if self._thread is not None:
            # a worker that outlived stop()'s wait (e.g. inside the first
            # kernel build) ends at its next block boundary: wait for it
            self._thread.join()
        self._stop.clear()
        self.error = ""
        self.elapsed_s = self.realtime_factor = 0.0
        # running flips before the thread starts, so a worker that fails at
        # once leaves it False (its finally runs after this line)
        self.running = True
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # a first block on a fresh machine includes the kernel build
            self._thread.join(timeout=60.0)
            if self._thread.is_alive():
                return  # still finishing a block; its finally clears running
            self._thread = None
        self.running = False

    def _build_pipeline(self) -> tuple[RxPipeline, Callable[[int], Callable]]:
        """The pipeline for the current settings and a function that opens
        its block reader for a device block (caller holds the lock; the
        reader is opened outside it: a preload uploads the whole capture).
        A reader maps (stream position, count) to a raw (count, 2) block,
        numpy on the host or a tensor on the pipeline's device."""
        src = self.source
        input_format = "i16"
        fmt = src.file_format
        if fmt == "auto" and src.file_path:
            fmt = ("sdriq" if src.file_path.lower().endswith(".sdriq")
                   else src.file_path.rsplit(".", 1)[-1].lower())
        raw_file = src.kind == "filesource" and fmt in sdriq.RAW_FORMATS
        if raw_file:
            input_format = sdriq.RAW_FORMATS[fmt][1]
        elif src.kind == "filesource":
            # the capture header is authoritative for rate, centre and width
            # (the reference reads it in filesourcethread.cpp)
            info = sdriq.read_header(src.file_path)
            src.sample_rate = float(info.sample_rate)
            if info.center_frequency:
                src.center_frequency = float(info.center_frequency)
            if info.sample_size == 24:
                input_format = "i24"  # int32 container, 2^23 scale
        frontend = DeviceConfig(
            sample_rate=src.sample_rate, center_frequency=src.center_frequency,
            log2_decim=src.log2_decim, fc_pos=src.fc_pos, dc_correction=src.dc_correction,
            iq_correction=src.iq_correction, input_format=input_format,
        )
        specs = []
        for ch in self.channels:
            st = {k: v for k, v in ch.settings.items() if k not in registry.SESSION_KEYS}
            specs.append(ChannelSpec(ch.uri, ch.frequency_offset, st,
                                     requested_rate=registry.requested_rate(ch.uri, st)))
        pipe = RxPipeline(
            frontend, specs, self.device, block_size=1 << 16,
            spectrum_cfg=dsp_spectrum.SpectrumConfig(
                fft_size=int(src.spectrum_fft_size), averaging_mode=src.spectrum_averaging,
                averaging_n=int(src.spectrum_averaging_n), overlap=int(src.spectrum_overlap)),
        )
        if src.kind == "filesource":
            mm = sdriq.open_raw(src.file_path, fmt) if raw_file else sdriq.open_mmap(src.file_path)[1]
            return pipe, self._file_reader(mm)
        if src.kind == "daemonsource":
            key = (src.daemon_address, int(src.daemon_port))
            if self._daemon is not None and self._daemon.key != key:
                self._daemon.close()
                self._daemon = None
            if self._daemon is None:
                self._daemon = DaemonSource(*key)
                self.daemon_stats = self._daemon.stats
            source = self._daemon  # a network stream: the position is the socket's
            return pipe, lambda block: (lambda pos, count: source.read(count))
        cfg = testsource.TestSourceConfig(
            sample_rate=src.sample_rate, carrier_freq=src.carrier_freq,
            modulation=src.modulation, tone_freq=src.tone_freq, amplitude=src.amplitude,
        )
        return pipe, lambda block: (
            lambda pos, count: testsource.to_iq_int16(
                testsource.generate(cfg, count, start_sample=pos)))

    def _file_reader(self, mm: np.ndarray) -> Callable[[int], Callable]:
        """Playback over an (N, 2) host capture. With file_preload the whole
        capture, extended by one block so no read straddles the end, becomes
        one tensor on the device, and each block is a slice of it."""
        src = self.source
        if not src.file_preload:
            return lambda block: (lambda pos, count: sdriq.read_block(mm, pos, count))
        mb = mm.nbytes / 1e6
        if mb > src.file_preload_max_mb:
            raise ValueError(f"file_preload: capture is {mb:.0f} MB > "
                             f"file_preload_max_mb={src.file_preload_max_mb}")
        device = self.device

        def open_reader(block: int):
            n = mm.shape[0]
            head = sdriq.read_block(mm, 0, block)
            capture = torch.from_numpy(np.concatenate([mm, head])).to(device)
            return lambda pos, count: capture[pos % n:pos % n + count]

        return open_reader

    def _sync_sinks(self, egress: _Egress) -> None:
        """Reconcile the egress with the channels' settings (caller holds
        the lock): audioFile, audioUdp/audioRtp, and UDPSrc's udpAddress/
        udpPort/udpFormat."""
        live = {id(ch): ch for ch in self.channels}
        _reconcile(egress.wav, live, lambda ch: ch.settings.get("audioFile") or None, _open_wav)
        _reconcile(egress.net, live, _net_key, _open_net)
        _reconcile(egress.data, live, _udpsrc_key, lambda key: [udp.UdpSink(*key)])

    def _live_dyn(self, pipe: RxPipeline) -> tuple[list, bool]:
        """Per-channel overrides from the live settings (caller holds the
        lock), and whether a retune left its channelizer passband, which the
        NCO cannot absorb (downchannelizer.cpp applyConfiguration)."""
        dyn, rebuild = [], False
        for i, ch in enumerate(self.channels):
            kind, cfg = pipe.kinds[i], pipe.demod_cfgs[i]
            d = {}
            if "offset_hz" in kind.dynamic_fields:
                delta = ch.frequency_offset - pipe.channel_specs[i].frequency_offset
                if abs(delta) > 0.25 * pipe.plans[i].channel_rate:
                    rebuild = True
                d["offset_hz"] = float(cfg.input_offset + delta)
            if "squelch_db" in kind.dynamic_fields:
                d["squelch_db"] = float(ch.settings.get("squelch_db", cfg.squelch_db))
            if "volume" in kind.dynamic_fields:
                d["volume"] = float(ch.settings.get("volume", cfg.volume))
            dyn.append(d)
        return dyn, rebuild

    def _work(self) -> None:
        """Each worker runs generations until a stop, an error or a flip of
        `sharded`, which hands over to the other."""
        try:
            while not self._stop.is_set() and not self.error:
                if self.source.sharded:
                    self._work_sharded()
                else:
                    self._work_regular()
        finally:
            self.running = False

    def _work_regular(self) -> None:
        """The engine thread: gotoRunning → block loop → gotoIdle
        (dspdevicesourceengine.cpp:325-408). The outer loop is a settings
        generation: a static change ends the block loop, the pending blocks
        are published, and the pipeline is rebuilt at the same position."""
        egress = _Egress()
        recorder = None  # ((path, rate, centre), SdriqWriter)
        pos = 0  # device-rate sample position, kept across rebuilds
        t_start = None  # the run's first queued block (host clock)
        signal_s = 0.0  # seconds of signal published in this run
        try:
            while not self._stop.is_set():
                with self._lock:
                    gen = self._gen
                    if self.source.sharded:
                        return  # the sharded worker takes over
                    pipe, open_reader = self._build_pipeline()
                    chans = list(self.channels)  # the pipeline's channels, in its order
                    self._sync_sinks(egress)
                    rec_cfg = (self.source.record_file, int(self.source.sample_rate),
                               int(self.source.center_frequency))
                    pub_n = max(1, int(self.source.publish_every))
                    run_blocks, throttle = self.source.run_blocks, self.source.throttle
                reader = open_reader(pipe.device_block)
                if recorder is not None and rec_cfg != recorder[0]:
                    recorder[1].close()
                    recorder = None
                if recorder is None and rec_cfg[0]:
                    recorder = (rec_cfg, sdriq.SdriqWriter(
                        rec_cfg[0], sample_rate=rec_cfg[1], center_frequency=rec_cfg[2],
                        sample_size=24 if pipe.frontend.input_format == "i24" else 16))
                state = pipe.init_state()
                block_seconds = pipe.device_block / pipe.frontend.sample_rate
                pending: list[torch.Tensor] = []  # packed blocks queued, oldest first

                def flush(blocks: list[torch.Tensor]) -> None:
                    """Read `blocks` back with one copy and publish them to
                    the channels they were computed for."""
                    nonlocal signal_s
                    flat = fetch(blocks[0] if len(blocks) == 1 else torch.cat(blocks))
                    size = pipe.out_layout.size
                    for k in range(len(blocks)):
                        self._publish_block(
                            unpack_outs(flat[k * size:(k + 1) * size], pipe.out_layout),
                            chans, egress)
                    signal_s += len(blocks) * block_seconds
                    self.elapsed_s = time.perf_counter() - t_start
                    self.realtime_factor = signal_s / max(self.elapsed_s, 1e-9)

                while not self._stop.is_set():
                    if run_blocks and self.blocks_processed + len(pending) >= run_blocks:
                        self._stop.set()  # play once: done
                        break
                    with self._lock:
                        if self._gen != gen:
                            break  # a static change: rebuild between blocks
                        dyn, rebuild = self._live_dyn(pipe)
                        if rebuild:
                            self._gen += 1
                            continue
                    t0 = time.perf_counter()
                    t_start = t0 if t_start is None else t_start
                    raw = reader(pos, pipe.device_block)
                    if recorder is not None:
                        recorder[1].write(_to_i16_record(raw, pipe.frontend.input_format))
                    if isinstance(raw, np.ndarray):
                        raw = pipe.upload(raw)
                    state, flat = pipe.step_packed(state, raw, dyn)
                    pending.append(flat)
                    pos += pipe.device_block
                    # read a burst back once the block after it is queued,
                    # so the device never idles on the read-back
                    if len(pending) > pub_n:
                        flush(pending[:pub_n])
                        del pending[:pub_n]
                    dt = time.perf_counter() - t0
                    if throttle and dt < block_seconds:
                        time.sleep(block_seconds - dt)
                if pending:
                    flush(pending)  # before the rebuild or the stop
        except Exception as e:  # StError (dspdevicesourceengine.h:28)
            self.error = f"{type(e).__name__}: {e}"
        finally:
            egress.close()
            if recorder is not None:
                recorder[1].close()
            if self._daemon is not None:
                self._daemon.close()
                self._daemon = None

    def _publish_block(self, outs: dict, chans: list[ChannelState], egress: _Egress) -> None:
        """One block's host outputs into the reports, the audio buffers and
        the egress (WAV, UDP, RTP; UDPSrc's datagrams). `chans` are the
        channels the block was computed for; a channel removed since then
        gets nothing (its audio is dropped),
        every other channel gets its part whatever changed meanwhile. A
        DATV pass runs after the lock is released: it takes seconds, and the
        reports stay readable meanwhile."""
        decodes = []
        with self._lock:
            self.spectrum = outs["spectrum"]
            self.scope = outs["scope"]
            if self.histogram is None or self.histogram.shape[1] != len(self.spectrum):
                # (re)size with the spectrum tap's fft size
                self.histogram = np.zeros((100, len(self.spectrum)), np.uint8)
                self.waterfall.clear()
            self.waterfall.append(self.spectrum)
            del self.waterfall[:-self.waterfall_keep]
            self.histogram = dsp_spectrum.histogram_decay(self.histogram, self.spectrum)
            live = {id(ch) for ch in self.channels}
            for ch, out in zip(chans, outs["channels"]):
                if id(ch) not in live:
                    continue
                ch.channel_power_db = float(10.0 * np.log10(max(float(out["power"]), 1e-12)))
                if "data" in out:
                    ch.latest_data = out["data"]
                    ch.data_blocks += 1
                    if ch.uri == "sdrangel.channel.dsddemod":
                        ch.dsd_sync = ch.dsd_sync or DsdHostSync()
                        ch.host_report = {"dsd": ch.dsd_sync.feed(ch.latest_data["dibits"])}
                    elif ch.uri == "sdrangel.channel.demoddatv":
                        ch.datv = ch.datv or DatvHostDecode()
                        todo = ch.datv.take(ch.latest_data["soft_i"], ch.latest_data["soft_q"],
                                            bool(ch.settings.get("datvContinuous", False)))
                        if todo is not None:
                            decodes.append((ch, todo, ch.settings.get("fec_rate", "1/2")))
                    entry = egress.data.get(id(ch))
                    if entry is not None:
                        # UDPSrc's datagrams (udpsrc.cpp feed -> UDPSink); a
                        # data kind's squelch meter is set only here
                        d = ch.latest_data
                        payload = ((d["iq_real"] + 1j * d["iq_imag"]).astype(np.complex64)
                                   if entry[0][2] in ("iq16", "iq24") else d["scalar"])
                        entry[1][0].write(payload)
                        if "squelch" in d:
                            ch.squelch = bool(d["squelch"])
                    continue
                audio = out["audio"]
                # the demod's own gate state where it has one (nfmdemod.h getters)
                ch.squelch = (bool(out["squelch"]) if "squelch" in out
                              else bool(np.abs(audio).max() > 1e-4))
                ch.audio_samples += audio.shape[0]
                ch.audio.append(audio)
                del ch.audio[:-self.audio_keep_blocks]
                mono = audio if audio.ndim == 1 else audio[:, 0]
                for w in egress.wav.get(id(ch), (None, ()))[1]:
                    w.writeframes(
                        np.clip(mono * 32768.0, -32768, 32767).astype(np.int16).tobytes())
                for sink in egress.net.get(id(ch), (None, ()))[1]:
                    sink.write(mono)
            self.blocks_processed += 1
        for ch, (soft_i, soft_q, rounds), fec_rate in decodes:
            ch.host_report = {"datv": DatvHostDecode.decode(soft_i, soft_q, rounds, fec_rate)}

    # -- the sharded worker (parallel/sharded.py) ---------------------------

    def _bank_plan(self, n_channel: int) -> tuple[tuple, list]:
        """The channels as the bank's homogeneous groups (kind and settings
        alike): (groups, chmap), chmap[g] the channel indices of group g's
        rows, in order (caller holds the lock)."""
        order, by_key = [], {}
        for idx, ch in enumerate(self.channels):
            kind = REGISTRY.get(ch.uri)
            if kind is None or kind.output != "audio":
                raise ValueError(f"sharded device sets support audio channel kinds; "
                                 f"channel {idx} is {ch.uri}")
            if "offset_hz" not in kind.dynamic_fields:
                raise ValueError(f"{ch.uri} cannot run sharded (its offset is not a "
                                 f"per-block argument)")
            st = {k: v for k, v in ch.settings.items() if k not in registry.SESSION_KEYS}
            key = (ch.uri, tuple(sorted(st.items())))
            if key not in by_key:
                by_key[key] = []
                order.append(key)
            by_key[key].append(idx)
        groups, chmap = [], []
        for key in order:
            idxs = by_key[key]
            if len(idxs) % n_channel:
                raise ValueError(f"{key[0]}: {len(idxs)} channels with identical settings "
                                 f"needed in multiples of the mesh channel axis {n_channel}")
            groups.append(shmod.BankGroup(key[0], len(idxs), dict(key[1])))
            chmap.append(idxs)
        return tuple(groups), chmap

    def _work_sharded(self) -> None:
        """The sharded engine thread: the mesh gear as the set's acquisition
        loop, with _work_regular's generations. Each block: this process's
        time rows read (filesource through hostfeed, or the test source),
        the live offsets as per-block arguments, the step, the held rows
        published."""
        egress = _Egress()
        pos_blocks = 0  # block index, kept across rebuilds
        t_start = None
        signal_s = 0.0
        try:
            while not self._stop.is_set():
                with self._lock:
                    gen = self._gen
                    src = self.source
                    if not src.sharded:
                        return  # the one-pipeline worker takes over
                    n_channel = max(1, int(src.mesh_channel))
                    # the group's places under init_distributed, else the
                    # visible cards; a cpu set puts every shard on the CPU
                    places = meshmod.group_places() or (
                        meshmod.default_places() if self.device.type == "cuda" else [])
                    n_time = int(src.mesh_time) or max(1, len(places) // n_channel)
                    places = places or [self.device] * (n_time * n_channel)
                    groups, chmap = self._bank_plan(n_channel)
                    if src.kind == "filesource" and src.file_path:
                        info = sdriq.read_header(src.file_path)
                        src.sample_rate = float(info.sample_rate)
                        if info.center_frequency:
                            src.center_frequency = float(info.center_frequency)
                    self._sync_sinks(egress)
                    run_blocks, throttle = src.run_blocks, src.throttle
                if not groups:
                    time.sleep(0.05)
                    continue
                # shard length (4·2^k per time shard) and, with a PFB gear,
                # whole frames on every shard of the mesh in one alignment,
                # so the analysis is frame-sharded at any sharded_block
                pfb_m = int(src.sharded_pfb_m)
                a2a = bool(src.sharded_pfb_a2a) and bool(pfb_m) and not self.a2a_fallback
                align = ((math.lcm(4, pfb_m or 1) << src.log2_decim)
                         * n_time * (n_channel if pfb_m else 1))
                if a2a:  # the a2a spectrum tap's frames align with the time shards
                    align = math.lcm(align, int(src.spectrum_fft_size) * n_time
                                     << src.log2_decim)
                block = int(src.sharded_block) or (1 << 17)
                block = max(block // align, 1) * align
                cfg = shmod.ShardedPipelineConfig(
                    n_time=n_time, n_channel=n_channel, device_rate=src.sample_rate,
                    log2_decim=src.log2_decim, fc_pos=src.fc_pos, block=block, bank=groups,
                    pfb_m=pfb_m, pfb_all_to_all=a2a,
                    spectrum=dsp_spectrum.SpectrumConfig(
                        fft_size=int(src.spectrum_fft_size), averaging_mode="none"))
                mesh = meshmod.make_mesh(n_time, n_channel, places)
                step, init_fn = shmod.build_sharded_step(cfg, mesh)
                if step.replicated_analysis:  # the alignment above rules it out
                    raise RuntimeError("the sharded PFB gear fell back to replicated analysis")
                state, carry = init_fn()
                if src.kind == "filesource":
                    feeder = hostfeed.ShardedSdriqFeeder(src.file_path, mesh, block)
                    read_block = feeder.block
                elif src.kind == "testsource":
                    tcfg = testsource.TestSourceConfig(
                        sample_rate=src.sample_rate, carrier_freq=src.carrier_freq,
                        modulation=src.modulation, tone_freq=src.tone_freq,
                        amplitude=src.amplitude)

                    def read_block(b, _block=block, _cfg=tcfg, _mesh=mesh):
                        return hostfeed.shard_block(
                            _mesh, _block, b, lambda start, count: testsource.to_iq_int16(
                                testsource.generate(_cfg, count, start_sample=start)))
                else:
                    raise ValueError(f"sharded device sets support filesource/testsource, "
                                     f"not {src.kind!r}")
                spec_alpha = 1.0 / max(1, int(src.spectrum_averaging_n))
                block_seconds = block / src.sample_rate
                while not self._stop.is_set():
                    if run_blocks and pos_blocks >= run_blocks:
                        self._stop.set()  # play once: every process stops here
                        return
                    with self._lock:
                        if self._gen != gen:
                            break  # a static change: rebuild between blocks
                        raw_offsets = [np.asarray([self.channels[i].frequency_offset
                                                   for i in idxs], np.float32)
                                       for idxs in chmap]
                    t0 = time.perf_counter()
                    t_start = t0 if t_start is None else t_start
                    row_orders = None
                    if a2a:
                        # placement by grid chunk; a retune that no longer
                        # balances over the shards falls back to the
                        # all-gather gear for the rest of the generation
                        try:
                            orders, local_idx, residuals = shmod.a2a_placement(cfg, raw_offsets)
                        except ValueError as e:
                            with self._lock:
                                self._a2a_fallback_gen = self._gen
                            _log.warning("a2a placement failed after retune (%s); falling "
                                         "back to the all_gather gear", e)
                            break  # rebuild (same generation, a2a off)
                        state, audio, carry, spec = step(
                            state, read_block(pos_blocks), carry, tuple(residuals),
                            tuple(local_idx))
                        row_orders = orders  # audio row r = channel orders[g][r]
                    elif pfb_m:
                        split = [shmod.grid_split(cfg, o) for o in raw_offsets]
                        state, audio, carry, spec = step(
                            state, read_block(pos_blocks), carry,
                            tuple(r for _, r in split), tuple(i for i, _ in split))
                    else:
                        state, audio, carry, spec = step(
                            state, read_block(pos_blocks), carry, tuple(raw_offsets))
                    audios = [a.cpu().numpy() for a in (audio if isinstance(audio, tuple)
                                                        else (audio,))]
                    frame = spec.cpu().numpy()
                    self._publish_sharded(audios, step.rows, chmap, egress, gen, row_orders)
                    # the spectrum tap: the step's unaveraged frame, the EMA here
                    with self._lock:
                        if (src.spectrum_averaging == "moving" and self.spectrum is not None
                                and len(self.spectrum) == len(frame)):
                            frame = (1.0 - spec_alpha) * self.spectrum + spec_alpha * frame
                        self.spectrum = frame
                        self.waterfall.append(frame)
                        del self.waterfall[:-self.waterfall_keep]
                    signal_s += block_seconds
                    self.elapsed_s = time.perf_counter() - t_start
                    self.realtime_factor = signal_s / max(self.elapsed_s, 1e-9)
                    pos_blocks += 1
                    dt = time.perf_counter() - t0
                    if throttle and dt < block_seconds:
                        time.sleep(block_seconds - dt)
        except Exception as e:  # StError (dspdevicesourceengine.h:28)
            self.error = f"{type(e).__name__}: {e}"
        finally:
            egress.close()

    def _publish_sharded(self, audios: list, rows: tuple, chmap: list, egress: _Egress,
                         gen: int, row_orders=None) -> None:
        """One sharded block's rows held by this process into the channels'
        reports, audio buffers, WAV files and UDP/RTP sinks. rows[g] are the
        bank rows of audios[g]; with the a2a gear a row is a placement slot,
        row_orders[g][row] the group's channel position. A block computed
        before a channel layout change publishes nothing."""
        with self._lock:
            if self._gen != gen:
                return
            for g, audio in enumerate(audios):
                for row, a in zip(rows[g], audio):
                    pos = int(row_orders[g][row]) if row_orders is not None else int(row)
                    ch = self.channels[chmap[g][pos]]
                    # the bank returns no magsq: the audio's power stands in
                    ch.channel_power_db = float(
                        10.0 * np.log10(max(float((a * a).mean()), 1e-12)))
                    ch.squelch = bool(np.abs(a).max() > 1e-4)
                    ch.audio_samples += a.shape[-1]
                    ch.audio.append(a)
                    del ch.audio[:-self.audio_keep_blocks]
                    for w in egress.wav.get(id(ch), (None, ()))[1]:
                        w.writeframes(np.clip(a * 32768.0, -32768, 32767).astype(np.int16)
                                      .tobytes())
                    for sink in egress.net.get(id(ch), (None, ()))[1]:
                        sink.write(a)
            self.blocks_processed += 1

    def drain_audio(self, channel: int) -> np.ndarray:
        with self._lock:
            ch = self.channels[channel]
            parts, ch.audio = ch.audio, []
        if not parts:
            return np.zeros(0, dtype=np.float32)
        return np.concatenate(parts, axis=0)


def _to_i16_record(raw, input_format: str) -> np.ndarray:
    """A raw block as the .sdriq recorder writes it: host int16 (int32 for
    24-bit); an 8-bit capture is rescaled to 16 bits."""
    rec = raw.cpu().numpy() if isinstance(raw, torch.Tensor) else np.asarray(raw)
    if rec.dtype in (np.int16, np.int32):
        return rec
    _, off, scale = INPUT_FORMATS[input_format]
    return np.clip((rec.astype(np.float32) - off) * (32768.0 / scale),
                   -32768, 32767).astype(np.int16)


@dataclasses.dataclass
class SinkSettings:
    """Tx device sink settings (the filesink role, or the sdrdaemonsink
    network role with kind="daemonsink")."""

    kind: str = "filesink"  # filesink (.sdriq) | daemonsink (UDP superframes)
    file_path: str = ""  # the .sdriq the filesink records to (required to start it)
    sample_rate: float = 384000.0  # the DAC rate
    center_frequency: float = 0.0
    log2_interp: int = 0
    throttle: bool = False  # pace blocks in real time (a DAC-clock stand-in)
    # daemonsink: where its superframes go, their parity blocks (nbFECBlocks)
    # and whether the receiver's loss reports drive that number
    daemon_address: str = "127.0.0.1"
    daemon_port: int = 9094
    daemon_fec: int = 4
    daemon_auto_fec: bool = False


class TxDeviceSet:
    """One sink and its modulator channels, run on one torch device — the
    card unless the caller asks for the CPU. Its worker runs until stopped
    (the DSPDeviceSinkEngine work loop): AF blocks from each channel's
    source (a tone, `toneFrequency`; a looped 48 kHz WAV, `afFile`; the CW
    keyer, `cwText`/`cwWpm`, keying the tone) go through `TxPipeline`, and
    each int16 device block is read back one block behind and handed to a
    BlockFifo, which a writer thread drains into the .sdriq (filesink) or
    sends as UDP superframes (daemonsink). Channel and sink settings apply
    at the next start, as in the JAX session."""

    direction = "tx"

    def __init__(self, index: int, device: torch.device | str = "cuda"):
        self.index = index
        self.device = resolve_device(device)
        self.sink = SinkSettings()
        self.channels: list[ChannelState] = []
        self.running = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.blocks_processed = 0  # device blocks read back and handed to the sink
        self.error = ""
        # wall seconds from the run's first queued block to its latest read
        # back (host clock), and the seconds of signal read back over them
        self.elapsed_s = 0.0
        self.realtime_factor = 0.0
        # the Rx display taps, which a Tx set does not have
        self.spectrum = self.scope = self.histogram = None
        self.waterfall: list = []

    # -- configuration -------------------------------------------------------

    def add_channel(self, uri: str, settings: dict | None = None) -> int:
        settings = dict(settings or {})
        registry.validate_settings(uri, settings, "tx")
        offset = float(settings.pop("inputFrequencyOffset", 0.0))
        self.channels.append(ChannelState(uri, offset, settings))
        return len(self.channels) - 1

    def remove_channel(self, index: int) -> None:
        del self.channels[index]

    def update_channel(self, index: int, settings: dict) -> None:
        ch = self.channels[index]
        registry.validate_settings(ch.uri, settings, "tx")
        if "inputFrequencyOffset" in settings:
            ch.frequency_offset = float(settings.pop("inputFrequencyOffset"))
        ch.settings.update(settings)

    def update_source(self, settings: dict) -> None:
        """Typed sink-settings update (a wrong type is the API's 400)."""
        for k, v in coerce_settings(self.sink, check_sink(settings)).items():
            setattr(self.sink, k, v)

    # -- the worker ----------------------------------------------------------

    def start(self) -> None:
        if self.running:
            return
        if self._thread is not None:
            self._thread.join()  # a worker that outlived stop()'s wait
        self._stop.clear()
        self.error = ""
        self.elapsed_s = self.realtime_factor = 0.0
        self.running = True  # before the thread: a fast failure leaves it False
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            if self._thread.is_alive():
                return  # still finishing a block; its finally clears running
            self._thread = None
        self.running = False

    def _af_sources(self) -> tuple[list[TxChannelSpec], Callable, list]:
        """The pipeline's channel specs, af(b, c, count), each channel's AF
        source, and the UDP sources to close when the worker ends. A
        channel's AF source is the mono16 datagrams of afUdp ("host:port",
        the reference's channeltx/udpsink ingest; an underrun reads as
        silence), else a looped WAV (afFile; its channels averaged, played
        at 48 kHz), else its tone (toneFrequency, default 1 kHz) keyed by
        the CW keyer when cwText is set (the CWKeyer feeding Tx channels,
        cwkeyer.h:141)."""
        from ..channels.cwkeyer import CWConfig, CWKeyer

        specs, tones, wavs, keyers, udps = [], [], {}, {}, {}
        try:
            for i, ch in enumerate(self.channels):
                st = ch.settings
                tones.append(float(st.get("toneFrequency", 1000.0)))
                if st.get("afUdp"):
                    host, port = st["afUdp"].rsplit(":", 1)
                    udps[i] = udp.UdpSource(host, int(port), "mono16", timeout=2.0)
                if st.get("afFile"):
                    with wave.open(st["afFile"], "rb") as w:
                        pcm = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
                        wavs[i] = (pcm.reshape(-1, w.getnchannels()).mean(axis=1) / 32768.0
                                   ).astype(np.float32)
                if st.get("cwText"):
                    keyers[i] = CWKeyer(str(st["cwText"]), CWConfig(
                        wpm=float(st.get("cwWpm", 15.0)), sample_rate=48000.0), loop=True)
                specs.append(TxChannelSpec(ch.uri, ch.frequency_offset, {
                    k: v for k, v in st.items() if k not in registry.SESSION_KEYS}))
        except BaseException:  # a bound socket would hold its port until collected
            for src in udps.values():
                src.close()
            raise

        def af(b: int, c: int, count: int) -> np.ndarray:
            if c in udps:
                try:
                    return udps[c].read(count).astype(np.float32)
                except OSError:  # a timeout: the underrun is silence
                    return np.zeros(count, np.float32)
            if c in wavs:
                src = wavs[c]
                return src[(b * count + np.arange(count)) % len(src)]
            tt = (b * count + np.arange(count)) / 48000.0
            tone = np.sin(2 * np.pi * tones[c] * tt).astype(np.float32)
            return tone * keyers[c].next_block(count) if c in keyers else tone

        return specs, af, list(udps.values())

    def _work(self) -> None:
        try:
            specs, af, udp_sources = self._af_sources()
            try:
                self._work_sink(specs, af)
            finally:
                for src in udp_sources:
                    src.close()
        except Exception as e:  # StError
            self.error = f"{type(e).__name__}: {e}"
        finally:
            self.running = False

    def _work_sink(self, specs: list[TxChannelSpec], af: Callable) -> None:
        """The engine thread: build the pipeline and the sink, then queue
        blocks until stopped, reading each back once the next is queued."""
        if not self.channels:
            raise ValueError("Tx device set has no channels — add a modulator channel "
                             "before starting")
        sink = self.sink
        if sink.kind == "filesink" and not sink.file_path:
            raise ValueError("the filesink needs file_path")
        chans = list(self.channels)  # the pipeline's channels, in its order
        pipe = TxPipeline(TxDeviceConfig(sink.sample_rate, sink.log2_interp,
                                         sink.center_frequency), specs, BLOCK_AF, self.device)
        block_seconds = pipe.device_block / sink.sample_rate
        writer = (DaemonSink(sink) if sink.kind == "daemonsink" else
                  sdriq.SdriqWriter(sink.file_path, sample_rate=int(sink.sample_rate),
                                    center_frequency=int(sink.center_frequency)))
        # the SampleSourceFifo role: the device blocks flow to a writer
        # thread through a bounded FIFO, so compute, read-back and disk IO
        # overlap, and a slow sink holds the producer back
        fifo = BlockFifo(depth=8)
        drain_error: list[Exception] = []

        def drain() -> None:
            try:
                while (blk := fifo.get()) is not None:
                    writer.write(blk)
            except Exception as e:  # surfaced by the worker
                drain_error.append(e)
                fifo.close()

        drain_thread = threading.Thread(target=drain, daemon=True)
        drain_thread.start()
        t_start, signal_s = None, 0.0

        def hand_over(out: torch.Tensor) -> None:
            nonlocal signal_s
            if not fifo.put(fetch(out)):
                raise RuntimeError(f"the {sink.kind} stopped: {drain_error[0]!r}"
                                   if drain_error else f"the {sink.kind} stopped")
            for ch in chans:
                ch.audio_samples += BLOCK_AF
            self.blocks_processed += 1
            signal_s += block_seconds
            self.elapsed_s = time.perf_counter() - t_start
            self.realtime_factor = signal_s / max(self.elapsed_s, 1e-9)

        try:
            state = pipe.init_state()
            pending = None  # one behind: block b is read back once b+1 is queued
            b = 0
            while not self._stop.is_set():
                t0 = time.perf_counter()
                t_start = t0 if t_start is None else t_start
                state, out = pipe.step(state, pipe.upload(
                    [af(b, c, BLOCK_AF) for c in range(len(specs))]))
                if pending is not None:
                    hand_over(pending)
                pending = out
                b += 1
                dt = time.perf_counter() - t0
                if sink.throttle and dt < block_seconds:
                    time.sleep(block_seconds - dt)
            if pending is not None:
                hand_over(pending)
        finally:
            fifo.close()
            drain_thread.join(timeout=30.0)
            writer.close()
        if drain_error:
            raise drain_error[0]


def device_settings(ds: DeviceSet | TxDeviceSet) -> SourceSettings | SinkSettings:
    """A device set's device settings: the source of an Rx set, the sink of
    a Tx set."""
    return ds.sink if ds.direction == "tx" else ds.source


#: the preset document's schema: 1 had no "schema" key; 2 stamps it, and
#: settings are sanitized against the current dataclasses on load
PRESET_SCHEMA_VERSION = 2


def _known_fields(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def _migrate_v1_to_v2(preset: dict) -> dict:
    """v1 → v2: stamp the version, default the missing structure."""
    preset = dict(preset)
    preset["schema"] = 2
    sets = []
    for entry in preset.get("deviceSets", []):
        entry = dict(entry)
        entry.setdefault("direction", "rx")
        entry["channels"] = [
            {"uri": ch["uri"], "inputFrequencyOffset": ch.get("inputFrequencyOffset", 0.0),
             "settings": ch.get("settings", {})}
            for ch in entry.get("channels", [])
        ]
        sets.append(entry)
    preset["deviceSets"] = sets
    return preset


#: migration chain: schema N -> function producing schema N+1
PRESET_MIGRATIONS = {1: _migrate_v1_to_v2}


def migrate_preset(preset: dict) -> dict:
    """A preset document at PRESET_SCHEMA_VERSION (unchanged when current;
    raises on a document newer than this build)."""
    version = int(preset.get("schema", 1))
    if version > PRESET_SCHEMA_VERSION:
        raise ValueError(f"preset schema {version} is newer than this build's "
                         f"{PRESET_SCHEMA_VERSION}; upgrade to load it")
    while version < PRESET_SCHEMA_VERSION:
        preset = PRESET_MIGRATIONS[version](preset)
        version = int(preset["schema"])
    return preset


class Session:
    """MainCore: the device sets, the presets (a JSON store, where the
    reference keeps Base64-TLV blobs in QSettings) and the stored commands.
    Every device set runs on the session's torch device: the card unless the
    caller asks for the CPU."""

    def __init__(self, preset_path: str | None = None, preset_dir: str | None = None,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.device_sets: list[DeviceSet | TxDeviceSet] = []
        self.presets: dict[str, dict] = {}
        self.commands: dict[str, dict] = {}
        self.start_time = time.time()
        self.preset_path = preset_path
        # preset file import/export confinement (see _preset_file_path)
        self.preset_dir = preset_dir or os.environ.get(
            "SDRANGEL_TPU_PRESET_DIR",
            os.path.dirname(os.path.abspath(preset_path)) if preset_path
            else os.path.join(os.path.expanduser("~"), ".sdrangel_tpu", "presets"))
        if preset_path and os.path.exists(preset_path):
            with open(preset_path) as f:
                raw = json.load(f)
            # an entry this build cannot read (saved by a newer one) is kept
            # verbatim, so the next persist keeps it; loading it raises
            for k, v in raw.items():
                try:
                    self.presets[k] = migrate_preset(v)
                except Exception:
                    self.presets[k] = v

    def _persist_presets(self) -> None:
        if self.preset_path:
            with open(self.preset_path, "w") as f:
                json.dump(self.presets, f, indent=1)

    def add_device_set(self, direction: str = "rx") -> DeviceSet | TxDeviceSet:
        if direction not in ("rx", "tx"):
            raise ValueError(f"direction must be rx or tx, got {direction!r}")
        cls = TxDeviceSet if direction == "tx" else DeviceSet
        ds = cls(len(self.device_sets), self.device)
        self.device_sets.append(ds)
        return ds

    def remove_last_device_set(self) -> None:
        if self.device_sets:
            self.device_sets.pop().stop()

    def shutdown(self) -> None:
        """Stop every device set (MainCore::MsgDeleteInstance role,
        webapiadaptersrv.cpp:104-115)."""
        for ds in self.device_sets:
            ds.stop()

    # -- commands (sdrbase/commands/command.h:30-70) ---------------------------

    def set_command(self, name: str, command: str, args: str = "") -> None:
        self.commands[name] = {"command": command, "args": args}

    def delete_command(self, name: str) -> None:
        del self.commands[name]

    def run_command(self, name: str, api_port: int = 8091) -> dict:
        """Run a stored command; %1 in its arguments becomes the API address."""
        entry = self.commands[name]
        args = entry["args"].replace("%1", f"127.0.0.1:{api_port}")
        cmd = f"{entry['command']} {args}".strip()
        proc = subprocess.run(cmd, shell=True, capture_output=True, text=True, timeout=30.0)
        return {"name": name, "command": cmd, "returncode": proc.returncode,
                "stdout": proc.stdout[-4096:], "stderr": proc.stderr[-4096:]}

    def summary(self) -> dict:
        """instanceSummary (webapiadaptersrv.cpp:71-103): torch and the
        device stand where the reference names Qt."""
        from .. import __version__

        root = logging.getLogger()
        return {
            "appname": "sdrangel_tpu_torch",
            "version": __version__,
            "torchVersion": torch.__version__,
            "device": (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                       else "cpu"),
            "architecture": platform.machine(),
            "os": f"{platform.system()} {platform.release()}",
            "dspRxBits": 16,
            "dspTxBits": 16,
            "pid": os.getpid(),
            "uptime_s": round(time.time() - self.start_time, 1),
            "logging": {
                "consoleLevel": logging.getLevelName(root.level),
                "fileName": next((h.baseFilename for h in root.handlers
                                  if isinstance(h, logging.FileHandler)), ""),
            },
            "devicesetlist": {
                "devicesetcount": len(self.device_sets),
                "deviceSets": [self._device_set_summary(ds) for ds in self.device_sets],
            },
        }

    @staticmethod
    def _device_set_summary(ds: DeviceSet | TxDeviceSet) -> dict:
        return {
            "index": ds.index,
            "state": "error" if ds.error else ("running" if ds.running else "idle"),
            "error": ds.error,
            "realtimeFactor": round(ds.realtime_factor, 2),
            "a2aFallback": bool(getattr(ds, "a2a_fallback", False)),
            "direction": ds.direction,
            "source": dataclasses.asdict(device_settings(ds)),
            "channelcount": len(ds.channels),
            "channels": [
                {"index": i, "uri": ch.uri, "inputFrequencyOffset": ch.frequency_offset}
                for i, ch in enumerate(ds.channels)
            ],
        }

    # -- presets (maincore preset load/save, JSON; the document carries its
    # schema version and older ones migrate forward on load) -----------------

    def save_preset(self, group: str, name: str) -> dict:
        key = f"{group}/{name}"
        self.presets[key] = {"schema": PRESET_SCHEMA_VERSION, "group": group, "name": name,
                             **self._snapshot()}
        self._persist_presets()
        return self.presets[key]

    def _snapshot(self) -> dict:
        """The instance as a preset body (no side effects on the store)."""
        with_channels = []
        for ds in self.device_sets:
            with_channels.append({
                "direction": ds.direction,
                "source": dataclasses.asdict(device_settings(ds)),
                "channels": [
                    # a copy: the live dict would let later PATCHes rewrite it
                    {"uri": ch.uri, "inputFrequencyOffset": ch.frequency_offset,
                     "settings": dict(ch.settings)}
                    for ch in ds.channels
                ],
            })
        return {"deviceSets": with_channels}

    def load_preset(self, group: str, name: str) -> None:
        """Replace the device sets with the preset's. The whole preset is
        checked first, so one that names an unknown kind raises and leaves
        the running instance as it was."""
        preset = migrate_preset(self.presets[f"{group}/{name}"])
        plan = []
        for entry in preset["deviceSets"]:
            direction = entry.get("direction", "rx")
            if direction == "tx":
                device = SinkSettings(**_known_fields(SinkSettings, check_sink(entry["source"])))
            else:
                device = SourceSettings(**_known_fields(SourceSettings,
                                                        check_source(entry["source"])))
            channels = []
            for ch in entry["channels"]:
                registry.check_kind(ch["uri"], direction)
                # settings renamed or removed since the preset was saved drop
                # (API PUTs stay strict)
                allowed = set(registry.settings_schema(ch["uri"])) | registry.SESSION_KEYS
                allowed |= set(registry.UNPORTED_KEYS)  # kept, so they raise below
                settings = {k: v for k, v in ch["settings"].items() if k in allowed}
                settings["inputFrequencyOffset"] = ch["inputFrequencyOffset"]
                registry.validate_settings(ch["uri"], settings, direction)
                channels.append((ch["uri"], settings))
            plan.append((direction, device, channels))
        for ds in self.device_sets:
            ds.stop()
        self.device_sets = []
        for direction, device, channels in plan:
            ds = self.add_device_set(direction)
            if direction == "tx":
                ds.sink = device
            else:
                ds.source = device
            for uri, settings in channels:
                ds.add_channel(uri, settings)

    def delete_preset(self, group: str, name: str) -> None:
        del self.presets[f"{group}/{name}"]
        self._persist_presets()

    def server_file_path(self, path: str, kind: str) -> str:
        """A REST-supplied server-side path for `kind` ("logs", "profile"),
        confined to SDRANGEL_TPU_FILES_DIR (default ~/.sdrangel_tpu): an
        unconfined path on an unauthenticated API writes anywhere. Relative
        paths land in base/kind/; absolute ones must lie inside the base."""
        base = os.path.realpath(os.environ.get(
            "SDRANGEL_TPU_FILES_DIR", os.path.join(os.path.expanduser("~"), ".sdrangel_tpu")))
        sub = os.path.join(base, kind)
        os.makedirs(sub, exist_ok=True)
        resolved = os.path.realpath(path if os.path.isabs(path) else os.path.join(sub, path))
        if resolved != base and not resolved.startswith(base + os.sep):
            raise ValueError(f"{kind} path must stay inside {base} "
                             f"(set SDRANGEL_TPU_FILES_DIR to relocate)")
        return resolved

    def _preset_file_path(self, path: str) -> str:
        """A preset file path confined to `preset_dir` (SDRANGEL_TPU_PRESET_DIR
        or beside the preset store), for the same reason."""
        base = os.path.realpath(self.preset_dir)
        os.makedirs(base, exist_ok=True)
        resolved = os.path.realpath(path if os.path.isabs(path) else os.path.join(base, path))
        if resolved != base and not resolved.startswith(base + os.sep):
            raise ValueError(f"preset file path must stay inside the presets directory {base}")
        return resolved

    def export_preset_file(self, group: str, name: str, path: str, fmt: str = "json") -> None:
        """Server-side preset export (instancePresetFilePost): fmt "json", or
        "reference", the Base64-TLV blob the reference's own SimpleDeserializer
        reads (refpreset.to_reference_preset; only the four audio demod kinds
        survive the conversion)."""
        preset = self.presets[f"{group}/{name}"]
        if fmt == "reference":
            blob = refpreset.to_reference_preset(preset)
            with open(self._preset_file_path(path), "w") as f:
                f.write(base64.b64encode(blob).decode())
            return
        if fmt != "json":
            raise ValueError(f"unknown preset export format {fmt!r}")
        with open(self._preset_file_path(path), "w") as f:
            json.dump(preset, f, indent=1)

    def import_preset_file(self, path: str) -> str:
        """Server-side preset import (instancePresetFilePut): one preset
        object as `export_preset_file` writes it, or a reference Base64-TLV
        preset blob (settings/preset.cpp's serialize format), mapped by
        runtime/refpreset.py."""
        with open(self._preset_file_path(path)) as f:
            raw = f.read()
        try:
            preset = json.loads(raw)
        except json.JSONDecodeError:
            preset = refpreset.to_session_preset(refpreset.parse_preset(raw.strip()))
        if not isinstance(preset, dict) or "deviceSets" not in preset:
            raise ValueError("not a preset file (missing deviceSets)")
        key = f"{preset.get('group', 'default')}/{preset.get('name', 'imported')}"
        self.presets[key] = migrate_preset(preset)
        self._persist_presets()
        return key

    # -- instance config (GET/PUT /sdrangel/config) ----------------------------

    def config_get(self) -> dict:
        return {"schema": PRESET_SCHEMA_VERSION, **self._snapshot()}

    def config_put(self, config: dict) -> None:
        if "deviceSets" not in config:
            raise ValueError("config must contain deviceSets")
        self.presets["__config__/incoming"] = {"group": "__config__", "name": "incoming",
                                               **config}
        try:
            self.load_preset("__config__", "incoming")
        finally:
            self.presets.pop("__config__/incoming", None)
