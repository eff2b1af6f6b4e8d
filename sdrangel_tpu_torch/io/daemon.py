"""SDRdaemon-style UDP superframe transport with FEC — the distributed
I/Q data plane.

Reference: plugins/samplesource/sdrdaemonsource/sdrdaemonsourcebuffer.h:27-85
— superframes of 128 data blocks + nbFECBlocks parity (512-byte payloads),
block 0 carrying MetaDataFEC {centerFrequency, sampleRate, sampleBits,
nbBlocks, nbFECBlocks, crc32}; the receiver keeps decoder slots per frame,
recovers lost blocks with CM256, and tracks recovery statistics
(:100-115). This implementation keeps the same superframe structure over
plain sockets with io/fec.py as the erasure code.

The port's own copy of the JAX package's module (sdrangel_tpu/io/daemon.py):
the datagrams are a wire protocol, and tests/test_torch_daemon.py holds them
byte-equal to the JAX package's and runs each side's sender into the other's
receiver.
"""

from __future__ import annotations

import dataclasses
import socket
import struct
import zlib

import numpy as np

from . import fec

BLOCK_BYTES = 512  # payload per UDP block (sdrdaemonsourcebuffer.h)
DATA_BLOCKS = 128  # original blocks per superframe
_HDR = struct.Struct("<IHH")  # frame_index, block_index, n_fec
_META = struct.Struct("<QIIHHII")  # cf, rate, bits, nbBlocks, nbFEC, length, crc32
#: receiver->sender feedback datagram (link-quality report the reference
#: only displays in its GUI): interval expected/received blocks, failed/ok
#: frames since the previous report
_FEEDBACK_MAGIC = b"SDFB"
_FEEDBACK = struct.Struct("<IIII")


@dataclasses.dataclass
class FrameStats:
    frames_ok: int = 0
    frames_failed: int = 0
    blocks_received: int = 0
    blocks_recovered: int = 0


def make_superframe(
    frame_index: int,
    payload: bytes,
    n_fec: int,
    center_frequency: int = 0,
    sample_rate: int = 0,
    sample_bits: int = 16,
) -> list[bytes]:
    """Split payload into DATA_BLOCKS blocks (block 0 = metadata), append
    n_fec parity blocks; returns the UDP datagrams (header + 512B payload)."""
    meta = _META.pack(
        center_frequency, sample_rate, sample_bits, DATA_BLOCKS, n_fec,
        len(payload), zlib.crc32(payload),
    )
    meta = meta + b"\x00" * (BLOCK_BYTES - len(meta))
    room = (DATA_BLOCKS - 1) * BLOCK_BYTES
    assert len(payload) <= room, (len(payload), room)
    padded = payload + b"\x00" * (room - len(payload))
    blocks = [meta] + [
        padded[i * BLOCK_BYTES : (i + 1) * BLOCK_BYTES] for i in range(DATA_BLOCKS - 1)
    ]
    arr = np.frombuffer(b"".join(blocks), dtype=np.uint8).reshape(DATA_BLOCKS, BLOCK_BYTES)
    parity = fec.fec_encode(arr, n_fec) if n_fec else np.zeros((0, BLOCK_BYTES), np.uint8)
    grams = []
    for i in range(DATA_BLOCKS):
        grams.append(_HDR.pack(frame_index, i, n_fec) + blocks[i])
    for j in range(n_fec):
        grams.append(_HDR.pack(frame_index, DATA_BLOCKS + j, n_fec) + parity[j].tobytes())
    return grams


class SuperframeAssembler:
    """Receiver side: per-frame decoder slots + FEC recovery + stats."""

    def __init__(self):
        self.slots: dict[int, dict[int, np.ndarray]] = {}
        self._slot_nfec: dict[int, int] = {}
        self._done: dict[int, None] = {}  # recently decided frames (FIFO)
        self.stats = FrameStats()
        # interval link-quality counters for sender feedback (reset by
        # take_interval)
        self.intv_expected = 0
        self.intv_received = 0
        self.intv_failed = 0
        self.intv_ok = 0

    def take_interval(self) -> tuple[int, int, int, int]:
        out = (self.intv_expected, self.intv_received,
               self.intv_failed, self.intv_ok)
        self.intv_expected = self.intv_received = 0
        self.intv_failed = self.intv_ok = 0
        return out

    def _mark_done(self, fi: int) -> None:
        self._done[fi] = None
        while len(self._done) > 64:
            self._done.pop(next(iter(self._done)))

    def _account(self, slot: dict, n_fec: int, ok: bool) -> None:
        # loss is measured over DATA blocks only: a frame decodes as soon
        # as any DATA_BLOCKS of its blocks arrive, so trailing parity
        # blocks are legitimately still in flight at decode time and must
        # not read as loss (parity sees the same link rate anyway)
        data_present = sum(1 for i in slot if i < DATA_BLOCKS)
        self.intv_expected += DATA_BLOCKS
        self.intv_received += min(data_present, DATA_BLOCKS)
        if ok:
            self.intv_ok += 1
        else:
            self.intv_failed += 1

    def feed(self, datagram: bytes):
        """Returns (frame_index, payload, meta dict) when a frame completes,
        else None."""
        fi, bi, n_fec = _HDR.unpack_from(datagram)
        block = np.frombuffer(datagram[_HDR.size :], dtype=np.uint8)
        if len(block) != BLOCK_BYTES:
            return None
        if fi in self._done:
            return None  # late block of an already-decided frame
        slot = self.slots.setdefault(fi, {})
        self._slot_nfec[fi] = n_fec
        slot[bi] = block
        self.stats.blocks_received += 1
        # bound decoder slots (jitter window) on INGEST: frames that never
        # reach DATA_BLOCKS (heavy loss) must still decide as failed here,
        # or the link-quality feedback would stay silent exactly when the
        # link is at its worst. Eviction order is INSERTION order (dict),
        # not frame-index sort — wrap-safe at 2^32, and never evicts the
        # frame the current datagram may be about to complete.
        if len(self.slots) > 8:
            for old in list(self.slots)[:-4]:
                if old == fi:
                    continue
                self._account(self.slots[old],
                              self._slot_nfec.get(old, 0), ok=False)
                self.stats.frames_failed += 1
                self._mark_done(old)
                del self.slots[old]
                self._slot_nfec.pop(old, None)
        if len(slot) < DATA_BLOCKS:
            return None
        data = fec.fec_decode(slot, DATA_BLOCKS, BLOCK_BYTES)
        del self.slots[fi]
        self._slot_nfec.pop(fi, None)
        self._mark_done(fi)
        if data is None:
            self.stats.frames_failed += 1
            self._account(slot, n_fec, ok=False)
            return None
        n_data_present = sum(1 for i in slot if i < DATA_BLOCKS)
        self.stats.blocks_recovered += DATA_BLOCKS - n_data_present
        meta_raw = data[0].tobytes()
        cf, rate, bits, nb, nfec, length, crc = _META.unpack_from(meta_raw)
        payload = data[1:].tobytes()[:length]
        if zlib.crc32(payload) != crc:  # integrity check (MetaDataFEC crc32)
            self.stats.frames_failed += 1
            self._account(slot, n_fec, ok=False)
            return None
        self.stats.frames_ok += 1
        self._account(slot, n_fec, ok=True)
        meta = {
            "center_frequency": cf, "sample_rate": rate, "sample_bits": bits,
            "nb_blocks": nb, "nb_fec": nfec, "length": length, "crc32": crc,
        }
        return fi, payload, meta


class DaemonSender:
    """UDP sender streaming I/Q superframes (the sdrdaemonsink role).

    With auto_fec, receiver feedback datagrams (block-loss per interval —
    the stats sdrdaemonsourcebuffer.h:100-115 collects but only displays)
    drive nbFECBlocks: grow immediately to cover observed loss with
    margin, decay by one frame-interval at a time when the link is clean.
    The reference sets nbFECBlocks manually over REST."""

    def __init__(self, address: str, port: int, n_fec: int = 8,
                 center_frequency: int = 0, sample_rate: int = 0,
                 auto_fec: bool = False, min_fec: int = 1, max_fec: int = 32):
        self.addr = (address, port)
        self.n_fec = n_fec
        self.cf = center_frequency
        self.rate = sample_rate
        self.frame_index = 0
        self.auto_fec = auto_fec
        self.min_fec = min_fec
        self.max_fec = max_fec
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    @property
    def payload_room(self) -> int:
        return (DATA_BLOCKS - 1) * BLOCK_BYTES

    def poll_feedback(self) -> None:
        """Drain receiver feedback and adapt n_fec (auto_fec mode)."""
        self._sock.setblocking(False)
        try:
            while True:
                try:
                    raw, _ = self._sock.recvfrom(256)
                except (BlockingIOError, OSError):
                    break
                if not raw.startswith(_FEEDBACK_MAGIC):
                    continue
                exp, rec, failed, ok = _FEEDBACK.unpack_from(
                    raw, len(_FEEDBACK_MAGIC))
                if not self.auto_fec or exp == 0:
                    continue
                loss = 1.0 - rec / exp
                frame_len = DATA_BLOCKS + self.n_fec
                # cover observed per-frame loss with 50% margin + 1 block
                need = int(np.ceil(loss * frame_len * 1.5)) + (1 if loss else 0)
                if failed:
                    need = max(need, self.n_fec * 2, 4)
                if need > self.n_fec:
                    self.n_fec = min(need, self.max_fec)
                elif need < self.n_fec:
                    self.n_fec = max(self.n_fec - 1, need, self.min_fec)
        finally:
            self._sock.setblocking(True)

    def send_iq(self, iq_int16: np.ndarray) -> int:
        """Send (N,2) int16 I/Q; N*4 bytes must fit one superframe."""
        if self.auto_fec:
            self.poll_feedback()
        payload = iq_int16.astype("<i2").tobytes()
        grams = make_superframe(
            self.frame_index, payload, self.n_fec, self.cf, self.rate
        )
        for g in grams:
            self._sock.sendto(g, self.addr)
        # '<I' wire field: a continuous stream wraps after ~65 days
        self.frame_index = (self.frame_index + 1) & 0xFFFFFFFF
        return len(grams)

    def close(self):
        self._sock.close()


class DaemonReceiver:
    """UDP receiver (the sdrdaemonsource role).

    feedback_every > 0 returns the interval link stats to the sender's
    source address every N decided frames (consumed by DaemonSender
    auto_fec; ignored by senders that don't poll)."""

    def __init__(self, address: str, port: int, timeout: float = 2.0,
                 feedback_every: int = 4):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((address, port))
        self._sock.settimeout(timeout)
        self.assembler = SuperframeAssembler()
        self.feedback_every = feedback_every
        self._decided_at_last_fb = 0
        self._sender_addr = None

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def _maybe_feedback(self) -> None:
        if not self.feedback_every or self._sender_addr is None:
            return
        decided = self.assembler.stats.frames_ok + self.assembler.stats.frames_failed
        if decided - self._decided_at_last_fb < self.feedback_every:
            return
        self._decided_at_last_fb = decided
        exp, rec, failed, ok = self.assembler.take_interval()
        self._sock.sendto(
            _FEEDBACK_MAGIC + _FEEDBACK.pack(exp, rec, failed, ok),
            self._sender_addr)

    def recv_frame(self):
        """Block until one full superframe decodes; returns (iq_int16, meta)."""
        while True:
            gram, addr = self._sock.recvfrom(2048)
            self._sender_addr = addr
            out = self.assembler.feed(gram)
            self._maybe_feedback()
            if out is not None:
                fi, payload, meta = out
                iq = np.frombuffer(payload, dtype="<i2").reshape(-1, 2)
                return iq, meta

    def close(self):
        self._sock.close()
