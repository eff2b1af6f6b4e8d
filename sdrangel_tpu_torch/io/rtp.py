"""Minimal RTP packetization for audio egress — the qrtplib role.

Reference: sdrbase/audio/audionetsink.{h,cpp} can emit demod audio either as
raw UDP or RTP via the vendored qrtplib (qrtplib/rtpsession.h). This is a
from-scratch RFC 3550 header packetizer/parser over a plain UDP socket —
enough for L16 mono/stereo audio interop.

The port's own copy of the JAX package's module (sdrangel_tpu/io/rtp.py),
held equal to it by tests/test_torch_net_io.py. It is host code and stays on the host.
"""

from __future__ import annotations

import secrets
import socket
import struct

import numpy as np

RTP_VERSION = 2
PT_L16_MONO = 11  # RFC 3551 static payload types
PT_L16_STEREO = 10
PT_RED = 96  # RFC 2198 redundant audio (dynamic PT)

_HDR = struct.Struct("!BBHII")  # V/P/X/CC, M/PT, seq, timestamp, ssrc


#: RFC 2198 redundant-block length field is 10 bits
RED_MAX_BLOCK = 0x3FF


def build_red_payload(primary: bytes, primary_pt: int,
                      redundant: bytes | None, ts_offset: int) -> bytes:
    """RFC 2198 payload: [1|PT|ts-offset(14)|length(10)] per redundant
    block, then [0|PT] for the primary, then block data oldest-first."""
    hdr = b""
    data = b""
    if redundant is not None:
        if len(redundant) > RED_MAX_BLOCK:
            raise ValueError(
                f"RED block {len(redundant)} B exceeds the 10-bit length "
                f"field ({RED_MAX_BLOCK}); use smaller packets")
        word = (1 << 31) | ((primary_pt & 0x7F) << 24) \
            | ((ts_offset & 0x3FFF) << 10) | len(redundant)
        hdr += struct.pack("!I", word)
        data += redundant
    hdr += struct.pack("!B", primary_pt & 0x7F)
    return hdr + data + primary


def parse_red_payload(payload: bytes) -> list[tuple[int, int, bytes]]:
    """-> [(payload_type, ts_offset, block)] oldest-first; the final
    entry (ts_offset 0) is the primary. Raises ValueError on malformed
    input (PT 96 is dynamic — a foreign sender may put anything there)."""
    headers = []
    off = 0
    while off < len(payload) and payload[off] & 0x80:
        if off + 4 > len(payload):
            raise ValueError("truncated RED block header")
        word = struct.unpack_from("!I", payload, off)[0]
        headers.append(((word >> 24) & 0x7F, (word >> 10) & 0x3FFF,
                        word & 0x3FF))
        off += 4
    if off >= len(payload):
        raise ValueError("RED payload without a primary header")
    primary_pt = payload[off] & 0x7F
    off += 1
    if off + sum(h[2] for h in headers) > len(payload):
        raise ValueError("RED block lengths exceed the payload")
    out = []
    for pt, ts_off, length in headers:
        out.append((pt, ts_off, payload[off:off + length]))
        off += length
    out.append((primary_pt, 0, payload[off:]))
    return out


def build_packet(
    payload: bytes, seq: int, timestamp: int, ssrc: int, payload_type: int,
    marker: bool = False,
) -> bytes:
    b0 = RTP_VERSION << 6
    b1 = (0x80 if marker else 0) | (payload_type & 0x7F)
    return _HDR.pack(b0, b1, seq & 0xFFFF, timestamp & 0xFFFFFFFF, ssrc) + payload


def parse_packet(raw: bytes) -> dict:
    b0, b1, seq, ts, ssrc = _HDR.unpack_from(raw)
    assert (b0 >> 6) == RTP_VERSION, "not RTP v2"
    cc = b0 & 0xF
    offset = _HDR.size + 4 * cc
    return {
        "payload_type": b1 & 0x7F,
        "marker": bool(b1 & 0x80),
        "seq": seq,
        "timestamp": ts,
        "ssrc": ssrc,
        "payload": raw[offset:],
    }


class RtpAudioSender:
    """L16 (big-endian int16 PCM) RTP sender (audionetsink RTP mode).

    RR-driven adaptation: incoming RTCP Receiver Reports are polled on the
    sender's RTCP socket; when the reported fraction_lost crosses
    `red_enter` the sender switches the stream to RFC 2198 redundant audio
    (each packet carries the previous packet's payload as a redundant
    block, so any single lost packet is recoverable from its successor),
    and drops back to plain L16 once loss stays under `red_exit`. The
    reference collects the same A.8 stats via qrtplib but never consumes
    them — this closes that loop."""

    def __init__(self, address: str, port: int, stereo: bool = False,
                 samples_per_packet: int = 480, rtcp: bool = True,
                 rtcp_interval: float = 2.0,
                 red_enter: float = 0.05, red_exit: float = 0.01):
        self.addr = (address, port)
        self.stereo = stereo
        self.spp = samples_per_packet
        self.seq = secrets.randbelow(1 << 16)
        self.timestamp = secrets.randbelow(1 << 32)
        self.ssrc = secrets.randbelow(1 << 32)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._pending = np.zeros((0, 2) if stereo else (0,), dtype=np.int16)
        # RTCP sender reports on port+1 (qrtplib rtpsession auto-SR role)
        self.packet_count = 0
        self.octet_count = 0
        self._rtcp = RtcpPeer(address, port, bind=False) if rtcp else None
        self._rtcp_interval = rtcp_interval
        self._last_sr = 0.0
        # adaptation state
        self.red_enter = red_enter
        self.red_exit = red_exit
        self.redundant = False  # currently sending RFC 2198 RED
        self.fraction_lost = 0.0  # latest RR feedback
        self._prev_payload: bytes | None = None
        # RED's redundant-block length field is 10 bits: while redundant,
        # cap samples/packet so the previous payload always fits
        self._red_spp = min(self.spp, RED_MAX_BLOCK // (4 if stereo else 2))

    def poll_feedback(self) -> None:
        """Drain pending RRs from the RTCP socket and adapt (hysteresis:
        enter RED above red_enter, leave below red_exit)."""
        if self._rtcp is None:
            return
        for rpt in self._rtcp.poll():
            if rpt.get("type") == "RR" and rpt.get("source_ssrc") == self.ssrc:
                self.fraction_lost = rpt["fraction_lost"] / 256.0
                if not self.redundant and self.fraction_lost >= self.red_enter:
                    self.redundant = True
                elif self.redundant and self.fraction_lost <= self.red_exit:
                    self.redundant = False
                    self._prev_payload = None

    def write(self, audio: np.ndarray) -> int:
        """audio: float in [-1,1) (T,) mono or (T,2) stereo."""
        self.poll_feedback()
        pcm = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
        self._pending = np.concatenate([self._pending, pcm])
        sent = 0
        pt = PT_L16_STEREO if self.stereo else PT_L16_MONO
        while True:
            spp = self._red_spp if self.redundant else self.spp
            if len(self._pending) < spp:
                break
            chunk, self._pending = self._pending[:spp], self._pending[spp:]
            payload = chunk.astype(">i2").tobytes()
            if self.redundant:
                wire = build_red_payload(
                    payload, pt, self._prev_payload, spp)
                pkt = build_packet(wire, self.seq, self.timestamp,
                                   self.ssrc, PT_RED)
                self._prev_payload = payload
            else:
                wire = payload
                pkt = build_packet(payload, self.seq, self.timestamp,
                                   self.ssrc, pt)
            self._sock.sendto(pkt, self.addr)
            self.seq = (self.seq + 1) & 0xFFFF
            self.timestamp = (self.timestamp + spp) & 0xFFFFFFFF
            self.packet_count += 1
            self.octet_count += len(wire)
            sent += 1
        if self._rtcp is not None and sent:
            import time as _time

            now = _time.monotonic()
            if now - self._last_sr >= self._rtcp_interval:
                self._last_sr = now
                self._rtcp.send(build_sr(
                    self.ssrc, self.timestamp,
                    self.packet_count, self.octet_count))
        return sent

    def close(self):
        self._sock.close()
        if self._rtcp is not None:
            self._rtcp.close()


class RtpAudioReceiver:
    """RTP receiver with RFC 3550 A.8 reception statistics (interarrival
    jitter, loss from the sequence gap) and Receiver Report emission —
    the qrtplib RTPSourceStats role."""

    def __init__(self, address: str, port: int, timeout: float = 2.0,
                 clock_rate: float = 48000.0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((address, port))
        self._sock.settimeout(timeout)
        self.clock_rate = clock_rate
        self.ssrc = secrets.randbelow(1 << 32)
        # reception stats (RFC 3550 A.8)
        self.received = 0
        self.base_seq: int | None = None
        self.max_seq = 0
        self.cycles = 0
        self.jitter = 0.0
        self._last_transit: float | None = None
        self.source_ssrc = 0
        self.recovered = 0  # packets reconstructed from RFC 2198 blocks
        self._rr_expected_prior = 0  # interval stats (RFC 3550 A.3)
        self._rr_received_prior = 0

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def read_packet(self) -> tuple[dict, np.ndarray]:
        import time as _time

        raw, _ = self._sock.recvfrom(65536)
        info = parse_packet(raw)
        if info["payload_type"] == PT_RED:
            # RFC 2198: recover the immediately-preceding packet from the
            # redundant block when the sequence shows a single-packet gap.
            # PT 96 is dynamic — guard against foreign/malformed payloads.
            try:
                blocks = parse_red_payload(info["payload"])
            except ValueError:
                blocks = [(PT_L16_MONO, 0, b"")]
                info["malformed"] = True
            pt, _, primary = blocks[-1]
            info["payload_type"] = pt
            payload = primary
            gap = (self.base_seq is not None
                   and ((info["seq"] - self.max_seq) & 0xFFFF) == 2)
            if gap and len(blocks) > 1:
                payload = blocks[0][2] + primary
                info["recovered"] = 1
                self.recovered += 1
        else:
            payload = info["payload"]
        pcm = np.frombuffer(payload, dtype=">i2").astype(np.float32) / 32768.0
        if info["payload_type"] == PT_L16_STEREO:
            pcm = pcm.reshape(-1, 2)
        # stats update
        self.received += 1
        self.source_ssrc = info["ssrc"]
        seq = info["seq"]
        if self.base_seq is None:
            self.base_seq = seq
            self.max_seq = seq
        else:
            # RFC 3550 A.1 update_seq (simplified): a forward step (mod
            # 2^16) advances max_seq, bumping cycles exactly once per wrap;
            # a backward step is a reordered old packet and leaves it alone
            delta = (seq - self.max_seq) & 0xFFFF
            if 0 < delta < 0x8000:
                if seq < self.max_seq:
                    self.cycles += 1 << 16
                self.max_seq = seq
        # interarrival jitter in timestamp units (A.8): J += (|D| - J)/16.
        # Transit differences are taken mod 2^32 (RFC 3550 uses 32-bit
        # modular arithmetic precisely so the RTP timestamp wrap — ~24.8 h
        # at 48 kHz — doesn't inject a 2^32 jump into the EMA).
        arrival = int(_time.monotonic() * self.clock_rate) & 0xFFFFFFFF
        transit = (arrival - info["timestamp"]) & 0xFFFFFFFF
        if self._last_transit is not None:
            d = (transit - self._last_transit) & 0xFFFFFFFF
            if d >= 1 << 31:
                d -= 1 << 32
            self.jitter += (abs(d) - self.jitter) / 16.0
        self._last_transit = transit
        return info, pcm

    @property
    def expected(self) -> int:
        if self.base_seq is None:
            return 0
        return self.cycles + self.max_seq - self.base_seq + 1

    @property
    def lost(self) -> int:
        return max(0, self.expected - self.received)

    def receiver_report(self) -> bytes:
        """Build an RR for the observed source (rtcprrpacket role).
        fraction_lost is computed over the interval since the previous RR
        (RFC 3550 A.3), so feedback tracks CURRENT conditions — cumulative
        loss would keep the sender's RED adaptation latched long after the
        network recovers."""
        exp = self.expected
        exp_i = exp - self._rr_expected_prior
        rec_i = self.received - self._rr_received_prior
        self._rr_expected_prior = exp
        self._rr_received_prior = self.received
        lost_i = exp_i - rec_i
        frac = 0 if exp_i <= 0 or lost_i <= 0 else min(
            255, (lost_i * 256) // exp_i)
        return build_rr(self.ssrc, self.source_ssrc, frac, self.lost,
                        self.cycles + self.max_seq, self.jitter)

    def close(self):
        self._sock.close()


# ---------------------------------------------------------------------------
# RTCP — the qrtplib rtcpcompoundpacket/rtcpsrpacket/rtcprrpacket role
# (qrtplib/rtpsession.h schedules SR/RR + SDES automatically; here the
# sender emits SR+SDES on a timer from write(), and the receiver tracks
# RFC 3550 A.8 statistics and can answer with RR).
# ---------------------------------------------------------------------------

RTCP_SR = 200
RTCP_RR = 201
RTCP_SDES = 202
RTCP_BYE = 203

_NTP_EPOCH_DELTA = 2208988800  # 1900 -> 1970


def _ntp_now() -> tuple[int, int]:
    import time as _time

    t = _time.time() + _NTP_EPOCH_DELTA
    sec = int(t)
    frac = int((t - sec) * (1 << 32)) & 0xFFFFFFFF
    return sec & 0xFFFFFFFF, frac


def build_sr(ssrc: int, rtp_ts: int, packet_count: int, octet_count: int,
             cname: str = "sdrangel_tpu") -> bytes:
    """Compound SR + SDES(CNAME) packet (rtcpsrpacket.h layout)."""
    ntp_sec, ntp_frac = _ntp_now()
    sr = struct.pack(
        "!BBHIIIIII",
        (RTP_VERSION << 6) | 0,  # V, P=0, RC=0
        RTCP_SR,
        6,  # length in 32-bit words minus one (28 bytes body / 4 - 1 + 1hdr)
        ssrc & 0xFFFFFFFF,
        ntp_sec, ntp_frac,
        rtp_ts & 0xFFFFFFFF,
        packet_count & 0xFFFFFFFF,
        octet_count & 0xFFFFFFFF,
    )
    cname_b = cname.encode()[:255]
    item = bytes([1, len(cname_b)]) + cname_b  # SDES CNAME item
    chunk = struct.pack("!I", ssrc & 0xFFFFFFFF) + item + b"\x00"
    pad = (-len(chunk)) % 4
    chunk += b"\x00" * pad
    sdes = struct.pack(
        "!BBH", (RTP_VERSION << 6) | 1, RTCP_SDES, len(chunk) // 4
    ) + chunk
    return sr + sdes


def build_rr(ssrc: int, source_ssrc: int, fraction_lost: int, cum_lost: int,
             highest_seq: int, jitter: int, lsr: int = 0, dlsr: int = 0) -> bytes:
    """Receiver Report with one report block (rtcprrpacket.h layout)."""
    body = struct.pack(
        "!IIIIIII",
        ssrc & 0xFFFFFFFF,
        source_ssrc & 0xFFFFFFFF,
        ((fraction_lost & 0xFF) << 24) | (cum_lost & 0xFFFFFF),
        highest_seq & 0xFFFFFFFF,
        int(jitter) & 0xFFFFFFFF,
        lsr & 0xFFFFFFFF,
        dlsr & 0xFFFFFFFF,
    )
    return struct.pack(
        "!BBH", (RTP_VERSION << 6) | 1, RTCP_RR, len(body) // 4
    ) + body


def parse_rtcp(raw: bytes) -> list[dict]:
    """Parse a compound RTCP packet into a list of report dicts."""
    out = []
    off = 0
    while off + 4 <= len(raw):
        b0, pt, length = struct.unpack_from("!BBH", raw, off)
        size = 4 * (length + 1)
        body = raw[off + 4 : off + size]
        if pt == RTCP_SR and len(body) >= 24:
            ssrc, ntp_s, ntp_f, rtp_ts, pkts, octets = struct.unpack_from(
                "!IIIIII", body)
            out.append({"type": "SR", "ssrc": ssrc, "ntp_sec": ntp_s,
                        "ntp_frac": ntp_f, "rtp_timestamp": rtp_ts,
                        "packet_count": pkts, "octet_count": octets})
        elif pt == RTCP_RR and len(body) >= 28:
            ssrc, src, lost_w, hseq, jit, lsr, dlsr = struct.unpack_from(
                "!IIIIIII", body)
            out.append({"type": "RR", "ssrc": ssrc, "source_ssrc": src,
                        "fraction_lost": lost_w >> 24,
                        "cumulative_lost": lost_w & 0xFFFFFF,
                        "highest_seq": hseq, "jitter": jit,
                        "lsr": lsr, "dlsr": dlsr})
        elif pt == RTCP_SDES and len(body) >= 6:
            ssrc = struct.unpack_from("!I", body)[0]
            items = {}
            p = 4
            while p + 2 <= len(body) and body[p] != 0:
                typ, ln = body[p], body[p + 1]
                items[typ] = body[p + 2 : p + 2 + ln].decode(errors="replace")
                p += 2 + ln
            out.append({"type": "SDES", "ssrc": ssrc,
                        "cname": items.get(1, "")})
        elif pt == RTCP_BYE:
            out.append({"type": "BYE"})
        off += size if size > 4 else 4
    return out


class RtcpPeer:
    """RTCP socket bound/aimed at the RTP port + 1 (RFC 3550 §11)."""

    def __init__(self, address: str, rtp_port: int, bind: bool,
                 timeout: float = 2.0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        if bind:
            self._sock.bind((address, rtp_port + 1))
            self._sock.settimeout(timeout)
        self.addr = (address, rtp_port + 1)

    def send(self, pkt: bytes) -> None:
        self._sock.sendto(pkt, self.addr)

    def recv(self) -> list[dict]:
        raw, addr = self._sock.recvfrom(65536)
        self.peer_addr = addr  # symmetric RTCP: reply to the source
        return parse_rtcp(raw)

    def reply(self, pkt: bytes) -> None:
        """Send to the last seen peer (where its SR/RR came from) — the
        symmetric-RTCP route a receiver uses to return RRs to a sender
        whose RTCP socket has an ephemeral port."""
        self._sock.sendto(pkt, getattr(self, "peer_addr", self.addr))

    def poll(self) -> list[dict]:
        """Drain all pending RTCP datagrams without blocking."""
        out = []
        saved = self._sock.gettimeout()
        self._sock.setblocking(False)
        try:
            while True:
                try:
                    raw, addr = self._sock.recvfrom(65536)
                except (BlockingIOError, OSError):
                    break
                self.peer_addr = addr
                out.extend(parse_rtcp(raw))
        finally:
            self._sock.settimeout(saved)
        return out

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def close(self):
        self._sock.close()
