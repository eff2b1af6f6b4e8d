"""MPEG transport-stream demux: PAT/PMT/PES extraction from the 188-byte
TS packets the DVB-S chain recovers (channels/dvbs.py).

Reference: the DATV plugin hands its TS bytes to ffmpeg/libavformat for
demux+render (plugins/channelrx/demoddatv/datvideorender.cpp); here the
container layer is implemented directly (host side — it is a byte-level
state machine at ~Mb/s rates) so the framework can expose programme maps
and elementary-stream payloads without an external media stack. Video
*decoding* (H.262/H.264) remains out of scope, as it is ffmpeg's job in
the reference too.

The port's own copy of the JAX package's numpy module
(sdrangel_tpu/channels/tsdemux.py), held equal to it by
tests/test_torch_dvbs_copies.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

TS_PACKET = 188
SYNC = 0x47

#: common stream_type assignments (ISO 13818-1 table 2-29, subset)
STREAM_TYPES = {
    0x01: "MPEG-1 video",
    0x02: "MPEG-2 video",
    0x03: "MPEG-1 audio",
    0x04: "MPEG-2 audio",
    0x0F: "AAC audio",
    0x1B: "H.264 video",
    0x24: "HEVC video",
    0x06: "private PES",
}


@dataclasses.dataclass
class ProgramInfo:
    program_number: int
    pmt_pid: int
    pcr_pid: int | None = None
    # elementary streams: pid -> stream_type
    streams: dict = dataclasses.field(default_factory=dict)

    def describe(self) -> dict:
        return {
            "program": self.program_number,
            "pmtPid": self.pmt_pid,
            "pcrPid": self.pcr_pid,
            "streams": [
                {"pid": pid, "type": st, "codec": STREAM_TYPES.get(st, f"type 0x{st:02x}")}
                for pid, st in sorted(self.streams.items())
            ],
        }


class TsDemux:
    """Streaming TS demux with carried section/PES state.

    feed(bytes) consumes any number of whole TS packets (non-multiples are
    buffered). After PAT+PMT have appeared: `programs` maps program_number
    → ProgramInfo; `pes_payloads[pid]` accumulates the elementary-stream
    bytes of every PES-carrying pid (bounded; caller drains).
    """

    def __init__(self, max_buffer: int = 1 << 22):
        self._carry = b""
        self.programs: dict[int, ProgramInfo] = {}
        self._pmt_pids: dict[int, int] = {}  # pmt pid -> program number
        self.pes_payloads: dict[int, bytearray] = {}
        self.pts: dict[int, list] = {}  # pid -> decoded PTS values (90 kHz)
        self.packets = 0
        self.sync_losses = 0
        self.continuity_errors = 0
        self._last_cc: dict[int, int] = {}
        self._section_buf: dict[int, bytearray] = {}
        self._pes_hdr: dict[int, bytearray] = {}  # PES headers spanning packets
        self.max_buffer = max_buffer

    # -- public ------------------------------------------------------------

    def feed(self, data: bytes | np.ndarray) -> None:
        if isinstance(data, np.ndarray):
            data = data.astype(np.uint8).tobytes()
        buf = self._carry + data
        pos = 0
        while pos + TS_PACKET <= len(buf):
            if buf[pos] != SYNC:
                # resync: scan for the next 0x47 that is CONFIRMED by another
                # one 188 later (when enough bytes are buffered to check) —
                # otherwise a 0x47 payload byte locks parsing onto garbage
                nxt = buf.find(b"\x47", pos + 1)
                self.sync_losses += 1
                while (
                    0 <= nxt
                    and nxt + TS_PACKET < len(buf)
                    and buf[nxt + TS_PACKET] != SYNC
                ):
                    nxt = buf.find(b"\x47", nxt + 1)
                if nxt < 0:
                    pos = len(buf)
                    break
                pos = nxt
                continue
            self._packet(buf[pos : pos + TS_PACKET])
            pos += TS_PACKET
        self._carry = buf[pos:]

    def drain_pes(self, pid: int) -> bytes:
        out = bytes(self.pes_payloads.get(pid, b""))
        if pid in self.pes_payloads:
            self.pes_payloads[pid] = bytearray()
        return out

    def summary(self) -> dict:
        return {
            "packets": self.packets,
            "syncLosses": self.sync_losses,
            "continuityErrors": self.continuity_errors,
            "programs": [p.describe() for p in self.programs.values()],
        }

    # -- packet layer --------------------------------------------------------

    def _packet(self, pkt: bytes) -> None:
        self.packets += 1
        pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
        pusi = bool(pkt[1] & 0x40)
        afc = (pkt[3] >> 4) & 0x3
        cc = pkt[3] & 0xF
        if pid == 0x1FFF:  # null packet
            return
        if afc in (1, 3):  # has payload: continuity check
            last = self._last_cc.get(pid)
            if last is not None and cc != ((last + 1) & 0xF):
                self.continuity_errors += 1
            self._last_cc[pid] = cc
        payload_start = 4
        if afc in (2, 3):  # adaptation field present
            payload_start = 5 + pkt[4]
            if payload_start > TS_PACKET:
                return
        if afc in (2, 0) or payload_start >= TS_PACKET:
            return
        payload = pkt[payload_start:]

        if pid == 0 or pid in self._pmt_pids:
            self._section(pid, payload, pusi)
        else:
            self._pes(pid, payload, pusi)

    # -- PSI sections ---------------------------------------------------------

    def _section(self, pid: int, payload: bytes, pusi: bool) -> None:
        if pusi:
            ptr = payload[0]
            if pid in self._section_buf and ptr:
                # the bytes before the pointer complete the previous section
                self._section_buf[pid] += payload[1 : 1 + ptr]
                self._drain_sections(pid)
            self._section_buf[pid] = bytearray(payload[1 + ptr :])
        elif pid in self._section_buf:
            self._section_buf[pid] += payload
        self._drain_sections(pid)

    def _drain_sections(self, pid: int) -> None:
        """Parse every complete section in the pid's buffer (several short
        sections may share one packet; 0xFF is stuffing)."""
        buf = self._section_buf.get(pid)
        while buf:
            if buf[0] == 0xFF:  # stuffing: nothing further in this unit
                del self._section_buf[pid]
                return
            if len(buf) < 3:
                return
            section_len = ((buf[1] & 0x0F) << 8) | buf[2]
            total = 3 + section_len
            if len(buf) < total:
                return
            sec = bytes(buf[:total])
            del buf[:total]
            if not buf:
                del self._section_buf[pid]
                buf = None
            if pid == 0:
                self._parse_pat(sec)
            else:
                self._parse_pmt(self._pmt_pids[pid], sec)

    def _parse_pat(self, sec: bytes) -> None:
        if sec[0] != 0x00:
            return
        body = sec[8:-4]  # skip to program loop; drop CRC32
        for i in range(0, len(body) - 3, 4):
            prog = (body[i] << 8) | body[i + 1]
            pid = ((body[i + 2] & 0x1F) << 8) | body[i + 3]
            if prog == 0:
                continue  # network PID
            if prog not in self.programs:
                self.programs[prog] = ProgramInfo(prog, pid)
            self._pmt_pids[pid] = prog

    def _parse_pmt(self, prog: int, sec: bytes) -> None:
        if sec[0] != 0x02 or prog not in self.programs:
            return
        info = self.programs[prog]
        info.pcr_pid = ((sec[8] & 0x1F) << 8) | sec[9]
        prog_info_len = ((sec[10] & 0x0F) << 8) | sec[11]
        i = 12 + prog_info_len
        end = len(sec) - 4  # CRC32
        while i + 5 <= end:
            stype = sec[i]
            pid = ((sec[i + 1] & 0x1F) << 8) | sec[i + 2]
            es_len = ((sec[i + 3] & 0x0F) << 8) | sec[i + 4]
            info.streams[pid] = stype
            self.pes_payloads.setdefault(pid, bytearray())
            i += 5 + es_len

    # -- PES ------------------------------------------------------------------

    def _pes(self, pid: int, payload: bytes, pusi: bool) -> None:
        if pid not in self.pes_payloads:
            return  # not an elementary stream we know about
        # A PES header (9 + header_len bytes) may span TS packets: buffer it
        # per pid until complete, so trailing header bytes in continuation
        # packets are skipped (not leaked into the ES) and a split PTS field
        # is still decoded.
        if pusi and len(payload) >= 3 and payload[:3] == b"\x00\x00\x01":
            self._pes_hdr[pid] = bytearray(payload)
            payload = b""
        elif pid in self._pes_hdr:
            self._pes_hdr[pid] += payload
            payload = b""
        if pid in self._pes_hdr:
            hdr = self._pes_hdr[pid]
            if len(hdr) < 9 or len(hdr) < 9 + hdr[8]:
                return  # header still incomplete; wait for the next packet
            flags = hdr[7]
            if (flags & 0x80) and hdr[8] >= 5:  # PTS present
                p = hdr[9:14]
                pts = (
                    ((p[0] >> 1) & 0x7) << 30
                    | p[1] << 22
                    | (p[2] >> 1) << 15
                    | p[3] << 7
                    | p[4] >> 1
                )
                self.pts.setdefault(pid, []).append(pts)
                del self.pts[pid][:-64]
            payload = bytes(hdr[9 + hdr[8] :])
            del self._pes_hdr[pid]
        buf = self.pes_payloads[pid]
        if len(buf) + len(payload) <= self.max_buffer:
            buf += payload


# -- encoder helpers (tests/goldens) ------------------------------------------


def _crc32_mpeg(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7) & 0xFFFFFFFF if crc & 0x80000000 else (crc << 1) & 0xFFFFFFFF
    return crc


def _section_packetize(pid: int, table: bytes, cc: int) -> list[bytes]:
    """One PSI section (with pointer byte) into TS packets."""
    data = b"\x00" + table
    out = []
    first = True
    while data:
        chunk, data = data[:184], data[184:]
        hdr = bytes([
            SYNC,
            (0x40 if first else 0) | (pid >> 8),
            pid & 0xFF,
            0x10 | (cc & 0xF),
        ])
        out.append(hdr + chunk + b"\xff" * (184 - len(chunk)))
        cc += 1
        first = False
    return out


def make_pat(programs: dict[int, int]) -> bytes:
    """{program_number: pmt_pid} -> PAT section bytes."""
    loop = b""
    for prog, pid in programs.items():
        loop += bytes([prog >> 8, prog & 0xFF, 0xE0 | (pid >> 8), pid & 0xFF])
    body = bytes([0x00, 0x01]) + bytes([0xC1, 0x00, 0x00]) + loop  # tsid + ver/sec
    section_len = len(body) + 4
    sec = bytes([0x00, 0xB0 | (section_len >> 8), section_len & 0xFF]) + body
    crc = _crc32_mpeg(sec)
    return sec + crc.to_bytes(4, "big")


def make_pmt(program: int, pcr_pid: int, streams: dict[int, int]) -> bytes:
    """{es_pid: stream_type} -> PMT section bytes."""
    loop = b""
    for pid, stype in streams.items():
        loop += bytes([stype, 0xE0 | (pid >> 8), pid & 0xFF, 0xF0, 0x00])
    body = (
        bytes([program >> 8, program & 0xFF, 0xC1, 0x00, 0x00])
        + bytes([0xE0 | (pcr_pid >> 8), pcr_pid & 0xFF, 0xF0, 0x00])
        + loop
    )
    section_len = len(body) + 4
    sec = bytes([0x02, 0xB0 | (section_len >> 8), section_len & 0xFF]) + body
    crc = _crc32_mpeg(sec)
    return sec + crc.to_bytes(4, "big")


def make_pes_packets(pid: int, es: bytes, pts: int | None = None, start_cc: int = 0) -> list[bytes]:
    """Elementary-stream bytes into one PES packet split across TS packets."""
    if pts is not None:
        p = bytes([
            0x21 | (((pts >> 30) & 0x7) << 1),
            (pts >> 22) & 0xFF,
            0x01 | (((pts >> 15) & 0x7F) << 1),
            (pts >> 7) & 0xFF,
            0x01 | ((pts & 0x7F) << 1),
        ])
        pes_hdr = b"\x00\x00\x01\xe0" + b"\x00\x00" + bytes([0x80, 0x80, 5]) + p
    else:
        pes_hdr = b"\x00\x00\x01\xe0" + b"\x00\x00" + bytes([0x80, 0x00, 0])
    data = pes_hdr + es
    out = []
    cc = start_cc
    first = True
    while data:
        chunk, data = data[:184], data[184:]
        if len(chunk) < 184:
            # pad with an adaptation field so payload stays byte-exact
            af_len = 184 - len(chunk) - 1
            af = bytes([af_len]) + (bytes([0x00]) + b"\xff" * (af_len - 1) if af_len else b"")
            hdr = bytes([SYNC, (0x40 if first else 0) | (pid >> 8), pid & 0xFF, 0x30 | (cc & 0xF)])
            out.append(hdr + af + chunk)
        else:
            hdr = bytes([SYNC, (0x40 if first else 0) | (pid >> 8), pid & 0xFF, 0x10 | (cc & 0xF)])
            out.append(hdr + chunk)
        cc += 1
        first = False
    return out
