"""DSD frame synchronization — sync-pattern search + frame typing over the
dibit stream.

The port's own copy of the JAX package's numpy module
(sdrangel_tpu/channels/dsdsync.py), held equal to it by
tests/test_torch_dsdsync.py; it runs on the host, on the dibits the
session reads back from the card.

The reference hands its discriminator output to the external DSDcc library,
whose first stage is exactly this: correlate the symbol stream against the
published sync words of each protocol and report the frame type
(plugins/channelrx/demoddsd/dsddemod.cpp feed -> DSDcc::DSDDecoder;
dsddecoder.h:61-63 getSyncType/getFrameTypeText). The vocoder and trunking
stacks stay external here exactly as they do in the reference (mbelib /
serial dongle); this module restores the sync/typing layer so a consumer of
the /data dibit stream can tell DMR from D-Star from YSF and find frame
boundaries.

Sync words (public air-interface standards, transcribed from the specs —
they are protocol constants, not reference code):

  * DMR (ETSI TS 102 361-1 §9.1.1): 48-bit sync words. 4FSK dibit mapping
    (table 10.2): bits b1b0 = 01 -> +3, 00 -> +1, 10 -> -1, 11 -> -3; the
    dibit VALUE here is (b1<<1)|b0 — DSDcc's convention, also what
    channels/demod_dsd.py emits. Sync words use only ±3 symbols, and each
    data word is the symbol-negation of the voice word (a built-in
    self-check: negation = flipping both bits = hex 5<->F, 7<->D).
  * YSF (Yaesu System Fusion): 40-bit FICH frame sync 0xD471C9634D, same
    C4FM dibit mapping as DMR.
  * D-Star (ARIB STD): GMSK binary — sync detected in the bit domain
    (bit = dibit sign bit). Frame sync = 24 bits 0x55 0x2D 0x16
    (bit-sync tail 0101.. + 15-bit frame sync); the voice stream repeats
    it as the slow-data sync every 21st frame.

Polarity: a discriminator sign flip negates every symbol. Like DSDcc, each
pattern is also matched inverted and the hit is flagged — with one
DMR-specific subtlety: each DMR data sync word is exactly the symbol
negation of the matching voice word (asserted below), so "data, normal
polarity" and "voice, inverted polarity" are the SAME symbol sequence and
every DMR window match is inherently ambiguous. DSDcc resolves this by
matching DMR only in normal polarity (dsd_frame_sync has no -DMR sync
types; inverted search exists for D-Star/ProVoice/X2-TDMA, whose inverted
patterns are not other valid syncs). We do the same by default, and keep a
polarity lock (`SyncSearcher.polarity`) that YSF hits update automatically — when the lock says the channel is
inverted, DMR pairs resolve to the inverted interpretation instead. The
lock can also be preset for a channel known to be inverted.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np


def _hex_to_dibits(word: int, n_bits: int) -> np.ndarray:
    """MSB-first bit pairs -> dibit values (b1<<1)|b0."""
    bits = [(word >> (n_bits - 1 - i)) & 1 for i in range(n_bits)]
    return np.array(
        [(bits[i] << 1) | bits[i + 1] for i in range(0, n_bits, 2)],
        dtype=np.int8,
    )


def _invert(dibits: np.ndarray) -> np.ndarray:
    """Symbol negation: +3<->-3, +1<->-1 (dibit 1<->3, 0<->2)."""
    return (dibits ^ 2).astype(np.int8)


#: dibit value -> symbol level (DSDcc / ETSI mapping)
DIBIT_LEVELS = np.array([+1, +3, -1, -3], dtype=np.int8)

# --- DMR: ETSI TS 102 361-1 §9.1.1 sync words (48 bits = 24 dibits) ---
DMR_BS_VOICE = _hex_to_dibits(0x755FD7DF75F7, 48)
DMR_BS_DATA = _hex_to_dibits(0xDFF57D75DF5D, 48)
DMR_MS_VOICE = _hex_to_dibits(0x7F7D5DD57DFD, 48)
DMR_MS_DATA = _hex_to_dibits(0xD5D7F77FD757, 48)
assert np.array_equal(_invert(DMR_BS_VOICE), DMR_BS_DATA)
assert np.array_equal(_invert(DMR_MS_VOICE), DMR_MS_DATA)

# --- YSF: 40-bit frame sync, C4FM mapping ---
YSF_SYNC = _hex_to_dibits(0xD471C9634D, 40)

# --- D-Star: 24-bit frame/slow-data sync, bit domain ---
DSTAR_SYNC_BITS = np.array(
    [(0x552D16 >> (23 - i)) & 1 for i in range(24)], dtype=np.int8
)

#: DMR burst length: 264 info bits + 48 sync/embedded = 288 bits = 144 dibits
DMR_BURST_DIBITS = 144
#: YSF frame: 100 ms at 4800 symbols/s = 480 dibits (960 bits):
#: 20-dibit sync + 100-dibit FICH + 5 blocks of 72 dibits (36 DCH + 36 VCH)
YSF_FRAME_DIBITS = 480
YSF_FICH_DIBITS = 100
YSF_BLOCK_DIBITS = 72   # per V/D-mode channel block: DCH then VCH
YSF_DCH_DIBITS = 36
#: D-Star voice frame: 96 bits (72 voice + 24 slow data)
DSTAR_FRAME_BITS = 96

# --- NXDN (NXDN TS 1-A Common Air Interface, 2400 sym/s) ---
# FSW = 20 bits 0xCDF5D (10 dibits {3,0,3,1,3,3,1,1,3,1}); the reference
# surfaces positive and negative FSW as DISTINCT sync states
# (DSDcc DSDSyncNXDNP / DSDSyncNXDNN, dsddemod.cpp:664-665) — the
# inverted-pattern hit maps to NXDN- here.
NXDN_FSW = _hex_to_dibits(0xCDF5D, 20)
#: NXDN frame: 384 bits = 192 dibits (FSW 10 + LICH 8 + SACCH 30 + 4x36
#: VCH/FACCH for RTCH/RDCH)
NXDN_FRAME_DIBITS = 192
NXDN_LICH_DIBITS = 8
NXDN_SACCH_DIBITS = 30
#: LICH RF-channel-type field values (NXDN TS 1-A §4; the strings the
#: reference's status line leads with, dsddemod.cpp:657-676)
NXDN_RF_CHANNELS = ("RCCH", "RTCH", "RDCH", "RTCH-C")

# --- dPMR (ETSI TS 102 658, 2400 sym/s) ---
# Frame sync patterns, transcribed from the standard's frame structure
# (§4.4: FS1 opens the header frame, FS2 each payload superframe, FS3 the
# end frame). dPMR support in the reference is likewise detection-level:
# its status line shows the DSDcc frame type (dsddemod.cpp:655-661).
DPMR_FS1 = _hex_to_dibits(0x57FF5F75D477, 48)  # header frame (24 dibits)
DPMR_FS2 = _hex_to_dibits(0x5FF77D, 24)        # payload superframe
DPMR_FS3 = _hex_to_dibits(0x7DFF57, 24)        # end frame
DPMR_FRAME_TYPES = {"header": "HEAD", "payload": "PAYL", "end": "END"}


# ---------------------------------------------------------------------------
# YSF FICH channel coding (Yaesu System Fusion spec; DSDcc decodes this in
# DSDYSF::processFICH — its sources are not vendored in the reference tree,
# so the tables here are spec-derived and verified by encode/decode
# SELF-CONSISTENCY plus conservative gating: an undecodable FICH never
# produces voice frames, it only withholds them).
#
# Structure of the 200-bit FICH block (100 dibits after the frame sync):
#   32 info bits + CRC-16/CCITT over the 4 info bytes = 48 bits
#   -> 4 x Golay(24,12) = 96 bits, + 4 flushing zeros = 100 bits
#   -> rate-1/2 K=5 convolutional code (G1 = 1+D^3+D^4, G2 = 1+D+D^2+D^4,
#      the NXDN/YSF generator pair) = 200 bits
#   -> 20x5 block interleave over dibits: coded dibit 5j+k sits at frame
#      dibit j + 20k.
# Info layout (byte0..byte3): FI(2) CS(2) CM(2) BN(2) | BT(2) FN(3) FT(3) |
# Res(1) Dev(1) MR(3) VoIP(1) DT(2) | SQL(1) Res(1) SQ(6).
#   FI: 0 header, 1 communication, 2 terminator, 3 test
#   DT: 0 V/D mode 1, 1 Data FR, 2 V/D mode 2, 3 Voice FR
# ---------------------------------------------------------------------------

#: coded-dibit -> frame-dibit position of the 20x5 interleave
_FICH_INTERLEAVE = np.array(
    [j + 20 * k for j in range(20) for k in range(5)], dtype=np.int64)

_G24 = 0b110001110101  # Golay(24,12) generator taps (x^11+x^10+x^6+x^5+x^4+x^2+1)


@functools.lru_cache(maxsize=1)
def _golay_codewords() -> np.ndarray:
    """(4096, 24) systematic extended-Golay codebook: [12 data | 11 check |
    overall parity]."""
    words = np.zeros((4096, 24), np.uint8)
    for d in range(4096):
        # long-division on the 23-bit codeword space
        v = d << 11
        for i in range(11, -1, -1):
            if v & (1 << (i + 11)):
                v ^= _G24 << i
        code23 = (d << 11) | (v & 0x7FF)
        parity = bin(code23).count("1") & 1
        bits = [(code23 >> (22 - b)) & 1 for b in range(23)] + [parity]
        words[d] = bits
    return words


def golay_encode(data12: int) -> np.ndarray:
    return _golay_codewords()[data12 & 0xFFF]


def golay_decode(bits24: np.ndarray) -> int | None:
    """Nearest-codeword decode, correcting up to 3 bit errors."""
    cw = _golay_codewords()
    d = (cw != np.asarray(bits24, np.uint8)[None, :]).sum(axis=1)
    k = int(np.argmin(d))
    return k if int(d[k]) <= 3 else None


def _crc16_ccitt(data: bytes) -> int:
    """CRC-16/CCITT (poly 0x1021, init 0, no final xor) — the YSF FICH
    checksum convention (self-consistency pinned in tests)."""
    crc = 0
    for byte in data:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021 if crc & 0x8000 else crc << 1) & 0xFFFF
    return crc


_CONV_G1, _CONV_G2 = 0b11001, 0b10111  # K=5: 1+D^3+D^4, 1+D+D^2+D^4


def _conv_encode(bits: np.ndarray) -> np.ndarray:
    """Rate-1/2 K=5 convolutional encoder, zero initial state."""
    out = np.empty(2 * len(bits), np.uint8)
    st = 0
    for i, b in enumerate(np.asarray(bits, np.uint8)):
        st = ((st << 1) | int(b)) & 0x1F
        out[2 * i] = bin(st & _CONV_G1).count("1") & 1
        out[2 * i + 1] = bin(st & _CONV_G2).count("1") & 1
    return out


def _conv_decode(pairs: np.ndarray) -> np.ndarray:
    """Hard-decision Viterbi for the K=5 rate-1/2 code (16 states)."""
    pairs = np.asarray(pairs, np.uint8).reshape(-1, 2)
    n = len(pairs)
    metric = np.full(16, 1 << 30, np.int64)
    metric[0] = 0
    back = np.zeros((n, 16), np.int8)
    for t in range(n):
        new = np.full(16, 1 << 30, np.int64)
        for s in range(16):
            if metric[s] >= (1 << 30):
                continue
            for b in (0, 1):
                reg = ((s << 1) | b) & 0x1F
                o0 = bin(reg & _CONV_G1).count("1") & 1
                o1 = bin(reg & _CONV_G2).count("1") & 1
                cost = (o0 != pairs[t, 0]) + (o1 != pairs[t, 1])
                ns = reg & 0x0F
                m = metric[s] + cost
                if m < new[ns]:
                    new[ns] = m
                    back[t, ns] = s * 2 + b
        metric = new
    s = int(np.argmin(metric))
    bits = np.empty(n, np.uint8)
    for t in range(n - 1, -1, -1):
        prev_b = back[t, s]
        bits[t] = prev_b & 1
        s = prev_b >> 1
    return bits


def encode_fich(fi: int = 1, dt: int = 2, cs: int = 2, cm: int = 0,
                bn: int = 0, bt: int = 0, fn: int = 0, ft: int = 6,
                dev: int = 0, mr: int = 0, voip: int = 0, sql: int = 0,
                sq: int = 0) -> np.ndarray:
    """FICH fields -> 100 frame dibits (the inverse of decode_fich)."""
    b0 = (fi & 3) << 6 | (cs & 3) << 4 | (cm & 3) << 2 | (bn & 3)
    b1 = (bt & 3) << 6 | (fn & 7) << 3 | (ft & 7)
    b2 = (dev & 1) << 6 | (mr & 7) << 3 | (voip & 1) << 2 | (dt & 3)
    b3 = (sql & 1) << 7 | (sq & 0x3F)
    data = bytes([b0, b1, b2, b3])
    crc = _crc16_ccitt(data)
    bits48 = np.array(
        [(int.from_bytes(data, "big") >> (31 - i)) & 1 for i in range(32)]
        + [(crc >> (15 - i)) & 1 for i in range(16)], np.uint8)
    coded = np.concatenate([
        golay_encode(int("".join(map(str, bits48[12 * k:12 * k + 12])), 2))
        for k in range(4)])
    conv_in = np.concatenate([coded, np.zeros(4, np.uint8)])  # flush: 100 bits
    enc = _conv_encode(conv_in)  # 200 bits = 100 coded dibits
    dib = ((enc[0::2] << 1) | enc[1::2]).astype(np.int8)
    out = np.empty(100, np.int8)
    out[_FICH_INTERLEAVE] = dib
    return out


def decode_fich(dibits100: np.ndarray) -> dict | None:
    """100 frame dibits -> FICH fields, or None when the CRC fails."""
    dib = np.asarray(dibits100, np.int8)[_FICH_INTERLEAVE]
    bits = np.empty(200, np.uint8)
    bits[0::2] = (dib >> 1) & 1
    bits[1::2] = dib & 1
    dec = _conv_decode(bits)[:96]
    vals = []
    for k in range(4):
        v = golay_decode(dec[24 * k:24 * k + 24])
        if v is None:
            return None
        vals.append(v)
    word48 = 0
    for v in vals:
        word48 = (word48 << 12) | v
    data = (word48 >> 16).to_bytes(4, "big")
    if _crc16_ccitt(data) != (word48 & 0xFFFF):
        return None
    b0, b1, b2, b3 = data
    return {
        "fi": b0 >> 6, "cs": (b0 >> 4) & 3, "cm": (b0 >> 2) & 3, "bn": b0 & 3,
        "bt": b1 >> 6, "fn": (b1 >> 3) & 7, "ft": b1 & 7,
        "dev": (b2 >> 6) & 1, "mr": (b2 >> 3) & 7, "voip": (b2 >> 2) & 1,
        "dt": b2 & 3, "sql": b3 >> 7, "sq": b3 & 0x3F,
    }


class SyncHit(NamedTuple):
    protocol: str     # "dmr" | "ysf" | "dstar" | "nxdn" | "dpmr"
    frame_type: str   # e.g. "bs_voice", "ms_data", "fich", "frame_sync"
    position: int     # stream index of the FIRST sync symbol (global)
    inverted: bool    # matched with inverted polarity


#: (protocol, frame_type, pattern, max-error CAP): short patterns get a
#: tighter cap than the channel-wide max_errors — a 10-dibit window with 2
#: tolerated errors false-fires ~4e-4 per offset on random 4FSK (thousands
#: per block), while <=1 is ~3e-5 (DSDcc similarly holds its short
#: NXDN/dPMR correlators to tighter budgets). One error must be allowed:
#: the 4FSK tracker's inner-symbol (+-1) decisions bias under amplitude
#: error, and the NXDN FSW carries one +1 symbol (loopback-measured: every
#: recovered FSW had exactly one symbol error).
_DIBIT_PATTERNS = [
    ("dmr", "bs_voice", DMR_BS_VOICE, None),
    ("dmr", "bs_data", DMR_BS_DATA, None),
    ("dmr", "ms_voice", DMR_MS_VOICE, None),
    ("dmr", "ms_data", DMR_MS_DATA, None),
    ("ysf", "fich", YSF_SYNC, None),
    ("nxdn", "fsw", NXDN_FSW, 1),
    ("dpmr", "header", DPMR_FS1, None),
    ("dpmr", "payload", DPMR_FS2, 1),
    ("dpmr", "end", DPMR_FS3, 1),
]


def _pattern_table():
    """(levels matrix, metadata) for one-shot correlation of all dibit
    patterns and their inversions, padded to the longest length."""
    rows, meta = [], []
    for proto, kind, pat, cap in _DIBIT_PATTERNS:
        rows.append(pat)
        meta.append((proto, kind, False, len(pat), cap))
        rows.append(_invert(pat))
        meta.append((proto, kind, True, len(pat), cap))
    return rows, meta


@dataclasses.dataclass
class SyncSearcher:
    """Streaming sync scanner. feed(dibits) -> list[SyncHit]; keeps the
    cross-block tail so patterns straddling block boundaries are found.
    Tolerates `max_errors` symbol errors per pattern (DSDcc allows a small
    number of bit errors in its sync correlators)."""

    max_errors: int = 2
    #: established channel polarity (False = normal). Updated automatically
    #: by YSF/D-Star hits (their inverted patterns are unambiguous); presets
    #: survive until such evidence arrives. DMR hits never update it — a DMR
    #: window match cannot distinguish inverted voice from normal data.
    polarity: bool = False
    _tail: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int8))
    _pos: int = 0  # global index of _tail[0]
    _scan_from: int = 0  # hits before this were already reported (tail rescan)
    counts: dict = dataclasses.field(default_factory=dict)
    last: SyncHit | None = None

    def feed(self, dibits: np.ndarray) -> list[SyncHit]:
        dibits = np.asarray(dibits, dtype=np.int8).ravel()
        buf = np.concatenate([self._tail, dibits])
        start = self._pos
        hits: list[SyncHit] = []

        rows, meta = _pattern_table()
        max_len = max(len(r) for r in rows)
        if len(buf) >= max_len:
            # dibit-domain patterns: exact symbol-level comparison windows
            for row, (proto, kind, inv, plen, cap) in zip(rows, meta):
                if len(buf) < plen:
                    continue
                budget = self.max_errors if cap is None \
                    else min(self.max_errors, cap)
                wins = np.lib.stride_tricks.sliding_window_view(buf, plen)
                err = (wins != row).sum(axis=1)
                for off in np.nonzero(err <= budget)[0]:
                    hits.append(SyncHit(proto, kind, start + int(off), inv))

            # D-Star: bit domain (bit = sign of the symbol: dibit>=2 -> 1)
            bits = (buf >= 2).astype(np.int8)
            for target, inv in ((DSTAR_SYNC_BITS, False),
                                (DSTAR_SYNC_BITS ^ 1, True)):
                wins = np.lib.stride_tricks.sliding_window_view(
                    bits, len(target))
                err = (wins != target).sum(axis=1)
                for off in np.nonzero(err <= 1)[0]:
                    hits.append(SyncHit("dstar", "frame_sync",
                                        start + int(off), inv))

            keep = max_len - 1
            self._pos = start + len(buf) - keep
            self._tail = buf[-keep:]
        else:
            self._tail = buf

        # the kept tail is rescanned next feed — report each hit once
        hits = [h for h in hits if h.position >= self._scan_from]
        self._scan_from = max(self._scan_from, self._pos)
        hits.sort(key=lambda h: h.position)
        # Resolve the DMR voice/data polarity ambiguity in stream order:
        # every DMR window match arrives as a PAIR at the same position —
        # (kind, normal) and (complement kind, inverted) with identical
        # error counts, because data words are exact symbol negations of
        # voice words. Keep only the interpretation matching the current
        # polarity lock; YSF/D-Star hits (unambiguous) update the lock as
        # they stream past.
        resolved: list[SyncHit] = []
        for h in hits:
            if h.protocol == "dmr":
                if h.inverted != self.polarity:
                    continue
            elif h.protocol == "ysf":
                # only YSF updates the lock: its 20-dibit exact-symbol
                # pattern is a reliable witness, while the 24-bit D-Star
                # bit-domain correlator (1 error tolerated) false-fires on
                # unrelated 4FSK traffic — a single false inverted hit
                # must not flip the channel-global DMR interpretation.
                # (D-Star's own extractor keeps its per-protocol polarity.)
                self.polarity = h.inverted
            resolved.append(h)
        hits = resolved
        for h in hits:
            key = f"{h.protocol}:{h.frame_type}"
            self.counts[key] = self.counts.get(key, 0) + 1
            self.last = h
        return hits

    def report(self) -> dict:
        """Channel-report fragment (the getSyncType/getFrameTypeText role)."""
        return {
            "syncCounts": dict(self.counts),
            "lastSync": None if self.last is None else {
                "protocol": self.last.protocol,
                "frameType": self.last.frame_type,
                "position": self.last.position,
                "invertedPolarity": self.last.inverted,
            },
        }


# --- Voice payload extraction (the mbelib / DVSerial hand-off boundary) ---
#
# The reference's DSDcc slices each synchronized voice frame into AMBE
# frames and hands them to mbelib or the DVSerial dongle
# (dsddemod.cpp feed -> DSDDecoder; the vocoder itself stays external,
# as it does here). This layer reproduces the slicing so a consumer of
# the channel report/data gets vocoder-ready AMBE frames, not raw dibits:
#
#   DMR (ETSI TS 102 361-1 §6.1): a voice burst carries 216 voice bits as
#   108 before + 108 after the 48-bit centre sync; they form exactly three
#   72-bit AMBE frames: A[0:108]+B[0:108] bits -> f1 = bits 0..71,
#   f2 = 72..143, f3 = 144..215 (DSDcc processFrame's 36+36+36 dibits).
#
#   D-Star (ARIB STD-B10): the voice stream is 96-bit frames of
#   [72 voice | 24 slow-data]; the 24-bit sync occupies the slow-data slot
#   every 21st frame, so the sync frame's voice IMMEDIATELY PRECEDES the
#   sync and subsequent frames follow at 96-bit spacing.
#
#   YSF (Yaesu System Fusion spec, V/D modes): each 480-dibit frame is
#   [20-dibit sync | 100-dibit FICH | 5 x (36-dibit DCH + 36-dibit VCH)];
#   the five 72-bit VCH channels are the vocoder payload (AMBE V/D frame
#   per block; interleave/whitening inside the VCH stays with the vocoder
#   stack, exactly where DSDcc hands off).

#: DMR voice payload span around a sync start p: [p-54, p+78) dibits
_DMR_PRE = 54
_DMR_POST = 78


def _dibits_to_bits(dibits: np.ndarray) -> np.ndarray:
    """MSB-first bit pairs of each dibit value (b1<<1)|b0."""
    d = np.asarray(dibits, np.int8)
    out = np.empty(d.size * 2, np.uint8)
    out[0::2] = (d >> 1) & 1
    out[1::2] = d & 1
    return out


def _bits_to_hex(bits: np.ndarray) -> str:
    v = 0
    for b in np.asarray(bits, np.uint8):
        v = (v << 1) | int(b)
    return f"{v:0{len(bits) // 4}x}"


@dataclasses.dataclass
class VoiceExtractor:
    """Streaming AMBE-frame slicer over the dibit stream + sync hits.

    feed(dibits, hits) buffers the stream (global positions, like
    SyncSearcher) and returns a list of
    {"protocol", "position", "hex"} 72-bit vocoder frames (DMR AMBE72,
    D-Star AMBE72, YSF V/D VCH blocks) for every voice hit whose payload
    span is fully buffered; hits whose tail has not arrived yet are held
    for the next feed. Inverted-polarity hits are corrected (symbol
    negation = dibit ^ 2, i.e. the sign bit flips)."""

    _buf: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int8))
    _pos: int = 0  # global index of _buf[0]
    _pending: list = dataclasses.field(default_factory=list)
    #: D-Star voice cadence: global bit position of the next expected
    #: 72-bit voice frame (chained at 96-bit spacing from the last sync;
    #: a sync hit re-anchors it, so drift cannot accumulate)
    _dstar_next: int | None = None
    _dstar_inv: bool = False
    #: most recent successfully-decoded YSF FICH (repeats every frame;
    #: reused when a frame's own FICH is too corrupted to decode)
    last_fich: dict | None = None
    total: int = 0

    def feed(self, dibits: np.ndarray, hits: list) -> list[dict]:
        dibits = np.asarray(dibits, np.int8).ravel()
        self._buf = np.concatenate([self._buf, dibits])
        self._pending.extend(
            h for h in hits
            if (h.protocol == "dmr" and h.frame_type.endswith("_voice"))
            or h.protocol == "ysf")
        for h in hits:
            if h.protocol == "dstar":
                # re-anchor the voice cadence right after this sync —
                # forward only: the searcher tolerates a bit error on the
                # 24-bit pattern, so occasional false hits fire on other
                # 4FSK traffic; a hit BEHIND the established cadence would
                # rewind _dstar_next and re-emit duplicate frames. Hits at
                # or ahead of the cadence (including the expected every-
                # 21st-frame slow-data sync) re-anchor as before.
                nxt = h.position + len(DSTAR_SYNC_BITS)
                if self._dstar_next is None or nxt >= self._dstar_next:
                    self._dstar_next = nxt
                    self._dstar_inv = h.inverted
        out: list[dict] = []
        still_pending = []
        end = self._pos + len(self._buf)
        for h in self._pending:
            if h.protocol == "ysf":
                lo, hi = h.position, h.position + YSF_FRAME_DIBITS
            else:
                lo, hi = h.position - _DMR_PRE, h.position + _DMR_POST
            if lo < self._pos:
                continue  # too old (history already trimmed) — drop
            if hi > end:
                still_pending.append(h)  # tail not buffered yet
                continue
            seg = self._buf[lo - self._pos: hi - self._pos]
            if h.inverted:
                seg = (seg ^ 2).astype(np.int8)
            if h.protocol == "ysf":
                # decode the FICH first (DSDcc gates on it too): headers,
                # terminators and Data-FR frames carry NO V/D voice, and an
                # undecodable FICH falls back to the stream's last valid
                # one (the FICH repeats every frame) or withholds voice
                # entirely — garbage never reaches the vocoder boundary.
                fich = decode_fich(
                    seg[len(YSF_SYNC): len(YSF_SYNC) + YSF_FICH_DIBITS])
                if fich is not None:
                    self.last_fich = fich
                else:
                    fich = self.last_fich
                if fich is None or fich["fi"] != 1 or fich["dt"] not in (0, 2):
                    continue  # header/terminator/test, Data FR, or no FICH
                # V/D layout: sync(20) | FICH(100) | 5 x (DCH 36 | VCH 36);
                # each 36-dibit VCH is one 72-bit vocoder channel block
                base = len(YSF_SYNC) + YSF_FICH_DIBITS
                for k in range(5):
                    vch = seg[base + k * YSF_BLOCK_DIBITS + YSF_DCH_DIBITS:
                              base + (k + 1) * YSF_BLOCK_DIBITS]
                    out.append({
                        "protocol": "ysf",
                        "position": int(h.position),
                        "dt": fich["dt"],
                        "hex": _bits_to_hex(_dibits_to_bits(vch)),
                    })
                continue
            a = _dibits_to_bits(seg[:_DMR_PRE])
            b = _dibits_to_bits(seg[_DMR_PRE + 24:])
            voice = np.concatenate([a, b])  # 216 bits
            for k in range(3):
                out.append({
                    "protocol": "dmr",
                    "position": int(h.position),
                    "hex": _bits_to_hex(voice[72 * k: 72 * (k + 1)]),
                })
        self._pending = still_pending
        # D-Star: emit every chained 72-bit voice frame that is buffered
        # ([72 voice | 24 data] cadence; the GMSK bit = symbol sign bit)
        while (self._dstar_next is not None
               and self._dstar_next + 72 <= end):
            lo = self._dstar_next
            if lo >= self._pos:
                seg = self._buf[lo - self._pos: lo - self._pos + 72]
                bits = (seg >= 2).astype(np.uint8)
                if self._dstar_inv:
                    bits ^= 1
                out.append({
                    "protocol": "dstar",
                    "position": int(lo),
                    "hex": _bits_to_hex(bits),
                })
            self._dstar_next += DSTAR_FRAME_BITS
        # keep enough history for a hit near the buffer head next feed
        keep = max(_DMR_PRE + _DMR_POST, DSTAR_FRAME_BITS,
                   YSF_FRAME_DIBITS) * 2
        if len(self._buf) > keep:
            self._pos += len(self._buf) - keep
            self._buf = self._buf[-keep:]
        self.total += len(out)
        return out


# ---------------------------------------------------------------------------
# NXDN elementary decode + dPMR typing (r5 — VERDICT r4 next #4).
#
# The reference's DSD channel surfaces, via DSDcc, a status line per
# protocol: for NXDN the RF channel type with RAN and message type
# (dsddemod.cpp:663-682), for dPMR the frame type (:655-661). This layer
# reproduces that surface over the /data dibit stream:
#
#   * LICH (8 dibits after the FSW): bit k is the MSB of dibit k (DSDcc's
#     processLICH convention); fields RF-channel(2) functional(2)
#     option(2) direction(1) even-parity(1).
#   * SACCH (30 dibits): the condensed single-fragment layout used here —
#     SR(2) RAN(6) MSG_TYPE(6) SPARE(6) CRC-6(6) + 4 flush bits, rate-1/2
#     K=5 convolutional (the same NXDN/YSF generator pair as the FICH
#     codec above) = 60 channel bits. Multi-fragment CAC/SACCH reassembly
#     stays with the external trunking stack, exactly where DSDcc's does;
#     validation is encode/decode loopback through the 4FSK chain.
# ---------------------------------------------------------------------------

_CRC6_POLY = 0x43  # x^6 + x + 1


def _crc6(bits: np.ndarray) -> int:
    reg = 0
    for b in bits:
        reg = ((reg << 1) | int(b)) ^ (_CRC6_POLY if reg & 0x20 else 0)
    for _ in range(6):
        reg = ((reg << 1) ^ (_CRC6_POLY if reg & 0x20 else 0)) & 0x3F
    return reg & 0x3F


def encode_nxdn_lich(rf_channel: int, functional: int = 0, option: int = 0,
                     direction: int = 1) -> np.ndarray:
    """8 LICH dibits; bit k rides the MSB of dibit k."""
    bits = [(rf_channel >> 1) & 1, rf_channel & 1,
            (functional >> 1) & 1, functional & 1,
            (option >> 1) & 1, option & 1, direction & 1]
    bits.append(int(sum(bits)) & 1)  # even parity over the 7 field bits
    return np.array([b << 1 for b in bits], dtype=np.int8)


def decode_nxdn_lich(dibits8: np.ndarray) -> dict | None:
    bits = (np.asarray(dibits8) >> 1) & 1
    if int(bits.sum()) & 1:
        return None  # parity violation
    return {
        "rf_channel": int(bits[0]) << 1 | int(bits[1]),
        "functional": int(bits[2]) << 1 | int(bits[3]),
        "option": int(bits[4]) << 1 | int(bits[5]),
        "direction": int(bits[6]),
    }


def _bits_to_dibits(bits: np.ndarray) -> np.ndarray:
    bits = np.asarray(bits, np.int8).reshape(-1, 2)
    return (bits[:, 0] << 1 | bits[:, 1]).astype(np.int8)


def encode_nxdn_sacch(sr: int, ran: int, message_type: int,
                      spare: int = 0) -> np.ndarray:
    info = np.array(
        [(sr >> i) & 1 for i in (1, 0)]
        + [(ran >> i) & 1 for i in range(5, -1, -1)]
        + [(message_type >> i) & 1 for i in range(5, -1, -1)]
        + [(spare >> i) & 1 for i in range(5, -1, -1)], dtype=np.int8)
    crc = _crc6(info)
    payload = np.concatenate([
        info, np.array([(crc >> i) & 1 for i in range(5, -1, -1)], np.int8)])
    payload = np.concatenate([payload, np.zeros(4, np.int8)])  # flush
    coded = _conv_encode(payload)  # K=5 rate 1/2: (26+4 flush)*2 = 60 bits
    return _bits_to_dibits(coded)


def decode_nxdn_sacch(dibits30: np.ndarray) -> dict | None:
    """The inverse of encode_nxdn_sacch. Both follow the JAX module's own
    layout (26 bits and a 4-bit flush, K=5 rate 1/2, neither punctured nor
    interleaved), not the air interface's (NXDN TS 1-A punctures and
    interleaves its coded SACCH), so they agree with each other in loopback
    and with no NXDN radio. The port keeps the JAX layout on purpose
    (ROADMAP.md §3, standing divergences)."""
    pairs = _dibits_to_bits(np.asarray(dibits30)).reshape(-1, 2)
    bits = _conv_decode(pairs)[:26]
    info, crc_bits = bits[:20], bits[20:26]
    crc = int("".join(str(int(b)) for b in crc_bits), 2)
    if crc != _crc6(info):
        return None
    u = lambda sl: int("".join(str(int(b)) for b in sl), 2)
    return {"sr": u(info[0:2]), "ran": u(info[2:8]),
            "message_type": u(info[8:14]), "spare": u(info[14:20])}


def encode_nxdn_frame(rf_channel: int, ran: int, message_type: int,
                      functional: int = 0, option: int = 0,
                      direction: int = 1, sr: int = 0) -> np.ndarray:
    """One 192-dibit NXDN frame: FSW + LICH + SACCH + pseudo-random
    payload (the air interface scrambles the VCH/FACCH area; a constant
    filler would starve the 4FSK tracker's amplitude/clock recovery of
    symbol diversity)."""
    body = np.zeros(NXDN_FRAME_DIBITS, np.int8)
    body[:10] = NXDN_FSW
    body[10:18] = encode_nxdn_lich(rf_channel, functional, option, direction)
    body[18:48] = encode_nxdn_sacch(sr, ran, message_type)
    body[48:] = np.random.default_rng(0xADD).integers(
        0, 4, NXDN_FRAME_DIBITS - 48).astype(np.int8)
    return body


def encode_dpmr_frame(kind: str) -> np.ndarray:
    """A dPMR frame skeleton: the frame sync + zeroed body (detection-level
    scope, like the reference's)."""
    pat = {"header": DPMR_FS1, "payload": DPMR_FS2, "end": DPMR_FS3}[kind]
    return np.concatenate([pat, np.zeros(60, np.int8)])


@dataclasses.dataclass
class NxdnDpmrDecoder:
    """Streaming NXDN LICH/SACCH + dPMR frame-type consumer (the DSDcc
    getNXDNDecoder()/getDPMRDecoder() status surface of
    dsddemod.cpp:655-682). feed(dibits, hits) buffers the stream like
    VoiceExtractor; report() yields the channel-report fragment."""

    _buf: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int8))
    _pos: int = 0
    _pending: list = dataclasses.field(default_factory=list)
    nxdn_frames: int = 0
    nxdn_bad_lich: int = 0
    nxdn: dict | None = None       # last decoded {rfChannel, ran, ...}
    dpmr_counts: dict = dataclasses.field(default_factory=dict)
    dpmr_last: str | None = None

    def feed(self, dibits: np.ndarray, hits: list) -> None:
        dibits = np.asarray(dibits, np.int8).ravel()
        self._buf = np.concatenate([self._buf, dibits])
        for h in hits:
            if h.protocol == "nxdn":
                self._pending.append(h)
            elif h.protocol == "dpmr":
                key = h.frame_type + ("-" if h.inverted else "")
                self.dpmr_counts[key] = self.dpmr_counts.get(key, 0) + 1
                self.dpmr_last = DPMR_FRAME_TYPES[h.frame_type]
        end = self._pos + len(self._buf)
        still = []
        for h in self._pending:
            lo, hi = h.position, h.position + 48  # FSW+LICH+SACCH
            if lo < self._pos:
                continue
            if hi > end:
                still.append(h)
                continue
            seg = self._buf[lo - self._pos: hi - self._pos]
            if h.inverted:
                seg = (seg ^ 2).astype(np.int8)
            self.nxdn_frames += 1
            lich = decode_nxdn_lich(seg[10:18])
            if lich is None:
                self.nxdn_bad_lich += 1
                continue
            entry = dict(self.nxdn or {})  # persist last-good SACCH fields
            entry.update({
                "rfChannel": NXDN_RF_CHANNELS[lich["rf_channel"]],
                "functional": lich["functional"],
                "direction": lich["direction"],
                "negativeFSW": h.inverted,
            })
            sacch = decode_nxdn_sacch(seg[18:48])
            if sacch is not None:
                entry["ran"] = sacch["ran"]
                entry["messageType"] = sacch["message_type"]
                # the reference status line shape, dsddemod.cpp:663-676:
                # "RC r cc mm" / "RT r cc mm"
                entry["statusText"] = (
                    f"{entry['rfChannel']} {sacch['ran']:02d} "
                    f"{sacch['message_type']:02X}")
            self.nxdn = entry
        self._pending = still
        keep = 2 * NXDN_FRAME_DIBITS
        if len(self._buf) > keep:
            self._pos += len(self._buf) - keep
            self._buf = self._buf[-keep:]

    def report(self) -> dict:
        out: dict = {}
        if self.nxdn_frames:
            out["nxdn"] = {
                "frames": self.nxdn_frames,
                "badLich": self.nxdn_bad_lich,
                **(self.nxdn or {}),
            }
        if self.dpmr_counts:
            out["dpmr"] = {
                "frameCounts": dict(self.dpmr_counts),
                "lastFrameType": self.dpmr_last,
            }
        return out
