"""Reference preset import — the Base64-TLV interchange surface.

The reference persists presets as SimpleSerializer TLV blobs (Base64 in
QSettings): a stream of tagged elements, each
``[header byte (type<<4 | idLen<<2 | lenLen)] [id, idLen+1 bytes BE]
[length, lenLen+1 bytes BE] [value bytes]`` with variable-length
minimally-encoded integers (util/simpleserializer.cpp:263-295 writeTag,
:44-96 writeS32/U32 length selection, :322-343 readS32 sign extension from
the first byte's top bit). Preset layout: settings/preset.cpp:28-77 —
group(1) description(2) centerFrequency(3,U64) layout(4) spectrum(5)
sourcePreset(6,bool), device configs from id 20, channel configs
count(200) + per-channel URI(201+2i) / settings-blob(202+2i).

This module deserializes those blobs and converts the four audio demod
channel settings into this framework's registry settings so a reference
user's presets load into a Session. Per-kind field
scalings follow each settings class's deserialize():
  * NFM  nfmdemodsettings.cpp:82-130  (rfBW/fmDev INDEX tables :25-30,
    afBW x1000, volume /10, squelch in centibels -> dB/10 via the
    pow(10, squelch/100) level in nfmdemod.cpp:533, squelchGate x10 ms)
  * AM   amdemodsettings.cpp:67-100   (rfBW x100, volume /10, squelch dB)
  * SSB  ssbdemodsettings.cpp:60-85   (rfBW x100, lowCutoff x100,
    volume /10, dsb flag)
  * WFM  wfmdemodsettings.cpp:50-113  (rfBW INDEX table :26-28,
    afBW x1000, volume /10, squelch dB)

The port's own copy of the JAX package's module (sdrangel_tpu/runtime/refpreset.py),
held equal to it by tests/test_torch_refpreset.py. It is host code and stays on the host.
"""

from __future__ import annotations

import base64
import struct

# SimpleSerializer::Type (simpleserializer.h:33-44)
TS32, TU32, TS64, TU64, TFLOAT, TDOUBLE, TBOOL, TSTRING, TBLOB, TVERSION = range(10)

# NFMDemodSettings::m_rfBW / m_fmDev (nfmdemodsettings.cpp:25-30)
NFM_RFBW = (5000, 6250, 8330, 10000, 12500, 15000, 20000, 25000, 40000)
NFM_FMDEV = (2000, 2500, 3330, 4000, 5000, 6000, 8000, 10000, 16000)
# WFMDemodSettings::m_rfBW (wfmdemodsettings.cpp:26-28)
WFM_RFBW = (12500, 25000, 40000, 60000, 75000, 80000, 100000, 125000,
            140000, 160000, 180000, 200000, 220000, 250000)


def _index(table, idx):
    """getRFBW/getFMDev clamp semantics (nfmdemodsettings.cpp:132-150)."""
    if idx < 0:
        return table[0]
    if idx < len(table):
        return table[idx]
    return table[-1]


class RefDeserializer:
    """SimpleDeserializer semantics (simpleserializer.cpp:297-720):
    parse-all into {id: (type, payload)}; typed getters return defaults on
    missing id / type mismatch exactly like readS32 & co."""

    def __init__(self, data: bytes):
        self.elements: dict[int, tuple[int, bytes]] = {}
        self.valid = self._parse(data)
        self.version = 0
        if self.valid:
            el = self.elements.get(0)
            if el is not None and el[0] == TVERSION:
                v = 0
                for b in el[1]:
                    v = (v << 8) | b
                self.version = v
            else:
                self.valid = False  # first element must carry the version

    def _parse(self, data: bytes) -> bool:
        ofs, n = 0, len(data)
        while ofs < n:
            if ofs + 1 > n:
                return False
            hdr = data[ofs]
            ofs += 1
            typ = (hdr >> 4) & 0x0F
            id_len = ((hdr >> 2) & 0x03) + 1
            len_len = (hdr & 0x03) + 1
            if ofs + id_len + len_len > n:
                return False
            elem_id = int.from_bytes(data[ofs:ofs + id_len], "big")
            ofs += id_len
            length = int.from_bytes(data[ofs:ofs + len_len], "big")
            ofs += len_len
            if ofs + length > n:
                return False
            self.elements[elem_id] = (typ, data[ofs:ofs + length])
            ofs += length
        return True

    def _int(self, elem_id, typ, max_len, default, signed):
        el = self.elements.get(elem_id)
        if el is None or el[0] != typ or len(el[1]) > max_len:
            return default
        v = 0
        for i, b in enumerate(el[1]):
            if signed and i == 0 and (b & 0x80):
                v = -1
            v = (v << 8) | b
        return v

    def s32(self, elem_id, default=0):
        return self._int(elem_id, TS32, 4, default, True)

    def u32(self, elem_id, default=0):
        return self._int(elem_id, TU32, 4, default, False)

    def s64(self, elem_id, default=0):
        return self._int(elem_id, TS64, 8, default, True)

    def u64(self, elem_id, default=0):
        return self._int(elem_id, TU64, 8, default, False)

    def real(self, elem_id, default=0.0):
        el = self.elements.get(elem_id)
        if el is None:
            return default
        if el[0] == TFLOAT and len(el[1]) == 4:
            return struct.unpack(">f", el[1])[0]
        if el[0] == TDOUBLE and len(el[1]) == 8:
            return struct.unpack(">d", el[1])[0]
        return default

    def bool_(self, elem_id, default=False):
        el = self.elements.get(elem_id)
        if el is None or el[0] != TBOOL or len(el[1]) != 1:
            return default
        return el[1][0] != 0

    def string(self, elem_id, default=""):
        el = self.elements.get(elem_id)
        if el is None or el[0] != TSTRING:
            return default
        return el[1].decode("utf-8", errors="replace")

    def blob(self, elem_id, default=b""):
        el = self.elements.get(elem_id)
        if el is None or el[0] != TBLOB:
            return default
        return el[1]


def _nfm_settings(d: RefDeserializer) -> dict:
    import math

    idx = d.s32(2, 4)
    delta = d.bool_(12, False)
    if delta:
        # delta-squelch presets store NEGATIVE MILLIS: threshold =
        # -m_squelch/1000 (nfmdemod.cpp:525-530); our AF squelch takes a
        # dB power ratio, so convert the ratio back to dB
        ratio = max(-d.s32(5, -300) / 1000.0, 1e-6)
        squelch_db = 10.0 * math.log10(ratio)
    else:
        # centibels -> dB (nfmdemod.cpp:533 pow(10, squelch/100) = power)
        squelch_db = d.s32(5, -300) / 10.0
    return {
        "inputFrequencyOffset": float(d.s32(1, 0)),
        "rf_bandwidth": float(_index(NFM_RFBW, idx)),
        "fm_deviation": float(_index(NFM_FMDEV, idx)),
        "af_bandwidth": float(d.s32(3, 3)) * 1000.0,
        "volume": d.s32(4, 20) / 10.0,
        "squelch_db": squelch_db,
        "delta_squelch": delta,
        "ctcss_index": d.s32(8, 0) if d.bool_(9, False) else 0,
        "ctcss_on": d.bool_(9, False),
        "audio_mute": d.bool_(10, False),
        "squelch_gate_ms": d.s32(11, 5) * 10.0,
    }


def _am_settings(d: RefDeserializer) -> dict:
    return {
        "inputFrequencyOffset": float(d.s32(1, 0)),
        "rf_bandwidth": 100.0 * d.s32(2, 4),
        "volume": d.s32(4, 20) / 10.0,
        "squelch_db": float(d.s32(5, -40)),
        "bandpass_enable": d.bool_(8, False),
        "sync_am": d.bool_(12, False),  # m_pll -> PLL-synchronous detect
    }


def _ssb_settings(d: RefDeserializer) -> dict:
    # the reference normalizes the signed band pair at apply time
    # (ssbdemod.cpp:465-478): LSB presets store NEGATIVE bandwidth and
    # lowCutoff; both are negated (the sideband is carried by `usb`) and
    # the band is clamped to >= 100 Hz
    band = 100.0 * d.s32(2, 30)
    low = 100.0 * d.s32(6, 3)
    usb = band >= 0
    if band < 0:
        band, low = -band, -low
    if band < 100.0:
        band, low = 100.0, 0.0
    return {
        "inputFrequencyOffset": float(d.s32(1, 0)),
        "bandwidth": band,
        "volume": d.s32(3, 30) / 10.0,
        "low_cutoff": low,
        "dsb": d.bool_(10, False),
        "usb": usb,
        "agc_enable": d.bool_(11, False),
    }


def _wfm_settings(d: RefDeserializer) -> dict:
    return {
        "inputFrequencyOffset": float(d.s32(1, 0)),
        "rf_bandwidth": float(_index(WFM_RFBW, d.s32(2, 4))),
        "af_bandwidth": float(d.s32(3, 15)) * 1000.0,
        "volume": d.s32(4, 20) / 10.0,
        "squelch_db": float(d.s32(5, -60)),
    }


# BFMDemodSettings::m_rfBW (bfmdemodsettings.cpp:26-28)
BFM_RFBW = (80000, 100000, 120000, 140000, 160000, 180000, 200000,
            220000, 250000)


def _bfm_settings(d: RefDeserializer) -> dict:
    # bfmdemodsettings.cpp:82-130 deserialize scalings
    return {
        "inputFrequencyOffset": float(d.s32(1, 0)),
        "rf_bandwidth": float(_index(BFM_RFBW, d.s32(2, 4))),
        "af_bandwidth": float(d.s32(3, 3)) * 1000.0,
        "volume": d.s32(4, 20) / 10.0,
        "squelch_db": float(d.s32(5, -60)),
        "audio_stereo": d.bool_(9, False),
    }


def _dsd_settings(d: RefDeserializer) -> dict:
    # dsddemodsettings.cpp:96-140 deserialize scalings; m_baudRate is the
    # 4FSK symbol rate (2400 dPMR/NXDN48, 4800 DMR/YSF/D-Star)
    return {
        "inputFrequencyOffset": float(d.s32(1, 0)),
        "rf_bandwidth": 100.0 * d.s32(2, 125),
        "fm_deviation": 100.0 * d.s32(4, 50),
        "squelch_db": d.s32(5, -400) / 10.0,
        "symbol_rate": float(d.s32(11, 4800)),
    }


#: UDPSrcSettings::SampleFormat (udpsrcsettings.h:28-41) -> our fmt strings
_UDPSRC_FORMATS = ("iq", "iq", "nfm", "nfm", "lsb", "usb", "lsb", "usb",
                   "am", "am", "am", "iq")


def _udpsrc_settings(d: RefDeserializer) -> dict:
    # udpsrcsettings.cpp:102-150 deserialize scalings (NOTE: the offset is
    # id 2 here, not 1 — the serializer skips id 1)
    fmt_i = d.s32(3, 0)
    fmt = _UDPSRC_FORMATS[fmt_i] if 0 <= fmt_i < len(_UDPSRC_FORMATS) \
        else "iq"
    return {
        "inputFrequencyOffset": float(d.s32(2, 0)),
        "fmt": fmt,
        "output_sample_rate": float(d.real(4, 48000.0)),
        "rf_bandwidth": float(d.real(5, 32000.0)),
        "gain": d.s32(8, 10) / 10.0,
        "audio_active": d.bool_(11, False),
        "fm_deviation": float(d.s32(15, 2500)),
        "squelch_db": float(d.s32(16, -60)),
        "agc_enable": d.bool_(18, False),
    }


_CHANNEL_PARSERS = {
    "sdrangel.channel.nfmdemod": _nfm_settings,
    "sdrangel.channel.amdemod": _am_settings,
    "sdrangel.channel.ssbdemod": _ssb_settings,
    "sdrangel.channel.wfmdemod": _wfm_settings,
    "sdrangel.channel.bfm": _bfm_settings,
    "sdrangel.channel.dsddemod": _dsd_settings,
    "sdrangel.channel.udpsrc": _udpsrc_settings,
}


#: fcPos_t (rtlsdrsettings.h:23-27 — the same 3-value enum every
#: decimating Rx plugin uses): INFRA=0, SUPRA=1, CENTER=2
_FC_POS = {0: "inf", 1: "sup", 2: "cen"}


def _rtlsdr_device(d: RefDeserializer) -> dict:
    # rtlsdrsettings.cpp:68-100 deserialize: log2Decim U32(4), dcBlock(5),
    # iqImbalance(6), fcPos S32(7), devSampleRate S32(8)
    return {
        "log2_decim": int(d.u32(4, 4)),
        "dc_correction": d.bool_(5, False),
        "iq_correction": d.bool_(6, False),
        "fc_pos": _FC_POS.get(d.s32(7, 2), "cen"),
        "sample_rate": float(d.s32(8, 1024000)),
    }


def _filesource_device(d: RefDeserializer) -> dict:
    # filesourcesettings.cpp:40-56: fileName(1) only — rate/centre come
    # from the .sdriq header, as in the reference
    return {"kind": "filesource", "file_path": d.string(1, "")}


_DEVICE_PARSERS = {
    "sdrangel.samplesource.rtlsdr": _rtlsdr_device,
    "sdrangel.samplesource.filesource": _filesource_device,
}


def parse_preset(data: bytes | str) -> dict:
    """Deserialize a reference Preset blob (settings/preset.cpp:28-77).

    `data`: raw bytes or a Base64 string (how the reference stores blobs in
    QSettings / exported .prex files). Returns {group, description,
    centerFrequency, sourcePreset, channels: [{uri, settings(raw blob),
    parsed (mapped settings or None for unsupported kinds)}]}.
    """
    if isinstance(data, str):
        data = base64.b64decode(data)
    d = RefDeserializer(bytes(data))
    if not d.valid:
        raise ValueError("not a SimpleSerializer TLV stream")
    channels = []
    count = d.s32(200, 0)
    for i in range(count):
        uri = d.string(201 + 2 * i)
        blob = d.blob(202 + 2 * i)
        parser = _CHANNEL_PARSERS.get(uri)
        parsed = None
        if parser is not None and blob:
            cd = RefDeserializer(blob)
            if cd.valid and cd.version == 1:
                parsed = parser(cd)
        channels.append({"uri": uri, "config": blob, "settings": parsed})
    # device configs (preset.cpp:45-64: count at 20, entries 24+4i..27+4i)
    devices = []
    for i in range(d.s32(20, 0)):
        dev_id = d.string(24 + 4 * i)
        blob = d.blob(27 + 4 * i)
        parser = _DEVICE_PARSERS.get(dev_id)
        parsed = None
        if parser is not None and blob:
            dd = RefDeserializer(blob)
            if dd.valid and dd.version == 1:
                parsed = parser(dd)
        devices.append({
            "deviceId": dev_id,
            "serial": d.string(25 + 4 * i),
            "sequence": d.s32(26 + 4 * i, 0),
            "config": blob,
            "settings": parsed,
        })
    return {
        "group": d.string(1),
        "description": d.string(2),
        "centerFrequency": d.u64(3, 0),
        "sourcePreset": d.bool_(6, True),
        "devices": devices,
        "channels": channels,
    }


def to_session_preset(parsed: dict) -> dict:
    """Reference preset -> this framework's JSON preset document (the
    runtime.session schema; see Session._snapshot). Unsupported channel
    kinds are skipped (the reference GUI-only kinds have no runtime here)."""
    from .session import PRESET_SCHEMA_VERSION

    channels = []
    for ch in parsed["channels"]:
        st = ch.get("settings")
        if st is None:
            continue
        st = dict(st)
        off = st.pop("inputFrequencyOffset", 0.0)
        channels.append({
            "uri": ch["uri"],
            "inputFrequencyOffset": off,
            "settings": st,
        })
    source = {"center_frequency": float(parsed.get("centerFrequency", 0))}
    for dev in parsed.get("devices", ()):
        if dev.get("settings"):
            # first recognized device blob provides the front-end config
            # (log2Decim/fcPos/corrections/rate — deviceset.cpp:140-210's
            # per-device restore role)
            source.update(dev["settings"])
            break
    return {
        "schema": PRESET_SCHEMA_VERSION,
        "group": parsed.get("group", ""),
        "name": parsed.get("description", "imported"),
        "deviceSets": [{
            "direction": "rx" if parsed.get("sourcePreset", True) else "tx",
            "source": source,
            "channels": channels,
        }],
    }


# ---------------------------------------------------------------------------
# Export: this framework's preset document -> the reference's Base64-TLV
# blob, readable by the reference's own SimpleDeserializer (verified at
# golden-generation time: tools/gen_reference_goldens.py feeds a blob from
# this writer to the --verify mode of native/ref_preset_gen.cc, which parses
# it with the COMPILED reference deserializer; the transcript is pinned in
# tests/goldens/refpreset_export_verify.txt).
# ---------------------------------------------------------------------------


class RefSerializer:
    """SimpleSerializer wire format (simpleserializer.cpp:20-295)."""

    def __init__(self, version: int = 1):
        self.buf = bytearray()
        length = max((version.bit_length() + 7) // 8, 0)
        self._tag(TVERSION, 0, length)
        self.buf += version.to_bytes(length, "big")

    def _tag(self, typ: int, elem_id: int, length: int) -> None:
        id_len = max((elem_id.bit_length() + 7) // 8, 1)
        len_len = max((length.bit_length() + 7) // 8, 1)
        self.buf.append((typ << 4) | ((id_len - 1) << 2) | (len_len - 1))
        self.buf += elem_id.to_bytes(id_len, "big")
        self.buf += length.to_bytes(len_len, "big")

    def _int(self, typ, elem_id, value, max_bytes, signed):
        # minimal-length big-endian encoding (writeS32/U32/S64/U64 length
        # selection, simpleserializer.cpp:44-170)
        if value == 0:
            b = b""
        elif signed:
            n = 1
            while not (-(1 << (8 * n - 1)) <= value < (1 << (8 * n - 1))):
                n += 1
            b = value.to_bytes(n, "big", signed=True)
        else:
            n = max((value.bit_length() + 7) // 8, 1)
            b = value.to_bytes(n, "big")
        assert len(b) <= max_bytes
        self._tag(typ, elem_id, len(b))
        self.buf += b

    def s32(self, i, v):
        self._int(TS32, i, int(v), 4, True)

    def u32(self, i, v):
        self._int(TU32, i, int(v), 4, False)

    def u64(self, i, v):
        self._int(TU64, i, int(v), 8, False)

    def bool_(self, i, v):
        self._tag(TBOOL, i, 1)
        self.buf.append(1 if v else 0)

    def string(self, i, v):
        raw = str(v).encode("utf-8")
        self._tag(TSTRING, i, len(raw))
        self.buf += raw

    def blob(self, i, v):
        self._tag(TBLOB, i, len(v))
        self.buf += bytes(v)

    def final(self) -> bytes:
        return bytes(self.buf)


def _rfbw_index(table, rfbw) -> int:
    """getRFBWIndex: first table entry >= rfbw (nfmdemodsettings.cpp:154)."""
    for i, v in enumerate(table):
        if rfbw <= v:
            return i
    return len(table) - 1


def _nfm_blob(off: float, st: dict) -> bytes:
    s = RefSerializer(1)  # nfmdemodsettings.cpp:57-80
    s.s32(1, round(off))
    s.s32(2, _rfbw_index(NFM_RFBW, st.get("rf_bandwidth", 12500.0)))
    s.s32(3, round(st.get("af_bandwidth", 3000.0) / 1000.0))
    s.s32(4, round(st.get("volume", 1.0) * 10.0))
    if st.get("delta_squelch", False):
        s.s32(5, -round(10.0 ** (st.get("squelch_db", -30.0) / 10.0) * 1000.0))
    else:
        s.s32(5, round(st.get("squelch_db", -30.0) * 10.0))  # centibels
    s.u32(7, 0xFF0000)
    s.s32(8, int(st.get("ctcss_index", 0)))
    s.bool_(9, bool(st.get("ctcss_on", False)))
    s.bool_(10, bool(st.get("audio_mute", False)))
    s.s32(11, round(st.get("squelch_gate_ms", 50.0) / 10.0))
    s.bool_(12, bool(st.get("delta_squelch", False)))
    s.string(14, "NFM Demodulator")
    s.string(15, "System default device")
    return s.final()


def _am_blob(off: float, st: dict) -> bytes:
    s = RefSerializer(1)  # amdemodsettings.cpp:45-65
    s.s32(1, round(off))
    s.s32(2, round(st.get("rf_bandwidth", 5000.0) / 100.0))
    s.s32(4, round(st.get("volume", 1.0) * 10.0))
    s.s32(5, round(st.get("squelch_db", -40.0)))
    s.u32(7, 0xFFFF00)
    s.bool_(8, bool(st.get("bandpass_enable", False)))
    s.string(9, "AM Demodulator")
    s.string(11, "System default device")
    s.bool_(12, bool(st.get("sync_am", False)))
    s.s32(13, 0)
    return s.final()


def _ssb_blob(off: float, st: dict) -> bytes:
    s = RefSerializer(1)  # ssbdemodsettings.cpp:60-85
    sign = 1.0 if st.get("usb", True) else -1.0
    s.s32(1, round(off))
    s.s32(2, round(sign * st.get("bandwidth", 3000.0) / 100.0))
    s.s32(3, round(st.get("volume", 1.0) * 10.0))
    s.u32(5, 0x00FF00)
    s.s32(6, round(sign * st.get("low_cutoff", 300.0) / 100.0))
    s.s32(7, 3)
    s.bool_(8, bool(st.get("audio_binaural", False)))
    s.bool_(9, bool(st.get("audio_flip_channels", False)))
    s.bool_(10, bool(st.get("dsb", False)))
    s.bool_(11, bool(st.get("agc_enable", False)))
    s.s32(12, int(st.get("agc_time_log2", 7)))
    s.s32(13, round(st.get("agc_power_threshold_db", -40.0)))
    s.s32(14, int(st.get("agc_threshold_gate", 4)))
    return s.final()


def _wfm_blob(off: float, st: dict) -> bytes:
    s = RefSerializer(1)  # wfmdemodsettings.cpp:50-68
    s.s32(1, round(off))
    s.s32(2, _rfbw_index(WFM_RFBW, st.get("rf_bandwidth", 180000.0)))
    s.s32(3, round(st.get("af_bandwidth", 15000.0) / 1000.0))
    s.s32(4, round(st.get("volume", 1.0) * 10.0))
    s.s32(5, round(st.get("squelch_db", -60.0)))
    s.u32(7, 0x0000FF)
    s.string(8, "WFM Demodulator")
    return s.final()


_CHANNEL_WRITERS = {
    "sdrangel.channel.nfmdemod": _nfm_blob,
    "sdrangel.channel.amdemod": _am_blob,
    "sdrangel.channel.ssbdemod": _ssb_blob,
    "sdrangel.channel.wfmdemod": _wfm_blob,
}


def to_reference_preset(doc: dict) -> bytes:
    """This framework's JSON preset document (Session._snapshot schema) ->
    the reference Preset TLV (settings/preset.cpp:28-77 layout). Channels
    of kinds the reference cannot read (our data channels) are skipped."""
    s = RefSerializer(1)
    s.string(1, doc.get("group", "default"))
    s.string(2, doc.get("name", "exported"))
    ds = (doc.get("deviceSets") or [{}])[0]
    src = ds.get("source", {})
    s.u64(3, int(src.get("center_frequency", 0.0)))
    s.blob(4, b"")
    s.blob(5, b"")
    s.bool_(6, ds.get("direction", "rx") == "rx")
    s.s32(20, 1)
    s.string(24, "sdrangel.samplesource.filesource")
    s.string(25, "")
    s.s32(26, 0)
    s.blob(27, b"")
    chans = [ch for ch in ds.get("channels", [])
             if ch.get("uri") in _CHANNEL_WRITERS]
    s.s32(200, len(chans))
    for i, ch in enumerate(chans):
        writer = _CHANNEL_WRITERS[ch["uri"]]
        s.string(201 + 2 * i, ch["uri"])
        s.blob(202 + 2 * i, writer(float(ch.get("inputFrequencyOffset", 0.0)),
                                   ch.get("settings", {})))
    return s.final()
