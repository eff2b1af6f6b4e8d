"""The port's copy of the DSD frame-sync module
(`sdrangel_tpu_torch/channels/dsdsync.py`) against the JAX package's
(`sdrangel_tpu/channels/dsdsync.py`), on the inputs of tests/test_dsd.py:
the same constants, codeword tables and encoders, and on each stream the
same sync hits, AMBE/VCH voice frames, NXDN/dPMR reports and searcher
reports, fed in the same uneven chunks. Equality is exact: both are numpy
on the host.
"""

import numpy as np
import pytest

from sdrangel_tpu.channels import dsdsync as jd
from sdrangel_tpu_torch.channels import dsdsync as pd

_CONSTANTS = (
    "DIBIT_LEVELS", "DMR_BS_VOICE", "DMR_BS_DATA", "DMR_MS_VOICE", "DMR_MS_DATA", "YSF_SYNC",
    "DSTAR_SYNC_BITS", "NXDN_FSW", "DPMR_FS1", "DPMR_FS2", "DPMR_FS3", "DMR_BURST_DIBITS",
    "YSF_FRAME_DIBITS", "YSF_FICH_DIBITS", "YSF_DCH_DIBITS", "DSTAR_FRAME_BITS",
    "NXDN_FRAME_DIBITS", "NXDN_LICH_DIBITS", "NXDN_SACCH_DIBITS", "NXDN_RF_CHANNELS",
    "DPMR_FRAME_TYPES",
)


def test_constants_and_tables_equal_jax():
    for name in _CONSTANTS:
        np.testing.assert_array_equal(np.asarray(getattr(pd, name), dtype=object),
                                      np.asarray(getattr(jd, name), dtype=object), name)
    np.testing.assert_array_equal(pd._golay_codewords(), jd._golay_codewords())
    (p_rows, p_meta), (j_rows, j_meta) = pd._pattern_table(), jd._pattern_table()
    assert p_meta == j_meta
    assert len(p_rows) == len(j_rows)
    for a, b in zip(p_rows, j_rows):
        np.testing.assert_array_equal(a, b)


def test_codecs_equal_jax():
    rng = np.random.default_rng(41)
    for data in (0, 1, 0x5A5, 0xFFF, *rng.integers(0, 4096, 20)):
        np.testing.assert_array_equal(pd.golay_encode(int(data)), jd.golay_encode(int(data)))
        word = jd.golay_encode(int(data)).copy()
        for pos in rng.choice(24, 4, replace=False)[:int(data) % 5]:
            word[pos] ^= 1  # up to 4 bit errors: decoded, corrected or refused alike
        assert pd.golay_decode(word) == jd.golay_decode(word)
    for kw in ({}, dict(fi=1, dt=2, fn=5, ft=7, sq=42, cs=3), dict(fi=2, dt=1, cm=1)):
        f = jd.encode_fich(**kw)
        np.testing.assert_array_equal(pd.encode_fich(**kw), f)
        bad = f.copy()
        bad[[3, 41, 77]] ^= 2
        assert pd.decode_fich(f) == jd.decode_fich(f)
        assert pd.decode_fich(bad) == jd.decode_fich(bad)
    garbage = rng.integers(0, 4, 100).astype(np.int8)
    assert pd.decode_fich(garbage) == jd.decode_fich(garbage) is None
    for args in ((1, 23, 0x18), (0, 9, 0x21), (2, 1, 2), (3, 63, 0x3F)):
        frame = jd.encode_nxdn_frame(*args)
        np.testing.assert_array_equal(pd.encode_nxdn_frame(*args), frame)
        lich, sacch = frame[10:18], frame[18:48]
        assert pd.decode_nxdn_lich(lich) == jd.decode_nxdn_lich(lich)
        assert pd.decode_nxdn_sacch(sacch) == jd.decode_nxdn_sacch(sacch) is not None
    for kind in ("header", "payload", "end"):
        np.testing.assert_array_equal(pd.encode_dpmr_frame(kind), jd.encode_dpmr_frame(kind))
    data = bytes(rng.integers(0, 256, 17).tolist())
    assert pd._crc16_ccitt(data) == jd._crc16_ccitt(data)


# -- the streams of tests/test_dsd.py -------------------------------------------------

def _random(rng, n):
    return rng.integers(0, 4, n).astype(np.int8)


def _frames(rng, pattern, frame_dibits, n):
    return np.concatenate([np.concatenate([np.asarray(pattern, np.int8),
                                           _random(rng, frame_dibits - len(pattern))])
                           for _ in range(n)])


def _bits_to_dibits(bits):
    bits = np.asarray(bits, np.uint8)
    return ((bits[0::2] << 1) | bits[1::2]).astype(np.int8)


def _dmr_voice_burst(rng, voice_bits):
    return np.concatenate([_bits_to_dibits(voice_bits[:108]), jd.DMR_BS_VOICE,
                           _bits_to_dibits(voice_bits[108:]), _random(rng, 12)])


def _ysf_frame(rng, fi=1, dt=2):
    parts = [np.asarray(jd.YSF_SYNC, np.int8), jd.encode_fich(fi=fi, dt=dt)]
    for _ in range(5):
        parts += [_random(rng, jd.YSF_DCH_DIBITS),
                  _bits_to_dibits(rng.integers(0, 2, 72).astype(np.uint8))]
    return np.concatenate(parts)


def _dstar(rng):
    voices = [rng.integers(0, 2, 72).astype(np.uint8) for _ in range(4)]
    data = rng.integers(0, 2, 24).astype(np.uint8)
    bits = np.concatenate([voices[0], jd.DSTAR_SYNC_BITS.astype(np.uint8),
                           voices[1], data, voices[2], data, voices[3], data])
    return np.where(bits == 1, 3, 1).astype(np.int8)


def _stream(case: str) -> tuple[np.ndarray, dict]:
    """A dibit stream and the searcher's settings, per protocol mix."""
    rng = np.random.default_rng(_CASES.index(case) + 51)
    if case == "dmr":
        s = np.concatenate([
            _random(rng, 100), _frames(rng, jd.DMR_BS_VOICE, jd.DMR_BURST_DIBITS, 3),
            _frames(rng, jd.DMR_MS_DATA, jd.DMR_BURST_DIBITS, 2),
            _frames(rng, jd.DMR_BS_DATA, jd.DMR_BURST_DIBITS, 2),
            _dmr_voice_burst(rng, rng.integers(0, 2, 216).astype(np.uint8)),
            _dmr_voice_burst(rng, rng.integers(0, 2, 216).astype(np.uint8)), _random(rng, 60)])
        pat = jd.DMR_MS_VOICE.copy()
        pat[[5, 17]] ^= 2  # two symbol errors
        return np.concatenate([s, pat, _random(rng, 40)]), {"max_errors": 2}
    if case == "dmr_inverted":
        s = np.concatenate([_random(rng, 77),
                            _dmr_voice_burst(rng, rng.integers(0, 2, 216).astype(np.uint8)),
                            _random(rng, 40)])
        return (s ^ 2).astype(np.int8), {"max_errors": 0, "polarity": True}
    if case == "ysf":
        s = np.concatenate([_random(rng, 77), _ysf_frame(rng), _ysf_frame(rng, fi=0),
                            _ysf_frame(rng, dt=1), _ysf_frame(rng), _ysf_frame(rng, fi=2),
                            _random(rng, 50)])
        s[77 + 3 * jd.YSF_FRAME_DIBITS + 20:77 + 3 * jd.YSF_FRAME_DIBITS + 120] = _random(
            rng, 100)  # a FICH beyond repair
        return s, {"max_errors": 0}
    if case == "ysf_polarity_lock":
        s = np.concatenate([(jd.YSF_SYNC ^ 2).astype(np.int8), _random(rng, 64),
                            (jd.DMR_BS_VOICE ^ 2).astype(np.int8), _random(rng, 40),
                            (_ysf_frame(rng) ^ 2).astype(np.int8)])
        return s, {"max_errors": 0}
    if case == "dstar":
        return np.concatenate([_random(rng, 30), _dstar(rng), _random(rng, 64)]), {
            "max_errors": 0}
    if case == "nxdn_dpmr":
        s = _random(rng, 6000)
        s[300:324] = jd.DMR_BS_VOICE
        s[800:820] = jd.YSF_SYNC
        for i, b in enumerate(jd.DSTAR_SYNC_BITS):
            s[1500 + i] = 2 if b else 0
        s[2200:2392] = jd.encode_nxdn_frame(2, ran=1, message_type=2)
        s[2600:2792] = (jd.encode_nxdn_frame(1, ran=5, message_type=1) ^ 2).astype(np.int8)
        for k, kind in enumerate(("header", "payload", "payload", "end")):
            f = jd.encode_dpmr_frame(kind)
            s[3000 + 400 * k:3000 + 400 * k + len(f)] = f
        return s, {"max_errors": 0}
    raise ValueError(case)


_CASES = ["dmr", "dmr_inverted", "ysf", "ysf_polarity_lock", "dstar", "nxdn_dpmr"]


@pytest.mark.parametrize("case", _CASES)
def test_frame_sync_equals_jax(case):
    """Both modules fed the same stream in uneven chunks (patterns straddle
    the seams): the same hits, voice frames, NXDN/dPMR report and searcher
    report after every chunk, and the same polarity lock."""
    stream, kw = _stream(case)
    mods = {"jax": jd, "port": pd}
    objs = {k: (m.SyncSearcher(**kw), m.VoiceExtractor(), m.NxdnDpmrDecoder())
            for k, m in mods.items()}
    cuts = [0, 137, 400, 401, 1000, 2201, len(stream)]
    n_hits = 0
    for a, b in zip(cuts, cuts[1:]):
        got = {}
        for k, (s, ve, nx) in objs.items():
            chunk = stream[a:b]
            hits = s.feed(chunk)
            frames = ve.feed(chunk, hits)
            nx.feed(chunk, hits)
            got[k] = ([tuple(h) for h in hits], frames, nx.report(), s.report(), s.polarity,
                      ve.total)
        assert got["port"] == got["jax"], (case, a, b)
        n_hits += len(got["jax"][0])
    assert n_hits, f"{case}: the stream carries no sync to compare"
