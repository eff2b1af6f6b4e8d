"""The port's copies of the JAX package's numpy modules under DATV and the
daemon — `io/fec.py`, `channels/dvbs.py` and `channels/tsdemux.py` —
against the originals, on the inputs of tests/test_fec_daemon.py,
tests/test_dvbs.py and tests/test_tsdemux.py: the GF(256) tables, parity
and recovery with erasures (native and NumPy), the convolutional code and
Viterbi (hard and soft, at each puncture rate), the Forney interleaver,
RS(204,188) with errors, the energy-dispersal PRBS and its spec vectors,
the whole transport chain, and the demux's summaries. Equality is exact:
both sides are numpy (or the same native codec) on the host.
"""

import numpy as np
import pytest

from sdrangel_tpu.channels import dvbs as jd
from sdrangel_tpu.channels import tsdemux as jts
from sdrangel_tpu.io import fec as jfec
from sdrangel_tpu_torch.channels import dvbs as pd
from sdrangel_tpu_torch.channels import tsdemux as pts
from sdrangel_tpu_torch.io import fec as pfec

# -- io/fec.py -----------------------------------------------------------------------------------


def test_gf_tables_and_cauchy_matrix_equal_jax():
    np.testing.assert_array_equal(pfec._EXP, jfec._EXP)
    np.testing.assert_array_equal(pfec._LOG, jfec._LOG)
    a, b = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8))
    np.testing.assert_array_equal(pfec.gf_mul(a, b), jfec.gf_mul(a, b))
    assert [pfec.gf_inv(x) for x in range(1, 256)] == [jfec.gf_inv(x) for x in range(1, 256)]
    np.testing.assert_array_equal(pfec._cauchy_matrix(16, 128), jfec._cauchy_matrix(16, 128))
    # tests/test_fec_daemon.py: every nonzero element times its inverse is 1
    x = np.arange(1, 256, dtype=np.uint8)
    inv = np.array([pfec.gf_inv(int(v)) for v in x], dtype=np.uint8)
    np.testing.assert_array_equal(pfec.gf_mul(x, inv), np.ones(255, np.uint8))


def _codecs(path):
    """(encode, decode) of each package for the native or the NumPy path."""
    if path == "native":
        assert pfec.native_available() and jfec.native_available()
        return (pfec.fec_encode, pfec.fec_decode), (jfec.fec_encode, jfec.fec_decode)
    return ((pfec.fec_encode_py, pfec.fec_decode_py), (jfec.fec_encode_py, jfec.fec_decode_py))


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("n_lost,n_fec", [(0, 4), (2, 4), (4, 4), (8, 8)])
def test_fec_recovery_equals_jax(n_lost, n_fec, path):
    """tests/test_fec_daemon.py's recovery cases (k = 32 blocks of 64 bytes)."""
    (p_enc, p_dec), (j_enc, j_dec) = _codecs(path)
    rng = np.random.default_rng(1)
    k, L = 32, 64
    data = rng.integers(0, 256, size=(k, L), dtype=np.uint8)
    parity = p_enc(data, n_fec)
    np.testing.assert_array_equal(parity, j_enc(data, n_fec))
    received = {i: data[i] for i in range(k)}
    for i in rng.choice(k, size=n_lost, replace=False):
        del received[int(i)]
    received.update({k + j: parity[j] for j in range(n_fec)})
    out = p_dec(received, k, L)
    np.testing.assert_array_equal(out, j_dec(received, k, L))
    np.testing.assert_array_equal(out, data)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_fec_insufficient_blocks_equals_jax(path):
    (p_enc, p_dec), (_, j_dec) = _codecs(path)
    data = np.random.default_rng(2).integers(0, 256, size=(16, 32), dtype=np.uint8)
    parity = p_enc(data, 2)
    received = {i: data[i] for i in range(10)}
    received.update({16: parity[0], 17: parity[1]})
    assert p_dec(received, 16, 32) is None and j_dec(received, 16, 32) is None


def test_native_and_numpy_agree_as_in_jax():
    """tests/test_fec_daemon.py's native-against-oracle trials, through the
    port: odd block lengths exercise the codec's scalar tail."""
    rng = np.random.default_rng(3)
    for trial in range(6):
        k = int(rng.integers(4, 48))
        L = int(rng.choice([16, 17, 512]))
        n_fec = int(rng.integers(1, 8))
        data = rng.integers(0, 256, size=(k, L), dtype=np.uint8)
        p_native = pfec.fec_encode(data, n_fec)
        np.testing.assert_array_equal(p_native, pfec.fec_encode_py(data, n_fec))
        np.testing.assert_array_equal(p_native, jfec.fec_encode_py(data, n_fec))
        lost = rng.choice(k, size=int(rng.integers(0, n_fec + 1)), replace=False)
        received = {i: data[i] for i in range(k) if i not in lost}
        received.update({k + r: p_native[r] for r in range(n_fec)})
        np.testing.assert_array_equal(pfec.fec_decode(received, k, L), data)
        np.testing.assert_array_equal(pfec.fec_decode_py(received, k, L), data)


def test_superframe_codec_native_and_numpy_agree():
    """A whole superframe: 128 blocks of 512 bytes, 16 parity blocks, 16
    erasures (chip_smoke's phase 11d at the same size)."""
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, size=(128, 512), dtype=np.uint8)
    parity = pfec.fec_encode(data, 16)
    np.testing.assert_array_equal(parity, pfec.fec_encode_py(data, 16))
    lost = set(rng.choice(128, size=16, replace=False).tolist())
    received = {i: data[i] for i in range(128) if i not in lost}
    received.update({128 + r: parity[r] for r in range(16)})
    np.testing.assert_array_equal(pfec.fec_decode(received, 128, 512), data)
    np.testing.assert_array_equal(pfec.fec_decode_py(received, 128, 512), data)


# -- channels/dvbs.py ----------------------------------------------------------------------------


def _ts_packets(n, seed=0):
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, 256, size=(n, pd.TS_PACKET), dtype=np.uint8)
    pk[:, 0] = pd.SYNC_BYTE
    return pk.reshape(-1)


def test_constants_and_tables_equal_jax():
    assert (pd.TS_PACKET, pd.RS_PACKET, pd.SYNC_BYTE, pd.INTERLEAVER_DELAY) == (
        jd.TS_PACKET, jd.RS_PACKET, jd.SYNC_BYTE, jd.INTERLEAVER_DELAY)
    assert pd.PUNCTURE == jd.PUNCTURE
    np.testing.assert_array_equal(pd._NXT, jd._NXT)
    np.testing.assert_array_equal(pd._OUTS, jd._OUTS)
    np.testing.assert_array_equal(pd._rs_generator(), jd._rs_generator())
    np.testing.assert_array_equal(pd._PRBS_XOR, jd._PRBS_XOR)


def test_viterbi_hard_and_soft_equal_jax():
    """tests/test_dvbs.py's clean (hard) and noisy (soft) cases."""
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, 600).astype(np.uint8)
    coded = pd.conv_encode(bits)
    np.testing.assert_array_equal(coded, jd.conv_encode(bits))
    out = pd.viterbi_decode(coded)
    np.testing.assert_array_equal(out, jd.viterbi_decode(coded))
    np.testing.assert_array_equal(out, bits)
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, 1000).astype(np.uint8)
    noisy = pd.conv_encode(bits).astype(np.float64) * 2 - 1 + 0.6 * rng.standard_normal(2000)
    out = pd.viterbi_decode(noisy, hard=False)
    np.testing.assert_array_equal(out, jd.viterbi_decode(noisy, hard=False))
    assert (out != bits).mean() < 0.01


@pytest.mark.parametrize("rate", ["1/2", "2/3", "3/4", "5/6", "7/8"])
def test_punctured_viterbi_equals_jax(rate):
    """tests/test_dvbs.py's puncture cases, hard and soft (with channel
    noise), at each DVB-S rate."""
    rng = np.random.default_rng(10)
    bits = rng.integers(0, 2, 840).astype(np.uint8)
    coded = pd.conv_encode(bits)
    punct = pd.puncture(coded, rate)
    np.testing.assert_array_equal(punct, jd.puncture(coded, rate))
    hard = pd.depuncture(punct.astype(np.float64) * 2 - 1, rate)
    np.testing.assert_array_equal(hard, jd.depuncture(punct.astype(np.float64) * 2 - 1, rate))
    out = pd.viterbi_decode(hard)
    np.testing.assert_array_equal(out, jd.viterbi_decode(hard))
    m = min(len(out), len(bits)) - 8
    assert (out[:m] == bits[:m]).mean() > 0.999
    soft = (punct.astype(np.float64) * 2 - 1) + 0.3 * rng.standard_normal(len(punct))
    ps, js = pd.depuncture(soft, rate, hard=False), jd.depuncture(soft, rate, hard=False)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pd.viterbi_decode(ps, hard=False),
                                  jd.viterbi_decode(js, hard=False))


def test_interleaver_equals_jax():
    data = np.random.default_rng(3).integers(0, 256, 204 * 30, dtype=np.uint8)
    il = pd.interleave(data)
    np.testing.assert_array_equal(il, jd.interleave(data))
    rt = pd.deinterleave(il)
    np.testing.assert_array_equal(rt, jd.deinterleave(il))
    d = pd.INTERLEAVER_DELAY
    np.testing.assert_array_equal(rt[d:], data[:len(data) - d])


def test_rs_with_errors_equals_jax():
    """tests/test_dvbs.py's RS cases: clean, 8 byte errors corrected, 9
    flagged; and a sweep of 0-10 errors."""
    rng = np.random.default_rng(4)
    msg = rng.integers(0, 256, pd.TS_PACKET, dtype=np.uint8)
    cw = pd.rs_encode(msg)
    np.testing.assert_array_equal(cw, jd.rs_encode(msg))
    for n_err in (0, 8, 9, *range(11)):
        bad = cw.copy()
        pos = rng.choice(204, n_err, replace=False)
        bad[pos] ^= rng.integers(1, 256, n_err).astype(np.uint8)
        (p_out, p_n), (j_out, j_n) = pd.rs_decode(bad), jd.rs_decode(bad)
        assert p_n == j_n == (n_err if n_err <= 8 else -1)
        np.testing.assert_array_equal(p_out, j_out)


def test_energy_dispersal_equals_jax():
    """EN 300 421 §4.4's spec vectors, and scramble/descramble/fix_sync."""
    assert list(pd._prbs_bytes(4)) == [0x03, 0xF6, 0x08, 0x34]
    np.testing.assert_array_equal(pd._prbs_bytes(300), jd._prbs_bytes(300))
    assert pd._PRBS_XOR[0] == 0 and pd._PRBS_XOR[1] == 0x03
    pk = _ts_packets(8, seed=5)
    sc = pd.scramble(pk)
    np.testing.assert_array_equal(sc, jd.scramble(pk))
    assert sc[0] == 0xB8 and sc[pd.TS_PACKET] == pd.SYNC_BYTE
    de = pd.descramble(sc)
    np.testing.assert_array_equal(de, jd.descramble(sc))
    np.testing.assert_array_equal(pd.fix_sync(de), jd.fix_sync(de))
    np.testing.assert_array_equal(pd.fix_sync(de), pk)


def test_transport_loopback_with_errors_equals_jax():
    """tests/test_dvbs.py's full loopback: 16 packets and 11 to fill the
    interleaver, 0.5 % of channel bits flipped."""
    pk = _ts_packets(16, seed=6)
    pad = _ts_packets(11, seed=8)
    chan = pd.encode_transport(np.concatenate([pk, pad]))
    np.testing.assert_array_equal(chan, jd.encode_transport(np.concatenate([pk, pad])))
    chan = chan.astype(np.float64) * 2 - 1
    rng = np.random.default_rng(7)
    chan[rng.random(len(chan)) < 0.005] *= -1
    (p_out, p_n), (j_out, j_n) = pd.decode_transport(chan, 16), jd.decode_transport(chan, 16)
    assert p_n == j_n
    np.testing.assert_array_equal(p_out, j_out)
    np.testing.assert_array_equal(p_out.reshape(-1, pd.TS_PACKET)[:16].reshape(-1), pk)


# -- channels/tsdemux.py -------------------------------------------------------------------------


def _make_stream(m):
    """tests/test_tsdemux.py's two-stream programme, built by module m."""
    pkts = m._section_packetize(0, m.make_pat({1: 0x100}), 0)
    pkts += m._section_packetize(0x100, m.make_pmt(1, 0x200, {0x200: 0x02, 0x201: 0x04}), 0)
    pkts += m.make_pes_packets(0x200, bytes(range(256)) * 4, pts=900_000)
    pkts += m.make_pes_packets(0x201, b"\xab\xcd" * 100, pts=900_300)
    return pkts


def _long_pmt_stream(m):
    """tests/test_tsdemux.py's PMT spanning two packets, its tail sharing a
    packet with a repeat of it."""
    pmt = m.make_pmt(9, 0x300, {0x300 + i: 0x1B for i in range(36)})
    p1 = bytes([m.SYNC, 0x40 | (0x150 >> 8), 0x150 & 0xFF, 0x10]) + b"\x00" + pmt[:183]
    rest = pmt[183:]
    p2 = (bytes([m.SYNC, 0x40 | (0x150 >> 8), 0x150 & 0xFF, 0x11]) + bytes([len(rest)])
          + (rest + pmt)[:183])
    return b"".join(m._section_packetize(0, m.make_pat({9: 0x150}), 0)) + p1 + p2


def _demux_state(d) -> tuple:
    return (d.summary(), {pid: d.drain_pes(pid) for pid in sorted(d.pes_payloads)},
            dict(d.pts), d.continuity_errors, d.sync_losses)


def test_muxers_equal_jax():
    assert _make_stream(pts) == _make_stream(jts)
    assert _long_pmt_stream(pts) == _long_pmt_stream(jts)
    for data in (b"", b"\x00\xb0\x0d", bytes(range(256)) * 3):
        assert pts._crc32_mpeg(data) == jts._crc32_mpeg(data)
    es = bytes(range(200)) * 20
    assert pts.make_pes_packets(0x300, es, pts=12345, start_cc=5) == jts.make_pes_packets(
        0x300, es, pts=12345, start_cc=5)
    assert pts.STREAM_TYPES == jts.STREAM_TYPES


def _streams():
    raw = b"".join(_make_stream(pts))
    pkts = _make_stream(pts)
    vid = [i for i, p in enumerate(pkts) if ((p[1] & 0x1F) << 8) | p[2] == 0x200]
    dropped = b"".join(p for i, p in enumerate(pkts) if i != vid[2])
    return {
        "whole": [raw],
        "fragments_after_garbage": [(b"\x12\x34\x56" + raw)[i:i + 100]
                                    for i in range(0, len(raw) + 3, 100)],
        "payload_sync_in_garbage": [b"\x01\x02\x47\x03\x04\x05\x06" + raw],
        "lost_packet": [dropped],
        "long_pmt": [_long_pmt_stream(pts)],
        "after_fec": [pd.decode_transport(pd.encode_transport(np.concatenate([
            np.frombuffer(raw, np.uint8), _ts_packets(11, seed=3)])).astype(np.float64) * 2 - 1,
            len(raw) // pd.TS_PACKET)[0].tobytes()],
    }


@pytest.mark.parametrize("case", sorted(_streams()))
def test_demux_equals_jax(case):
    """Each stream of tests/test_tsdemux.py fed in the same chunks to both
    demuxes: the same summary, elementary streams, PTS and error counts."""
    chunks = _streams()[case]
    p, j = pts.TsDemux(), jts.TsDemux()
    for c in chunks:
        p.feed(c)
        j.feed(c)
    assert _demux_state(p) == _demux_state(j)
    if case != "long_pmt":
        assert p.programs[1].streams == {0x200: 0x02, 0x201: 0x04}


def test_pes_header_spanning_a_packet_equals_jax():
    """tests/test_tsdemux.py's stuffed PES header (239 bytes) split across
    two packets, its PTS in the second."""
    pid, pts_v, header_len = 0x200, 1_234_567, 230
    ptsb = bytes([0x21 | (((pts_v >> 30) & 0x7) << 1), (pts_v >> 22) & 0xFF,
                  0x01 | (((pts_v >> 15) & 0x7F) << 1), (pts_v >> 7) & 0xFF,
                  0x01 | ((pts_v & 0x7F) << 1)])
    pes = (b"\x00\x00\x01\xe0\x00\x00" + bytes([0x80, 0x80, header_len]) + ptsb
           + b"\xff" * (header_len - 5) + bytes(range(64)) * 3)
    pkts = []
    for cc, off in enumerate(range(0, len(pes), 184)):
        chunk = pes[off:off + 184]
        hdr = bytes([pts.SYNC, (0x40 if cc == 0 else 0) | (pid >> 8), pid & 0xFF, 0x10 | cc])
        pkts.append(hdr + chunk + b"\xff" * (184 - len(chunk)))
    p, j = pts.TsDemux(), jts.TsDemux()
    for d in (p, j):
        d.pes_payloads[pid] = bytearray()
        d.feed(b"".join(pkts))
    assert _demux_state(p) == _demux_state(j)
    assert p.pts[pid] == [pts_v]
