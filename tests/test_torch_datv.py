"""The port's DATV receiver against the JAX package: the RRC designer, the
device front end (`demod_datv.process`) streamed over 3 blocks with its
state carried, JAX's QPSK end-to-end test run through the port, the host
glue (`recover_ts` at rates 1/2 and 3/4 and all four rotations, and the
ranking of its candidates where the port departs from JAX), the
registry's DATV kind, an RxPipeline of DATV and NFM with JAX's state handed
over, and the session's DATV host report against the JAX session's decode
of the same soft symbols.

Tolerances: the RRC designer 1e-7 (both are float64 numpy rounded to
complex64); the soft symbols 2e-5 absolute (the outputs lie in [-1, 1]);
every host result (TS bytes, stats, reports) equal.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrangel_tpu.channels import demod_datv as jdd
from sdrangel_tpu.channels import registry as jreg
from sdrangel_tpu.dsp import fftfilt as jff
from sdrangel_tpu.runtime import engine as jeng
from sdrangel_tpu.runtime import session as jsession
from sdrangel_tpu_torch.channels import demod_datv as pdd
from sdrangel_tpu_torch.channels import dvbs, tsdemux
from sdrangel_tpu_torch.channels import registry as preg
from sdrangel_tpu_torch.dsp import fftfilt as pff
from sdrangel_tpu_torch.io import sdriq
from sdrangel_tpu_torch.runtime import engine as peng
from sdrangel_tpu_torch.runtime import session as psession
from torch_port_util import CPU, n, t

ATOL = 2e-5
DATV = "sdrangel.channel.demoddatv"


def _packets(n_pk: int, seed: int) -> np.ndarray:
    pk = np.random.default_rng(seed).integers(0, 256, size=(n_pk, dvbs.TS_PACKET),
                                              dtype=np.uint8)
    pk[:, 0] = dvbs.SYNC_BYTE
    return pk


def _shape(symbols: np.ndarray, sps: int, amp: float = 0.4) -> np.ndarray:
    """QPSK symbols as an RRC-shaped (rolloff 0.35) baseband at sps samples a
    symbol: the impulse train through the port's fftfilt."""
    h = pff.create_rrc_filter(1.0 / sps, 0.35, 1024)
    up = np.zeros(len(symbols) * sps, np.complex64)
    up[::sps] = symbols * sps
    up = up[:len(up) // 512 * 512]
    _, shaped = pff.run_filt(pff.make_state(1024, CPU), t(up), t(h))
    return (n(shaped) * amp).astype(np.complex64)


def _stream(pk: np.ndarray, fec_rate: str = "1/2") -> np.ndarray:
    chan = dvbs.encode_transport(pk.reshape(-1))
    if fec_rate != "1/2":
        chan = dvbs.puncture(chan, fec_rate)
    return pdd.bits_to_qpsk(chan)


# -- the designer and the front end ------------------------------------------------------------


@pytest.mark.parametrize("fb,alpha,flen", [(0.25, 0.35, 1024), (0.125, 0.35, 1024),
                                           (0.1, 0.2, 512), (1 / 32, 0.35, 4096)])
def test_create_rrc_filter_equals_jax(fb, alpha, flen):
    p, j = pff.create_rrc_filter(fb, alpha, flen), jff.create_rrc_filter(fb, alpha, flen)
    assert p.dtype == j.dtype == np.complex64
    np.testing.assert_allclose(p, j, atol=1e-7, rtol=0)


def test_config_as_in_jax():
    for rate, sym in ((1e6, 250e3), (2e6, 250e3), (1.5e6, 500e3)):
        pc, jc = pdd.DATVConfig(rate, symbol_rate=sym), jdd.DATVConfig(rate, symbol_rate=sym)
        assert pc.sps == jc.sps
        np.testing.assert_array_equal(pc.rrc_filter, jc.rrc_filter)
    with pytest.raises(ValueError, match="integer number of samples per symbol"):
        pdd.DATVConfig(96_000.0).sps
    with pytest.raises(AssertionError):
        jdd.DATVConfig(96_000.0).sps


@pytest.mark.parametrize("offset", [0.0, 3000.0])
def test_process_streamed_equals_jax(offset):
    """3 blocks of a DVB-S waveform off-tuned by `offset`, the state carried
    through each package's own states."""
    cfg_kw = dict(channel_rate=1_000_000.0, symbol_rate=250_000.0, input_offset=offset)
    pc, jc = pdd.DATVConfig(**cfg_kw), jdd.DATVConfig(**cfg_kw)
    x = _shape(_stream(_packets(12, 1)), 4)
    x = x * np.exp(2j * np.pi * offset * np.arange(len(x)) / 1e6).astype(np.complex64)
    run = jax.jit(jdd.process, static_argnums=2)
    js, ps = jdd.make_state(jc), pdd.make_state(pc, CPU)
    block = 8192
    for b in range(3):
        xb = x[b * block:(b + 1) * block]
        js, jo = run(js, jnp.asarray(xb), jc)
        ps, po = pdd.process(ps, t(xb), pc)
        for k in ("soft_i", "soft_q"):
            pv, jv = n(getattr(po, k)), np.asarray(getattr(jo, k))
            assert pv.dtype == jv.dtype == np.float32 and pv.shape == jv.shape == (block // 4,)
            np.testing.assert_allclose(pv, jv, atol=ATOL, rtol=0, err_msg=k)
    assert int(ps.nco.phase) == int(js.nco.phase)
    np.testing.assert_allclose(n(ps.sym.mu), np.asarray(js.sym.mu), atol=1e-5)
    np.testing.assert_allclose(n(ps.fft.overlap), np.asarray(js.fft.overlap), atol=ATOL)


def test_datv_qpsk_end_to_end():
    """tests/test_datv.py's end-to-end test through the port: 8 packets
    behind a 6-packet lead-in, shaped at 4 samples a symbol, received in
    16,384-sample blocks, the rotation resolved and the bit alignment
    searched; at least 7 of the 8 come back."""
    n_pk, n_lead = 8, 6
    rng = np.random.default_rng(0)
    pk = rng.integers(0, 256, size=(n_pk, dvbs.TS_PACKET), dtype=np.uint8)
    pk[:, 0] = dvbs.SYNC_BYTE
    lead = rng.integers(0, 256, size=(n_lead, dvbs.TS_PACKET), dtype=np.uint8)
    lead[:, 0] = dvbs.SYNC_BYTE
    pad = rng.integers(0, 256, size=(11, dvbs.TS_PACKET), dtype=np.uint8)
    pad[:, 0] = dvbs.SYNC_BYTE
    x = _shape(_stream(np.concatenate([lead, pk, pad])), 4)
    cfg = pdd.DATVConfig(channel_rate=1_000_000.0, symbol_rate=250_000.0)
    bsize = 16384
    x = np.concatenate([x, np.zeros((-len(x)) % bsize, np.complex64)])
    state, si, sq = pdd.make_state(cfg, CPU), [], []
    for b in range(len(x) // bsize):
        state, outs = pdd.process(state, t(x[b * bsize:(b + 1) * bsize]), cfg)
        si.append(n(outs.soft_i))
        sq.append(n(outs.soft_q))
    _, soft = pdd.resolve_rotation(np.concatenate(si), np.concatenate(sq))
    best = 0
    for bit_off in range(0, 64, 2):
        out, _ = dvbs.decode_transport(soft[bit_off:], n_lead + n_pk)
        got = out.reshape(-1, dvbs.TS_PACKET)
        if len(got) < n_lead + n_pk:
            continue
        best = max(best, sum(np.array_equal(got[n_lead + i], pk[i]) for i in range(n_pk)))
        if best == n_pk:
            break
    assert best >= n_pk - 1, f"recovered {best}/{n_pk} packets"


# -- the host glue -----------------------------------------------------------------------------


def test_symbol_glue_equals_jax():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, 400).astype(np.uint8)
    np.testing.assert_array_equal(pdd.bits_to_qpsk(bits), jdd.bits_to_qpsk(bits))
    si, sq = rng.uniform(-1, 1, (2, 200)).astype(np.float32)
    np.testing.assert_array_equal(pdd.qpsk_to_soft_bits(si, sq), jdd.qpsk_to_soft_bits(si, sq))
    s = _stream(_packets(4, 2)) * 1j
    pr, psoft = pdd.resolve_rotation(s.real, s.imag)
    jr, jsoft = jdd.resolve_rotation(s.real, s.imag)
    assert pr == jr
    np.testing.assert_array_equal(psoft, jsoft)


@pytest.mark.parametrize("rotation", [1.0, 1j, -1.0, -1j])
@pytest.mark.parametrize("fec_rate", ["1/2", "3/4"])
def test_recover_ts_equals_jax(fec_rate, rotation):
    """24 packets, noiseless and rotated: the same TS bytes and stats as
    JAX's."""
    s = _stream(_packets(24, 4), fec_rate) * rotation
    si, sq = s.real.astype(np.float32), s.imag.astype(np.float32)
    p_ts, p_stats = pdd.recover_ts(si, sq, fec_rate=fec_rate)
    j_ts, j_stats = jdd.recover_ts(si, sq, fec_rate=fec_rate)
    assert p_stats == j_stats and p_ts == j_ts
    assert p_stats["packets"] > 0 and p_stats["rsFailed"] == 0


def test_candidates_rank_by_the_sync_grid_at_every_bit_phase():
    """The one divergence of the host glue (ROADMAP.md §3): FEC 3/4 behind
    7 symbols of receiver delay (K1 ÷8's at 8 MS/s; 14 channel bits, 9
    decoded bits: no whole byte). JAX ranks each (rotation, puncture
    phase) by its 0x47 bytes at bit phase 0, where the right one scores
    below wrong ones (behind K1 ÷8 on an 8 MS/s capture it fell out of the
    6 checked: ROADMAP.md §3); the port's `_sync_score` (the syncs on the
    204-byte grid at the best bit phase) puts it first, far above the rest."""
    rng = np.random.default_rng(6)
    lead = pdd.bits_to_qpsk(rng.integers(0, 2, 14).astype(np.uint8))
    sc = np.concatenate([lead, _stream(_packets(24, 4), "3/4")])
    probe = (dvbs.INTERLEAVER_DELAY + 4 * dvbs.RS_PACKET) * 8 * 2
    jax_rank, port_rank = [], []
    for ri, rot in enumerate((1.0, 1j, -1.0, -1j)):
        sr = sc[:probe] * rot
        raw = pdd.qpsk_to_soft_bits(sr.real, sr.imag)
        for pre in range(4):
            sb = dvbs.depuncture(raw[pre:], "3/4", hard=False)
            bits = dvbs.viterbi_decode(sb[:probe], hard=False)
            jax_rank.append((int((np.packbits(bits) == dvbs.SYNC_BYTE).sum()), ri, pre))
            port_rank.append((pdd._sync_score(bits), ri, pre))
    jax_rank.sort(reverse=True)
    port_rank.sort(reverse=True)
    assert jax_rank[0][1:] != (0, 2) and jax_rank[3][1:] != (0, 2), jax_rank
    assert port_rank[0][1:] == (0, 2) and port_rank[0][0] >= 10 > 3 >= port_rank[1][0], port_rank


# -- the registry and the pipeline -------------------------------------------------------------


def test_registry_datv_as_in_jax():
    pk, jk = preg.REGISTRY[DATV], jreg.REGISTRY[DATV]
    for field in ("output", "needs_fft_hop", "needs_audio_ratio", "data_keys",
                  "host_report_keys", "dynamic_fields"):
        assert getattr(pk, field) == getattr(jk, field), field
    assert preg.settings_schema(DATV) == jreg.settings_schema(DATV)
    assert preg.report_schema(DATV) == jreg.report_schema(DATV)
    assert DATV in preg.REGISTRY
    assert "datvContinuous" in preg.SESSION_KEYS
    preg.validate_settings(DATV, {"datvContinuous": True, "fec_rate": "3/4"})
    for settings in ({}, {"symbol_rate": 500_000.0}, {"symbol_rate": 125_000.0}):
        assert preg.requested_rate(DATV, settings) == jreg.requested_rate(DATV, settings)
        for rate in (1e6, 2e6, 4e6):
            assert pk.block_factor(rate, settings) == jk.block_factor(rate, settings)


RATE = 2_000_000.0
_CHANNELS = [
    (DATV, 0.0, {"symbol_rate": 250_000.0}),
    ("sdrangel.channel.nfmdemod", 300_000.0, {"squelch_db": -60.0}),
]


def _pipes():
    def specs(mod, reg):
        return [mod.ChannelSpec(u, o, s, reg.requested_rate(u, s)) for u, o, s in _CHANNELS]

    jp = jeng.RxPipeline(jeng.DeviceConfig(RATE, log2_decim=1), specs(jeng, jreg))
    pp = peng.RxPipeline(peng.DeviceConfig(RATE, log2_decim=1), specs(peng, preg), CPU)
    assert (pp.base_block, pp.device_block) == (jp.base_block, jp.device_block)
    assert [p.signs for p in pp.plans] == [p.signs for p in jp.plans]
    return jp, pp


def test_pipeline_datv_and_nfm_match_jax_with_its_state_handed_over():
    """Random QPSK at 250 kS/s shaped at 8 samples a symbol on the 2 MS/s
    capture (the port's K1 path: int16, centred, ÷2) beside an FM tone at
    +300 kHz. JAX runs the first block; its state carries the port through
    the next two, whose packed soft symbols and audio match JAX's."""
    jp, pp = _pipes()
    rng = np.random.default_rng(9)
    total = 3 * pp.device_block
    sym = ((rng.integers(0, 2, total // 8 + 64) * 2 - 1)
           + 1j * (rng.integers(0, 2, total // 8 + 64) * 2 - 1)) / np.sqrt(2)
    x = _shape(sym.astype(np.complex64), 8, amp=0.3)[:total]
    tt = np.arange(total) / RATE
    x = x + 0.1 * np.exp(1j * (2 * np.pi * 300_000.0 * tt + 3.0 * np.sin(2 * np.pi * 1000 * tt)))
    x = x + 0.002 * (rng.standard_normal(total) + 1j * rng.standard_normal(total))
    raws = np.stack([np.round(x.real * 32767), np.round(x.imag * 32767)], -1).astype(np.int16)
    raws = raws.reshape(3, pp.device_block, 2)
    js, _ = jp._step(jp.init_state(), jnp.asarray(raws[0]))
    ps = pp.state_from_numpy(jax.tree.map(np.asarray, js))
    for raw in raws[1:]:
        js, jo = jp._step(js, jnp.asarray(raw))
        ps, flat = pp.step_packed(ps, t(raw))
        po = pp.to_host(flat)
        jd, pd_ = jo["channels"][0]["data"], po["channels"][0]["data"]
        assert sorted(pd_) == ["soft_i", "soft_q"]
        for k in ("soft_i", "soft_q"):
            jv = np.asarray(jd[k])
            assert pd_[k].dtype == jv.dtype == np.float32 and pd_[k].shape == jv.shape
            np.testing.assert_allclose(pd_[k], jv, atol=ATOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(po["channels"][1]["audio"],
                                   np.asarray(jo["channels"][1]["audio"]), atol=ATOL, rtol=0)
    back, jtree = pp.state_to_numpy(ps), jax.tree.map(np.asarray, js)
    assert back["demod"][0].nco.phase == jtree["demod"][0].nco.phase
    np.testing.assert_allclose(back["demod"][0].sym.mu, jtree["demod"][0].sym.mu, atol=1e-5)
    np.testing.assert_allclose(back["demod"][0].sym.tail, jtree["demod"][0].sym.tail, atol=ATOL)
    np.testing.assert_allclose(back["demod"][0].fft.overlap, jtree["demod"][0].fft.overlap,
                               atol=ATOL)


# -- the session's host decode -----------------------------------------------------------------


def _jax_decode_reports(blocks: list[tuple[np.ndarray, np.ndarray]], settings: dict) -> list:
    """The JAX session's `_datv_host_decode` fed the same blocks: the
    channel's report after each block."""
    jds = jsession.DeviceSet(0)
    ch = jsession.ChannelState(DATV, 0.0, dict(settings))
    reports = []
    for si, sq in blocks:
        ch.latest_data = {"soft_i": si, "soft_q": sq}
        jds._datv_host_decode(0, ch)
        reports.append(ch.host_report)
    return reports


def test_decode_schedule_equals_jax(monkeypatch):
    """The one-shot pass, the continuous passes with their rounds, and the
    fresh window at 8× the decode size, over 46 blocks of 24,000 soft bits
    (continuous: passes at blocks 5, 10, ..., 40, where the window starts
    afresh, and 45), with recover_ts stubbed in both sessions to report the
    bits it got."""
    def stub(si, sq, fec_rate="1/2", max_packets=256):
        return b"", {"rotation": 0, "packets": 2 * len(si), "rsCorrected": 0, "rsFailed": 0}

    monkeypatch.setattr(jdd, "recover_ts", stub)
    monkeypatch.setattr(pdd, "recover_ts", stub)
    rng = np.random.default_rng(5)
    blocks = [tuple(rng.uniform(-1, 1, (2, 12_000)).astype(np.float32)) for _ in range(46)]
    for continuous in (False, True):
        expect = _jax_decode_reports(blocks, {"datvContinuous": continuous})
        dec, got = psession.DatvHostDecode(), None
        passes = 0
        for (si, sq), want in zip(blocks, expect):
            todo = dec.take(si, sq, continuous)
            if todo is not None:
                got = dec.decode(*todo, "1/2")
                passes += 1
                assert got.pop("hostSeconds") >= 0.0
            assert (got and {"datv": got}) == want
        assert passes == (9 if continuous else 1)
        assert got["rounds"] == 1 and got["packets"] == 120_000


def _datv_capture(tmp_path, fec_rate: str) -> str:
    """A DVB-S capture at 1 MS/s (4 samples a symbol): PAT, PMT and an H.264
    PES of programme 7, repeated, between random packets, as a .sdriq."""
    psi = tsdemux._section_packetize(0, tsdemux.make_pat({7: 0x120}), 0)
    psi += tsdemux._section_packetize(0x120, tsdemux.make_pmt(7, 0x300, {0x300: 0x1B}), 0)
    psi += tsdemux.make_pes_packets(0x300, bytes(range(200)) * 20, pts=12345)
    psi_arr = np.frombuffer(b"".join(psi), np.uint8).reshape(-1, dvbs.TS_PACKET)
    stream = np.concatenate([_packets(6, 1), np.tile(psi_arr, (3, 1)), _packets(40, 2)])
    x = _shape(_stream(stream, fec_rate), 4)
    path = str(tmp_path / f"datv{fec_rate.replace('/', '')}.sdriq")
    sdriq.write(path, x, sample_rate=1_000_000)
    return path


@pytest.mark.parametrize("publish_every,continuous", [(1, False), (3, False), (1, True),
                                                      (3, True)])
def test_session_datv_report_equals_jax_decode(tmp_path, publish_every, continuous):
    """A DeviceSet on the CPU plays the capture once (8 blocks of 65,536
    samples); its DATV report equals the JAX session's decode fed the same
    blocks' soft symbols (those of an RxPipeline with the session's block
    size): recover_ts's stats, the round and the TS demux summary with
    programme 7's H.264 stream."""
    path = _datv_capture(tmp_path, "1/2")
    settings = {"symbol_rate": 250_000.0, "datvContinuous": continuous}
    ds = psession.DeviceSet(0, CPU)
    ds.update_source({"kind": "filesource", "file_path": path, "run_blocks": 8,
                      "publish_every": publish_every})
    ds.add_channel(DATV, dict(settings))
    ds.start()
    deadline = time.time() + 120
    while ds.running and time.time() < deadline:
        time.sleep(0.05)
    assert not ds.running and not ds.error, ds.error
    assert ds.blocks_processed == 8 and ds.channels[0].data_blocks == 8
    got = dict(ds.channels[0].host_report["datv"])
    assert got.pop("hostSeconds") > 0.0
    pipe = peng.RxPipeline(peng.DeviceConfig(1_000_000.0), [peng.ChannelSpec(
        DATV, 0.0, {"symbol_rate": 250_000.0}, preg.requested_rate(DATV, settings))], CPU,
        block_size=1 << 16)
    mm = sdriq.open_mmap(path)[1]
    blocks = [(o["channels"][0]["data"]["soft_i"], o["channels"][0]["data"]["soft_q"])
              for _, o in pipe.run(lambda b, c: sdriq.read_block(mm, b * c, c), 8)]
    want = _jax_decode_reports(blocks, settings)[-1]["datv"]
    assert got == want
    assert got["rounds"] == (2 if continuous else 1)
    assert got["rsFailed"] == 0 and got["packets"] > 20
    progs = {p["program"]: p for p in got["ts"]["programs"]}
    assert progs[7]["streams"][0]["codec"] == "H.264 video"


def test_daemon_and_datv_settings_round_trip_a_preset(tmp_path):
    """A preset with a daemon source, a DATV channel in continuous mode and
    a daemon sink saves and loads (the port refused all three before)."""
    s = psession.Session(device=CPU, preset_dir=str(tmp_path))
    rx = s.add_device_set()
    rx.update_source({"kind": "daemonsource", "daemon_port": 9191, "sample_rate": 1e6})
    rx.add_channel(DATV, {"datvContinuous": True, "fec_rate": "3/4"})
    tx = s.add_device_set("tx")
    tx.update_source({"kind": "daemonsink", "daemon_port": 9192, "daemon_fec": 16,
                      "daemon_auto_fec": True})
    s.save_preset("g", "d")
    s.device_sets = []
    s.load_preset("g", "d")
    rx, tx = s.device_sets
    assert (rx.source.kind, rx.source.daemon_port) == ("daemonsource", 9191)
    assert rx.channels[0].settings == {"datvContinuous": True, "fec_rate": "3/4"}
    assert dataclasses.astuple(tx.sink)[-4:] == ("127.0.0.1", 9192, 16, True)
