"""The port's RxPipeline against the JAX RxPipeline, the state hand-over
between them, the precision pins, and the CLI with jax made unimportable.

Configuration of tests/test_e2e.py:43-75: 768 kS/s, ÷2, NFM at +100 kHz
(2 channelizer stages), 3 blocks. Audio agrees to ≥ 80 dB, squelch meters
are equal, the spectrum is within 1e-2 dB within 60 dB of its peak and
within 8 ε_f32 of the peak's amplitude at the deeper live bins (above
−120 dB; see `_compare_spectrum`), and the scope within 1e-5. The product
path's ÷64 runs at 3.072 MS/s (NFM at +10 kHz of a 48 kHz baseband) at
fc_pos sup and for the u8, i8, i12 and i24 captures, by the same bounds
(the scope's dB row as the amplitude it encodes, see `_compare_outs`).

The AM, SSB and WFM receivers on the same front end (alone, and NFM+AM+SSB
in one pipeline; WFM asks for 250 kHz): each channel's audio within 2e-5
of the JAX audio's block peak, its power and squelch meter as JAX's; the
block-size solver equal to the JAX engine's, raising where it raises.

Channel banks: 16 NFM channels on the nfm16 raster (two banks) and a mix
that groups by kind, plan depth and settings, each against one one-channel
pipeline a channel (a bank's rows within 1e-6 of the block's peak, a group
of one bit for bit, NCO phases exact, channelizer tails in the JAX layout
alike, the same packed layout); live
overrides reach their own row of a bank as in the JAX step.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrangel_tpu.io import testsource as jsrc
from sdrangel_tpu.runtime import engine as jeng
from sdrangel_tpu_torch.dsp.types import INPUT_FORMATS, complex_to_iq_raw
from sdrangel_tpu_torch.runtime import engine as peng
from torch_port_util import CPU, agreement_db, n, t, tone_snr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE = 768_000.0
NFM = "sdrangel.channel.nfmdemod"


def _pipes(offset=100_000.0, rate=RATE, log2_decim=1, block_size=32_768, extra=(),
           **frontend):
    """The JAX and the port's pipeline of NFM channels at `offset` and the
    `extra` offsets."""
    chans = [(NFM, f, {"squelch_db": -60.0}) for f in (offset, *extra)]
    jp = jeng.RxPipeline(jeng.DeviceConfig(rate, log2_decim=log2_decim, **frontend),
                         [jeng.ChannelSpec(*c) for c in chans], block_size=block_size)
    pp = peng.RxPipeline(peng.DeviceConfig(rate, log2_decim=log2_decim, **frontend),
                         [peng.ChannelSpec(*c) for c in chans], CPU, block_size=block_size)
    assert pp.device_block == jp.device_block
    assert [p.signs for p in pp.plans] == [p.signs for p in jp.plans]
    return jp, pp


def _blocks(pipe, n_blocks, carrier, fmt="i16", **src):
    cfg = jsrc.TestSourceConfig(sample_rate=pipe.frontend.sample_rate, carrier_freq=carrier,
                                modulation="fm", tone_freq=1000.0, fm_deviation=5000.0,
                                amplitude=0.4, **src)
    iq = jsrc.generate(cfg, pipe.device_block * n_blocks)
    if fmt != "i16":  # the capture an ADC of that width makes
        return n(complex_to_iq_raw(t(iq), fmt)).reshape(n_blocks, pipe.device_block, 2)
    raw = np.empty((len(iq), 2), np.int16)
    raw[:, 0] = np.clip(iq.real * 32768, -32768, 32767)
    raw[:, 1] = np.clip(iq.imag * 32768, -32768, 32767)
    return raw.reshape(n_blocks, pipe.device_block, 2)


def _compare_outs(j, p, scope_db_as_amplitude=False):
    """scope_db_as_amplitude: hold the scope's dB row as the amplitude it
    encodes (10^(dB/20)) at the same 1e-5 as the I and Q rows. At ÷64 the
    3907-tap composed filter sums in another order than JAX's legs, which
    leaves each baseband sample ~2.5e-6 of itself apart (I and Q within
    ~1.3e-6); the dB row shows that as 2–3e-5 dB."""
    ja, pa = np.asarray(j["channels"][0]["audio"]), n(p["channels"][0]["audio"])
    assert np.any(ja != 0.0), "squelch never opened: nothing to compare"
    assert agreement_db(ja, pa) >= 80.0
    assert bool(p["channels"][0]["squelch"]) == bool(j["channels"][0]["squelch"])
    np.testing.assert_allclose(float(p["channels"][0]["power"]),
                               float(j["channels"][0]["power"]), rtol=1e-5)
    _compare_spectrum(np.asarray(j["spectrum"]), n(p["spectrum"]))
    ps, js = n(p["scope"]), np.asarray(j["scope"])
    if scope_db_as_amplitude:  # rows: I, Q, 10·log10|x|²
        ps, js = ps.astype(np.float64), js.astype(np.float64)
        ps[2], js[2] = 10.0 ** (ps[2] / 20.0), 10.0 ** (js[2] / 20.0)
    np.testing.assert_allclose(ps, js, atol=1e-5)


EPS_F32 = float(np.finfo(np.float32).eps)


def _compare_spectrum(js, ps):
    """The dB spectrum, bound by f32 rounding relative to the block's peak.

    Bins within 60 dB of the peak agree within 1e-2 dB (measured ~1e-4).
    Deeper live bins (above −120 dB, down to ~98 dB under the peak) carry
    f32 rounding of sums whose terms are as large as the peak: the DC/IQ
    block means (`torch.mean`) are summed in an order that follows torch's
    intra-op thread split, and an error of a few ε_f32 of the peak
    amplitude there is ~0.04 dB. So they are held in amplitude relative to
    the peak: |√P_port − √P_jax| ≤ 8·ε_f32·√P_peak. With 1 thread the worst
    such bin is off by ~0.3 ε_f32 of the peak amplitude (0.018 dB at 98 dB
    under it), a margin of ~27×."""
    live = js > -120.0
    peak = js.max()
    near = live & (js >= peak - 60.0)
    np.testing.assert_allclose(ps[near], js[near], atol=1e-2)
    deep = live & ~near
    amp = lambda db: 10.0 ** ((db.astype(np.float64) - peak) / 20.0)  # √P / √P_peak
    np.testing.assert_allclose(amp(ps[deep]), amp(js[deep]), rtol=0, atol=8 * EPS_F32)


@pytest.fixture
def one_thread():
    """torch on one intra-op thread (the summation order that once failed)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


#: ÷64 at 3.072 MS/s: the product path's ratio on a 48 kHz baseband; the
#: NFM channel at +10 kHz, blocks of 524,288 device samples
RATE64, OFFSET64 = 3_072_000.0, 10_000.0


@pytest.mark.parametrize("case", ["cen_i16", "inf", "dc_iq", "sup", "u8", "i8", "i12", "i24"])
def test_pipeline_matches_jax(case):
    _run_pipeline_case(case)


def test_pipeline_matches_jax_dc_iq_one_thread(one_thread):
    _run_pipeline_case("dc_iq")


def _run_pipeline_case(case):
    frontend, carrier, src, fmt = {}, 100_000.0, {}, "i16"
    if case == "inf":
        frontend = {"fc_pos": "inf"}
        carrier = 100_000.0 - RATE / 4  # the inf band is centred at −fs/4
    elif case == "dc_iq":
        frontend = {"dc_correction": True, "iq_correction": True}
        src = {"dc_factor": 0.05, "phase_imbalance": 0.05}
    elif case == "sup":  # at ÷64 the sup band is centred at +fs/64
        frontend = dict(rate=RATE64, log2_decim=6, block_size=8192, fc_pos="sup")
        carrier = OFFSET64 + RATE64 / 64
    elif case in INPUT_FORMATS:
        frontend = dict(rate=RATE64, log2_decim=6, block_size=8192, input_format=case)
        carrier, fmt = OFFSET64, case
    offset = OFFSET64 if frontend.get("log2_decim") == 6 else 100_000.0
    jp, pp = _pipes(offset, **frontend)
    assert pp.fused_ingest == (case == "cen_i16")
    js, ps = jp.init_state(), pp.init_state()
    for raw in _blocks(pp, 3, carrier, fmt, **src):
        js, jo = jp._step(js, jnp.asarray(raw))
        ps, po = pp.step(ps, t(raw))
        _compare_outs(jo, po, scope_db_as_amplitude=frontend.get("log2_decim") == 6)


def test_state_handover_from_jax():
    """JAX runs 2 blocks; its state, converted, carries the port through a
    third that matches the JAX third block; the port's own 2-block state maps
    back onto the JAX state."""
    jp, pp = _pipes()
    raws = _blocks(pp, 3, 100_000.0)
    js, ps = jp.init_state(), pp.init_state()
    for raw in raws[:2]:
        js, _ = jp._step(js, jnp.asarray(raw))
        ps, _ = pp.step(ps, t(raw))
    jtree = jax.tree.map(np.asarray, js)

    back = pp.state_to_numpy(ps)
    np.testing.assert_array_equal(back["dev_casc"].tail, jtree["dev_casc"].tail)
    assert back["demod"][0].nco.phase == jtree["demod"][0].nco.phase
    np.testing.assert_allclose(back["demod"][0].resamp.tail, jtree["demod"][0].resamp.tail,
                               atol=2e-5)
    np.testing.assert_array_equal(back["demod"][0].squelch.count,
                                  jtree["demod"][0].squelch.count)

    handed = pp.state_from_numpy(jtree)
    assert handed["dev_casc"].tail.dtype == torch.int16
    _, jo = jp._step(js, jnp.asarray(raws[2]))
    _, po = pp.step(handed, t(raws[2]))
    _compare_outs(jo, po)


def test_run_drains_one_behind_and_matches_step():
    _, pp = _pipes()
    raws = _blocks(pp, 3, 100_000.0)
    got = list(pp.run(lambda b, count: raws[b], 3))
    assert [idx for idx, _ in got] == [0, 1, 2]
    ps = pp.init_state()
    for b, raw in enumerate(raws):
        ps, po = pp.step(ps, t(raw))
        np.testing.assert_array_equal(got[b][1]["channels"][0]["audio"],
                                      n(po["channels"][0]["audio"]))


def test_pipeline_pins_f32_precision():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    _pipes()
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        peng.RxPipeline(peng.DeviceConfig(RATE, log2_decim=1),
                        [peng.ChannelSpec(NFM, 100_000.0, {})], "cuda")


_NO_JAX = textwrap.dedent("""
    import runpy, sys

    class NoJax:
        # refuse jax and the JAX package (the port must need neither)
        def find_spec(self, name, path=None, target=None):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "sdrangel_tpu"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, NoJax())
    sys.argv = ["sdrangel_tpu_torch"] + sys.argv[1:]
    try:
        runpy.run_module("sdrangel_tpu_torch", run_name="__main__")
    except SystemExit as e:
        if e.code:
            raise
    assert not any(m.split(".")[0] in ("jax", "sdrangel_tpu") for m in sys.modules)
""")


def _cli(tmp_path, device):
    return subprocess.run(
        [sys.executable, "-c", _NO_JAX, "demod", "--device", device, "--test-fm", "1000",
         "--rate", "768000", "--log2-decim", "1", "--channel", "nfm:100000",
         "--squelch", "-60", "--seconds", "1.1", "--out", str(tmp_path / "a.wav")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO},
    )


def test_cli_demod_without_jax(tmp_path):
    from sdrangel_tpu_torch.io import wav

    proc = _cli(tmp_path, "cpu")
    assert proc.returncode == 0, proc.stderr
    data, fs = wav.read_wav(str(tmp_path / "a.wav"))
    audio = data[:, 0].astype(np.float64)[len(data) // 2:] / 32768.0
    assert tone_snr(audio, 1000.0, fs) > 25.0


def test_cli_cuda_fails_loudly_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the no-card refusal")
    proc = _cli(tmp_path, "cuda")
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not (tmp_path / "a.wav").exists()


def test_dyn_overrides_match_jax():
    """default_dyn reproduces the bound configs; live overrides (volume,
    squelch, offset) act as in the JAX step, each on its own row of the
    bank that the two NFM channels at one plan depth form."""
    jp, pp = _pipes(extra=(-100_000.0,))
    assert [g.idxs for g in pp.groups] == [(0, 1)]
    raws = np.clip(_blocks(pp, 2, 100_000.0).astype(np.int32)
                   + _blocks(pp, 2, -100_000.0), -32768, 32767).astype(np.int16)
    dyn = pp.default_dyn()
    assert dyn == jp.default_dyn()
    loud = [dict(dyn[0], volume=0.5, squelch_db=-50.0),
            dict(dyn[1], volume=2.0, offset_hz=dyn[1]["offset_hz"] + 500.0)]
    js, ps = jp.init_state(), pp.init_state()
    for raw in raws:
        js, jo = jp._step(js, jnp.asarray(raw), loud)
        ps, po = pp.step(ps, t(raw), loud)
        _compare_outs(jo, po)
        _compare_channels(jo, po)
    # an override one channel of the bank leaves out takes its bound value
    ps, shut = pp.step(pp.init_state(), t(raws[0]), [{"squelch_db": 10.0}, {}])
    assert not np.any(n(shut["channels"][0]["audio"]))
    assert not bool(shut["channels"][0]["squelch"])
    assert np.any(n(shut["channels"][1]["audio"])) and bool(shut["channels"][1]["squelch"])


# -- demod banks: the channels of one kind, depth and settings in one call ----

#: the nfm16 traffic's raster (portbench/traffic/nfm16.json), received at
#: 625 kHz (1.25 MS/s ÷2): banks of 12 channels at depth 3 and 4 at depth 2
NFM16 = [-187_500.0 + 25_000.0 * k for k in range(16)]


def _carriers(rate, size, carriers, seed):
    """NFM carriers (1 kHz, 5 kHz deviation; AM at 80 % for an AM channel)
    at (uri, offset) and noise 46 dB under one carrier, as an int16
    capture."""
    tt = np.arange(size) / rate
    iq = 0.002 * np.random.default_rng(seed).standard_normal((size, 2)) @ [1, 1j]
    for uri, f in carriers:
        if uri == AM:
            iq += 0.1 * (1.0 + 0.8 * np.sin(2 * np.pi * 1000.0 * tt)) * np.exp(2j * np.pi * f * tt)
        else:
            iq += 0.1 * np.exp(1j * (2 * np.pi * f * tt - 5.0 * np.cos(2 * np.pi * 1000.0 * tt)))
    return np.stack([np.round(iq.real * 32767), np.round(iq.imag * 32767)], -1).astype(np.int16)


def _against_one_channel_pipelines(frontend, specs, groups, carriers, n_blocks=3):
    """The pipeline of `specs` forms `groups` and, block by block, equals one
    one-channel pipeline a spec in spec order: a bank's rows within 1e-6 of
    the block's peak (power within 1e-6 relative, squelch equal), a group of
    one bit for bit, the NCO phases exact; its packed layout is that of the
    one-channel outputs in spec order. After the last block each channel's
    channelizer tails in the JAX layout equal its pipeline's, a bank's
    within 1e-6 of their peak. Returns the bank pipeline and its state."""
    pipe = peng.RxPipeline(frontend, specs, CPU, block_size=32_768)
    assert [g.idxs for g in pipe.groups] == groups
    assert pipe.n_banked == sum(len(g) for g in groups if len(g) > 1)
    ones = [peng.RxPipeline(frontend, [s], CPU, block_size=32_768) for s in specs]
    assert {p.device_block for p in ones} == {pipe.device_block}
    banked = {i for g in groups if len(g) > 1 for i in g}
    raws = _carriers(frontend.sample_rate, n_blocks * pipe.device_block, carriers, 5)
    state, states = pipe.init_state(), [p.init_state() for p in ones]
    opened = set()
    for raw in raws.reshape(n_blocks, pipe.device_block, 2):
        state, flat = pipe.step_packed(state, t(raw))
        got = peng.unpack_outs(n(flat), pipe.out_layout)
        want = []
        for i, one in enumerate(ones):
            states[i], o = one.step(states[i], t(raw))
            want.append(o["channels"][0])
            g, w = got["channels"][i], {k: n(v) for k, v in o["channels"][0].items()}
            assert list(g) == list(w)
            if i not in banked:
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
                continue
            peak = max(float(np.abs(w["audio"]).max()), 1e-30)
            assert np.abs(g["audio"] - w["audio"]).max() <= 1e-6 * peak, f"channel {i}"
            np.testing.assert_allclose(g["power"], w["power"], rtol=1e-6)
            assert bool(g["squelch"]) == bool(w["squelch"])
            opened |= {i} if bool(w["squelch"]) else set()
        _, layout = peng.pack_outs({"channels": want, "spectrum": o["spectrum"],
                                    "scope": o["scope"]})
        assert pipe.out_layout == layout
    assert opened, "no banked channel's squelch opened: nothing to compare"
    back = pipe.state_to_numpy(state)
    assert len(back["demod"]) == len(back["chan"]) == len(specs)
    for i, one in enumerate(ones):
        alone = one.state_to_numpy(states[i])
        assert back["demod"][i].nco.phase == alone["demod"][0].nco.phase
        assert len(back["chan"][i].tails) == len(alone["chan"][0].tails) > 0
        for got, want in zip(back["chan"][i].tails, alone["chan"][0].tails):
            if i not in banked:
                np.testing.assert_array_equal(got, want)
            else:
                assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), f"channel {i}"
    return pipe, state


def test_bank_matches_one_channel_pipelines():
    """The nfm16 raster: 16 NFM channels in two banks, carriers on every
    other channel, the rest squelched, against 16 one-channel pipelines
    over 3 blocks; a bank's channelizer tails are stacked one row a
    channel, and its state after the blocks round-trips through the JAX
    layout."""
    specs = [peng.ChannelSpec(NFM, f, {"squelch_db": -60.0}) for f in NFM16]
    pipe, state = _against_one_channel_pipelines(
        peng.DeviceConfig(1_250_000.0, log2_decim=1), specs,
        [(0, 1, 3, 4, 6, 7, 8, 9, 11, 12, 14, 15), (2, 5, 10, 13)],
        [(NFM, f) for f in NFM16[::2]])
    assert [tuple(s.shape) for s in state["chan"][0].tails] == [(12, 46)] * 3
    assert len(pipe.state_to_numpy(state)["chan"]) == 16
    handed = pipe.state_from_numpy(pipe.state_to_numpy(state))
    for a, b in zip(jax.tree.leaves(pipe.state_to_numpy(handed)),
                    jax.tree.leaves(pipe.state_to_numpy(state))):
        np.testing.assert_array_equal(a, b)


def test_channels_group_by_kind_depth_and_settings():
    """NFM at +100, −100 and +60 kHz (depth 2) bank; NFM at +24 kHz (depth
    3), NFM at +140 kHz with another squelch and an AM channel each run
    alone; the outputs come back in spec order."""
    sq = {"squelch_db": -60.0}
    specs = [peng.ChannelSpec(NFM, 100_000.0, sq), peng.ChannelSpec(AM, -150_000.0, sq),
             peng.ChannelSpec(NFM, -100_000.0, sq), peng.ChannelSpec(NFM, 24_000.0, sq),
             peng.ChannelSpec(NFM, 60_000.0, sq),
             peng.ChannelSpec(NFM, 140_000.0, {"squelch_db": -50.0})]
    _against_one_channel_pipelines(
        peng.DeviceConfig(RATE, log2_decim=1), specs, [(0, 2, 4), (1,), (3,), (5,)],
        [(s.uri, s.frequency_offset) for s in specs if s.frequency_offset != 60_000.0])


def test_settings_equal_under_eq_share_a_bank():
    """`registry.bank_groups` compares settings with ==: NFM channels whose
    squelch reads -60 and -60.0 bank, and the bank equals their one-channel
    pipelines; equal list-valued settings group too; a kind that is not
    bankable runs alone; a modulator always groups."""
    from sdrangel_tpu_torch.channels.registry import bank_groups

    cha, nfm_mod = "sdrangel.channel.chanalyzer", "sdrangel.channeltx.modnfm"
    assert bank_groups([
        (NFM, 2, {"squelch_db": -60}), (NFM, 2, {"squelch_db": -60.0}),
        (NFM, 3, {"squelch_db": -60}), (AM, 2, {"squelch_db": -60}), (cha, 2, {}), (cha, 2, {}),
        (NFM, 2, {"squelch_db": -60.0, "volume": 1.0}), (nfm_mod, 1, {"x": [1, 2]}),
        (NFM, 2, {"squelch_db": -60.0}), (nfm_mod, 1, {"x": [1.0, 2]}),
    ]) == [(0, 1, 8), (2,), (3,), (4,), (5,), (6,), (7, 9)]
    specs = [peng.ChannelSpec(NFM, 100_000.0, {"squelch_db": -60}),
             peng.ChannelSpec(NFM, -100_000.0, {"squelch_db": -60.0})]
    _against_one_channel_pipelines(peng.DeviceConfig(RATE, log2_decim=1), specs, [(0, 1)],
                                   [(s.uri, s.frequency_offset) for s in specs])


def test_cli_demod_sdriq_capture_and_info(tmp_path, capsys):
    from sdrangel_tpu.io import sdriq as jsdriq

    from sdrangel_tpu_torch.__main__ import main
    from sdrangel_tpu_torch.io import wav

    cfg = jsrc.TestSourceConfig(sample_rate=RATE, carrier_freq=-50_000.0, modulation="fm",
                                tone_freq=1000.0, fm_deviation=5000.0, amplitude=0.4)
    path = str(tmp_path / "cap.sdriq")
    jsdriq.write(path, jsrc.generate(cfg, 3 * 262_144), sample_rate=int(RATE))
    assert main(["info", "--in", path]) == 0
    assert "sample_rate:       768000 S/s" in capsys.readouterr().out
    out = str(tmp_path / "a.wav")
    assert main(["demod", "--device", "cpu", "--in", path, "--log2-decim", "1",
                 "--channel", "nfm:-50000", "--squelch", "-60", "--out", out]) == 0
    data, fs = wav.read_wav(out)
    assert tone_snr(data[:, 0].astype(np.float64)[len(data) // 2:] / 32768.0, 1000.0, fs) > 25.0


# -- the AM, SSB and WFM receivers on the pipeline ---------------------------

AM, SSB, WFM = ("sdrangel.channel.amdemod", "sdrangel.channel.ssbdemod",
                "sdrangel.channel.wfmdemod")
#: (uri, offset, settings, requested rate), and the signal each channel gets
MIXES = {
    "am": [(AM, 100_000.0, {"squelch_db": -60.0}, 48_000.0)],
    "ssb": [(SSB, -50_000.0, {}, 48_000.0)],
    "wfm": [(WFM, 0.0, {}, 250_000.0)],
    "nfm_am_ssb": [(NFM, 100_000.0, {"squelch_db": -60.0}, 48_000.0),
                   (AM, -100_000.0, {"squelch_db": -60.0}, 48_000.0),
                   (SSB, 50_000.0, {"usb": False}, 48_000.0)],
}


def _signal(uri, offset, settings, size):
    """AM (1 kHz, 80 %), an SSB tone 1 kHz into the sideband, wideband FM
    (75 kHz deviation) or NFM (5 kHz), at the channel's offset."""
    tt = np.arange(size) / RATE
    tone = np.sin(2 * np.pi * 1000.0 * tt)
    if uri == AM:
        return 0.3 * (1.0 + 0.8 * tone) * np.exp(2j * np.pi * offset * tt)
    if uri == SSB:
        side = 1.0 if settings.get("usb", True) else -1.0
        return 0.3 * np.exp(2j * np.pi * (offset + side * 1000.0) * tt)
    dev = 75_000.0 if uri == WFM else 5000.0
    return 0.3 * np.exp(1j * (2 * np.pi * offset * tt - dev / 1000.0 * np.cos(2 * np.pi * 1000.0 * tt)))


def _mix_pipes(chans, block_size=32_768):
    jp = jeng.RxPipeline(jeng.DeviceConfig(RATE, log2_decim=1),
                         [jeng.ChannelSpec(*c) for c in chans], block_size=block_size)
    pp = peng.RxPipeline(peng.DeviceConfig(RATE, log2_decim=1),
                         [peng.ChannelSpec(*c) for c in chans], CPU, block_size=block_size)
    assert pp.device_block == jp.device_block
    size = 3 * pp.device_block
    iq = sum(_signal(u, o, s, size) for u, o, s, _ in chans)
    iq = iq + 0.002 * np.random.default_rng(41).standard_normal((size, 2)) @ [1, 1j]
    raw = np.empty((size, 2), np.int16)
    raw[:, 0] = np.clip(iq.real * 32768, -32768, 32767)
    raw[:, 1] = np.clip(iq.imag * 32768, -32768, 32767)
    return jp, pp, raw.reshape(3, pp.device_block, 2)


def _compare_channels(j, p):
    """Each channel's audio within 2e-5 of the JAX audio's block peak (2e-5
    absolute below a peak of 1), its power within 1e-5 relative, its
    squelch meter equal. Returns each channel's peak."""
    peaks = []
    for c, (jc, pc) in enumerate(zip(j["channels"], p["channels"])):
        ja, pa = np.asarray(jc["audio"]), n(pc["audio"])
        assert pa.shape == ja.shape
        peaks.append(float(np.abs(ja).max()))
        err = np.abs(pa.astype(np.float64) - ja).max()
        assert err <= 2e-5 * max(1.0, np.abs(ja).max()), f"channel {c}: {err:.3e}"
        np.testing.assert_allclose(float(pc["power"]), float(jc["power"]), rtol=1e-5)
        assert ("squelch" in pc) == ("squelch" in jc)
        if "squelch" in jc:
            assert bool(pc["squelch"]) == bool(jc["squelch"])
    return peaks


@pytest.mark.parametrize("mix", list(MIXES))
def test_receivers_on_the_pipeline_match_jax(mix):
    jp, pp, raws = _mix_pipes(MIXES[mix])
    assert [p.signs for p in pp.plans] == [p.signs for p in jp.plans]
    js, ps = jp.init_state(), pp.init_state()
    for raw in raws:
        js, jo = jp._step(js, jnp.asarray(raw))
        ps, po = pp.step(ps, t(raw))
        peaks = _compare_channels(jo, po)
    # SSB's 6144-sample AGC delay line holds its first block back
    assert min(peaks) > 0.01, f"a channel stayed silent: peaks {peaks}"


def _leaves_by_name(port, jax_tree):
    """(port leaf, JAX leaf) pairs, matched by field name along the port's
    structure, as `state_from_numpy` matches them."""
    if hasattr(port, "_fields"):
        for f in port._fields:
            yield from _leaves_by_name(getattr(port, f), getattr(jax_tree, f))
    elif isinstance(port, (list, tuple)):
        assert len(port) == len(jax_tree)
        for p, j in zip(port, jax_tree):
            yield from _leaves_by_name(p, j)
    else:
        yield port, jax_tree


def test_receiver_state_handover_from_jax():
    """A JAX AM+SSB+WFM pipeline state after 2 blocks maps onto the port's
    and back bit for bit, field by field (AM's sync-mode fields, which the
    port does not carry, dropped), and carries the port through the third
    block."""
    jp, pp, raws = _mix_pipes(MIXES["am"] + MIXES["ssb"] + MIXES["wfm"])
    js = jp.init_state()
    for raw in raws[:2]:
        js, _ = jp._step(js, jnp.asarray(raw))
    jtree = jax.tree.map(np.asarray, js)
    handed = pp.state_from_numpy(jtree)
    back = pp.state_to_numpy(handed)
    pairs = list(_leaves_by_name(back["demod"], jtree["demod"]))
    assert len(pairs) == len(jax.tree.leaves(back["demod"]))
    for got, want in pairs:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    _, jo = jp._step(js, jnp.asarray(raws[2]))
    _, po = pp.step(handed, t(raws[2]))
    assert min(_compare_channels(jo, po)) > 0.01


AUDIO_48K = 48_000.0


@pytest.mark.parametrize("rate,log2,chans", [
    # the three rows of the slice's table and WFM at the default request
    (10e6, 6, [(AM, 20_000.0, {}, AUDIO_48K)]),
    (10e6, 6, [(SSB, -20_000.0, {}, AUDIO_48K)]),
    (10e6, 5, [(WFM, 0.0, {}, 250e3)]),
    (10e6, 6, [(WFM, 0.0, {}, AUDIO_48K)]),  # 40,960,000 device samples: raises
    (10e6, 6, [(NFM, 20_000.0, {}, AUDIO_48K)]),
    (RATE, 1, MIXES["nfm_am_ssb"]),
    (RATE, 1, [(AM, 100_000.0, {}, AUDIO_48K), (SSB, -50_000.0, {}, AUDIO_48K),
               (WFM, 0.0, {}, AUDIO_48K)]),
    (2.4e6, 3, [(SSB, 7_000.0, {}, AUDIO_48K), (WFM, 0.0, {}, 250e3)]),
    (1.92e6, 2, [(AM, -10_000.0, {}, AUDIO_48K), (SSB, 60_000.0, {}, AUDIO_48K)]),
])
def test_block_size_solver_equals_jax(rate, log2, chans):
    def solve(mod, **kw):
        try:
            pipe = mod.RxPipeline(mod.DeviceConfig(rate, log2_decim=log2),
                                  [mod.ChannelSpec(*c) for c in chans], **kw)
        except ValueError as e:
            assert "device samples" in str(e)
            return "raises"
        return pipe.base_block, pipe.device_block

    want = solve(jeng)
    assert solve(peng, device=CPU) == want
    if chans == [(WFM, 0.0, {}, AUDIO_48K)]:
        assert want == "raises"
    elif rate == 10e6:
        assert want[1] in (10_240_000, 20_480_000)


@pytest.mark.parametrize("rate,chan", [
    (RATE, (SSB, -50_000.0, {"fft_len": 2048}, AUDIO_48K)),
    (1.25e6, (WFM, 0.0, {"fft_len": 2048}, 250e3)),  # 312.5 kS/s, p/q = 625/96
])
def test_block_size_solver_takes_the_hop_from_fft_len(rate, chan):
    """A 2048-point fftfilt needs whole 1024-sample hops where it runs (SSB
    at the audio rate, WFM at the channel rate): the least block the solver
    gives holds them, and the pipeline steps on it."""
    pp = peng.RxPipeline(peng.DeviceConfig(rate, log2_decim=1), [peng.ChannelSpec(*chan)],
                         CPU, block_size=1)
    (cfg,) = pp.demod_cfgs
    assert cfg.fft_len == 2048
    fed = cfg.resampler_plan.block_out if chan[0] == SSB else cfg.block_in
    assert fed % 1024 == 0, fed
    raw = np.zeros((pp.device_block, 2), np.int16)
    raw[:, 0] = 1000
    _, po = pp.step(pp.init_state(), t(raw))
    assert np.all(np.isfinite(n(po["channels"][0]["audio"])))


def test_default_device_is_the_card():
    """RxPipeline and `demod` run on cuda unless the caller asks for the
    CPU; without a card that raises, with no fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the no-card refusal")
    from sdrangel_tpu_torch.__main__ import main

    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        peng.RxPipeline(peng.DeviceConfig(RATE, log2_decim=1),
                        [peng.ChannelSpec(AM, 100_000.0, {})])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["demod", "--test-am", "1000", "--channel", "am:100000", "--out", "unused.wav"])


def test_cli_demod_am_ssb_wfm_without_jax(tmp_path):
    """One `demod --device cpu` with an AM, an SSB and a WFM channel, jax
    and the JAX package unimportable: three WAVs, the AM tone above 25 dB."""
    from sdrangel_tpu_torch.io import wav

    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, "demod", "--device", "cpu", "--test-am", "1000",
         "--rate", "768000", "--log2-decim", "1", "--channel", "am:100000",
         "--channel", "ssb:-50000", "--channel", "wfm:0", "--squelch", "-60",
         "--seconds", "1.1", "--out", str(tmp_path / "a.wav")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    data, fs = wav.read_wav(str(tmp_path / "a.wav"))
    assert tone_snr(data[:, 0].astype(np.float64)[len(data) // 2:] / 32768.0, 1000.0, fs) > 25.0
    for c in (1, 2):
        extra, _ = wav.read_wav(str(tmp_path / f"a.ch{c}.wav"))
        assert len(extra) == len(data)
