"""The port's RxPipeline against the JAX RxPipeline, the state hand-over
between them, the precision pins, and the CLI with jax made unimportable.

Configuration of tests/test_e2e.py:43-75: 768 kS/s, ÷2, NFM at +100 kHz
(2 channelizer stages), 3 blocks. Audio agrees to ≥ 80 dB, squelch meters
are equal, the spectrum is within 1e-2 dB within 60 dB of its peak and
within 8 ε_f32 of the peak's amplitude at the deeper live bins (above
−120 dB; see `_compare_spectrum`), and the scope within 1e-5.
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
from sdrangel_tpu_torch.runtime import engine as peng
from torch_port_util import CPU, agreement_db, n, t, tone_snr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE = 768_000.0
NFM = "sdrangel.channel.nfmdemod"


def _pipes(offset=100_000.0, **frontend):
    chans = [(NFM, offset, {"squelch_db": -60.0})]
    jp = jeng.RxPipeline(jeng.DeviceConfig(RATE, log2_decim=1, **frontend),
                         [jeng.ChannelSpec(*c) for c in chans], block_size=32_768)
    pp = peng.RxPipeline(peng.DeviceConfig(RATE, log2_decim=1, **frontend),
                         [peng.ChannelSpec(*c) for c in chans], CPU, block_size=32_768)
    assert pp.device_block == jp.device_block
    assert [p.signs for p in pp.plans] == [p.signs for p in jp.plans]
    return jp, pp


def _blocks(pipe, n_blocks, carrier, **src):
    cfg = jsrc.TestSourceConfig(sample_rate=RATE, carrier_freq=carrier, modulation="fm",
                                tone_freq=1000.0, fm_deviation=5000.0, amplitude=0.4, **src)
    iq = jsrc.generate(cfg, pipe.device_block * n_blocks)
    raw = np.empty((len(iq), 2), np.int16)
    raw[:, 0] = np.clip(iq.real * 32768, -32768, 32767)
    raw[:, 1] = np.clip(iq.imag * 32768, -32768, 32767)
    return raw.reshape(n_blocks, pipe.device_block, 2)


def _compare_outs(j, p):
    ja, pa = np.asarray(j["channels"][0]["audio"]), n(p["channels"][0]["audio"])
    assert np.any(ja != 0.0), "squelch never opened: nothing to compare"
    assert agreement_db(ja, pa) >= 80.0
    assert bool(p["channels"][0]["squelch"]) == bool(j["channels"][0]["squelch"])
    np.testing.assert_allclose(float(p["channels"][0]["power"]),
                               float(j["channels"][0]["power"]), rtol=1e-5)
    _compare_spectrum(np.asarray(j["spectrum"]), n(p["spectrum"]))
    np.testing.assert_allclose(n(p["scope"]), np.asarray(j["scope"]), atol=1e-5)


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


@pytest.mark.parametrize("case", ["cen_i16", "inf", "dc_iq"])
def test_pipeline_matches_jax(case):
    _run_pipeline_case(case)


def test_pipeline_matches_jax_dc_iq_one_thread(one_thread):
    _run_pipeline_case("dc_iq")


def _run_pipeline_case(case):
    frontend, carrier, src = {}, 100_000.0, {}
    if case == "inf":
        frontend = {"fc_pos": "inf"}
        carrier = 100_000.0 - RATE / 4  # the inf band is centred at −fs/4
    elif case == "dc_iq":
        frontend = {"dc_correction": True, "iq_correction": True}
        src = {"dc_factor": 0.05, "phase_imbalance": 0.05}
    jp, pp = _pipes(**frontend)
    assert pp.fused_ingest == (case == "cen_i16")
    js, ps = jp.init_state(), pp.init_state()
    for raw in _blocks(pp, 3, carrier, **src):
        js, jo = jp._step(js, jnp.asarray(raw))
        ps, po = pp.step(ps, t(raw))
        _compare_outs(jo, po)


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
    squelch) act as in the JAX step."""
    jp, pp = _pipes()
    raws = _blocks(pp, 2, 100_000.0)
    dyn = pp.default_dyn()
    assert dyn == jp.default_dyn()
    loud = [dict(dyn[0], volume=0.5, squelch_db=-50.0)]
    js, ps = jp.init_state(), pp.init_state()
    for raw in raws:
        js, jo = jp._step(js, jnp.asarray(raw), loud)
        ps, po = pp.step(ps, t(raw), loud)
        _compare_outs(jo, po)
    ps, shut = pp.step(pp.init_state(), t(raws[0]), [dict(dyn[0], squelch_db=10.0)])
    assert not np.any(n(shut["channels"][0]["audio"]))
    assert not bool(shut["channels"][0]["squelch"])


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
