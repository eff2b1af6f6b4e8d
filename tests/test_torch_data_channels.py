"""The port's data channels against the JAX package: the Gardner symbol
synchronizer, the DSD front end, the channel analyzer, UDPSrc (every
format), the LoRa demodulator and the scope triggers, each streamed over 3
blocks with its state carried on the same seeded numpy input; the dsd96
goldens through the port's stages; the registry's data kinds against the
JAX registry; and an RxPipeline of all five data kinds and an NFM channel
against the JAX RxPipeline, with JAX's state handed over.

Tolerances:
- float outputs 2e-5 absolute (the Pallas kernel's own tolerance), LoRa's
  FFT magnitudes 2e-5 relative to their block's peak (the peak of 2^SF
  chips of amplitude 0.3 is ~150); the channel analyzer's dB power within
  1e-4 dB, its dB spectrum by `test_torch_engine._compare_spectrum`;
- integer outputs (dibits, LoRa symbols, squelch flags) equal;
- the squelch levels of DSD and UDPSrc sit far from the signal's power
  (−60 dB against about −10 dB): the port's moving average is a standing
  divergence of ~7e-5 from JAX's (ROADMAP.md §3), which would flip a gate
  set at the signal's own power;
- the dsd96 goldens at test_reference_golden.py:884-889's bounds (> 120 dB,
  scale within 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrangel_tpu.channels import chanalyzer as jca
from sdrangel_tpu.channels import demod_dsd as jdsd
from sdrangel_tpu.channels import demod_lora as jlora
from sdrangel_tpu.channels import registry as jreg
from sdrangel_tpu.channels import udpsrc as judp
from sdrangel_tpu.dsp import scope as jscope
from sdrangel_tpu.dsp import symsync as jsym
from sdrangel_tpu.runtime import engine as jeng
from sdrangel_tpu_torch.channels import chanalyzer as pca
from sdrangel_tpu_torch.channels import demod_dsd as pdsd
from sdrangel_tpu_torch.channels import demod_lora as plora
from sdrangel_tpu_torch.channels import dsdsync
from sdrangel_tpu_torch.channels import registry as preg
from sdrangel_tpu_torch.channels import udpsrc as pudp
from sdrangel_tpu_torch.dsp import movingavg as pmavg
from sdrangel_tpu_torch.dsp import nco as pnco
from sdrangel_tpu_torch.dsp import phasediscri as pdis
from sdrangel_tpu_torch.dsp import resampler as pres
from sdrangel_tpu_torch.dsp import scope as pscope
from sdrangel_tpu_torch.dsp import squelch as psq
from sdrangel_tpu_torch.dsp import symsync as psym
from sdrangel_tpu_torch.runtime import engine as peng
from test_torch_engine import _compare_spectrum
from torch_port_util import CPU, load_golden, n, real_best_lag, t

ATOL = 2e-5


def _fsk4(rng, n_sym: int, rate: float, deviation: float, offset: float = 0.0,
          amp: float = 0.5) -> tuple[np.ndarray, np.ndarray]:
    """Random dibits as rectangular 4FSK (DSDcc's levels ±1, ±3 → ±dev/3,
    ±dev) at `rate`, shifted by `offset`: (dibits, complex64 samples)."""
    dibits = rng.integers(0, 4, n_sym)
    m = (np.arange(int(n_sym * rate / 4800.0)) * 4800.0 / rate).astype(np.int64)
    freq = dsdsync.DIBIT_LEVELS[dibits].astype(np.float64)[m] / 3.0 * deviation + offset
    return dibits, (amp * np.exp(2j * np.pi * np.cumsum(freq) / rate)).astype(np.complex64)


def _tone(rate: float, n: int, freq: float, amp: float, fm_dev: float = 0.0,
          am_depth: float = 0.0) -> np.ndarray:
    """A carrier at `freq` with a 1 kHz tone as FM (fm_dev) or AM (am_depth)."""
    tt = np.arange(n) / rate
    phase = 2 * np.pi * freq * tt
    if fm_dev:
        phase = phase + fm_dev / 1000.0 * np.sin(2 * np.pi * 1000.0 * tt)
    env = amp * (1.0 + am_depth * np.sin(2 * np.pi * 1000.0 * tt))
    return (env * np.exp(1j * phase)).astype(np.complex64)


def _noisy(rng, x: np.ndarray, sigma: float = 0.01) -> np.ndarray:
    noise = rng.standard_normal((2, *x.shape)) * sigma
    return (x + noise[0] + 1j * noise[1]).astype(np.complex64)


def _close(p: torch.Tensor, j, atol=ATOL):
    np.testing.assert_allclose(n(p), np.asarray(j), atol=atol, rtol=0)


def _jit(process, cfg):
    """The JAX function under jit with its config bound, as the JAX engine
    runs it (one compile instead of an op-by-op dispatch)."""
    return jax.jit(lambda s, x: process(s, x, cfg))


# -- symsync -------------------------------------------------------------------------------

@pytest.mark.parametrize("delay", [0.0, 0.35, 0.8])
def test_symsync_streams_like_jax(delay):
    """A shaped 4-level stream at 10 samples a symbol, its symbol phase at
    `delay` of a symbol, with a slow clock offset: the symbols, μ, the
    frequency term and the tail over 3 blocks."""
    rng = np.random.default_rng(61)
    sps, n_sym = 10, 3 * 256
    levels = dsdsync.DIBIT_LEVELS[rng.integers(0, 4, n_sym + 4)].astype(np.float64) / 3.0
    pos = (np.arange(n_sym * sps) * (1.0 + 2e-4) - delay * sps) / sps
    shaped = np.interp(pos, np.arange(len(levels)) + 0.5, levels)
    x = (shaped + 0.02j * rng.standard_normal(len(shaped))).astype(np.complex64)
    js, ps = jsym.make_state(sps=sps), psym.make_state(CPU, sps=sps)
    for b in range(3):
        xb = x[b * 256 * sps:(b + 1) * 256 * sps]
        js, jy = jsym.synchronize_block(js, jnp.asarray(xb), sps)
        ps, py = psym.synchronize_block(ps, t(xb), sps)
        _close(py, jy)
        np.testing.assert_allclose(float(ps.mu), float(js.mu), atol=1e-5)
        np.testing.assert_allclose(float(ps.freq), float(js.freq), atol=1e-7)
        _close(ps.tail, js.tail, atol=0)


def test_symsync_bank_matches_single_channels_and_refuses_partial_symbols():
    """A (2,) bank (its own μ per channel, which the JAX function's gather
    cannot take) against two one-channel calls."""
    rng = np.random.default_rng(62)
    x = (rng.standard_normal((2, 3, 200)) + 1j * rng.standard_normal((2, 3, 200))).astype(
        np.complex64)
    bank = psym.make_state(CPU, (2,), sps=10)
    bank = bank._replace(mu=torch.tensor([10.0, 13.4]))
    singles = [psym.make_state(CPU, sps=10)._replace(mu=torch.tensor(m)) for m in (10.0, 13.4)]
    for b in range(3):
        bank, yb = psym.synchronize_block(bank, t(x[:, b]), 10)
        for c in range(2):
            singles[c], yc = psym.synchronize_block(singles[c], t(x[c, b]), 10)
            np.testing.assert_array_equal(n(yb[c]), n(yc))
            assert float(bank.mu[c]) == float(singles[c].mu)
    with pytest.raises(ValueError, match="multiple of sps"):
        psym.synchronize_block(psym.make_state(CPU), t(x[0, 0, :195]), 10)


# -- DSD -----------------------------------------------------------------------------------

_DSD_CASES = {
    "96k_offset": dict(channel_rate=96_000.0, input_offset=6000.0, fm_deviation=5400.0),
    "48k": dict(channel_rate=48_000.0),
    "78k125": dict(channel_rate=78_125.0, input_offset=-3000.0, fm_deviation=2700.0),
}


@pytest.mark.parametrize("case", sorted(_DSD_CASES))
def test_dsd_streams_like_jax(case):
    kw = _DSD_CASES[case]
    jc, pc = jdsd.DSDConfig(**kw), pdsd.DSDConfig(**kw)
    plan = pc.resampler_plan
    assert (plan.block_in, plan.block_out) == (jc.resampler_plan.block_in,
                                               jc.resampler_plan.block_out)
    assert plan.block_out % pc.sps == 0
    rng = np.random.default_rng(63)
    _, x = _fsk4(rng, int(3 * plan.block_in / kw["channel_rate"] * 4800) + 8,
                 kw["channel_rate"], pc.fm_deviation, kw.get("input_offset", 0.0))
    x = _noisy(rng, x)
    js, ps, jproc = jdsd.make_state(jc), pdsd.make_state(pc, CPU), _jit(jdsd.process, jc)
    for b in range(3):
        xb = x[b * plan.block_in:(b + 1) * plan.block_in]
        js, jo = jproc(js, jnp.asarray(xb))
        ps, po = pdsd.process(ps, t(xb), pc)
        _close(po.soft_symbols, jo.soft_symbols)
        # equal dibits wherever the soft value is clear of a slicer threshold
        # by more than the tolerance: the squelch's first 480 samples are
        # zeros, whose FFT-filtered ±1e-9 residue falls either side of 0
        soft = np.asarray(jo.soft_symbols)
        level = soft / max(1.5 * np.abs(soft).mean(), 1e-6)
        clear = (np.abs(soft) > ATOL) & (np.abs(np.abs(level) - 2.0 / 3.0) > 1e-3)
        np.testing.assert_array_equal(n(po.dibits)[clear], np.asarray(jo.dibits)[clear])
        assert clear.sum() >= (0.95 if b == 0 else 0.99) * len(soft)
        assert bool(po.squelch_open) == bool(jo.squelch_open)
        np.testing.assert_allclose(float(ps.sym.mu), float(js.sym.mu), atol=1e-5)
    assert bool(po.squelch_open)  # the gate is open on the signal
    assert po.dibits.dtype == torch.int32


def test_dsd96_goldens_through_the_port():
    """test_reference_golden.py:851-889 through the port's stages: the NCO,
    the resampler at rf/2.2, the discriminator, a 16-sample average and the
    480-sample gate, held to the same bounds."""
    flat = load_golden("dsd96_input")
    x = ((flat[0::2] / 32768.0) + 1j * (flat[1::2] / 32768.0)).astype(np.complex64)
    gd, gs = load_golden("dsd96_postdiscri"), load_golden("dsd96_sample")
    cfg = pdsd.DSDConfig(channel_rate=96000.0, input_offset=6000.0, rf_bandwidth=12500.0,
                         fm_deviation=5400.0, squelch_db=-40.0)
    plan = cfg.resampler_plan
    inc = pnco.freq_to_increment(-6000.0, 96000.0)
    st = (pnco.make_nco(CPU), pres.init_state(plan, CPU), pdis.make_state(CPU),
          pmavg.make_state(16, CPU), psq.make_state(480, CPU))
    dem_all, gat_all = [], []
    for b in range(len(x) // plan.block_in):
        n0, xm = pnco.mix_block(st[0], t(x[b * plan.block_in:(b + 1) * plan.block_in]), inc)
        r0, ci = pres.resample_block(st[1], xm, plan)
        d0, dem, magsq = pdis.discriminator_delta(st[2], ci, cfg.fm_scaling)
        m0, avg = pmavg.moving_average(st[3], magsq)
        s0, gated, _ = psq.gate_block(st[4], dem, avg >= 1e-4, 480)
        st = (n0, r0, d0, m0, s0)
        dem_all.append(n(dem))
        gat_all.append(n(gated))
    for golden, ours, what in ((gd, np.concatenate(dem_all), "post-discri"),
                               (gs, np.concatenate(gat_all), "gated sample")):
        lag, snr, s = real_best_lag(golden.astype(float), ours, range(-3, 4), 8000)
        assert snr > 120.0, f"dsd {what}: {snr:.1f} dB (lag {lag})"
        assert abs(s - 1.0) < 1e-3, f"dsd {what}: scale {s}"


# -- channel analyzer ------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["dsb", "usb", "lsb"])
def test_chanalyzer_streams_like_jax(mode):
    kw = dict(channel_rate=48_000.0, input_offset=1500.0, bandwidth=4000.0,
              ssb=mode != "dsb", usb=mode != "lsb")
    jc, pc = jca.ChanAnalyzerConfig(**kw), pca.ChanAnalyzerConfig(**kw)
    rng = np.random.default_rng(64)
    x = _noisy(rng, _tone(48_000.0, 3 * 4096, 2500.0, 0.3)
               + _tone(48_000.0, 3 * 4096, 500.0, 0.2))
    js, ps, jproc = jca.make_state(jc), pca.make_state(pc, CPU), _jit(jca.process, jc)
    for b in range(3):
        xb = x[b * 4096:(b + 1) * 4096]
        js, jo = jproc(js, jnp.asarray(xb))
        ps, po = pca.process(ps, t(xb), pc)
        _close(po.iq, jo.iq)
        np.testing.assert_allclose(float(po.channel_power_db), float(jo.channel_power_db),
                                   atol=1e-4)
        _compare_spectrum(np.asarray(jo.spectrum), n(po.spectrum))
    peak = float(np.asarray(js.spec.avg_sum).max())
    _close(ps.spec.avg_sum, js.spec.avg_sum, atol=ATOL * peak)


# -- UDPSrc --------------------------------------------------------------------------------

_UDP_CASES = {
    "iq": {}, "mono": {"fmt": "mono", "gain": 2.0}, "usb": {"fmt": "usb"},
    "lsb": {"fmt": "lsb", "rf_bandwidth": 6000.0}, "nfm": {"fmt": "nfm", "fm_deviation": 3000.0},
    "am": {"fmt": "am"}, "nfm_agc": {"fmt": "nfm", "agc_enable": True},
    "am_no_squelch": {"fmt": "am", "squelch_enabled": False, "gain": 0.5},
    "iq_squelch_shut": {"squelch_db": 0.0},
}


@pytest.mark.parametrize("case", sorted(_UDP_CASES))
def test_udpsrc_streams_like_jax(case):
    kw = dict(channel_rate=96_000.0, input_offset=-7000.0, block_in=8192, **_UDP_CASES[case])
    jc, pc = judp.UdpSrcConfig(**kw), pudp.UdpSrcConfig(**kw)
    rng = np.random.default_rng(65)
    fm = _tone(96_000.0, 3 * 8192, -7000.0, 0.3, fm_dev=3000.0)
    am = _tone(96_000.0, 3 * 8192, -7000.0, 0.3, am_depth=0.6)
    x = _noisy(rng, am if kw.get("fmt") == "am" else fm)
    js, ps = judp.make_state(jc), pudp.make_state(pc, CPU)
    # the JAX function's SSB formats do not trace under jit (fftfilt.run_ssb
    # reads its filter as numpy): they run op by op
    jproc = (lambda s_, x_: judp.process(s_, x_, jc)) if kw.get("fmt") in ("lsb", "usb") \
        else _jit(judp.process, jc)
    for b in range(3):
        xb = x[b * 8192:(b + 1) * 8192]
        js, jo = jproc(js, jnp.asarray(xb))
        ps, po = pudp.process(ps, t(xb), pc)
        _close(po.iq, jo.iq)
        _close(po.scalar, jo.scalar)
        np.testing.assert_allclose(float(po.power), float(jo.power), rtol=1e-5)
        assert bool(po.squelch_open) == bool(jo.squelch_open)
    assert bool(po.squelch_open) == (case != "iq_squelch_shut")


def test_udpsrc_overrides_stream_like_jax_and_refuse_unknown_formats():
    """offset_hz and squelch_db as per-block overrides (the f32 increment of
    JAX's traced path), the squelch shut by the override on the third block."""
    kw = dict(channel_rate=96_000.0, block_in=8192, fmt="nfm", fm_deviation=3000.0)
    jc, pc = judp.UdpSrcConfig(**kw), pudp.UdpSrcConfig(**kw)
    rng = np.random.default_rng(66)
    x = _noisy(rng, _tone(96_000.0, 3 * 8192, 4000.0, 0.3, fm_dev=3000.0))
    js, ps = judp.make_state(jc), pudp.make_state(pc, CPU)
    jproc = jax.jit(lambda s, v, o, q: judp.process(s, v, jc, offset_hz=o, squelch_db=q))
    for b, sq in enumerate((-60.0, -50.0, 0.0)):
        xb = x[b * 8192:(b + 1) * 8192]
        js, jo = jproc(js, jnp.asarray(xb), jnp.float32(4000.0), jnp.float32(sq))
        ps, po = pudp.process(ps, t(xb), pc, offset_hz=4000.0, squelch_db=sq)
        _close(po.scalar, jo.scalar)
        assert bool(po.squelch_open) == bool(jo.squelch_open) == (sq < 0.0)
    with pytest.raises(ValueError, match="udpsrc fmt"):
        pudp.process(ps, t(x[:8192]), pudp.UdpSrcConfig(**{**kw, "fmt": "iq24"}))


# -- LoRa ------------------------------------------------------------------------------------

def _lora_iq(symbols, rate: float, bw: float, sf: int, offset: float = 0.0,
             delay: float = 0.0, amp: float = 0.3) -> np.ndarray:
    """LoRa upchirps of `symbols` sampled at `rate` (any ratio to the chip
    rate), the frame start `delay` chips late, shifted by `offset`."""
    nb = 1 << sf
    tt = np.arange(int(len(symbols) * nb * rate / bw))
    chips = tt * bw / rate - delay
    m = np.clip(np.floor(chips / nb).astype(np.int64), 0, len(symbols) - 1)
    u = np.mod(chips - m * nb + np.asarray(symbols)[m], nb)
    phase = 2 * np.pi * (u * u / (2.0 * nb) - u / 2.0) + 2 * np.pi * offset * tt / rate
    return (amp * np.exp(1j * phase)).astype(np.complex64)


@pytest.mark.parametrize("sf,rate", [(7, 250_000.0), (9, 320_000.0)])
def test_lora_streams_like_jax(sf, rate):
    kw = dict(channel_rate=rate, bandwidth=125_000.0, spread_factor=sf, input_offset=3000.0)
    jc, pc = jlora.LoRaConfig(**kw), plora.LoRaConfig(**kw)
    plan = pc.resamp_plan
    assert plan.block_in == jc.resamp_plan.block_in and plan.block_out % pc.n_bins == 0
    rng = np.random.default_rng(67)
    n_sym = 3 * plan.block_out // pc.n_bins + 2
    syms = rng.integers(0, pc.n_bins, n_sym)
    x = _noisy(rng, _lora_iq(syms, rate, 125_000.0, sf, 3000.0, delay=0.4))
    js, ps, jproc = jlora.make_state(jc), plora.make_state(pc, CPU), _jit(jlora.process, jc)
    got = []
    for b in range(3):
        xb = x[b * plan.block_in:(b + 1) * plan.block_in]
        js, jo = jproc(js, jnp.asarray(xb))
        ps, po = plora.process(ps, t(xb), pc)
        np.testing.assert_array_equal(n(po.symbols), np.asarray(jo.symbols))
        scale = float(np.asarray(jo.magnitudes).max())
        _close(po.magnitudes, jo.magnitudes, atol=ATOL * scale)
        _close(po.snr_est, jo.snr_est, atol=ATOL * float(np.asarray(jo.snr_est).max()))
        got.append(n(po.symbols))
    got = np.concatenate(got)
    offs = (got[1:] - syms[1:len(got)]) % pc.n_bins
    assert np.mean(offs == np.bincount(offs).argmax()) >= 0.99  # one modal offset


def test_lora_symbol_chirps_equal_jax_and_partial_frames_refuse():
    cfg_j = jlora.LoRaConfig(channel_rate=250_000.0, spread_factor=8)
    cfg_p = plora.LoRaConfig(channel_rate=250_000.0, spread_factor=8)
    syms = np.random.default_rng(68).integers(0, 256, 9)
    np.testing.assert_array_equal(plora.make_symbol_chirps(syms, cfg_p),
                                  jlora.make_symbol_chirps(syms, cfg_j))
    np.testing.assert_array_equal(cfg_p.base_downchirp, cfg_j.base_downchirp)
    assert cfg_p.block_factor() == cfg_j.block_factor()
    odd = plora.LoRaConfig(channel_rate=250_000.0, spread_factor=8, block_in=4 * 300)
    with pytest.raises(ValueError, match="not a multiple of 2\\^SF"):
        plora.process(plora.make_state(odd, CPU), torch.zeros(1200, dtype=torch.complex64), odd)


# -- scope triggers ------------------------------------------------------------------------

_TRIGGERS = {
    "step_real": (jscope.Projection.REAL, 0.5, True),
    "falling_imag": (jscope.Projection.IMAG, -0.2, False),
    "magdb": (jscope.Projection.MAG_DB, -3.0, True),
    "phase": (jscope.Projection.PHASE, 0.25, True),
    "none": (jscope.Projection.REAL, 5.0, True),
}


@pytest.mark.parametrize("case", sorted(_TRIGGERS))
def test_trigger_and_capture_equal_jax(case):
    """find_trigger and capture on a (3, 512) batch, with pre-trigger
    samples reaching past the block's start on one row."""
    proj, level, edge = _TRIGGERS[case]
    rng = np.random.default_rng(69)
    x = (0.1 * (rng.standard_normal((3, 512)) + 1j * rng.standard_normal((3, 512)))).astype(
        np.complex64)
    x[0, 200:] += 1.0 - 0.5j
    x[1, 3:] += 0.8 + 0.6j
    x[2, 400:] += np.exp(1j * np.linspace(0, 3, 112)).astype(np.complex64)
    jc = jscope.TriggerCondition(projection=proj, level=level, positive_edge=edge)
    pc = pscope.TriggerCondition(projection=pscope.Projection(proj.value), level=level,
                                 positive_edge=edge)
    np.testing.assert_array_equal(n(pscope.find_trigger(t(x), pc)),
                                  np.asarray(jscope.find_trigger(jnp.asarray(x), jc)))
    ji, jtr = jscope.capture(jnp.asarray(x), jc, length=64, pre=8)
    pi, ptr = pscope.capture(t(x), pc, length=64, pre=8)
    np.testing.assert_array_equal(n(pi), np.asarray(ji))
    np.testing.assert_array_equal(n(ptr), np.asarray(jtr))


def test_trigger_holdoff_where_jax_raises():
    """With a holdoff the edge must stay across the level for `holdoff`
    samples. The JAX function pads its run count to T + 1 and raises on
    every block (ROADMAP.md §3); the port is held to a numpy oracle."""
    x = np.zeros(64, np.complex64)
    x[10:12] = 1.0  # a 2-sample glitch
    x[30:] = 1.0
    x[50] = 0.0
    cond = dict(level=0.5, holdoff=4)
    assert int(pscope.find_trigger(t(x), pscope.TriggerCondition(**cond))) == 30
    assert int(pscope.find_trigger(t(x[:34]), pscope.TriggerCondition(**cond))) == 30
    assert int(pscope.find_trigger(t(x[:33]), pscope.TriggerCondition(**cond))) == -1
    assert int(pscope.find_trigger(t(x[:3]), pscope.TriggerCondition(**cond))) == -1
    with pytest.raises(TypeError):
        jscope.find_trigger(jnp.asarray(x), jscope.TriggerCondition(**cond))


# -- the registry's data kinds ----------------------------------------------------------------

DATA_KINDS = ("sdrangel.channel.chanalyzer", "sdrangel.channel.lorademod",
              "sdrangel.channel.dsddemod", "sdrangel.channel.demodatv", "sdrangel.channel.udpsrc")


@pytest.mark.parametrize("uri", DATA_KINDS)
def test_data_kinds_register_as_in_jax(uri):
    pk, jk = preg.REGISTRY[uri], jreg.REGISTRY[uri]
    for field in ("output", "needs_fft_hop", "needs_audio_ratio", "data_keys",
                  "host_report_keys", "dynamic_fields"):
        assert getattr(pk, field) == getattr(jk, field), field
    assert preg.settings_schema(uri) == jreg.settings_schema(uri)
    assert preg.report_schema(uri) == jreg.report_schema(uri)
    for settings in ({}, {"bandwidth": 250_000.0, "spread_factor": 9, "rf_bandwidth": 3e6,
                          "standard": "pal525"}):
        assert preg.requested_rate(uri, settings) == jreg.requested_rate(uri, settings)
        for rate in (96_000.0, 320_000.0, 10e6):
            if jk.block_factor is not None:
                assert pk.block_factor(rate, settings) == jk.block_factor(rate, settings)


def test_datv_answers_with_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 6e"):
        preg.check_kind("sdrangel.channel.demoddatv")
    with pytest.raises(NotImplementedError, match="io/fec.py"):
        preg.validate_settings("sdrangel.channel.dsddemod", {"datvContinuous": True})
    with pytest.raises(KeyError):
        preg.check_kind("sdrangel.channeltx.modatv", "tx")


# -- RxPipeline: the five data kinds and an NFM channel ---------------------------------------

RATE = 1_536_000.0
_CHANNELS = [
    ("sdrangel.channel.lorademod", 60_000.0, {"spread_factor": 7}),
    ("sdrangel.channel.dsddemod", -40_000.0, {"fm_deviation": 2700.0}),
    ("sdrangel.channel.chanalyzer", 20_000.0, {}),
    ("sdrangel.channel.udpsrc", -90_000.0, {"fmt": "nfm", "fm_deviation": 3000.0}),
    ("sdrangel.channel.nfmdemod", 100_000.0, {"squelch_db": -60.0}),
    ("sdrangel.channel.demodatv", 0.0, {"rf_bandwidth": 500_000.0, "standard": "short",
                                        "lines": 96, "fps": 25.0}),
]


def _data_pipes():
    def specs(mod, reg):
        return [mod.ChannelSpec(u, o, s, reg.requested_rate(u, s)) for u, o, s in _CHANNELS]

    jp = jeng.RxPipeline(jeng.DeviceConfig(RATE, log2_decim=1), specs(jeng, jreg))
    pp = peng.RxPipeline(peng.DeviceConfig(RATE, log2_decim=1), specs(peng, preg), CPU)
    assert (pp.base_block, pp.device_block) == (jp.base_block, jp.device_block)
    assert [p.signs for p in pp.plans] == [p.signs for p in jp.plans]
    return jp, pp


def _data_capture(pipe, n_blocks: int) -> np.ndarray:
    """Every channel's signal at its offset on the device-rate stream,
    int16: LoRa chirps, DSD 4FSK, a tone, an FM tone twice and an AM video
    line pattern at the centre."""
    rng = np.random.default_rng(70)
    total = pipe.device_block * n_blocks
    lora = pipe.demod_cfgs[0]
    syms = rng.integers(0, lora.n_bins, int(total / RATE * 125_000.0 / lora.n_bins) + 2)
    x = _lora_iq(syms, RATE, 125_000.0, 7, 60_000.0, amp=0.1)[:total]
    x = x + _fsk4(rng, int(total / RATE * 4800) + 2, RATE, 2700.0, -40_000.0, 0.1)[1][:total]
    x = x + _tone(RATE, total, 20_000.0, 0.1)
    x = x + _tone(RATE, total, -90_000.0, 0.1, fm_dev=3000.0)
    x = x + _tone(RATE, total, 100_000.0, 0.1, fm_dev=3000.0)
    spl = int(RATE / 2400)
    line = np.where(np.arange(spl) < spl // 12, 0.0, np.linspace(0.3, 1.0, spl))
    x = x + 0.1 * np.tile(line, total // spl + 1)[:total]
    x = _noisy(rng, x, 0.002)
    raw = np.stack([np.round(x.real * 32767), np.round(x.imag * 32767)], -1).astype(np.int16)
    return raw.reshape(n_blocks, pipe.device_block, 2)


def test_data_pipeline_matches_jax_with_its_state_handed_over():
    """JAX runs the first block; its state, converted, carries the port
    through the next two, whose outputs, packed into one vector and
    unpacked on the host (int32 symbols and dibits, the bool squelch),
    match JAX's; the port's state maps back onto JAX's."""
    jp, pp = _data_pipes()
    raws = _data_capture(pp, 3)
    js, _ = jp._step(jp.init_state(), jnp.asarray(raws[0]))
    ps = pp.state_from_numpy(jax.tree.map(np.asarray, js))
    for raw in raws[1:]:
        js, jo = jp._step(js, jnp.asarray(raw))
        ps, flat = pp.step_packed(ps, t(raw))
        po = pp.to_host(flat)
        for c, (jc, pc) in enumerate(zip(jo["channels"], po["channels"])):
            np.testing.assert_allclose(pc["power"], float(jc["power"]), rtol=1e-5)
            if "audio" in jc:
                _close(torch.from_numpy(pc["audio"]), jc["audio"])
                continue
            assert sorted(pc["data"]) == sorted(preg.REGISTRY[_CHANNELS[c][0]].data_keys)
            for k, jv in jc["data"].items():
                jv, pv = np.asarray(jv), pc["data"][k]
                assert pv.dtype == jv.dtype and pv.shape == jv.shape, (k, pv.dtype, jv.dtype)
                if k == "spectrum":
                    _compare_spectrum(jv, pv)
                elif jv.dtype != np.float32:
                    np.testing.assert_array_equal(pv, jv, err_msg=k)
                else:
                    scale = max(1.0, float(np.abs(jv).max()))
                    np.testing.assert_allclose(pv, jv, atol=ATOL * scale, rtol=0, err_msg=k)
        assert po["channels"][3]["data"]["squelch"].dtype == np.bool_
        assert bool(po["channels"][3]["data"]["squelch"])
    back = pp.state_to_numpy(ps)
    jtree = jax.tree.map(np.asarray, js)
    for c in range(len(_CHANNELS)):
        assert back["demod"][c].nco.phase == jtree["demod"][c].nco.phase
    np.testing.assert_allclose(back["demod"][1].sym.mu, jtree["demod"][1].sym.mu, atol=1e-5)
    np.testing.assert_allclose(back["demod"][1].sym.tail, jtree["demod"][1].sym.tail, atol=ATOL)
    assert back["demod"][5].sync_phase == jtree["demod"][5].sync_phase


def _solve(mod, spec, rate, *extra):
    try:
        return mod.RxPipeline(mod.DeviceConfig(rate, log2_decim=1), [mod.ChannelSpec(*spec)],
                              *extra).base_block
    except ValueError as e:
        assert "device samples" in str(e)
        return "raises"


@pytest.mark.parametrize("uri,offset,settings", _CHANNELS)
def test_data_block_solver_equals_jax(uri, offset, settings):
    """The block solver takes the 48 kHz ratio only for the kinds that
    resample to 48 kHz, as the JAX solver does, and raises where it raises
    (UDPSrc at 10 MS/s ÷2 lands on 78.125 kHz)."""
    spec = (uri, offset, settings, preg.requested_rate(uri, settings))
    for rate in (RATE, 10e6, 10.24e6):
        assert _solve(peng, spec, rate, CPU) == _solve(jeng, spec, rate), (uri, rate)


def test_kinds_without_a_resampler_take_no_block_in():
    """The channel analyzer at 78.125 kHz (625/384 of 48 kHz): its block
    holds whole fftfilt hops and no 48 kHz numerator, and its config has no
    block_in to bind."""
    pp = peng.RxPipeline(peng.DeviceConfig(1.25e6, log2_decim=1),
                         [peng.ChannelSpec("sdrangel.channel.chanalyzer", 0.0, {}, 48_000.0)],
                         CPU, block_size=1)
    assert pp.plans[0].channel_rate == 78_125.0 and len(pp.plans[0].signs) == 3
    assert pp.base_block == 512 << 3
    assert not hasattr(pp.demod_cfgs[0], "block_in")


def test_udpsrc_ssb_formats_run_in_the_pipeline_where_jax_fails():
    """The JAX udpsrc's lsb/usb formats cannot run in the JAX RxPipeline
    (fftfilt.run_ssb reads its filter as numpy under jit: a
    TracerArrayConversionError, ROADMAP.md §3); the port's pipeline runs
    them, and its output equals the JAX function run op by op on the
    pipeline's own channel samples."""
    spec = ("sdrangel.channel.udpsrc", 10_000.0, {"fmt": "usb"}, 48_000.0)
    jp = jeng.RxPipeline(jeng.DeviceConfig(768_000.0, log2_decim=1), [jeng.ChannelSpec(*spec)])
    pp = peng.RxPipeline(peng.DeviceConfig(768_000.0, log2_decim=1), [peng.ChannelSpec(*spec)],
                         CPU)
    x = _noisy(np.random.default_rng(71), _tone(768_000.0, pp.device_block, 11_000.0, 0.3))
    raw = np.stack([np.round(x.real * 32767), np.round(x.imag * 32767)], -1).astype(np.int16)
    with pytest.raises(jax.errors.TracerArrayConversionError):
        jp._step(jp.init_state(), jnp.asarray(raw))
    state = pp.init_state()
    _, outs = pp.step(state, t(raw))
    scalar = n(outs["channels"][0]["data"]["scalar"])
    assert np.all(np.isfinite(scalar)) and np.abs(scalar).max() > 0.01
    # the same block through the port's stages up to the channel, then the
    # JAX function on those samples
    from sdrangel_tpu_torch.dsp import channelizer, decimators
    _, bb = decimators.decimate_flat_raw(state["dev_casc"], t(raw), 1)
    _, y = channelizer.channelize(state["chan"][0], bb, pp.plans[0])
    jc = judp.UdpSrcConfig(**{f: getattr(pp.demod_cfgs[0], f) for f in (
        "channel_rate", "input_offset", "block_in", "fmt")})
    _, jo = judp.process(judp.make_state(jc), jnp.asarray(n(y)), jc)
    _close(torch.from_numpy(scalar), jo.scalar)


_NO_JAX = """
import importlib, pkgutil, sys, time

class NoJax:
    # refuse jax and the JAX package: the port must need neither
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sdrangel_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, NoJax())
import sdrangel_tpu_torch
for mod in pkgutil.walk_packages(sdrangel_tpu_torch.__path__, "sdrangel_tpu_torch."):
    if mod.name != "sdrangel_tpu_torch.__main__":
        importlib.import_module(mod.name)
from sdrangel_tpu_torch.runtime.session import Session

ds = Session(device="cpu").add_device_set()
ds.update_source({"sample_rate": 192000.0, "carrier_freq": 20000.0, "run_blocks": 2})
ds.add_channel("sdrangel.channel.dsddemod", {"inputFrequencyOffset": 20000.0})
ds.add_channel("sdrangel.channel.lorademod", {})
ds.start()
while ds.running:
    time.sleep(0.02)
assert not ds.error and ds.blocks_processed == 2, ds.error
assert "syncCounts" in ds.channels[0].host_report["dsd"]
assert ds.channels[1].latest_data["symbols"].dtype.name == "int32"
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "sdrangel_tpu"))
assert not loaded, loaded
print("ok")
"""


def test_every_port_module_and_a_data_set_run_without_jax():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=repo, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": repo})
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
