"""The port's NFM stages and the whole demodulator against the JAX package,
and against the compiled-reference nfm156 golden.

Every stage streams 2 blocks of the same numpy input through both packages.
Tolerances: linear stages 2e-5 absolute (f32 sums taken in another order);
the discriminator and squelch 1e-5 with identical open masks; the whole
demodulator ≥ 80 dB agreement with the JAX audio; the port alone > 58 dB
against the golden, test_reference_golden.py's bound for nfm156.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdrangel_tpu.channels import demod_nfm as jnfm
from sdrangel_tpu.dsp import firdesign as jfir
from sdrangel_tpu.dsp import movingavg as jmavg
from sdrangel_tpu.dsp import nco as jnco
from sdrangel_tpu.dsp import phasediscri as jdis
from sdrangel_tpu.dsp import resampler as jres
from sdrangel_tpu.dsp import scope as jscope
from sdrangel_tpu.dsp import spectrum as jspec
from sdrangel_tpu.dsp import squelch as jsq
from sdrangel_tpu_torch.channels import demod_nfm as pnfm
from sdrangel_tpu_torch.dsp import firdesign as pfir
from sdrangel_tpu_torch.dsp import movingavg as pmavg
from sdrangel_tpu_torch.dsp import nco as pnco
from sdrangel_tpu_torch.dsp import phasediscri as pdis
from sdrangel_tpu_torch.dsp import resampler as pres
from sdrangel_tpu_torch.dsp import scope as pscope
from sdrangel_tpu_torch.dsp import spectrum as pspec
from sdrangel_tpu_torch.dsp import squelch as psq
from torch_port_util import CPU, agreement_db, best_lag, load_golden, load_golden_iq, n, t

LINEAR_ATOL = 2e-5
NONLINEAR_ATOL = 1e-5


def _iq(rng, size, amp=0.5):
    x = rng.uniform(-amp, amp, (size, 2)).astype(np.float32)
    return (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)


def test_nco_mix_streams_like_jax():
    rng = np.random.default_rng(1)
    inc = jnco.freq_to_increment(-20_000.0, 156_250.0)
    js, ps = jnco.make_nco(), pnco.make_nco(CPU)
    for _ in range(2):
        x = _iq(rng, 160_000)
        js, jy = jnco.mix_block(js, jnp.asarray(x), jnp.asarray(inc))
        ps, py = pnco.mix_block(ps, t(x), inc)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=LINEAR_ATOL)
    assert int(ps.phase) == int(js.phase)


def test_resampler_625_192_streams_like_jax():
    rng = np.random.default_rng(2)
    jp = jres.make_plan(156_250.0, 48_000.0, 160_000, cutoff=12_500.0 / 2.2)
    pp = pres.make_plan(156_250.0, 48_000.0, 160_000, cutoff=12_500.0 / 2.2)
    js, ps = jres.init_state(jp), pres.init_state(pp, CPU)
    step = jax.jit(jres.resample_block, static_argnums=2)
    for _ in range(2):
        x = _iq(rng, 160_000)
        js, jy = step(js, jnp.asarray(x), jp)
        ps, py = pres.resample_block(ps, t(x), pp)
        assert py.shape == (49_152,)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=LINEAR_ATOL)
    np.testing.assert_array_equal(n(ps.tail), np.asarray(js.tail))


@pytest.mark.parametrize("approx", [False, True])
def test_discriminator_streams_like_jax(approx):
    rng = np.random.default_rng(3)
    js, ps = jdis.make_state(), pdis.make_state(CPU)
    for _ in range(2):
        # an FM-like phasor stream plus a few samples on the axes
        ph = np.cumsum(rng.uniform(-2.5, 2.5, 4096))
        x = (0.4 * np.exp(1j * ph)).astype(np.complex64)
        x[:4] = [0.3, -0.3, 0.3j, -0.3j]
        js, jd, jm = jdis.discriminator_delta(js, jnp.asarray(x), 4.8, approx=approx)
        ps, pd, pm = pdis.discriminator_delta(ps, t(x), 4.8, approx=approx)
        # demod is scaled by fm_scaling 4.8: compare the phase step itself
        np.testing.assert_allclose(n(pd) / 4.8, np.asarray(jd) / 4.8, atol=NONLINEAR_ATOL)
        np.testing.assert_allclose(n(pm), np.asarray(jm), atol=NONLINEAR_ATOL)


def test_moving_average_streams_like_jax():
    """Values in the range of magsq at the audio rate. The JAX form differences
    a block cumulative sum, whose f32 rounding grows with the block's running
    total; 4096-sample blocks keep it well under the tolerance. The port sums
    each window, so it is also held to a float64 oracle."""
    rng = np.random.default_rng(4)
    js, ps = jmavg.make_state(32), pmavg.make_state(32, CPU)
    hist = np.zeros(32)
    for _ in range(2):
        x = rng.uniform(0.0, 0.3, 4096).astype(np.float32)
        js, jy = jmavg.moving_average(js, jnp.asarray(x))
        ps, py = pmavg.moving_average(ps, t(x))
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=LINEAR_ATOL)
        ext = np.concatenate([hist, x.astype(np.float64)])
        oracle = np.convolve(ext, np.ones(32) / 32, mode="valid")[1:]
        np.testing.assert_allclose(n(py), oracle, atol=1e-6)
        hist = ext[-32:]


def test_squelch_counter_and_gate_stream_like_jax():
    rng = np.random.default_rng(5)
    gate = 240
    js, ps = jsq.make_state(gate), psq.make_state(gate, CPU)
    jgate = jax.jit(jsq.gate_block, static_argnums=3)
    for _ in range(2):
        # runs of open/closed long enough to saturate both ways
        open_cond = np.repeat(rng.random(40) < 0.5, 1229)[:49_152]
        audio = rng.uniform(-1, 1, 49_152).astype(np.float32)
        js, jg, jo = jgate(js, jnp.asarray(audio), jnp.asarray(open_cond), gate)
        ps, pg, po = psq.gate_block(ps, t(audio), t(open_cond), gate)
        np.testing.assert_array_equal(n(po), np.asarray(jo))
        np.testing.assert_allclose(n(pg), np.asarray(jg), atol=NONLINEAR_ATOL)
        assert float(ps.count) == float(js.count)


def test_fir_301_streams_like_jax():
    rng = np.random.default_rng(6)
    taps = jnfm.NFMConfig(channel_rate=48_000.0).bandpass_taps
    js, ps = jfir.make_state(len(taps)), pfir.make_state(len(taps), CPU)
    for _ in range(2):
        x = rng.uniform(-1, 1, 49_152).astype(np.float32)
        js, jy = jfir.fir_apply(js, jnp.asarray(x), jnp.asarray(taps))
        ps, py = pfir.fir_apply(ps, t(x), t(taps))
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=LINEAR_ATOL)


@pytest.mark.parametrize("opts", [
    {"averaging_mode": "none"}, {"averaging_mode": "moving"}, {"averaging_mode": "fixed"},
    {"averaging_mode": "moving", "overlap": 256}, {"linear": True},
    {"positive_only": True},
])
def test_spectrum_streams_like_jax(opts):
    """Display values within 1e-2 dB (1e-2 relative when linear) wherever the
    JAX bin is above −120 dB."""
    rng = np.random.default_rng(7)
    kw = dict(fft_size=1024, averaging_n=8, **opts)
    jc, pc = jspec.SpectrumConfig(**kw), pspec.SpectrumConfig(**kw)
    js, ps = jspec.make_state(jc), pspec.make_state(pc, CPU)
    tone = np.exp(2j * np.pi * 0.1 * np.arange(10_240)).astype(np.complex64)
    for _ in range(2):
        x = (_iq(rng, 10_240, 0.01) + 0.3 * tone).astype(np.complex64)
        js, jv = jspec.power_spectrum(js, jnp.asarray(x), jc)
        ps, pv = pspec.power_spectrum(ps, t(x), pc)
        jv, pv = np.asarray(jv), n(pv)
        if opts.get("linear"):
            np.testing.assert_allclose(pv, jv, rtol=1e-2, atol=1e-12)
        else:
            live = jv > -120.0
            np.testing.assert_allclose(pv[live], jv[live], atol=1e-2)


@pytest.mark.parametrize("kind", list(pscope.Projection))
def test_scope_projections_match_jax(kind):
    rng = np.random.default_rng(8)
    x = _iq(rng, 1024)
    np.testing.assert_allclose(
        n(pscope.project(t(x), kind)),
        np.asarray(jscope.project(jnp.asarray(x), jscope.Projection(kind.value))),
        atol=NONLINEAR_ATOL)


def _golden_chain(name, rate, offset, **extra):
    """A golden's input, and the JAX golden test's configuration over all of it."""
    x = (load_golden_iq(name + "_input") / 32768.0).astype(np.complex64)
    kw = dict(channel_rate=rate, input_offset=offset, audio_rate=48_000.0,
              rf_bandwidth=12_500.0, af_bandwidth=3_000.0, fm_deviation=2_000.0,
              squelch_db=-30.0, squelch_gate_ms=50.0, volume=1.0, **extra)
    p = jnfm.NFMConfig(channel_rate=rate, block_in=0).resampler_plan.block_in
    blk = len(x) // p * p
    return x[:blk], dict(kw, block_in=blk)


def test_nfm_process_matches_jax_on_nfm156():
    x, kw = _golden_chain("nfm156", 156_250.0, 20_000.0)
    jc, pc = jnfm.NFMConfig(**kw), pnfm.NFMConfig(**kw)
    _, jy = jax.jit(jnfm.process, static_argnums=2)(jnfm.make_state(jc), jnp.asarray(x), jc)
    _, py = pnfm.process(pnfm.make_state(pc, CPU), t(x), pc)
    jy = np.asarray(jy)
    assert np.any(jy != 0.0)
    assert agreement_db(jy, n(py)) >= 80.0


@pytest.mark.parametrize("name,rate,offset,approx,bound", [
    # test_reference_golden.py:259-305's cases and bounds, on the port: the
    # exact chain > 58 dB; with the reference's own atan2 approximation
    # near bit-parity (130 dB) except nfm156, which the reference's f32
    # resampler distance drift at q=192 caps (55 dB)
    ("nfm48", 48_000.0, 0.0, False, 58.0),
    ("nfm96", 96_000.0, 12_000.0, False, 58.0),
    ("nfm156", 156_250.0, 20_000.0, False, 58.0),
    ("nfm48", 48_000.0, 0.0, True, 130.0),
    ("nfm96", 96_000.0, 12_000.0, True, 130.0),
    ("nfm156", 156_250.0, 20_000.0, True, 55.0),
])
def test_nfm_process_meets_reference_golden(name, rate, offset, approx, bound):
    x, kw = _golden_chain(name, rate, offset, ref_atan2_approx=approx)
    cfg = pnfm.NFMConfig(**kw)
    _, audio = pnfm.process(pnfm.make_state(cfg, CPU), t(x), cfg)
    golden = load_golden(name + "_audio")
    lag, snr, scale = best_lag(golden.astype(np.float64), n(audio), range(-8, 9), skip=8000)
    assert snr > bound, f"{name}: snr {snr:.1f} dB (lag {lag}, scale {scale})"


def test_unported_squelch_modes_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pnfm.NFMConfig(channel_rate=48_000.0, ctcss_on=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pnfm.NFMConfig(channel_rate=48_000.0, delta_squelch=True)
