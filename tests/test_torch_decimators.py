"""The port's ingest, K1 twin and decimators against the JAX package.

K1's plain twin (the CPU path of `flat_decimate`) is held against both
Pallas kernels run in interpret mode, exactly as tests/test_pallas.py runs
them, at that test's tolerance (2e-5). The streamed flat decimator, the
staged cascade and ingest are held against the JAX functions on the same
numpy inputs; the flat path also meets the compiled-reference golden at the
bound of tests/test_reference_golden.py. K1 itself against the twin is in
tests/test_torch_kernels_cuda.py (needs a card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdrangel_tpu.dsp import decimators as jdec
from sdrangel_tpu.dsp import types as jtypes
from sdrangel_tpu.pallas import decimator as pk
from sdrangel_tpu.runtime import corrections as jcorr
from sdrangel_tpu_torch.dsp import decimators as pdec
from sdrangel_tpu_torch.dsp import types as ptypes
from sdrangel_tpu_torch.kernels.flat_decimate import flat_decimate
from sdrangel_tpu_torch.runtime import corrections as pcorr
from torch_port_util import CPU, fit_snr, load_golden_iq, n, t

ATOL = 2e-5  # tests/test_pallas.py's tolerance for the fused decimator


def _raw(rng, count):
    return rng.integers(-8000, 8000, size=(count, 2), dtype=np.int16)


def _legs(log2):
    return t(pdec.flat_legs(log2))


@pytest.mark.parametrize("log2", [2, 6])
@pytest.mark.parametrize("form", ["vpu", "mxu"])
def test_twin_matches_pallas_kernels(log2, form):
    """HALO convention: the Pallas input raw[HALO − r·(t_leg−1):] is K1's ext."""
    rng = np.random.default_rng(5)
    size = 1 << 16
    raw = _raw(rng, size + pk.HALO)
    fused = pk.decimate_cascade_fused if form == "vpu" else pk.decimate_cascade_fused_mxu
    ref = np.asarray(fused(raw, log2_decim=log2, tile_out=size >> log2, interpret=True))
    ext = t(raw[pk.HALO - pdec.flat_tail_len(log2):])
    out = n(flat_decimate(ext, _legs(log2)))
    assert out.shape == (size >> log2, 2)
    np.testing.assert_allclose(out.T, ref, atol=ATOL)


def _complex_blocks(rng, n_blocks, size):
    x = rng.uniform(-0.5, 0.5, (n_blocks, size, 2)).astype(np.float32)
    return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)


@pytest.mark.parametrize("log2", [3, 6])
@pytest.mark.parametrize("fc_pos", ["cen", "inf", "sup"])
def test_decimate_flat_any_streams_like_jax(log2, fc_pos):
    rng = np.random.default_rng(20 + log2)
    blocks = _complex_blocks(rng, 3, 4 << 10)
    js = jdec.init_flat_state(log2)
    ps = pdec.init_flat_state(log2, CPU)
    for x in blocks:
        js, jy = jdec.decimate_flat_any(js, jnp.asarray(x), log2, fc_pos)
        ps, py = pdec.decimate_flat_any(ps, t(x), log2, fc_pos)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(n(ps.tail), np.asarray(js.tail), atol=1e-7)


@pytest.mark.parametrize("log2", [3, 6])
def test_fused_i16_path_streams_like_jax(log2):
    """decimate_flat_raw (int16 straight into K1, int16 tail) equals JAX
    ingest + decimate_flat_any over 3 blocks."""
    rng = np.random.default_rng(30 + log2)
    js = jdec.init_flat_state(log2)
    ps = pdec.init_flat_state(log2, CPU, raw=True)
    for _ in range(3):
        raw = _raw(rng, 4 << 10)
        js, jy = jdec.decimate_flat_any(
            js, jtypes.iq_raw_to_complex64(jnp.asarray(raw), "i16"), log2, "cen")
        ps, py = pdec.decimate_flat_raw(ps, t(raw), log2)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)
    tail = n(ps.tail).astype(np.float32) / 32768.0
    np.testing.assert_array_equal(tail[:, 0] + 1j * tail[:, 1], np.asarray(js.tail))


def test_complex_leg_twin_matches_rotated_cascade_oracle():
    """Complex legs on the modulated input equal the float64 rotated cascade."""
    rng = np.random.default_rng(9)
    x = _complex_blocks(rng, 1, 4 << 10)[0]
    ps, py = pdec.decimate_flat_any(pdec.init_flat_state(4, CPU), t(x), 4, "inf")
    np.testing.assert_allclose(n(py), pdec.decimate_reference_oracle(x, 4, "inf"), atol=ATOL)


@pytest.mark.parametrize("log2,fc_pos", [(2, "inf"), (3, "sup"), (1, "cen")])
def test_decimate_cascade_streams_like_jax(log2, fc_pos):
    rng = np.random.default_rng(40 + log2)
    js = jdec.init_state(log2)
    ps = pdec.init_state(log2, CPU)
    cascade = jax.jit(jdec.decimate_cascade, static_argnums=(2, 3))
    for x in _complex_blocks(rng, 2, 2048):
        js, jy = cascade(js, jnp.asarray(x), log2, fc_pos)
        ps, py = pdec.decimate_cascade(ps, t(x), log2, fc_pos)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)


@pytest.mark.parametrize("order", [48, 64])
def test_hb_decimate2_matches_jax(order):
    from sdrangel_tpu.dsp.hbfilter import hb_taps

    rng = np.random.default_rng(order)
    tail, x = _complex_blocks(rng, 1, order - 2)[0], _complex_blocks(rng, 1, 1024)[0]
    taps = hb_taps(order)
    jt, jy = jax.jit(jdec.hb_decimate2)(jnp.asarray(tail), jnp.asarray(x), jnp.asarray(taps))
    pt, py = pdec.hb_decimate2(t(tail), t(x), t(taps))
    np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)
    np.testing.assert_array_equal(n(pt), np.asarray(jt))


def test_flat_path_matches_reference_golden():
    """The port's flat ÷64 against the compiled reference cascade, at the
    bound of test_reference_golden.py (measured there 60.7..76.8 dB)."""
    x = load_golden_iq("decii_cen_l6_input")
    golden = load_golden_iq("decii_cen_l6")
    xx = x[63:]
    xx = xx[: len(xx) // 64 * 64].astype(np.complex64)
    _, y = pdec.decimate_flat(pdec.init_flat_state(6, CPU), t(xx), 6)
    snr, scale = fit_snr(golden, n(y), skip=128)
    assert snr > 57.0, f"snr {snr:.1f} dB"
    assert abs(abs(scale) - 16.0) < 0.16


@pytest.mark.parametrize("fmt", ["i16", "u8", "i8", "i12", "i24"])
def test_ingest_matches_jax(fmt):
    rng = np.random.default_rng(1)
    np_dtype = {"i16": np.int16, "u8": np.uint8, "i8": np.int8, "i12": np.int16,
                "i24": np.int32}[fmt]
    info = np.iinfo(np_dtype)
    raw = rng.integers(info.min, info.max, size=(1000, 2), endpoint=True).astype(np_dtype)
    np.testing.assert_array_equal(
        n(ptypes.iq_raw_to_complex64(t(raw), fmt)),
        np.asarray(jtypes.iq_raw_to_complex64(jnp.asarray(raw), fmt)))


def test_corrections_stream_like_jax():
    rng = np.random.default_rng(2)
    js, ps = jcorr.make_state(), pcorr.make_state(CPU)
    for _ in range(3):
        x = (0.3 * rng.standard_normal(4096) + 0.05
             + 1j * (0.25 * rng.standard_normal(4096) - 0.02)).astype(np.complex64)
        js, jy = jcorr.apply(js, jnp.asarray(x), True, True)
        ps, py = pcorr.apply(ps, t(x), True, True)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=1e-6)
    for a, b in zip(ps, js):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5)
