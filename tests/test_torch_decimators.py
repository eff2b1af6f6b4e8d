"""The port's ingest, K1 twin and decimators against the JAX package.

K1's plain twin (the CPU path of `flat_decimate`) is held against both
Pallas kernels run in interpret mode, exactly as tests/test_pallas.py runs
them, at that test's tolerance (2e-5). The streamed flat decimator, the
staged cascade and ingest are held against the JAX functions on the same
numpy inputs; the flat path also meets the compiled-reference golden at the
bound of tests/test_reference_golden.py. K1 itself against the twin is in
tests/test_torch_kernels_cuda.py (needs a card).
"""

import functools

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
from sdrangel_tpu_torch.kernels import decimator as kdec
from sdrangel_tpu_torch.kernels.flat_decimate import flat_decimate
from sdrangel_tpu_torch.kernels.flat_decimate_tc import (
    flat_decimate_tc,
    flat_decimate_tc_reference,
)
from sdrangel_tpu_torch.runtime import corrections as pcorr
from torch_port_util import CPU, fit_snr, load_golden_iq, n, t

ATOL = 2e-5  # tests/test_pallas.py's tolerance for the fused decimator


def _raw(rng, count):
    return rng.integers(-8000, 8000, size=(count, 2), dtype=np.int16)


def _legs(log2):
    return t(pdec.flat_legs(log2))


@functools.lru_cache(maxsize=None)
def _pallas_case(form, log2, size, tile_out, seed):
    """(raw, Pallas kernel output in interpret mode), shared by the tests of
    K1's and K1-TC's plain versions so each Pallas run happens once."""
    raw = _raw(np.random.default_rng(seed), size + pk.HALO)
    fused = pk.decimate_cascade_fused if form == "vpu" else pk.decimate_cascade_fused_mxu
    return raw, np.asarray(fused(raw, log2_decim=log2, tile_out=tile_out, interpret=True))


@pytest.mark.parametrize("log2", [2, 6])
@pytest.mark.parametrize("form", ["vpu", "mxu"])
def test_twin_matches_pallas_kernels(log2, form):
    """HALO convention: the Pallas input raw[HALO − r·(t_leg−1):] is K1's ext."""
    size = 1 << 16
    raw, ref = _pallas_case(form, log2, size, size >> log2, 5)
    ext = t(raw[pk.HALO - pdec.flat_tail_len(log2):])
    out = n(flat_decimate(ext, _legs(log2)))
    assert out.shape == (size >> log2, 2)
    np.testing.assert_allclose(out.T, ref, atol=ATOL)


@pytest.mark.parametrize("log2,size,tile_out", [
    (2, 1 << 16, 1 << 14), (6, 1 << 16, 1 << 10),
    (6, 1 << 16, 1 << 8),  # the Pallas kernel over 4 tiles (test_pallas.py's multi-tile case)
])
@pytest.mark.parametrize("entry", ["tc_plain", "mxu_counterpart", "vpu_counterpart"])
def test_port_decimators_match_pallas_mxu(log2, size, tile_out, entry):
    """K1-TC's plain Z-form version, and the port's kernels/decimator.py
    counterparts under the JAX names, against the Pallas MXU kernel."""
    raw, ref = _pallas_case("mxu", log2, size, tile_out, 5 if tile_out == size >> log2 else 8)
    if entry == "tc_plain":
        out = n(flat_decimate_tc(t(raw[pk.HALO - pdec.flat_tail_len(log2):]), _legs(log2))).T
    elif entry == "mxu_counterpart":
        out = n(kdec.decimate_cascade_fused_mxu(t(raw), log2))
    else:
        out = n(kdec.decimate_cascade_fused(t(raw), log2))
    assert out.shape == ref.shape == (2, size >> log2)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("log2", [2, 6])
def test_reference_equivalent_matches_jax(log2):
    raw, _ = _pallas_case("mxu", log2, 1 << 16, 1 << (16 - log2), 5)
    np.testing.assert_allclose(n(kdec.reference_equivalent(raw, log2)),
                               pk.reference_equivalent(raw, log2), atol=ATOL)


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), nearest, ties away: cvt.rna."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("log2", [1, 2, 3, 4, 5, 6])
def test_tc_plain_two_pointer_form_equals_one_tensor_form(log2):
    """flat_decimate_tc(x, legs, tail=t) is the one-tensor form on [t | x],
    bit for bit, at every ratio."""
    rng = np.random.default_rng(80 + log2)
    legs = _legs(log2)
    tail_len = pdec.flat_tail_len(log2)
    raw = rng.integers(-32768, 32767, size=(tail_len + (300 << log2), 2), endpoint=True,
                       dtype=np.int16)
    one = n(flat_decimate_tc(t(raw), legs))
    two = n(flat_decimate_tc(t(raw[tail_len:]), legs, tail=t(raw[:tail_len])))
    assert two.shape == (300, 2)
    np.testing.assert_array_equal(two, one)
    np.testing.assert_array_equal(
        n(flat_decimate_tc_reference(t(raw[tail_len:]), legs, tail=t(raw[:tail_len]))), one)
    with pytest.raises(ValueError):  # a tail that is not r·(t_leg − 1) pairs
        flat_decimate_tc(t(raw[tail_len:]), legs, tail=t(raw[1:tail_len]))


@pytest.mark.parametrize("log2", [2, 6])
def test_tc_three_pass_split_keeps_f32_fidelity(log2):
    """K1-TC's arithmetic, emulated: int16 = 256·hi + lo, legs = TF32 hi +
    TF32 remainder, the passes hi·hi + hi·lo + lo·hi. The kernel folds the
    exact power-of-two scales into the B fragments — tf32(l)/128 and
    remainder/128 — and takes A as hi and lo/256; each product equals the
    unfolded one exactly. On full-scale random int16 it stays within 2e-5 of
    the exact float64 result, as the kernel's source note bounds it (7.5e-6
    worst case at ÷64)."""
    rng = np.random.default_rng(90 + log2)
    legs = pdec.flat_legs(log2)
    r, t_leg = legs.shape
    l_hi = _tf32(legs).astype(np.float64)
    l_lo = _tf32(legs - _tf32(legs)).astype(np.float64)
    x = rng.integers(-32768, 32767, size=(r * (t_leg - 1 + 512), 2), endpoint=True)
    planes = x.reshape(-1, r, 2)  # planes[w, j, c] = x[r·w + j, c]
    hi, lo = (planes >> 8) / 128.0, (planes & 0xFF) / 32768.0

    def zsum(p, l):  # y[m, c] = Σ_t Σ_j l[j, t]·p[m + t, j, c]
        z = np.einsum("wjc,jt->wtc", p, l)
        return sum(z[tt:tt + 512, tt] for tt in range(t_leg))

    exact = zsum(planes / 32768.0, legs.astype(np.float64))
    emulated = zsum(hi, l_hi + l_lo) + zsum(lo, l_hi)
    assert np.abs(emulated - exact).max() <= ATOL
    # the folded B sets and A values, each exact in TF32 and in float32
    b_hi, b_lo = np.float32(l_hi / 128.0), np.float32(l_lo / 128.0)
    a_hi, a_lo = planes >> 8, (planes & 0xFF) / 256.0
    for v in (b_hi, b_lo, np.float32(a_hi), np.float32(a_lo)):
        np.testing.assert_array_equal(_tf32(v), v)
    np.testing.assert_array_equal(np.float64(b_hi) * 128.0, l_hi)
    folded = zsum(a_hi, np.float64(b_hi) + np.float64(b_lo)) + zsum(a_lo, np.float64(b_hi))
    assert np.abs(folded - exact).max() <= ATOL
    np.testing.assert_allclose(folded, emulated, rtol=0, atol=1e-12)
    one_pass = zsum(_tf32(planes / 32768.0).astype(np.float64), l_hi)
    assert np.abs(one_pass - exact).max() > ATOL  # plain TF32 would not do


def _split_pair_model(w):
    """The kernel's split_pair on uint32 words (I low, Q high): the byte put
    into the low mantissa byte of 2^23 (hi, sign bit flipped) or 2^15 (lo),
    the offset subtracted in float32."""
    t = w ^ np.uint32(0x80008000)
    out = []
    for shift, magic, offset in ((8, 0x4B000000, 8388736.0), (0, 0x47000000, 32768.0),
                                 (24, 0x4B000000, 8388736.0), (16, 0x47000000, 32768.0)):
        bits = np.uint32(magic) | ((t >> np.uint32(shift)) & np.uint32(0xFF))
        out.append(bits.view(np.float32) - np.float32(offset))
    return out  # hi_i, lo_i/256, hi_q, lo_q/256


def test_tc_split_pair_model_is_exact():
    """Every int16 I and Q: the byte-permute split gives hi and lo/256 with
    256·hi + 256·(lo/256) = the sample."""
    v = np.arange(-32768, 32768, dtype=np.int64)
    i16 = v.astype(np.int16)
    words = (i16.view(np.uint16).astype(np.uint32)
             | (i16[::-1].view(np.uint16).astype(np.uint32) << np.uint32(16)))
    hi_i, lo_i, hi_q, lo_q = _split_pair_model(words)
    np.testing.assert_array_equal(hi_i, v >> 8)
    np.testing.assert_array_equal(lo_i * 256.0, v & 0xFF)
    np.testing.assert_array_equal(256.0 * hi_q + 256.0 * lo_q, v[::-1])


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
