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
import pathlib
import re

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
from sdrangel_tpu_torch.kernels.flat_decimate import flat_decimate, flat_decimate_reference
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


# ---------------------------------------------------------------------------
# A numpy model of K1's schedule (kernels/csrc/flat_decimate.cu): which
# thread reads which window slot, leg and tap, where a staged row comes
# from, the ragged-tile mask and the fixed order of every sum. The kernel
# runs only on the card; the model runs its schedule here.
# ---------------------------------------------------------------------------

K1_SOURCE = (pathlib.Path(pdec.__file__).parent.parent / "kernels" / "csrc"
             / "flat_decimate.cu").read_text()
K1_WARPS, K1_OUT = 4, 16  # kWarps, kOut of the source


def _k1_geometry(r, t_leg):
    leg_lanes = min(r, 32)
    groups, leg_iters = 32 // leg_lanes, r // leg_lanes
    tile = K1_WARPS * groups * K1_OUT
    t_pad = -(-t_leg // K1_OUT) * K1_OUT
    rows = tile + t_pad - 1
    slots = rows + (rows - 1) // K1_OUT
    return leg_lanes, groups, leg_iters, tile, t_pad, rows, slots


def _k1_threads(r):
    """Per thread of a block: (warp, lane, leg lane jl, first output g0)."""
    leg_lanes, groups = min(r, 32), 32 // min(r, 32)
    tid = np.arange(K1_WARPS * 32)
    warp, lane = tid // 32, tid % 32
    jl, ol = lane % leg_lanes, lane // leg_lanes
    return warp, lane, jl, (warp * groups + ol) * K1_OUT


def _fma(a, b, c):
    """float32 fmaf, emulated: the float64 product is exact."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _k1_loads(r, t_leg, in_bytes, complex_legs):
    """Every shared-memory access of one tile, as (what, byte addresses of
    the 32 lanes of each warp, bytes per lane): the transposed leg writes,
    then per leg turn the window prologue, and per tap the new sample and
    the tap."""
    leg_lanes, groups, leg_iters, tile, t_pad, rows, slots = _k1_geometry(r, t_leg)
    tap_bytes = 8 if complex_legs else 4
    taps_base = slots * r * in_bytes
    warp, lane, jl, g0 = _k1_threads(r)
    for j0 in range(0, r, K1_WARPS):  # the legs' staging: warp w writes leg j0 + w
        for t0 in range(0, t_pad, 32):
            t = t0 + lane
            addr = taps_base + (t * (r + 1) + j0 + warp) * tap_bytes
            yield "leg write", np.where((t < t_pad) & (j0 + warp < r), addr, -1), tap_bytes
    base = g0 + g0 // K1_OUT
    for li in range(leg_iters):
        j = jl + 32 * li
        for u in range(K1_OUT - 1):
            yield "prologue", ((base + u) * r + j) * in_bytes, in_bytes
        for tc in range(0, t_pad, K1_OUT):
            for tt in range(K1_OUT):
                u = tt + K1_OUT - 1
                slot = base + tc + tc // K1_OUT + u + u // K1_OUT
                yield "sample", (slot * r + j) * in_bytes, in_bytes
                yield "tap", taps_base + ((tc + tt) * (r + 1) + j) * tap_bytes, tap_bytes


def _bank_ways(addr, width):
    """Most distinct 4-byte words of one bank in one pass of a warp's access:
    a pass is 32 lanes of 4 bytes or 16 lanes of 8 bytes; −1 marks an idle lane."""
    lanes_per_pass = 128 // width
    worst = 1
    for p in range(0, 32, lanes_per_pass):
        a = addr[p:p + lanes_per_pass]
        words = {int(x) // 4 + w for x in a[a >= 0] for w in range(width // 4)}
        banks = np.bincount([w % 32 for w in words], minlength=32) if words else [1]
        worst = max(worst, int(np.max(banks)))
    return worst


def _k1_model(tail, block, legs_re, legs_im, scale):
    """K1's arithmetic in the kernel's order. tail (tail_rows·r, 2) and
    block (block_rows·r, 2) stay apart; every slot that no row is staged
    into, and the legs' pitch column, hold NaN."""
    r, t_leg = legs_re.shape
    leg_lanes, groups, leg_iters, tile, t_pad, rows, slots = _k1_geometry(r, t_leg)
    tail_rows, block_rows = tail.shape[0] // r, block.shape[0] // r
    n_out = block_rows
    n_tiles = -(-n_out // tile)
    k_ = K1_OUT
    # staging: row w of tile b is plane row p = b·tile + w, at slot w + w/kOut
    x = np.full((n_tiles, slots, r, 2), np.nan, np.float32)
    p = np.arange(n_tiles)[:, None] * tile + np.arange(rows)
    tail_r = tail.astype(np.float32).reshape(tail_rows, r, 2)
    block_r = block.astype(np.float32).reshape(block_rows, r, 2)
    from_tail = p < tail_rows
    from_block = ~from_tail & (p - tail_rows < block_rows)
    staged = np.where(from_tail[..., None, None], tail_r[np.clip(p, 0, tail_rows - 1)],
                      np.where(from_block[..., None, None],
                               block_r[np.clip(p - tail_rows, 0, block_rows - 1)], 0.0))
    w = np.arange(rows)
    x[:, w + w // k_] = staged
    h = np.full((t_pad, r + 1, 2), np.nan, np.float32)
    h[:, :r] = 0.0
    h[:t_leg, :r, 0] = (legs_re.T * np.float32(scale)).astype(np.float32)
    h[:t_leg, :r, 1] = 0.0 if legs_im is None else (legs_im.T * np.float32(scale))
    # the threads: acc[b, tid, 2k + c]
    _, lane, jl, g0 = _k1_threads(r)
    acc = np.zeros((n_tiles, K1_WARPS * 32, 2 * k_), np.float32)
    base = g0 + g0 // k_
    for li in range(leg_iters):
        j = jl + 32 * li
        win = np.zeros((n_tiles, K1_WARPS * 32, k_, 2), np.float32)
        for u in range(k_ - 1):
            win[:, :, u] = x[:, base + u, j]
        for tc in range(0, t_pad, k_):
            for tt in range(k_):
                u = tt + k_ - 1
                win[:, :, u % k_] = x[:, base + tc + tc // k_ + u + u // k_, j]
                hr, hi = h[tc + tt, j, 0], h[tc + tt, j, 1]
                v = win[:, :, [(tt + k) % k_ for k in range(k_)]]
                y0, y1 = acc[..., 0::2], acc[..., 1::2]
                if legs_im is None:
                    acc[..., 0::2] = _fma(hr[:, None], v[..., 0], y0)
                    acc[..., 1::2] = _fma(hr[:, None], v[..., 1], y1)
                else:
                    acc[..., 0::2] = _fma(-hi[:, None], v[..., 1], _fma(hr[:, None], v[..., 0], y0))
                    acc[..., 1::2] = _fma(hi[:, None], v[..., 0], _fma(hr[:, None], v[..., 1], y1))
    # the sum over the leg lanes by recursive halving
    a = acc.reshape(n_tiles, K1_WARPS * groups, leg_lanes, 2 * k_)
    lanes = np.arange(leg_lanes)
    o, n = leg_lanes // 2, 2 * k_
    while o:
        half = n // 2
        upper = (lanes & o) != 0
        idx = np.where(upper[:, None], half + np.arange(half), np.arange(half))
        keep = np.take_along_axis(a, idx[None, None], axis=-1)
        recv = np.take_along_axis(a[:, :, lanes ^ o], idx[None, None], axis=-1)
        a = (keep + recv).astype(np.float32)
        o, n = o // 2, half
    # lane jl holds values v = kVals·jl + i of its group; v = 2·(output − g0) + plane
    vals = a.reshape(n_tiles, K1_WARPS * groups, 2 * k_)
    out = np.full(n_tiles * tile * 2, np.nan, np.float32)
    m = (np.arange(n_tiles)[:, None, None] * tile + np.arange(K1_WARPS * groups)[None, :, None]
         * k_ + np.arange(2 * k_)[None, None] // 2)
    keep_mask = m < n_out
    out[(2 * (m - np.arange(2 * k_) // 2) + np.arange(2 * k_))[keep_mask]] = vals[keep_mask]
    assert np.isnan(out[2 * n_out:]).all()  # the ragged tile's outputs are not stored
    return out[:2 * n_out].reshape(n_out, 2)


def test_k1_model_geometry_is_the_source():
    assert re.search(rf"constexpr int kWarps = {K1_WARPS};", K1_SOURCE)
    assert re.search(rf"constexpr int kOut = {K1_OUT};", K1_SOURCE)
    assert "r < 32 ? r : 32" in K1_SOURCE  # the leg lanes


@pytest.mark.parametrize("log2", [1, 2, 5, 6])
@pytest.mark.parametrize("form", ["i16 real", "f32 real", "f32 complex"])
def test_k1_schedule_model_matches_twin(log2, form):
    """The model of K1's schedule equals the twin within 2e-5 on a ragged
    n_out, with the tail's rows read through the tail pointer; three
    streamed blocks (output counts that are no multiple of the tile, so an
    output lands at another place in its tile) equal one long block bit for
    bit."""
    rng = np.random.default_rng(210 + log2)
    r = 1 << log2
    legs_re, legs_im, _ = pdec._device_legs(log2, "cen" if "real" in form else "inf", CPU)
    legs_re = n(legs_re)
    legs_im = None if legs_im is None else n(legs_im)
    tile = _k1_geometry(r, legs_re.shape[1])[3]
    sizes = (tile + 37, 2 * tile - 5, 11)
    tail_len = pdec.flat_tail_len(log2)
    if form.startswith("i16"):
        x = rng.integers(-32768, 32767, size=(tail_len + r * sum(sizes), 2), endpoint=True,
                         dtype=np.int16)
        scale = np.float32(1.0 / 32768.0)
    else:
        x = rng.uniform(-1.0, 1.0, (tail_len + r * sum(sizes), 2)).astype(np.float32)
        scale = np.float32(1.0)
    long = _k1_model(x[:tail_len], x[tail_len:], legs_re, legs_im, scale)
    twin = n(flat_decimate_reference(t(x[tail_len:]), t(legs_re),
                                     None if legs_im is None else t(legs_im), tail=t(x[:tail_len])))
    assert long.shape == twin.shape == (sum(sizes), 2)
    np.testing.assert_allclose(long, twin, atol=ATOL)
    parts, start = [], tail_len
    for size in sizes:
        block = x[start:start + r * size]
        parts.append(_k1_model(x[start - tail_len:start], block, legs_re, legs_im, scale))
        start += r * size
    np.testing.assert_array_equal(np.concatenate(parts), long)


@pytest.mark.parametrize("log2", [1, 2, 3, 4, 5, 6])
def test_k1_schedule_is_free_of_bank_conflicts(log2):
    """No two lanes of a warp read or write different words of one
    shared-memory bank in one pass, for int16 and float32 windows and real
    and complex legs, at every ratio."""
    r = 1 << log2
    t_leg = pdec.flat_legs(log2).shape[1]
    for in_bytes in (4, 8):
        for complex_legs in (False, True):
            for what, addr, width in _k1_loads(r, t_leg, in_bytes, complex_legs):
                for w in range(K1_WARPS):
                    ways = _bank_ways(addr[32 * w:32 * (w + 1)], width)
                    assert ways == 1, (what, in_bytes, complex_legs, w, ways)


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


@pytest.mark.parametrize("log2", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("dtype", ["i16", "f32"])
@pytest.mark.parametrize("fc_pos", ["cen", "inf", "sup"])
def test_k1_plain_two_pointer_form_equals_one_tensor_form(log2, dtype, fc_pos):
    """flat_decimate(x, legs, tail=t) is the one-tensor form on [t | x], bit
    for bit, at every ratio, for int16 and float32 input and real and
    complex legs; a tail that is not r·(t_leg − 1) pairs raises."""
    rng = np.random.default_rng(180 + log2)
    legs_re, legs_im, _ = pdec._device_legs(log2, fc_pos, CPU)
    tail_len = pdec.flat_tail_len(log2)
    shape = (tail_len + (77 << log2), 2)
    if dtype == "i16":
        ext = rng.integers(-32768, 32767, size=shape, endpoint=True, dtype=np.int16)
    else:
        ext = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    one = n(flat_decimate(t(ext), legs_re, legs_im))
    two = n(flat_decimate(t(ext[tail_len:]), legs_re, legs_im, tail=t(ext[:tail_len])))
    assert two.shape == (77, 2)
    np.testing.assert_array_equal(two, one)
    np.testing.assert_array_equal(
        n(flat_decimate_reference(t(ext[tail_len:]), legs_re, legs_im,
                                  tail=t(ext[:tail_len]))), one)
    with pytest.raises(ValueError):
        flat_decimate(t(ext[tail_len:]), legs_re, legs_im, tail=t(ext[1:tail_len]))


# block lengths (in units of 4·2^k) that put blocks shorter than the tail
# (2^k·(t_leg − 1) samples) between longer ones
_SHORT_BLOCKS = (3, 1, 40, 2, 5)


@pytest.mark.parametrize("log2", [3, 6])
@pytest.mark.parametrize("fc_pos", ["cen", "inf", "sup"])
def test_decimate_flat_any_streams_short_blocks_like_jax(log2, fc_pos):
    """Blocks shorter than the carried tail: the new tail is the end of
    [tail | block], not a clone of the block's end."""
    rng = np.random.default_rng(190 + log2)
    js = jdec.init_flat_state(log2)
    ps = pdec.init_flat_state(log2, CPU)
    for units in _SHORT_BLOCKS:
        x = _complex_blocks(rng, 1, units * (4 << log2))[0]
        js, jy = jdec.decimate_flat_any(js, jnp.asarray(x), log2, fc_pos)
        ps, py = pdec.decimate_flat_any(ps, t(x), log2, fc_pos)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(n(ps.tail), np.asarray(js.tail), atol=1e-7)


@pytest.mark.parametrize("log2", [3, 6])
def test_fused_i16_path_streams_short_blocks_like_jax(log2):
    rng = np.random.default_rng(200 + log2)
    js = jdec.init_flat_state(log2)
    ps = pdec.init_flat_state(log2, CPU, raw=True)
    for units in _SHORT_BLOCKS:
        raw = _raw(rng, units * (4 << log2))
        js, jy = jdec.decimate_flat_any(
            js, jtypes.iq_raw_to_complex64(jnp.asarray(raw), "i16"), log2, "cen")
        ps, py = pdec.decimate_flat_raw(ps, t(raw), log2)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)
    tail = n(ps.tail).astype(np.float32) / 32768.0
    np.testing.assert_array_equal(tail[:, 0] + 1j * tail[:, 1], np.asarray(js.tail))


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


@pytest.mark.parametrize("fc_pos", ["raw", "cen", "inf"])
def test_flat_decimators_take_strided_blocks(fc_pos):
    """A block that is a strided view streams like its contiguous copy: the
    flat decimators hand K1 a contiguous block."""
    rng = np.random.default_rng(210)
    log2 = 3
    raw = fc_pos == "raw"
    ps = pdec.init_flat_state(log2, CPU, raw=raw)
    pc = pdec.init_flat_state(log2, CPU, raw=raw)
    for _ in range(2):
        if raw:
            x = t(_raw(rng, 2 * (4 << 8)))[::2]
            step = lambda state, v: pdec.decimate_flat_raw(state, v, log2)
        else:
            x = t(_complex_blocks(rng, 1, 2 * (4 << 8))[0])[::2]
            step = lambda state, v: pdec.decimate_flat_any(state, v, log2, fc_pos)
        assert not x.is_contiguous()
        ps, y_strided = step(ps, x)
        pc, y_copy = step(pc, x.contiguous())
        np.testing.assert_array_equal(n(y_strided), n(y_copy))
    np.testing.assert_array_equal(n(ps.tail), n(pc.tail))


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
