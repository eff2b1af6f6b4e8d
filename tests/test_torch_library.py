"""The port's library remainder against the JAX package's.

- `decimate_flat_iq` (the layout-native flat ÷2^k, one K1 call on the block
  and its tail): streamed over 3 blocks against JAX's NWC conv within 2e-5,
  JAX's state handed over mid-stream, unbatched and batched, short blocks
  too; equal to `decimate_flat` on the same samples as complex64.
- `fftcorr`: cross- and auto-correlation streamed over 3 blocks against
  JAX's within 2e-5 relative, the state handed over both ways.
- `hbfilter.design_halfband` / `hb_poly_even_odd` and the `types` helpers
  equal JAX's; `registry.get_demod` answers for every kind.
- The native .sdriq loader (native/sdriq_loader.cc built with g++ into the
  port's build directory): its reads equal `sdriq.read_block` on 16- and
  24-bit captures, wrapped reads included.
"""

from __future__ import annotations

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrangel_tpu.channels import registry as jregistry
from sdrangel_tpu.dsp import decimators as jdec
from sdrangel_tpu.dsp import fftcorr as jfftcorr
from sdrangel_tpu.dsp import hbfilter as jhb
from sdrangel_tpu.dsp import types as jtypes
from sdrangel_tpu_torch.channels import registry as pregistry
from sdrangel_tpu_torch.dsp import decimators as pdec
from sdrangel_tpu_torch.dsp import fftcorr as pfftcorr
from sdrangel_tpu_torch.dsp import hbfilter as phb
from sdrangel_tpu_torch.dsp import types as ptypes
from sdrangel_tpu_torch.io import native, sdriq
from torch_port_util import CPU, n, t

ATOL = 2e-5


def _iq_blocks(rng, n_blocks: int, size: int, batch=()) -> np.ndarray:
    return rng.uniform(-0.9, 0.9, (n_blocks, *batch, size, 2)).astype(np.float32)


@pytest.mark.parametrize("log2", [1, 3, 6])
def test_decimate_flat_iq_streams_like_jax(log2):
    rng = np.random.default_rng(300 + log2)
    blocks = _iq_blocks(rng, 3, 4 << 10)
    js = jdec.init_flat_iq_state(log2)
    for k, x in enumerate(blocks):
        js, jy = jdec.decimate_flat_iq(js, jnp.asarray(x), log2)
        if k == 0:  # JAX's state handed over after the first block
            ps = pdec.flat_iq_state_from_numpy(np.asarray(js.tail), CPU)
            continue
        ps, py = pdec.decimate_flat_iq(ps, t(x), log2)
        assert py.shape == (x.shape[0] >> log2, 2) and py.dtype == torch.float32
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)
    np.testing.assert_array_equal(pdec.flat_iq_state_to_numpy(ps), np.asarray(js.tail))


@pytest.mark.parametrize("log2", [3, 6])
def test_decimate_flat_iq_batched_and_short_blocks_like_jax(log2):
    """A (2,)-batch, and blocks shorter than the carried tail between
    longer ones, from zero state."""
    rng = np.random.default_rng(310 + log2)
    js = jdec.init_flat_iq_state(log2, (2,))
    ps = pdec.init_flat_iq_state(log2, CPU, (2,))
    assert tuple(ps.tail.shape) == js.tail.shape
    for units in (3, 1, 40, 2):
        x = _iq_blocks(rng, 1, units << log2, (2,))[0]
        js, jy = jdec.decimate_flat_iq(js, jnp.asarray(x), log2)
        ps, py = pdec.decimate_flat_iq(ps, t(x), log2)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)
    np.testing.assert_array_equal(n(ps.tail), np.asarray(js.tail))


@pytest.mark.parametrize("log2", [2, 6])
def test_decimate_flat_iq_equals_decimate_flat(log2):
    """The same samples as (T, 2) float32 and as complex64 (decimate_flat):
    one K1 plain-version call each, equal to f32 rounding, 3 blocks."""
    rng = np.random.default_rng(320 + log2)
    si, sc = pdec.init_flat_iq_state(log2, CPU), pdec.init_flat_state(log2, CPU)
    for x in _iq_blocks(rng, 3, 8 << 10):
        si, yi = pdec.decimate_flat_iq(si, t(x), log2)
        sc, yc = pdec.decimate_flat(sc, torch.view_as_complex(t(x)), log2)
        np.testing.assert_allclose(n(yi), n(torch.view_as_real(yc)), atol=1e-6)
    with pytest.raises(TypeError):
        pdec.decimate_flat_iq(si, t(x).to(torch.float64), log2)
    s0, y0 = pdec.decimate_flat_iq(si, t(x), 0)
    assert s0 is si and y0.shape == x.shape


@pytest.mark.parametrize("fft_size", [64, 1024])
def test_fftcorr_streams_like_jax(fft_size):
    rng = np.random.default_rng(330)
    hop = fft_size // 2
    js = jfftcorr.make_state(fft_size, (2,))
    ps = pfftcorr.make_state(fft_size, (2,), CPU)
    for k in range(3):
        a = (rng.standard_normal((2, 4 * hop)) + 1j * rng.standard_normal((2, 4 * hop))
             ).astype(np.complex64)
        b = (rng.standard_normal((2, 4 * hop)) + 1j * rng.standard_normal((2, 4 * hop))
             ).astype(np.complex64)
        js, jc = jfftcorr.correlate_block(js, jnp.asarray(a), jnp.asarray(b), fft_size)
        ps, pc = pfftcorr.correlate_block(ps, t(a), t(b), fft_size)
        jc = np.asarray(jc)
        assert pc.shape == jc.shape == (2, 4, fft_size) and pc.dtype == torch.complex64
        np.testing.assert_allclose(n(pc), jc, atol=ATOL * np.abs(jc).max())
        if k == 0:  # hand the states over both ways
            ps = pfftcorr.state_from_numpy(jfftcorr.FftCorrState(*map(np.asarray, js)), CPU)
            js = jfftcorr.FftCorrState(*map(jnp.asarray, pfftcorr.state_to_numpy(ps)))
    _, pa = pfftcorr.autocorrelate_block(ps, t(a), fft_size)
    _, ja = jfftcorr.autocorrelate_block(js, jnp.asarray(a), fft_size)
    np.testing.assert_allclose(n(pa), np.asarray(ja), atol=ATOL * np.abs(np.asarray(ja)).max())
    with pytest.raises(ValueError):
        pfftcorr.correlate_block(ps, t(a[:, 1:]), t(b[:, 1:]), fft_size)


@pytest.mark.parametrize("order", [16, 32, 48, 64, 96, 128])
def test_halfband_designers_equal_jax(order):
    for beta in (6.0, 9.0):
        np.testing.assert_array_equal(phb.design_halfband(order, beta),
                                      jhb.design_halfband(order, beta))
    if order in phb.HB_COEFFS:  # the orders the port's paths use: 48, 64, 96
        for got, want in zip(phb.hb_poly_even_odd(order), jhb.hb_poly_even_odd(order)):
            np.testing.assert_array_equal(got, want)


def test_types_helpers_equal_jax():
    rng = np.random.default_rng(340)
    raw = rng.integers(-32768, 32767, (4, 100, 2), endpoint=True, dtype=np.int16)
    want = np.asarray(jtypes.iq_int16_to_complex64(jnp.asarray(raw)))
    np.testing.assert_array_equal(n(ptypes.iq_int16_to_complex64(t(raw))), want)
    np.testing.assert_array_equal(n(ptypes.iq_int16_to_complex64(t(raw.reshape(4, -1)))), want)
    x = (rng.uniform(-1.2, 1.2, 300) + 1j * rng.uniform(-1.2, 1.2, 300)).astype(np.complex64)
    np.testing.assert_array_equal(n(ptypes.complex64_to_iq_int16(t(x))),
                                  np.asarray(jtypes.complex64_to_iq_int16(jnp.asarray(x))))
    audio = rng.uniform(-1.5, 1.5, 500).astype(np.float32)
    np.testing.assert_array_equal(n(ptypes.audio_float_to_int16(t(audio))),
                                  np.asarray(jtypes.audio_float_to_int16(jnp.asarray(audio))))
    np.testing.assert_array_equal(ptypes.np_tone(1000.0, 48000.0, 256, 0.3, 0.7),
                                  jtypes.np_tone(1000.0, 48000.0, 256, 0.3, 0.7))


def test_get_demod_answers_for_every_kind():
    assert set(pregistry.REGISTRY) == set(jregistry.REGISTRY)
    for uri in pregistry.REGISTRY:
        assert pregistry.get_demod(uri) is pregistry.REGISTRY[uri]
    with pytest.raises(KeyError):
        pregistry.get_demod("sdrangel.channel.nosuchkind")


@pytest.fixture()
def loader():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed here: the native loader cannot be built")
    assert native.available(), "g++ is installed but the native loader did not build"
    path = native.library_path()
    assert path.startswith(native.BUILD_DIR) and not path.endswith("native/libsdriq.so")
    return native


@pytest.mark.parametrize("sample_size", [16, 24])
def test_native_loader_reads_equal_read_block(loader, tmp_path, sample_size):
    rng = np.random.default_rng(350)
    iq = (rng.uniform(-0.9, 0.9, 5000) + 1j * rng.uniform(-0.9, 0.9, 5000)).astype(np.complex64)
    path = str(tmp_path / f"cap{sample_size}.sdriq")
    sdriq.write(path, iq, sample_rate=96000, center_frequency=145_000_000,
                sample_size=sample_size, timestamp=0)
    info, mm = sdriq.open_mmap(path)
    nf = loader.NativeSdriq(path)
    assert (nf.sample_rate, nf.center_frequency, nf.sample_size, nf.n_samples) == (
        info.sample_rate, info.center_frequency, info.sample_size, info.n_samples)
    scale = 32768.0 if sample_size == 16 else 8388608.0
    for start, count in ((0, 1000), (4500, 1200), (12_345, 777)):  # wrapped reads too
        want = sdriq.read_block(mm, start, count)
        np.testing.assert_array_equal(nf.read_f32(start, count),
                                      (want.astype(np.float32) * np.float32(1.0 / scale)))
        if sample_size == 16:
            np.testing.assert_array_equal(nf.read_i16(start, count), want)
        else:
            np.testing.assert_array_equal(nf.read_i16(start, count), (want >> 8).astype(np.int16))
    nf.close()
