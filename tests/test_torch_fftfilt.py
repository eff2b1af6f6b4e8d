"""The port's fftfilt against the JAX package and the compiled-reference
fftfilt goldens.

Tolerances: the designers within 1e-6 of JAX (the same float64 numpy,
cast to complex64); the overlap-add filters 2e-5 absolute against JAX,
streamed over 3 blocks of unit-scale noise (f32 FFTs taken by another
library); the goldens at test_reference_golden.py:172-200's bounds and
scale checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sdrangel_tpu.dsp import fftfilt as jff
from sdrangel_tpu_torch.dsp import fftfilt as pff
from torch_port_util import CPU, fit_snr, load_golden_iq, n, t

ATOL = 2e-5


@pytest.mark.parametrize("f1,f2,flen", [
    (300 / 48_000, 3000 / 48_000, 1024),
    (0.0, 0.1, 1024),
    (-0.234375, 0.234375, 1024),  # WFM's ±rfBw/2 at 384 kS/s
    (0.2, 0.05, 512),  # f2 < f1: the highpass branch
    (0.0, 5000 / 48_000, 2048),
])
def test_create_filter_matches_jax(f1, f2, flen):
    np.testing.assert_allclose(pff.create_filter(f1, f2, flen), jff.create_filter(f1, f2, flen),
                               atol=1e-6)


@pytest.mark.parametrize("designer,args", [
    ("create_dsb_filter", (3000 / 48_000, 1024)),
    ("create_dsb_filter", (10_000 / 48_000, 2048)),
    ("create_asym_filter", (500 / 48_000, 3000 / 48_000, 1024)),
])
def test_other_designers_match_jax(designer, args):
    got, want = getattr(pff, designer)(*args), getattr(jff, designer)(*args)
    for g, w in zip(np.atleast_2d(got), np.atleast_2d(want)):
        np.testing.assert_allclose(g, w, atol=1e-6)


def _noise(rng, size):
    return (rng.standard_normal(size) + 1j * rng.standard_normal(size)).astype(np.complex64) * 0.3


_H = jff.create_filter(300 / 48_000, 3000 / 48_000, 1024)
_H_IN, _H_OPP = jff.create_asym_filter(500 / 48_000, 3000 / 48_000, 1024)
RUNS = {
    "filt": (lambda s, x: jff.run_filt(s, x, jnp.asarray(_H)),
             lambda s, x: pff.run_filt(s, x, t(_H))),
    "dsb": (lambda s, x: jff.run_dsb(s, x, jnp.asarray(_H)),
            lambda s, x: pff.run_dsb(s, x, t(_H))),
    **{f"ssb_usb{u}_dc{d}": (
        lambda s, x, u=u, d=d: jff.run_ssb(s, x, _H, usb=u, get_dc=d),
        lambda s, x, u=u, d=d: pff.run_ssb(s, x, t(_H), usb=u, get_dc=d))
       for u in (True, False) for d in (True, False)},
    **{f"asym_usb{u}": (
        lambda s, x, u=u: jff.run_asym(s, x, jnp.asarray(_H_IN), jnp.asarray(_H_OPP), usb=u),
        lambda s, x, u=u: pff.run_asym(s, x, t(_H_IN), t(_H_OPP), usb=u))
       for u in (True, False)},
}


@pytest.mark.parametrize("run", list(RUNS))
def test_overlap_add_streams_like_jax(run):
    """Three blocks of 3 hops, with a (2,) batch, carry the overlap as JAX does."""
    jrun, prun = RUNS[run]
    rng = np.random.default_rng(21)
    js, ps = jff.make_state(1024, batch_shape=(2,)), pff.make_state(1024, CPU, batch_shape=(2,))
    for _ in range(3):
        x = _noise(rng, (2, 1536))
        js, jy = jrun(js, jnp.asarray(x))
        ps, py = prun(ps, t(x))
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(n(ps.overlap), np.asarray(js.overlap), atol=ATOL)


def test_block_not_a_multiple_of_the_hop_raises():
    with pytest.raises(ValueError, match="multiple of flen/2=512"):
        pff.run_filt(pff.make_state(1024, CPU), t(np.zeros(1000, np.complex64)), t(_H))


def _golden_input():
    return load_golden_iq("fftfilt_input").astype(np.complex64)


@pytest.mark.parametrize("name,bound,scale_tol", [
    ("fftfilt_ssb_usb", 95.0, 1e-3),
    ("fftfilt_ssb_lsb", 80.0, 1e-3),
    ("fftfilt_dsb", 120.0, 1e-4),
    ("fftfilt_asym_usb", 80.0, 1e-3),
])
def test_fftfilt_meets_reference_golden(name, bound, scale_tol):
    x = t(_golden_input())
    s = pff.make_state(1024, CPU)
    if name.startswith("fftfilt_ssb"):
        h = pff.create_filter(300 / 48_000, 3000 / 48_000, 1024)
        _, y = pff.run_ssb(s, x, t(h), usb=name.endswith("usb"))
    elif name == "fftfilt_dsb":
        _, y = pff.run_dsb(s, x, t(pff.create_dsb_filter(3000 / 48_000, 1024)))
    else:
        h_in, h_opp = pff.create_asym_filter(500 / 48_000, 3000 / 48_000, 1024)
        _, y = pff.run_asym(s, x, t(h_in), t(h_opp), usb=True)
    snr, scale = fit_snr(load_golden_iq(name), n(y), skip=0)
    assert snr > bound, f"{name}: snr {snr:.1f} dB"
    assert abs(scale - 1.0) < scale_tol, f"{name}: scale {scale}"
