"""The port's polyphase DFT bank and channel banks against the JAX package.

`analyze` and `analyze_select` stream 3 blocks of the same numpy input
through both packages from the same non-zero state and are held to the JAX
output and to the numpy convolution oracle at 2e-5 absolute (f32 sums taken
in another order; the Pallas decimator's tolerance). The channel banks are
held to the JAX banks at the same tolerance, and a bank with mixed signs
to one `channelize` a channel within 1e-6 of the peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrangel_tpu.dsp import channelizer as jchan
from sdrangel_tpu.dsp import pfb as jpfb
from sdrangel_tpu_torch.dsp import channelizer as pchan
from sdrangel_tpu_torch.dsp import decimators as pdec
from sdrangel_tpu_torch.dsp import pfb as ppfb
from torch_port_util import CPU, n, t

ATOL = 2e-5


def _noise(rng, size, amp=0.5):
    x = rng.uniform(-amp, amp, (size, 2)).astype(np.float32)
    return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)


@pytest.mark.parametrize("m,p", [(4, 12), (8, 4), (16, 8)])
def test_analyze_streams_like_jax_and_oracle(m, p):
    rng = np.random.default_rng(m)
    h = jpfb.prototype(m, p)
    np.testing.assert_array_equal(ppfb.prototype(m, p), h)
    blocks = [_noise(rng, m * 64) for _ in range(3)]
    tail0 = _noise(rng, (p - 1) * m)  # the same non-zero starting history
    js = jpfb.PfbState(jnp.asarray(tail0))
    ps = ppfb.PfbState(t(tail0))
    run = jax.jit(lambda s, xx: jpfb.analyze(s, xx, m, h))
    ys = []
    for x in blocks:
        js, jy = run(js, jnp.asarray(x))
        ps, py = ppfb.analyze(ps, t(x), m, h)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)
        ys.append(n(py))
    np.testing.assert_array_equal(n(ps.tail), np.asarray(js.tail))
    # the numpy convolution oracle over the whole stream, history included
    stream = np.concatenate([tail0, *blocks])
    y = np.concatenate(ys)
    skip = len(tail0) // m
    for c in (0, 1, m // 2, m - 1):
        o = ppfb.oracle_channel(stream, m, c, h)[skip:]
        np.testing.assert_allclose(y[:, c], o, atol=ATOL)


@pytest.mark.parametrize("m,sel", [(4, [1, 3]), (16, [0, 5, 15, 5])])
def test_analyze_select_streams_like_jax(m, sel):
    rng = np.random.default_rng(100 + m)
    js, ps = jpfb.make_state(m), ppfb.make_state(m, CPU)
    run = jax.jit(lambda s, xx: jpfb.analyze_select(s, xx, m, sel))
    full = ppfb.make_state(m, CPU)
    for _ in range(3):
        x = _noise(rng, m * 32)
        js, jy = run(js, jnp.asarray(x))
        ps, py = ppfb.analyze_select(ps, t(x), m, sel)
        full, fy = ppfb.analyze(full, t(x), m)
        assert py.shape == (32, len(sel))
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)
        np.testing.assert_allclose(n(py), n(fy)[:, sel], atol=ATOL)


def test_analyze_batched_equals_per_stream():
    rng = np.random.default_rng(3)
    m = 4
    xs = np.stack([_noise(rng, m * 32) for _ in range(3)])
    _, yb = ppfb.analyze(ppfb.make_state(m, CPU, batch_shape=(3,)), t(xs), m)
    for i in range(3):
        _, yi = ppfb.analyze(ppfb.make_state(m, CPU), t(xs[i]), m)
        np.testing.assert_array_equal(n(yb[i]), n(yi))


def test_channel_freqs_match_jax():
    np.testing.assert_array_equal(ppfb.channel_freqs(8, 192e3), jpfb.channel_freqs(8, 192e3))


def test_channelize_bank_streams_like_jax():
    rng = np.random.default_rng(4)
    signs = np.array([[1, 0], [-1, 1], [0, 0], [1, 0]])
    js = jchan.init_state(2, batch_shape=(4,))
    ps = pchan.init_state(2, CPU, batch_shape=(4,))
    run = jax.jit(lambda s, xx: jchan.channelize_bank(s, xx, signs))
    for _ in range(3):
        x = np.stack([_noise(rng, 1024) for _ in range(4)])
        js, jy = run(js, jnp.asarray(x))
        ps, py = pchan.channelize_bank(ps, t(x), signs)
        assert py.shape == (4, 256)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)
    for a, b in zip(ps.tails, js.tails):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=ATOL)


def test_channelize_bank_mixed_signs_equals_separate_channels():
    """Signs −1, 0 and +1 at every stage: the bank over 3 streamed blocks
    equals one `channelize` a channel within 1e-6 of the peak; its first
    stage's rotation equals `decimators.rotate` a channel bit for bit; every
    stage's rotation period comes from the cache after the first block."""
    rng = np.random.default_rng(6)
    signs = np.array([[1, -1, 0], [-1, 0, 1], [0, 1, -1], [1, 1, 1], [-1, -1, 0]])
    c = len(signs)
    plans = [pchan.ChannelPlan(tuple(int(v) for v in row), 8, 1.0, 0.0) for row in signs]
    bank = pchan.init_state(3, CPU, batch_shape=(c,))
    ones = [pchan.init_state(3, CPU) for _ in range(c)]
    first = tuple(int(v) for v in signs[:, 0])
    for b in range(3):
        x = t(np.stack([_noise(rng, 1024) for _ in range(c)]))
        rotated = pdec.rotate_bank(x, first)
        for i, sign in enumerate(first):
            want = pdec.rotate(x[i], pdec._rotation_base(sign, CPU)) if sign else x[i]
            assert torch.equal(rotated[i], want)
        before = pdec._bank_rotation.cache_info()
        bank, yb = pchan.channelize_bank(bank, x, signs)
        after = pdec._bank_rotation.cache_info()
        if b:  # the periods of the first block, from the cache
            assert (after.misses, after.hits) == (before.misses, before.hits + 3)
        assert yb.shape == (c, 128)
        for i in range(c):
            ones[i], yi = pchan.channelize(ones[i], x[i], plans[i])
            peak = np.abs(n(yi)).max()
            assert np.abs(n(yb[i]) - n(yi)).max() <= 1e-6 * peak, f"channel {i}"
    for k in range(3):
        want = np.stack([n(one.tails[k]) for one in ones])
        assert np.abs(n(bank.tails[k]) - want).max() <= 1e-6 * np.abs(want).max()


def test_channelize_bank_unique_streams_like_jax():
    rng = np.random.default_rng(5)
    signs = np.array([[1, -1], [0, 0], [1, -1], [-1, 0], [0, 0]])
    u = pchan.unique_paths(signs)
    assert u == jchan.unique_paths(signs) == 3
    js = jchan.init_state(2, batch_shape=(u,))
    ps = pchan.init_state(2, CPU, batch_shape=(u,))
    run = jax.jit(lambda s, xx: jchan.channelize_bank_unique(s, xx, signs))
    for _ in range(3):
        bb = _noise(rng, 2048)
        js, jy = run(js, jnp.asarray(bb))
        ps, py = pchan.channelize_bank_unique(ps, t(bb), signs)
        assert py.shape == (5, 512)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)
