"""The port's raw-capture quantizer (`dsp/types.complex_to_iq_raw`) against
the JAX package's ingest: every ADC format the reference's device plugins
feed (RTL-SDR u8, HackRF i8, 12-bit, 16-bit, 24-bit) reads back through JAX's
`iq_raw_to_complex64` within half a code of what was quantized, saturates at
the container's range, and the port's ingest equals JAX's bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrangel_tpu.dsp import types as jtypes
from sdrangel_tpu_torch.dsp import types as ptypes

FORMATS = ["u8", "i8", "i12", "i16", "i24"]


def _signal(n=4096, amplitude=0.9, seed=16):
    rng = np.random.default_rng(seed)
    return amplitude * np.exp(2j * np.pi * rng.uniform(size=n)) * rng.uniform(size=n)


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantized_capture_reads_back_through_jax_ingest(fmt):
    x = _signal()
    raw = ptypes.complex_to_iq_raw(torch.from_numpy(x), fmt)
    assert raw.dtype == ptypes.INPUT_FORMATS[fmt][0] and raw.shape == (len(x), 2)
    back = np.asarray(jtypes.iq_raw_to_complex64(jnp.asarray(raw.numpy()), fmt))
    half = 0.5 / ptypes.INPUT_FORMATS[fmt][2]
    assert np.abs(back.real - x.real).max() <= half * 1.0001
    assert np.abs(back.imag - x.imag).max() <= half * 1.0001
    np.testing.assert_array_equal(ptypes.iq_raw_to_complex64(raw, fmt).numpy(), back)


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantizer_saturates_at_the_container_range(fmt):
    _, offset, scale = ptypes.INPUT_FORMATS[fmt]
    raw = ptypes.complex_to_iq_raw(torch.tensor([1.5 - 1.5j, -1.5 + 1.5j]), fmt).numpy()
    lo, hi = (0, 2 * scale - 1) if offset else (-scale, scale - 1)
    np.testing.assert_array_equal(raw, [[hi, lo], [lo, hi]])
