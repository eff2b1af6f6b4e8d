"""The plain reference's pieces against the port's CPU path, stage by
stage, at tiny sizes: the same mathematics written twice."""

import numpy as np
import pytest
import torch

from portbench.reference import dsp
from sdrangel_tpu_torch.dsp import channelizer as chan
from sdrangel_tpu_torch.dsp import decimators as dec
from sdrangel_tpu_torch.dsp import pfb

RNG = np.random.default_rng(5)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_device_decimator_is_the_staged_cascade():
    raw = torch.from_numpy(RNG.integers(-30000, 30000, (1 << 14, 2), dtype=np.int16))
    _, ours = dec.decimate_flat_raw(dec.init_flat_state(4, torch.device("cpu"), raw=True), raw, 4)
    ref = dsp.halfband_cascade(dsp.i16_to_complex(raw, dsp.F64), (0,) * 4, 64, dsp.F64)
    assert _rel(ours.numpy(), ref.numpy()) < 2e-6


@pytest.mark.parametrize("offset", [100e3, -150e3, 30e3])
def test_channel_plan_and_stages(offset):
    rate = 768e3
    plan = chan.plan_channel(rate, 48e3, offset)
    ref_plan = dsp.plan_channel(rate, 48e3, offset)
    assert plan.signs == ref_plan.signs and plan.residual_offset == ref_plan.residual_hz
    x = RNG.standard_normal(1 << 14) + 1j * RNG.standard_normal(1 << 14)
    _, ours = chan.channelize(chan.init_state(len(plan.signs), torch.device("cpu")),
                              torch.from_numpy(x.astype(np.complex64)), plan)
    ref = dsp.halfband_cascade(torch.from_numpy(x), ref_plan.signs, 48, dsp.F64)
    assert len(plan.signs) and _rel(ours.numpy(), ref.numpy()) < 2e-6


def test_pfb_channels():
    x = RNG.standard_normal(4096) + 1j * RNG.standard_normal(4096)
    _, ours = pfb.analyze(pfb.make_state(4, torch.device("cpu")),
                          torch.from_numpy(x.astype(np.complex64)), 4)
    ref = dsp.pfb_channels(torch.from_numpy(x), 4, 12, [0, 1, 3], dsp.F64)
    assert _rel(ours[:, [0, 1, 3]].T.numpy(), ref.numpy()) < 2e-6


def test_tf32_rounding_keeps_ten_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12], dtype=torch.float32)
    assert dsp.round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, 1.0]
