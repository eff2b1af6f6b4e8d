"""K1 on the card against its plain twin, and the port's pipeline on the
card against the same pipeline on the CPU. Marked `cuda`: they skip without
a card. Run on a machine with one:

    python -m pytest tests/test_torch_kernels_cuda.py -q -o addopts=""

This file imports no jax, so it runs where only the port is installed.
"""

import numpy as np
import pytest
import torch

from sdrangel_tpu_torch.dsp import decimators as pdec
from sdrangel_tpu_torch.io import testsource
from sdrangel_tpu_torch.kernels.flat_decimate import flat_decimate, flat_decimate_reference
from sdrangel_tpu_torch.runtime import engine as peng
from torch_port_util import agreement_db, n, t

ATOL = 2e-5  # tests/test_pallas.py's tolerance for the fused decimator

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 runs only there")
    peng.pin_f32_precision()  # the twin's conv1d must not run in TF32
    return torch.device("cuda")


@pytest.mark.parametrize("log2,fc_pos,i16,outputs", [
    (2, "cen", True, 1 << 16), (6, "cen", True, 4096), (6, "cen", False, 4096),
    (6, "inf", False, 4096), (6, "sup", False, 4096),
    (5, "cen", True, 1001),  # a ragged last tile
])
def test_k1_matches_twin_on_card(cuda_device, log2, fc_pos, i16, outputs):
    rng = np.random.default_rng(50 + log2)
    size = outputs << log2
    shape = (size + pdec.flat_tail_len(log2), 2)
    if i16:
        ext = t(rng.integers(-32768, 32767, size=shape, endpoint=True, dtype=np.int16))
    else:
        ext = t(rng.uniform(-1.0, 1.0, shape).astype(np.float32))
    ext = ext.to(cuda_device)
    legs_re, legs_im, _ = pdec._device_legs(log2, fc_pos, cuda_device)
    launches = flat_decimate.launches
    out = flat_decimate(ext, legs_re, legs_im)
    torch.cuda.synchronize()
    assert flat_decimate.launches == launches + 1
    assert out.shape == (outputs, 2)
    np.testing.assert_allclose(n(out), n(flat_decimate_reference(ext, legs_re, legs_im)),
                               atol=ATOL)


def test_k1_rejects_what_it_does_not_take(cuda_device):
    legs, _, _ = pdec._device_legs(3, "cen", cuda_device)
    good = torch.zeros((pdec.flat_tail_len(3) + 64, 2), dtype=torch.int16, device=cuda_device)
    with pytest.raises(TypeError):
        flat_decimate(good.to(torch.int32), legs)
    with pytest.raises(ValueError):
        flat_decimate(good[:-1], legs)  # not tail + a multiple of 2^k
    with pytest.raises(ValueError):
        flat_decimate(good.t().contiguous().t(), legs)  # not contiguous
    with pytest.raises(ValueError):  # a contiguous view that splits an I/Q pair
        flat_decimate(torch.cat([good.view(-1), good.view(-1)[:2]])[1:-1].view(-1, 2), legs)


@pytest.mark.parametrize("frontend", [{}, {"fc_pos": "inf"}])
def test_pipeline_on_card_matches_cpu(cuda_device, frontend):
    chans = [peng.ChannelSpec("sdrangel.channel.nfmdemod", 100_000.0, {"squelch_db": -60.0})]
    cfg = peng.DeviceConfig(768_000.0, log2_decim=1, **frontend)
    gpu = peng.RxPipeline(cfg, chans, cuda_device, block_size=32_768)
    cpu = peng.RxPipeline(cfg, chans, "cpu", block_size=32_768)
    src = testsource.TestSourceConfig(
        sample_rate=768_000.0, modulation="fm", amplitude=0.4,
        carrier_freq=100_000.0 - (192_000.0 if frontend else 0.0))
    raw = testsource.to_iq_int16(testsource.generate(src, 3 * gpu.device_block))
    launches = flat_decimate.launches
    got = [o["channels"][0]["audio"] for _, o in gpu.run(
        lambda b, c: raw[b * c:(b + 1) * c], 3)]
    want = [o["channels"][0]["audio"] for _, o in cpu.run(
        lambda b, c: raw[b * c:(b + 1) * c], 3)]
    assert flat_decimate.launches == launches + 3
    got, want = np.concatenate(got), np.concatenate(want)
    assert np.any(want != 0.0)
    assert agreement_db(want, got) >= 80.0
