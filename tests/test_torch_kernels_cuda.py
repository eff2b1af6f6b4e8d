"""K1 and K1-TC on the card against their plain versions, and the port's
pipeline on the card against the same pipeline on the CPU. Marked `cuda`: they skip without
a card. Run on a machine with one:

    python -m pytest tests/test_torch_kernels_cuda.py -q -o addopts=""

This file imports no jax, so it runs where only the port is installed.
"""

import numpy as np
import pytest
import torch

from sdrangel_tpu_torch.dsp import decimators as pdec
from sdrangel_tpu_torch.io import testsource
from sdrangel_tpu_torch.kernels import decimator as kdec
from sdrangel_tpu_torch.kernels import flat_decimate as k1
from sdrangel_tpu_torch.kernels.flat_decimate import flat_decimate, flat_decimate_reference
from sdrangel_tpu_torch.kernels.flat_decimate_tc import (
    blocks_per_sm,
    flat_decimate_tc,
    flat_decimate_tc_reference,
)
from sdrangel_tpu_torch.runtime import engine as peng
from torch_port_util import agreement_db, n, t

ATOL = 2e-5  # tests/test_pallas.py's tolerance for the fused decimator

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K1-TC run only there")
    peng.pin_f32_precision()  # the twin's conv1d must not run in TF32
    return torch.device("cuda")


def _ext(rng, pairs, i16, device):
    if i16:
        v = rng.integers(-32768, 32767, size=(pairs, 2), endpoint=True, dtype=np.int16)
    else:
        v = rng.uniform(-1.0, 1.0, (pairs, 2)).astype(np.float32)
    return t(v).to(device)


_K1_CASES = [
    (2, "cen", True, 1 << 16), (6, "cen", True, 4096), (6, "cen", False, 4096),
    (6, "inf", False, 4096), (6, "sup", False, 4096),
    (5, "cen", True, 1001),  # a ragged last tile
]
# every placement and input type at r = 2, 4, 32, 64, each with a ragged last tile
_K1_CASES += [(log2, fc_pos, i16, 1001) for log2 in (1, 2, 5, 6)
              for fc_pos in ("cen", "inf", "sup") for i16 in (True, False)
              if (log2, fc_pos, i16, 1001) not in _K1_CASES]


@pytest.mark.parametrize("log2,fc_pos,i16,outputs", _K1_CASES)
def test_k1_matches_twin_on_card(cuda_device, log2, fc_pos, i16, outputs):
    """The block and its tail as two tensors, and the one-tensor form, against
    the twin; both forms give the same bits."""
    rng = np.random.default_rng(50 + log2)
    tail = _ext(rng, pdec.flat_tail_len(log2), i16, cuda_device)
    block = _ext(rng, outputs << log2, i16, cuda_device)
    legs_re, legs_im, _ = pdec._device_legs(log2, fc_pos, cuda_device)
    launches = flat_decimate.launches
    out = flat_decimate(block, legs_re, legs_im, tail=tail)
    torch.cuda.synchronize()
    assert flat_decimate.launches == launches + 1
    assert out.shape == (outputs, 2)
    np.testing.assert_allclose(
        n(out), n(flat_decimate_reference(block, legs_re, legs_im, tail=tail)), atol=ATOL)
    np.testing.assert_array_equal(
        n(out), n(flat_decimate(torch.cat([tail, block]), legs_re, legs_im)))


@pytest.mark.parametrize("log2", [1, 2, 6])
@pytest.mark.parametrize("i16,offset_pairs", [
    (True, 1), (True, 2), (False, 1),  # 4-, 8- and 8-byte aligned views
])
def test_k1_unaligned_views_on_card(cuda_device, log2, i16, offset_pairs):
    """A block and a tail whose addresses allow only 8- or 4-byte copies."""
    rng = np.random.default_rng(150 + log2)
    outputs = 1001
    block = _ext(rng, (outputs << log2) + 8, i16, cuda_device)[
        offset_pairs:offset_pairs + (outputs << log2)]
    tail = _ext(rng, pdec.flat_tail_len(log2) + 8, i16, cuda_device)[
        offset_pairs:offset_pairs + pdec.flat_tail_len(log2)]
    assert block.data_ptr() % 16 and tail.data_ptr() % 16
    legs_re, legs_im, _ = pdec._device_legs(log2, "inf", cuda_device)
    want = n(flat_decimate(block.clone(), legs_re, legs_im, tail=tail.clone()))
    np.testing.assert_array_equal(n(flat_decimate(block, legs_re, legs_im, tail=tail)), want)
    np.testing.assert_allclose(
        want, n(flat_decimate_reference(block, legs_re, legs_im, tail=tail)), atol=ATOL)


@pytest.mark.parametrize("i16,fc_pos", [(True, "cen"), (False, "cen"), (False, "inf")])
def test_k1_streamed_equals_long_block(cuda_device, i16, fc_pos):
    """Three blocks of 1001 outputs, each with the previous block's tail as
    its own tensor, equal one long block bit for bit."""
    rng = np.random.default_rng(73)
    legs_re, legs_im, _ = pdec._device_legs(6, fc_pos, cuda_device)
    tail_len = pdec.flat_tail_len(6)
    size = 64 * 1001
    x = _ext(rng, 3 * size, i16, cuda_device)
    tail = _ext(rng, tail_len, i16, cuda_device)
    long = flat_decimate(x, legs_re, legs_im, tail=tail)
    parts = []
    for i in range(3):
        block = x[i * size:(i + 1) * size].clone()
        parts.append(flat_decimate(block, legs_re, legs_im, tail=tail))
        tail = block[size - tail_len:].clone()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(n(torch.cat(parts)), n(long))


@pytest.mark.parametrize("i16,complex_legs", [(True, False), (False, False), (False, True)])
def test_k1_holds_two_blocks_per_sm_at_r64(cuda_device, i16, complex_legs):
    assert k1.blocks_per_sm(64, pdec.flat_legs(6).shape[1], i16, complex_legs) >= 2


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
    with pytest.raises(ValueError):  # a tail that is not r·(t_leg − 1) pairs
        flat_decimate(good[8:], legs, tail=good[:8])


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


@pytest.mark.parametrize("uri,offset,requested,src", [
    ("sdrangel.channel.amdemod", 100_000.0, 48_000.0,
     dict(modulation="am", am_depth=0.8, carrier_freq=100_000.0)),
    ("sdrangel.channel.ssbdemod", -50_000.0, 48_000.0,  # a USB tone 1 kHz up
     dict(modulation="none", carrier_freq=-49_000.0)),
    ("sdrangel.channel.wfmdemod", 0.0, 250_000.0,
     dict(modulation="fm", fm_deviation=75_000.0, carrier_freq=0.0)),
])
def test_receiver_pipeline_on_card_matches_cpu(cuda_device, uri, offset, requested, src):
    """AM, SSB and WFM on the card against the CPU pipeline: ≥ 80 dB over 3
    blocks, K1 launched once per block."""
    chans = [peng.ChannelSpec(uri, offset, {}, requested)]
    cfg = peng.DeviceConfig(768_000.0, log2_decim=1)
    gpu = peng.RxPipeline(cfg, chans, cuda_device, block_size=32_768)
    cpu = peng.RxPipeline(cfg, chans, "cpu", block_size=32_768)
    source = testsource.TestSourceConfig(sample_rate=768_000.0, amplitude=0.4, **src)
    raw = testsource.to_iq_int16(testsource.generate(source, 3 * gpu.device_block))
    launches = flat_decimate.launches
    got = [o["channels"][0]["audio"] for _, o in gpu.run(
        lambda b, c: raw[b * c:(b + 1) * c], 3)]
    want = [o["channels"][0]["audio"] for _, o in cpu.run(
        lambda b, c: raw[b * c:(b + 1) * c], 3)]
    assert flat_decimate.launches == launches + 3
    got, want = np.concatenate(got), np.concatenate(want)
    assert np.any(want != 0.0)
    assert agreement_db(want, got) >= 80.0


@pytest.mark.parametrize("preload", [False, True])
def test_session_on_card_matches_cpu(cuda_device, tmp_path, preload):
    """The Rx session's DeviceSet on the card (K1 once per block, the packed
    outputs read back one block behind) against the same set on the CPU:
    ≥ 80 dB over 4 blocks of a .sdriq capture, ÷8 NFM, streamed or preloaded."""
    import time

    from sdrangel_tpu_torch.io import sdriq
    from sdrangel_tpu_torch.runtime.session import DeviceSet

    src = testsource.TestSourceConfig(sample_rate=768_000.0, modulation="fm", amplitude=0.4,
                                      carrier_freq=20_000.0)
    path = str(tmp_path / "cap.sdriq")
    sdriq.write(path, testsource.generate(src, 1 << 20), sample_rate=768_000)
    audio = {}
    for device in (cuda_device, "cpu"):
        ds = DeviceSet(0, device)
        ds.update_source({"kind": "filesource", "file_path": path, "log2_decim": 3,
                          "run_blocks": 4, "file_preload": preload})
        ds.add_channel("sdrangel.channel.nfmdemod",
                       {"inputFrequencyOffset": 20_000.0, "squelch_db": -60.0})
        launches = flat_decimate.launches
        ds.start()
        t0 = time.time()
        while ds.running and time.time() - t0 < 120:
            time.sleep(0.01)
        assert not ds.error and ds.blocks_processed == 4, ds.error
        assert flat_decimate.launches == launches + (4 if device is cuda_device else 0)
        audio[str(device)] = ds.drain_audio(0)
    assert np.any(audio["cpu"] != 0.0)
    assert agreement_db(audio["cpu"], audio["cuda"]) >= 80.0


def _raw(rng, pairs, device):
    return t(rng.integers(-32768, 32767, size=(pairs, 2), endpoint=True,
                          dtype=np.int16)).to(device)


def _raw_ext(rng, log2, outputs, device):
    return _raw(rng, (outputs << log2) + pdec.flat_tail_len(log2), device)


@pytest.mark.parametrize("log2,outputs", [
    (1, 4096), (2, 1 << 16), (3, 4096), (4, 4096), (5, 4096), (6, 4096),
    (6, 1001),  # a ragged last tile
])
def test_k1_tc_matches_plain_on_card(cuda_device, log2, outputs):
    rng = np.random.default_rng(60 + log2)
    ext = _raw_ext(rng, log2, outputs, cuda_device)
    legs, _, _ = pdec._device_legs(log2, "cen", cuda_device)
    launches = flat_decimate_tc.launches
    out = flat_decimate_tc(ext, legs)
    torch.cuda.synchronize()
    assert flat_decimate_tc.launches == launches + 1
    assert out.shape == (outputs, 2)
    np.testing.assert_allclose(n(out), n(flat_decimate_tc_reference(ext, legs)), atol=ATOL)
    np.testing.assert_allclose(n(out), n(flat_decimate(ext, legs)), atol=ATOL)


def test_k1_tc_streamed_equals_long_block(cuda_device):
    """Three blocks through a carried raw tail equal one long block."""
    rng = np.random.default_rng(70)
    legs, _, _ = pdec._device_legs(6, "cen", cuda_device)
    tail_len = pdec.flat_tail_len(6)
    raw = t(rng.integers(-32768, 32767, size=(3 * 64 * 3000, 2), endpoint=True,
                         dtype=np.int16)).to(cuda_device)
    ext = torch.cat([torch.zeros((tail_len, 2), dtype=torch.int16, device=cuda_device), raw])
    parts = [flat_decimate_tc(ext[i * 64 * 3000: (i + 1) * 64 * 3000 + tail_len].contiguous(), legs)
             for i in range(3)]
    long = flat_decimate_tc(ext, legs)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(n(torch.cat(parts)), n(long))


@pytest.mark.parametrize("log2,outputs", [
    (1, 4096), (2, 1 << 16), (3, 4096), (4, 4096), (5, 4096), (6, 4096),
    (6, 50),  # below one 128-output tile
    (6, 1001),  # not a multiple of 128
    (6, 800 * 128 - 37),  # 800 tiles: not a multiple of the run length on an H100
    (2, 800 * 128 + 5),
])
def test_k1_tc_two_pointer_form_matches_plain_on_card(cuda_device, log2, outputs):
    rng = np.random.default_rng(160 + log2)
    tail = _raw(rng, pdec.flat_tail_len(log2), cuda_device)
    block = _raw(rng, outputs << log2, cuda_device)
    legs, _, _ = pdec._device_legs(log2, "cen", cuda_device)
    launches = flat_decimate_tc.launches
    out = flat_decimate_tc(block, legs, tail=tail)
    torch.cuda.synchronize()
    assert flat_decimate_tc.launches == launches + 1
    assert out.shape == (outputs, 2)
    np.testing.assert_allclose(n(out), n(flat_decimate_tc_reference(block, legs, tail=tail)),
                               atol=ATOL)
    np.testing.assert_array_equal(n(out), n(flat_decimate_tc(torch.cat([tail, block]), legs)))


@pytest.mark.parametrize("log2", [1, 2, 6])
@pytest.mark.parametrize("offset_pairs", [1, 2])  # 4- and 8-byte aligned views
def test_k1_tc_unaligned_views_on_card(cuda_device, log2, offset_pairs):
    """A block and a tail whose addresses allow only 8- or 4-byte copies."""
    rng = np.random.default_rng(170 + log2)
    outputs = 1001
    buf = _raw(rng, (outputs << log2) + 8, cuda_device)
    block = buf[offset_pairs:offset_pairs + (outputs << log2)]
    tbuf = _raw(rng, pdec.flat_tail_len(log2) + 8, cuda_device)
    tail = tbuf[offset_pairs:offset_pairs + pdec.flat_tail_len(log2)]
    assert block.data_ptr() % 16 and tail.data_ptr() % 16
    legs, _, _ = pdec._device_legs(log2, "cen", cuda_device)
    want = n(flat_decimate_tc(block.clone(), legs, tail=tail.clone()))  # 16-byte aligned
    np.testing.assert_array_equal(n(flat_decimate_tc(block, legs, tail=tail)), want)
    np.testing.assert_allclose(want, n(flat_decimate_tc_reference(block, legs, tail=tail)),
                               atol=ATOL)
    ext = buf[offset_pairs:offset_pairs + (outputs << log2)]  # one tensor, unaligned
    np.testing.assert_allclose(n(flat_decimate_tc(ext, legs)),
                               n(flat_decimate_tc_reference(ext, legs)), atol=ATOL)


def test_k1_tc_two_pointer_streamed_equals_long_block(cuda_device):
    """Three blocks of 1001 outputs, each with the previous block's raw tail
    as its own tensor, equal one long block bit for bit."""
    rng = np.random.default_rng(72)
    legs, _, _ = pdec._device_legs(6, "cen", cuda_device)
    tail_len = pdec.flat_tail_len(6)
    size = 64 * 1001
    raw = _raw(rng, 3 * size, cuda_device)
    tail = torch.zeros((tail_len, 2), dtype=torch.int16, device=cuda_device)
    long = flat_decimate_tc(raw, legs, tail=tail)
    parts = []
    for i in range(3):
        block = raw[i * size:(i + 1) * size].clone()
        parts.append(flat_decimate_tc(block, legs, tail=tail))
        tail = block[size - tail_len:].clone()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(n(torch.cat(parts)), n(long))


def test_k1_tc_holds_two_blocks_per_sm_at_r64(cuda_device):
    assert blocks_per_sm(64) >= 2


def test_mxu_counterpart_matches_vpu_counterpart_on_card(cuda_device):
    rng = np.random.default_rng(71)
    raw = t(rng.integers(-32768, 32767, size=((1 << 16) + kdec.HALO, 2), endpoint=True,
                         dtype=np.int16)).to(cuda_device)
    tc = kdec.decimate_cascade_fused_mxu(raw, 6)
    k1 = kdec.decimate_cascade_fused(raw, 6)
    torch.cuda.synchronize()
    assert tc.shape == (2, 1 << 10)
    np.testing.assert_allclose(n(tc), n(k1), atol=ATOL)


def test_k1_tc_rejects_what_it_does_not_take(cuda_device):
    legs, _, _ = pdec._device_legs(3, "cen", cuda_device)
    good = torch.zeros((pdec.flat_tail_len(3) + 64, 2), dtype=torch.int16, device=cuda_device)
    with pytest.raises(TypeError):
        flat_decimate_tc(good.to(torch.float32), legs)
    with pytest.raises(ValueError):
        flat_decimate_tc(good[:-1], legs)  # not tail + a multiple of 2^k
    with pytest.raises(ValueError):
        flat_decimate_tc(good, torch.zeros((8, 65), device=cuda_device))  # t_leg > 64
    with pytest.raises(ValueError):
        flat_decimate_tc(good.t().contiguous().t(), legs)  # not contiguous
