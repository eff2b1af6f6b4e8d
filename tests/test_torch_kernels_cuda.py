"""K1, K1-TC and K-PLL on the card against their plain versions, and the
port's pipeline on the card against the same pipeline on the CPU. Marked
`cuda`: they skip without a card. Run on a machine with one:

    python -m pytest tests/test_torch_kernels_cuda.py -q -o addopts=""

This file imports no jax, so it runs where only the port is installed.
"""

import numpy as np
import pytest
import torch

from sdrangel_tpu_torch.dsp import decimators as pdec
from sdrangel_tpu_torch.dsp import phaselock as ppl
from sdrangel_tpu_torch.dsp.types import complex_to_iq_raw
from sdrangel_tpu_torch.io import testsource
from sdrangel_tpu_torch.kernels import decimator as kdec
from sdrangel_tpu_torch.kernels import flat_decimate as k1
from sdrangel_tpu_torch.kernels import pll_scan
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


@pytest.mark.parametrize("frontend", [
    pytest.param({}, id="frontend0"), pytest.param({"fc_pos": "inf"}, id="frontend1"),
    pytest.param({"fc_pos": "sup"}, id="sup"),
    pytest.param({"dc_correction": True, "iq_correction": True}, id="dc_iq"),
    *(pytest.param({"input_format": f}, id=f) for f in ("u8", "i8", "i12", "i24")),
])
def test_pipeline_on_card_matches_cpu(cuda_device, frontend):
    """NFM at 768 kS/s ÷2 on the card against the CPU pipeline over 3 blocks:
    i16 at cen, inf and sup, i16 with DC and IQ correction, and the u8, i8,
    i12 and i24 ingests; K1 once per block in the form the path takes."""
    chans = [peng.ChannelSpec("sdrangel.channel.nfmdemod", 100_000.0, {"squelch_db": -60.0})]
    cfg = peng.DeviceConfig(768_000.0, log2_decim=1, **frontend)
    gpu = peng.RxPipeline(cfg, chans, cuda_device, block_size=32_768)
    cpu = peng.RxPipeline(cfg, chans, "cpu", block_size=32_768)
    # the inf/sup band at ÷2 is centred at ∓fs/4
    centre = {"inf": -192_000.0, "sup": 192_000.0}.get(cfg.fc_pos, 0.0)
    impairments = dict(dc_factor=0.05, phase_imbalance=0.05) if cfg.dc_correction else {}
    src = testsource.TestSourceConfig(
        sample_rate=768_000.0, modulation="fm", amplitude=0.4,
        carrier_freq=100_000.0 + centre, **impairments)
    iq = testsource.generate(src, 3 * gpu.device_block)
    if cfg.input_format == "i16":
        raw = testsource.to_iq_int16(iq)
    else:
        raw = n(complex_to_iq_raw(t(iq), cfg.input_format))
    form = ("i16 real" if gpu.fused_ingest else
            "f32 complex" if cfg.fc_pos != "cen" else "f32 real")
    launches = flat_decimate.launches
    by_form = flat_decimate.form_launches[form]
    got = [o["channels"][0]["audio"] for _, o in gpu.run(
        lambda b, c: raw[b * c:(b + 1) * c], 3)]
    want = [o["channels"][0]["audio"] for _, o in cpu.run(
        lambda b, c: raw[b * c:(b + 1) * c], 3)]
    assert flat_decimate.launches == launches + 3
    assert flat_decimate.form_launches[form] == by_form + 3
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


@pytest.mark.parametrize("live", [False, True], ids=["bound", "dyn"])
def test_bank_pipeline_on_card_matches_cpu(cuda_device, live):
    """16 NFM channels on a 25 kHz raster at 625 kHz (1.25 MS/s ÷2: banks of
    12 and 4) on the card against the CPU pipeline over 3 blocks, with the
    bound configs or with per-channel live overrides (a (C,) tensor a field
    and block): each channel ≥ 80 dB, its squelch meter equal, the NCO
    phases equal."""
    offsets = [-187_500.0 + 25_000.0 * k for k in range(16)]
    chans = [peng.ChannelSpec("sdrangel.channel.nfmdemod", f, {"squelch_db": -60.0})
             for f in offsets]
    cfg = peng.DeviceConfig(1_250_000.0, log2_decim=1)
    gpu = peng.RxPipeline(cfg, chans, cuda_device, block_size=32_768)
    cpu = peng.RxPipeline(cfg, chans, "cpu", block_size=32_768)
    assert [len(g.idxs) for g in gpu.groups] == [12, 4]
    tt = np.arange(3 * gpu.device_block) / cfg.sample_rate
    iq = sum(0.05 * np.exp(1j * (2 * np.pi * f * tt - 5.0 * np.cos(2 * np.pi * 1000.0 * tt)))
             for f in offsets[::2])
    raw = testsource.to_iq_int16(iq.astype(np.complex64))
    dyn = None
    if live:
        dyn = gpu.default_dyn()
        for k, d in enumerate(dyn):
            d.update(volume=0.5 + 0.1 * k, offset_hz=d["offset_hz"] + 10.0 * k)
    outs, states = {}, {}
    for name, pipe in (("cuda", gpu), ("cpu", cpu)):
        state = pipe.init_state()
        outs[name] = []
        for b in range(3):
            state, flat = pipe.step_packed(state, pipe.upload(raw[b * pipe.device_block:(b + 1)
                                                                  * pipe.device_block]), dyn)
            outs[name].append(pipe.to_host(flat))
        states[name] = pipe.state_to_numpy(state)
    for c in range(len(offsets)):
        want = np.concatenate([o["channels"][c]["audio"] for o in outs["cpu"]])
        got = np.concatenate([o["channels"][c]["audio"] for o in outs["cuda"]])
        assert [bool(o["channels"][c]["squelch"]) for o in outs["cuda"]] == \
            [bool(o["channels"][c]["squelch"]) for o in outs["cpu"]]
        assert states["cuda"]["demod"][c].nco.phase == states["cpu"]["demod"][c].nco.phase
        if c % 2 == 0:  # a carrier: the squelch opens
            assert agreement_db(want, got) >= 80.0, f"channel {c}"
        else:
            assert not np.any(got) and not np.any(want)


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


@pytest.mark.parametrize("rate,log2,chans,n_blocks", [
    (9.6e6, 6, [("sdrangel.channeltx.modnfm", 20_000.0)], 2),
    (384_000.0, 0, [("sdrangel.channeltx.modnfm", -30_000.0), ("sdrangel.channeltx.modam",
                                                              40_000.0),
                    ("sdrangel.channeltx.modssb", 10_000.0)], 3),
])
def test_tx_pipeline_on_card_matches_cpu(cuda_device, rate, log2, chans, n_blocks):
    """TxPipeline on the card against the CPU: int16 within 1 LSB and
    ≥ 80 dB, at the Tx slice's full width (9.6 MS/s ×64) and at 384 kS/s ×1
    (two UpChannelizer stages, three groups)."""
    from sdrangel_tpu_torch.runtime import tx as ptx

    specs = [ptx.TxChannelSpec(uri, off, {}) for uri, off in chans]

    def af(b, c, count):
        tt = (b * count + np.arange(count)) / 48_000.0
        return (0.8 * np.sin(2 * np.pi * (700.0 + 300.0 * c) * tt)).astype(np.float32)

    out = {}
    for device in (cuda_device, "cpu"):
        pipe = ptx.TxPipeline(ptx.TxDeviceConfig(rate, log2), specs, device=device)
        out[str(device)] = np.concatenate(list(pipe.run(af, n_blocks)))
    assert out["cuda"].shape == (n_blocks * pipe.device_block, 2)
    assert np.abs(out["cuda"].astype(np.int32) - out["cpu"]).max() <= 1
    assert agreement_db(out["cpu"], out["cuda"]) >= 80.0


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


# -- K-PLL ------------------------------------------------------------------------

def _pll_inputs(rng, channels, size, real=False):
    """Carriers a few Hz off at 48 kHz (AM, 80 % depth) or a 192 kHz MPX with a
    10 % 19 kHz pilot, with noise, one row per channel."""
    if real:
        tt = np.arange(size) / 192_000.0
        phi = rng.uniform(-np.pi, np.pi, (channels, 1))
        x = (0.1 * np.cos(2 * np.pi * 19_000.0 * tt + phi) + 0.4 * np.sin(2 * np.pi * 1e3 * tt)
             + 0.01 * rng.standard_normal((channels, size)))
        return x.astype(np.float32)
    tt = np.arange(size) / 48_000.0
    f = rng.uniform(-40.0, 40.0, (channels, 1))
    phi = rng.uniform(-np.pi, np.pi, (channels, 1))
    x = (1 + 0.8 * np.sin(2 * np.pi * 1e3 * tt)) * np.exp(1j * (2 * np.pi * f * tt + phi))
    x = x + 0.05 * (rng.standard_normal((channels, size)) + 1j * rng.standard_normal(
        (channels, size)))
    return x.astype(np.complex64)


# entry point -> (plain version, its arguments, state maker, real input)
_KPLL = {
    "pll_run": (ppl.pll_plain, ppl.pll_gains(48_000.0), ppl.make_pll, False),
    "ref_pll_run": (ppl.ref_pll_plain, (ppl.ref_pll_coeffs(),), ppl.make_ref_pll, False),
    "pilot_pll_run": (ppl.pilot_pll_plain, (ppl.pilot_pll_coeffs(19_000.0, 192_000.0),),
                      lambda dev, shape: ppl.make_pilot_pll(19_000.0, 192_000.0, dev, shape),
                      True),
}


def _wrapped(a):
    """Phases as their difference from 0 wrapped into (−π, π]."""
    return np.angle(np.exp(1j * np.asarray(a, np.float64)))


@pytest.mark.parametrize("channels", [1, 16, 33])
@pytest.mark.parametrize("loop", list(_KPLL))
def test_pll_scan_matches_plain_on_card(cuda_device, loop, channels):
    """K-PLL against its plain loop on the same card and on the CPU over
    2048 samples: the locked 2nd-order and biquad loops' carriers and end
    states within 1e-4 absolute; the pilot loop, still acquiring over these
    samples, its phases (modulo 2π) and end state within 2e-3 (it drifted
    by 9e-4 against JAX's scan on the CPU, test_torch_phaselock). CUDA's
    sincosf/atan2f and the CPU's libm differ in the last ulp, and it goes
    round the loop. One launch per call; the plain runs launch none."""
    plain, args, make, real = _KPLL[loop]
    x = _pll_inputs(np.random.default_rng(70 + channels), channels, 2048, real)
    state0 = torch.stack(list(make(torch.device("cpu"), (channels,))))
    wrapper = getattr(pll_scan, loop)
    before = wrapper.launches
    st_k = state0.to(cuda_device).contiguous()
    y_k = wrapper(t(x).to(cuda_device), st_k, *args)  # updates st_k in place
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    for dev in (cuda_device, torch.device("cpu")):
        y_p, st_p = plain(t(x).to(dev), state0.to(dev), *args)
        if real:  # phases in [0, 2π)
            np.testing.assert_allclose(_wrapped(n(y_k) - n(y_p)), 0.0, atol=2e-3,
                                       err_msg=str(dev))
            np.testing.assert_allclose(_wrapped(n(st_k[0]) - n(st_p[0])), 0.0, atol=2e-3)
            np.testing.assert_allclose(n(st_k[1:]), n(st_p[1:]), atol=2e-3, err_msg=str(dev))
        else:
            np.testing.assert_allclose(n(y_k), n(y_p), atol=1e-4, err_msg=str(dev))
            np.testing.assert_allclose(n(st_k), n(st_p), atol=1e-4, err_msg=str(dev))
    assert wrapper.launches == before + 1


_LOOPS = {
    "pll_run": (lambda s, x: ppl.pll_run(s, x, 48_000.0), ppl.make_pll, False),
    "ref_pll_run": (ppl.ref_pll_run, ppl.make_ref_pll, False),
    "pilot_pll_run": (lambda s, x: ppl.pilot_pll_run(s, x, 19_000.0, 192_000.0),
                      lambda dev, shape: ppl.make_pilot_pll(19_000.0, 192_000.0, dev, shape),
                      True),
}


@pytest.mark.parametrize("loop", list(_LOOPS))
def test_pll_scan_streamed_equals_long_block(cuda_device, loop):
    """Three blocks with the state carried equal one long block bit for bit:
    the kernel walks the same recurrence either way."""
    run, make, real = _LOOPS[loop]
    x = t(_pll_inputs(np.random.default_rng(80), 4, 3 * 1000, real)).to(cuda_device)
    state, parts = make(cuda_device, (4,)), []
    for b in range(3):
        state, *out = run(state, x[:, b * 1000:(b + 1) * 1000].contiguous())
        parts.append(out[0])
    _, *long = run(make(cuda_device, (4,)), x)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts, dim=-1), long[0])


def _gated(x: np.ndarray) -> np.ndarray:
    """x (C, T) with a leading run of exact zeros, a zeroed stretch mid-block
    and single zeros of each sign: the one input where arg(x·conj(e^{jθ}))
    is not wrap(arg x − θ)."""
    x = x.copy()
    x[:, :37] = 0.0
    x[:, 2000:2100] = 0.0
    x[0, 3001] = complex(-0.0, 0.0)
    x[-1, 3017] = complex(0.0, -0.0)
    x[:, 3500] = complex(-0.0, -0.0)
    return x


@pytest.mark.parametrize("channels", [1, 16, 33])
def test_pll_run_zero_runs_bit_equal_on_card(cuda_device, channels):
    """pll_run's three kernels on a gated input against the split plain loop
    on the same card: carrier and end state bit for bit (each exact zero
    goes through the old detector in both, the rest through atan2f and
    sincosf, the functions torch.atan2/cos/sin use on the card); one launch
    per call. The first channel starts far outside the loop's range (θ =
    100, f = 9 rad a sample), so its chunks leave the floor-mod's fast
    range and run again through the exact one."""
    plain, args, make, _ = _KPLL["pll_run"]
    x = t(_gated(_pll_inputs(np.random.default_rng(90 + channels), channels, 4096, False)))
    x = x.to(cuda_device)
    state0 = torch.stack(list(make(cuda_device, (channels,))))
    state0[0] = torch.linspace(-3.0, 3.0, channels)  # start θ in every quadrant
    state0[:, 0] = torch.tensor([100.0, 9.0])
    before = pll_scan.pll_run.launches
    st_k = state0.clone().contiguous()
    y_k = pll_scan.pll_run(x, st_k, *args)
    torch.cuda.synchronize()
    assert pll_scan.pll_run.launches == before + 1
    y_p, st_p = plain(x, state0, *args)
    assert torch.equal(y_k, y_p) and torch.equal(st_k, st_p)
    assert pll_scan.pll_run.launches == before + 1


def test_pll_scan_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((2, 64), dtype=torch.complex64, device=cuda_device)
    with pytest.raises(TypeError):
        pll_scan.pll_run(x.real.contiguous(), torch.zeros((2, 2), device=cuda_device), 0.1, 0.1)
    with pytest.raises(TypeError):
        pll_scan.pll_run(x, torch.zeros((3, 2), device=cuda_device), 0.1, 0.1)  # 3 state rows
    with pytest.raises(TypeError):
        pll_scan.ref_pll_run(x[:, ::2], torch.zeros((4, 2), device=cuda_device), (0.0,) * 5)
    with pytest.raises(TypeError):
        pll_scan.pilot_pll_run(x.real.contiguous(), torch.zeros((8, 2)), (0.0,) * 7)  # on CPU


@pytest.mark.parametrize("uri,offset,requested,settings,src", [
    ("sdrangel.channel.amdemod", 100_000.0, 48_000.0, {"sync_am": True},
     dict(modulation="am", am_depth=0.8, carrier_freq=100_000.0)),
    ("sdrangel.channel.amdemod", 100_000.0, 48_000.0, {"sync_am": True, "sync_dsb": True,
                                                       "ref_pll_parity": True},
     dict(modulation="am", am_depth=0.8, carrier_freq=100_000.0)),
    ("sdrangel.channel.nfmdemod", 50_000.0, 48_000.0,
     {"delta_squelch": True, "squelch_db": -15.0, "ctcss_on": True},
     dict(modulation="fm", fm_deviation=5000.0, carrier_freq=50_000.0)),
    ("sdrangel.channel.bfm", 0.0, 180_000.0, {}, "stereo"),
])
def test_slice_receivers_on_card_match_cpu(cuda_device, uri, offset, requested, settings, src):
    """Sync AM (K-PLL on the card), NFM with the AF squelch and CTCSS, and
    broadcast FM on the card against the CPU pipeline: ≥ 80 dB over 3
    blocks; K1 once per block, K-PLL once per block for sync AM.

    The reference-exact loop (`ref_pll_parity`) is held to 40 dB: its
    K = 1000 integrators turn the card's and the CPU's last-ulp differences
    in its prefiltered input into a carrier difference while it acquires
    (51.2 dB measured; on one and the same input K-PLL and the plain loop
    agree within 1e-4, test_pll_scan_matches_plain_on_card). Broadcast FM
    gets a stereo broadcast with its pilot: without one, the L−R reference
    is the phase of filtered noise (49.6 dB card against CPU on a mono FM
    tone; the JAX receiver has no pilot-lock gate either)."""
    chans = [peng.ChannelSpec(uri, offset, settings, requested)]
    cfg = peng.DeviceConfig(768_000.0, log2_decim=1)
    gpu = peng.RxPipeline(cfg, chans, cuda_device, block_size=32_768)
    cpu = peng.RxPipeline(cfg, chans, "cpu", block_size=32_768)
    if src == "stereo":
        raw = testsource.to_iq_int16(_stereo_fm(3 * gpu.device_block, 768_000.0))
    else:
        source = testsource.TestSourceConfig(sample_rate=768_000.0, amplitude=0.4, **src)
        raw = testsource.to_iq_int16(testsource.generate(source, 3 * gpu.device_block))
    launches = flat_decimate.launches
    pll = pll_scan.pll_run.launches + pll_scan.ref_pll_run.launches
    got = [o["channels"][0]["audio"] for _, o in gpu.run(
        lambda b, c: raw[b * c:(b + 1) * c], 3)]
    want = [o["channels"][0]["audio"] for _, o in cpu.run(
        lambda b, c: raw[b * c:(b + 1) * c], 3)]
    assert flat_decimate.launches == launches + 3
    pll_now = pll_scan.pll_run.launches + pll_scan.ref_pll_run.launches
    assert pll_now == pll + (3 if settings.get("sync_am") else 0)
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.shape == want.shape and np.any(want != 0.0)
    assert agreement_db(want, got) >= (40.0 if settings.get("ref_pll_parity") else 80.0)


def _stereo_fm(size: int, rate: float) -> np.ndarray:
    """Broadcast FM at the band centre: L a 1 kHz tone, R silent, a 10 %
    pilot sin θ with the 38 kHz subcarrier sin 2θ, 75 kHz deviation."""
    tt = np.arange(size) / rate
    left = np.sin(2 * np.pi * 1000.0 * tt)
    mpx = 0.45 * left * (1.0 + np.sin(2 * np.pi * 38_000.0 * tt)) + 0.1 * np.sin(
        2 * np.pi * 19_000.0 * tt)
    return (0.4 * np.exp(2j * np.pi * 75_000.0 * np.cumsum(mpx) / rate)).astype(np.complex64)


@pytest.mark.parametrize("uri,offset,requested,settings", [
    ("sdrangel.channel.lorademod", 0.0, 250_000.0, {"spread_factor": 7}),
    ("sdrangel.channel.dsddemod", 100_000.0, 48_000.0, {}),
    ("sdrangel.channel.chanalyzer", 100_000.0, 48_000.0, {"ssb": True}),
    ("sdrangel.channel.udpsrc", 100_000.0, 48_000.0, {"fmt": "nfm"}),
    ("sdrangel.channel.demodatv", 0.0, 6e6, {"standard": "hskip", "lines": 64, "fps": 25.0}),
    ("sdrangel.channel.demoddatv", 0.0, 384_000.0, {"symbol_rate": 96_000.0}),
])
def test_data_channels_on_card_match_cpu(cuda_device, uri, offset, requested, settings):
    """Each data kind on the card against the CPU pipeline over 3 blocks:
    K1 once per block, the float outputs ≥ 80 dB (the dB spectrum as
    power), the integer outputs equal (DSD's dibits where the CPU's soft
    value is clear of a slicer threshold: the squelch's first 480 samples
    are zeros whose FFT-filtered ±1e-9 residue falls either side of 0). An
    FM carrier feeds all but ATV, which gets AM video lines (on a constant
    envelope its sync notch is rounding, ~1e-5)."""
    chans = [peng.ChannelSpec(uri, offset, settings, requested)]
    cfg = peng.DeviceConfig(768_000.0, log2_decim=1)
    gpu = peng.RxPipeline(cfg, chans, cuda_device, block_size=32_768)
    cpu = peng.RxPipeline(cfg, chans, "cpu", block_size=32_768)
    if uri == "sdrangel.channel.demodatv":  # 480 capture samples a line, 8 % sync tip
        line = np.where(np.arange(480) < 38, 0.0, np.linspace(0.3, 1.0, 480))
        video = np.tile(line, 3 * gpu.device_block // 480 + 1)[:3 * gpu.device_block]
        raw = testsource.to_iq_int16((0.1 + 0.7 * video).astype(np.complex64))
    else:
        source = testsource.TestSourceConfig(sample_rate=768_000.0, amplitude=0.4,
                                             modulation="fm", carrier_freq=offset + 1500.0)
        raw = testsource.to_iq_int16(testsource.generate(source, 3 * gpu.device_block))
    launches = flat_decimate.launches
    got = [o["channels"][0]["data"] for _, o in gpu.run(lambda b, c: raw[b * c:(b + 1) * c], 3)]
    want = [o["channels"][0]["data"] for _, o in cpu.run(lambda b, c: raw[b * c:(b + 1) * c], 3)]
    assert flat_decimate.launches == launches + 3
    for g, w in zip(got, want):
        for k, wv in w.items():
            gv = g[k]
            assert gv.shape == wv.shape and gv.dtype == wv.dtype, k
            if k == "dibits":
                soft = w["soft_symbols"]
                level = soft / max(1.5 * float(np.abs(soft).mean()), 1e-6)
                clear = (np.abs(soft) > 2e-5) & (np.abs(np.abs(level) - 2 / 3) > 1e-3)
                np.testing.assert_array_equal(gv[clear], wv[clear])
            elif wv.dtype != np.float32:
                np.testing.assert_array_equal(gv, wv, err_msg=k)
            elif k == "spectrum":
                assert agreement_db(10.0 ** (wv / 10.0), 10.0 ** (gv / 10.0)) >= 80.0
            elif np.any(wv != 0.0):
                assert agreement_db(wv, gv) >= 80.0, k


@pytest.mark.parametrize("log2", [1, 3, 6])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_decimate_flat_iq_on_card_matches_plain(cuda_device, log2, batch):
    """decimate_flat_iq launches K1 once per stream per block on the card;
    three streamed blocks against the same calls on the CPU (K1's plain
    version), and against one long block bit for bit."""
    rng = np.random.default_rng(600 + log2)
    x = rng.uniform(-0.9, 0.9, (*batch, 3 * (1001 << log2), 2)).astype(np.float32)
    parts = np.split(x, 3, axis=-2)
    sc = pdec.init_flat_iq_state(log2, cuda_device, batch)
    sp = pdec.init_flat_iq_state(log2, torch.device("cpu"), batch)
    launches = flat_decimate.launches
    ys = []
    for part in parts:
        sc, yc = pdec.decimate_flat_iq(sc, t(part).to(cuda_device), log2)
        sp, yp = pdec.decimate_flat_iq(sp, t(part), log2)
        torch.cuda.synchronize()
        np.testing.assert_allclose(n(yc), n(yp), atol=ATOL)
        ys.append(n(yc))
    assert flat_decimate.launches == launches + 3 * int(np.prod(batch))
    np.testing.assert_array_equal(n(sc.tail), n(sp.tail))
    _, y_long = pdec.decimate_flat_iq(pdec.init_flat_iq_state(log2, cuda_device, batch),
                                      t(x).to(cuda_device), log2)
    np.testing.assert_array_equal(np.concatenate(ys, axis=-2), n(y_long))


def test_fftcorr_on_card_matches_cpu(cuda_device):
    from sdrangel_tpu_torch.dsp import fftcorr

    rng = np.random.default_rng(610)
    states = {d: fftcorr.make_state(1024, (2,), d) for d in ("cpu", "cuda")}
    for _ in range(3):
        a = (rng.standard_normal((2, 4096)) + 1j * rng.standard_normal((2, 4096))
             ).astype(np.complex64)
        b = np.roll(a, 7, axis=-1)
        out = {}
        for d in states:
            states[d], out[d] = fftcorr.correlate_block(states[d], t(a).to(d), t(b).to(d), 1024)
        want = n(out["cpu"])
        np.testing.assert_allclose(n(out["cuda"]), want, atol=ATOL * np.abs(want).max())


_NFM8 = ("sdrangel.channel.nfmdemod", 8, {"squelch_db": -100.0, "squelch_gate_ms": 1.0})
_MESH_GEARS = {  # (config kwargs, per-group channel offsets, the FM carrier Hz);
    # the names and configurations of tests/test_torch_mesh.py
    "cen": (dict(n_channels=8), [[30_000.0] * 8], 30_000.0),
    "inf": (dict(n_channels=8, fc_pos="inf"), [[2_000.0] * 8], -1_536_000.0 + 2_000.0),
    "sup": (dict(n_channels=8, fc_pos="sup"), [[2_000.0] * 8], 1_536_000.0 + 2_000.0),
    "pfb": (dict(n_channels=8, pfb_m=8), [[390_000.0] * 8], 390_000.0),
    "a2a": (dict(n_channels=8, pfb_m=8, pfb_all_to_all=True),
            [[(g if g < 4 else g - 8) * 192_000.0 + 300.0 for g in range(8)]], 192_300.0),
    # an NFM group beside an AM group, at 768 kS/s (an AM carrier at −40 kHz added)
    "hetero": (dict(device_rate=768_000.0, bank=(
        ("sdrangel.channel.nfmdemod", 4, {"squelch_db": -100.0, "squelch_gate_ms": 1.0}),
        ("sdrangel.channel.amdemod", 4, {"squelch_db": -100.0}))),
        [[30_000.0] * 4, [-40_000.0] * 4], 30_000.0),
    "chan_stages": (dict(bank=(_NFM8,), chan_stages=1), [[30_000.0] * 8], 30_000.0),
    "split_on": (dict(bank=(_NFM8,), time_axis_channels=True), [[30_000.0] * 8], 30_000.0),
    "split_off": (dict(bank=(_NFM8,), time_axis_channels=False),
                  [list(np.linspace(-30e3, 30e3, 8))], 30_000.0),
}
#: gears whose first block is run on both sides but not compared: its 128
#: audio samples lie inside the audio FIR's 150-sample delay, so the CPU's
#: audio there stays under the silence bar (tests/test_torch_mesh.py starts
#: these from JAX's state after two blocks)
_MESH_WARM_UP = {"sup", "hetero", "chan_stages", "split_on", "split_off"}


@pytest.mark.parametrize("gear", sorted(_MESH_GEARS))
def test_mesh_gear_on_card_matches_cpu_mesh(cuda_device, gear):
    """A 2×2 mesh of four shards of the card against the same mesh of CPU
    shards (the kernels' plain versions) over 3 blocks at ÷8: ≥ 80 dB per
    channel and block, K1-TC (cen) or K1's complex legs (inf, sup) once per
    shard and block."""
    from sdrangel_tpu_torch.parallel import mesh as pmesh
    from sdrangel_tpu_torch.parallel import sharded

    kw, offs, carrier = _MESH_GEARS[gear]
    if "bank" in kw:
        kw = dict(kw, bank=tuple(sharded.BankGroup(*g) for g in kw["bank"]))
    cfg = sharded.ShardedPipelineConfig(n_time=2, n_channel=2, log2_decim=3, block=1 << 15,
                                        **kw)
    src = testsource.TestSourceConfig(sample_rate=cfg.device_rate, carrier_freq=carrier,
                                      modulation="fm", tone_freq=700.0, fm_deviation=4000.0,
                                      amplitude=0.4)
    n_blocks = 3 + (gear in _MESH_WARM_UP)
    iq = testsource.generate(src, n_blocks * cfg.block)
    if gear == "hetero":
        iq = iq + testsource.generate(testsource.TestSourceConfig(
            sample_rate=cfg.device_rate, carrier_freq=-40_000.0, modulation="am",
            am_depth=0.8, amplitude=0.3), n_blocks * cfg.block)
    raws = testsource.to_iq_int16(iq).reshape(n_blocks, -1, 2)
    if cfg.pfb_all_to_all:
        _, idx, res = sharded.a2a_placement(cfg, [np.asarray(offs[0])])
        args = [t(res[0]), t(idx[0])]
    elif cfg.pfb_m:
        idx, res = sharded.grid_split(cfg, np.asarray(offs[0]))
        args = [t(res), t(idx)]
    elif len(offs) > 1:  # one offsets vector per group
        args = [tuple(t(np.asarray(o, np.float32)) for o in offs)]
    else:
        args = [t(np.asarray(offs[0], np.float32))]

    def to(v, dev):
        return tuple(x.to(dev) for x in v) if isinstance(v, tuple) else v.to(dev)

    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        step, init_fn = sharded.build_sharded_step(cfg, pmesh.make_mesh(2, 2, [dev] * 4))
        state, carry = init_fn()
        counter = flat_decimate if cfg.fc_pos != "cen" else flat_decimate_tc
        launches = counter.launches
        complex_legs = flat_decimate.form_launches["f32 complex"]
        audio = []
        for raw in raws:
            state, a, carry = step(state, t(raw).to(dev), carry, *[to(v, dev) for v in args])
            # each group's channels in turn (one group: its (8, A) audio)
            audio.append(np.concatenate([n(g) for g in a]) if isinstance(a, tuple) else n(a))
        runs[dev.type] = (audio, counter.launches - launches)
        if dev.type == "cuda" and cfg.fc_pos != "cen":
            assert flat_decimate.form_launches["f32 complex"] == complex_legs + 4 * n_blocks
    assert runs["cuda"][1] == 4 * n_blocks and runs["cpu"][1] == 0
    warm = n_blocks - 3
    for b, (got, want) in enumerate(zip(runs["cuda"][0][warm:], runs["cpu"][0][warm:])):
        assert np.abs(want).max() > 0.01, f"block {b}: silent"
        for c in range(8):
            if np.any(want[c] != 0.0):
                assert agreement_db(want[c], got[c]) >= 80.0, f"block {b} channel {c}"
            else:  # a grid channel with no carrier: squelched on both
                assert np.abs(got[c]).max() < 1e-6, f"block {b} channel {c}"
