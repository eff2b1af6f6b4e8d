"""The port's host-side numpy designers and helpers against the JAX
package's originals: array equality, element for element."""

import dataclasses

import numpy as np
import pytest

import torch_port_util  # noqa: F401  (caps torch threads)
from sdrangel_tpu.channels import demod_nfm as jnfm
from sdrangel_tpu.dsp import channelizer as jchan
from sdrangel_tpu.dsp import decimators as jdec
from sdrangel_tpu.dsp import fftwindow as jwin
from sdrangel_tpu.dsp import firdesign as jfir
from sdrangel_tpu.dsp import hbfilter as jhb
from sdrangel_tpu.dsp import nco as jnco
from sdrangel_tpu.dsp import resampler as jres
from sdrangel_tpu.io import sdriq as jsdriq
from sdrangel_tpu.io import testsource as jsrc
from sdrangel_tpu.io import wav as jwav
from sdrangel_tpu_torch.channels import demod_nfm as pnfm
from sdrangel_tpu_torch.dsp import channelizer as pchan
from sdrangel_tpu_torch.dsp import decimators as pdec
from sdrangel_tpu_torch.dsp import fftwindow as pwin
from sdrangel_tpu_torch.dsp import firdesign as pfir
from sdrangel_tpu_torch.dsp import hbfilter as phb
from sdrangel_tpu_torch.dsp import nco as pnco
from sdrangel_tpu_torch.dsp import resampler as pres
from sdrangel_tpu_torch.io import sdriq as psdriq
from sdrangel_tpu_torch.io import testsource as psrc
from sdrangel_tpu_torch.io import wav as pwav


@pytest.mark.parametrize("order", [48, 64, 96])
def test_hb_taps_equal(order):
    np.testing.assert_array_equal(phb.hb_taps(order), jhb.hb_taps(order))


def test_hb_orders_equal():
    assert (phb.DECIMATORS_ORDER, phb.DOWNCHANNELIZER_ORDER, phb.UPCHANNELIZER_ORDER,
            phb.INTERPOLATORS_ORDERS) == (jhb.DECIMATORS_ORDER, jhb.DOWNCHANNELIZER_ORDER,
                                          jhb.UPCHANNELIZER_ORDER, jhb.INTERPOLATORS_ORDERS)


@pytest.mark.parametrize("log2", [1, 2, 3, 4, 5, 6])
def test_flat_legs_equal(log2):
    np.testing.assert_array_equal(
        pdec.flat_equivalent_filter(log2), jdec.flat_equivalent_filter(log2))
    np.testing.assert_array_equal(pdec.flat_legs(log2), jdec.flat_legs(log2))


@pytest.mark.parametrize("log2", [1, 3, 6])
@pytest.mark.parametrize("fc_pos", ["inf", "sup"])
def test_flat_rotated_equal(log2, fc_pos):
    legs_p, pat_p = pdec.flat_rotated(log2, fc_pos)
    legs_j, pat_j = jdec.flat_rotated(log2, fc_pos)
    np.testing.assert_array_equal(legs_p, legs_j)
    np.testing.assert_array_equal(pat_p, pat_j)


def test_placement_schedule_equal():
    for log2 in range(7):
        for fc_pos in ("cen", "inf", "sup"):
            assert pdec.placement_schedule(log2, fc_pos) == jdec.placement_schedule(log2, fc_pos)


@pytest.mark.parametrize("fc_pos", ["cen", "inf", "sup"])
def test_decimate_reference_oracle_equal(fc_pos):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)).astype(np.complex64)
    np.testing.assert_array_equal(
        pdec.decimate_reference_oracle(x, 3, fc_pos), jdec.decimate_reference_oracle(x, 3, fc_pos))


def test_plan_channel_equal():
    for in_rate in (384_000.0, 156_250.0, 96_000.0):
        for offset in np.linspace(-0.45 * in_rate, 0.45 * in_rate, 37):
            for req in (12_500.0, 48_000.0):
                assert dataclasses.astuple(pchan.plan_channel(in_rate, req, offset)) == \
                    dataclasses.astuple(jchan.plan_channel(in_rate, req, offset))


@pytest.mark.parametrize("in_rate,block_in", [(96_000.0, 4096), (156_250.0, 160_000)])
def test_resampler_plan_equal(in_rate, block_in):
    cutoff = 12_500.0 / 2.2
    pp = pres.make_plan(in_rate, 48_000.0, block_in, cutoff=cutoff)
    jp = jres.make_plan(in_rate, 48_000.0, block_in, cutoff=cutoff)
    assert (pp.p, pp.q, pp.block_out, pp.ntaps) == (jp.p, jp.q, jp.block_out, jp.ntaps)
    np.testing.assert_array_equal(pp.taps, jp.taps)
    np.testing.assert_array_equal(pp.start_idx, jp.start_idx)
    np.testing.assert_array_equal(pp.phase, jp.phase)
    np.testing.assert_array_equal(pp.residue_kernels, jp.residue_kernels[:, 0, :])
    np.testing.assert_array_equal(
        pres.create_polyphase_lowpass(16, 1.0, 16 * in_rate, cutoff),
        jres.create_polyphase_lowpass(16, 1.0, 16 * in_rate, cutoff))


@pytest.mark.parametrize("af_bw", [3000.0, 5000.0])
def test_nfm_filters_equal(af_bw):
    np.testing.assert_array_equal(
        pfir.nfm_mod_bandpass(301, 48_000.0, 300.0, af_bw),
        jfir.nfm_mod_bandpass(301, 48_000.0, 300.0, af_bw))
    np.testing.assert_array_equal(
        pfir.bandpass_ring_kernel(301, 48_000.0, 300.0, af_bw),
        jfir.bandpass_ring_kernel(301, 48_000.0, 300.0, af_bw))
    np.testing.assert_array_equal(pfir.lowpass(63, 300.0 / 48_000.0),
                                  jfir.lowpass(63, 300.0 / 48_000.0))
    pc = pnfm.NFMConfig(channel_rate=156_250.0, af_bandwidth=af_bw, block_in=160_000)
    jc = jnfm.NFMConfig(channel_rate=156_250.0, af_bandwidth=af_bw, block_in=160_000)
    np.testing.assert_array_equal(pc.bandpass_taps, jc.bandpass_taps)
    assert pc.squelch_gate_samples == jc.squelch_gate_samples
    assert pc.fm_scaling == jc.fm_scaling
    np.testing.assert_array_equal(pc.resampler_plan.residue_kernels,
                                  jc.resampler_plan.residue_kernels[:, 0, :])


def test_nco_increment_equal():
    freqs = np.array([-20_000.0, -1.5, 0.0, 7.25, 12_345.678, 77_000.0])
    np.testing.assert_array_equal(pnco.freq_to_increment(freqs, 156_250.0),
                                  jnco.freq_to_increment(freqs, 156_250.0))


@pytest.mark.parametrize("func", list(jwin.Function))
def test_fft_windows_equal(func):
    np.testing.assert_array_equal(pwin.window(pwin.Function(func.value), 1024),
                                  jwin.window(func, 1024))


@pytest.mark.parametrize("modulation", ["none", "am", "fm"])
def test_testsource_equal(modulation):
    kw = dict(sample_rate=768_000.0, carrier_freq=12_000.0, modulation=modulation,
              amplitude=0.4, dc_factor=0.01, i_factor=0.02, phase_imbalance=0.03)
    pc, jc = psrc.TestSourceConfig(**kw), jsrc.TestSourceConfig(**kw)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    np.testing.assert_array_equal(psrc.generate(pc, 5000, start_sample=777),
                                  jsrc.generate(jc, 5000, start_sample=777))


def test_wav_and_sdriq_io_equal(tmp_path):
    rng = np.random.default_rng(3)
    audio = rng.uniform(-1.2, 1.2, 4000).astype(np.float32)
    pwav.write_wav(str(tmp_path / "p.wav"), audio)
    jwav.write_wav(str(tmp_path / "j.wav"), audio)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    dp, fp = pwav.read_wav(str(tmp_path / "j.wav"))
    dj, fj = jwav.read_wav(str(tmp_path / "j.wav"))
    np.testing.assert_array_equal(dp, dj)
    assert fp == fj

    iq = (rng.uniform(-0.9, 0.9, 3000) + 1j * rng.uniform(-0.9, 0.9, 3000)).astype(np.complex64)
    path = str(tmp_path / "x.sdriq")
    jsdriq.write(path, iq, sample_rate=768_000, center_frequency=145_000_000)
    assert dataclasses.asdict(psdriq.read_header(path)) == \
        dataclasses.asdict(jsdriq.read_header(path))
    _, mp = psdriq.open_mmap(path)
    _, mj = jsdriq.open_mmap(path)
    for start, count in ((0, 3000), (2990, 25), (5, 7000)):
        np.testing.assert_array_equal(psdriq.read_block(mp, start, count),
                                      jsdriq.read_block(mj, start, count))
