"""The port's production decimator, channelizer and NFM stage functions
against the compiled-reference goldens, at tests/test_reference_golden.py's
own bounds.

- decii_{cen,inf,sup}_l1…l6 through `decimate_flat_any` (the device
  decimation of RxPipeline: K1 on the card, its plain twin here) on the
  input from index 2^k − 1 on: > 57 dB at lag 0 with |scale| 16 ± 1 %
  (test_reference_golden.py:94-106);
- decu_cen_l2 (> 45 dB, |scale| 256 ± 2, DC removed) and
  dec{if,ff,fi}_cen_l4 (> 45 dB) likewise (:123-151);
- chan_cen_cen, chan_low_up_cen, chan_up_low through `channelize` (the
  order-48 stages): > 57 dB at lag 0, |scale| 1 ± 5e-3 (:226-251);
- the NFM stage taps, each stage fed the reference's own stage input:
  post-NCO (nfm48 > 300 dB, nfm96 > 130), post-resampler (nfm48/96 > 130,
  nfm156 > 50), post-discriminator (nfm48/96 > 34 at scale 192 ± 0.2)
  (:514-595).
"""

import numpy as np
import pytest
import torch

from sdrangel_tpu_torch.channels import demod_nfm as pnfm
from sdrangel_tpu_torch.dsp import channelizer as pchan
from sdrangel_tpu_torch.dsp import decimators as pdec
from sdrangel_tpu_torch.dsp import nco as pnco
from sdrangel_tpu_torch.dsp import phasediscri as pdis
from sdrangel_tpu_torch.dsp import resampler as pres
from torch_port_util import CPU, best_lag, fit_snr, load_golden, load_golden_iq, n, t


def _flat(x: np.ndarray, log2: int, fc_pos: str) -> np.ndarray:
    """x from index 2^k − 1 on, whole rotation periods, through the flat
    cascade from a zero tail."""
    xx = x[(1 << log2) - 1:]
    xx = xx[:len(xx) // (4 << log2) * (4 << log2)].astype(np.complex64)
    _, y = pdec.decimate_flat_any(pdec.init_flat_state(log2, CPU), t(xx), log2, fc_pos)
    return n(y)


@pytest.mark.parametrize("log2", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("fc_pos", ["cen", "inf", "sup"])
def test_flat_decimator_meets_reference_golden(log2, fc_pos):
    name = f"decii_{fc_pos}_l{log2}"
    golden = load_golden_iq(name)
    ours = _flat(load_golden_iq(name + "_input"), log2, fc_pos)
    snr, scale = fit_snr(golden, ours, skip=128)
    assert snr > 57.0, f"{name}: snr {snr:.1f} dB"
    assert abs(abs(scale) - 16.0) < 0.16, f"{name}: scale {scale}"


def test_flat_decimator_unsigned_meets_reference_golden():
    """DecimatorsU<qint32,quint8,16,8,127> (rtlsdr u8 ingest), ÷4 centre; the
    reference's 127 against the signal's 127.4 offset is DC, removed."""
    u8 = load_golden("decu_input").astype(np.float64)
    x = (u8[0::2] - 127.0) + 1j * (u8[1::2] - 127.0)
    golden = load_golden_iq("decu_cen_l2")
    ours = _flat(x, 2, "cen").astype(np.complex128)
    snr, scale = fit_snr(golden - golden.mean(), ours - ours.mean(), skip=128)
    assert snr > 45.0, f"decu: snr {snr:.1f} dB"
    assert abs(abs(scale) - 256.0) < 2.0, f"decu: scale {scale}"


@pytest.mark.parametrize("name", ["decif_cen_l4", "decff_cen_l4", "decfi_cen_l4"])
def test_flat_decimator_float_paths_meet_reference_golden(name):
    inp = "decif_input" if name == "decif_cen_l4" else "decff_input"
    snr, _ = fit_snr(load_golden_iq(name), _flat(load_golden_iq(inp), 4, "cen"), skip=64)
    assert snr > 45.0, f"{name}: snr {snr:.1f} dB"


@pytest.mark.parametrize("name,modes", [
    ("chan_cen_cen", (0, 0)), ("chan_low_up_cen", (1, 2, 0)), ("chan_up_low", (2, 1)),
])
def test_channelizer_meets_reference_golden(name, modes):
    x = load_golden_iq(name + "_input")
    golden = load_golden_iq(name)
    k = len(modes)
    signs = tuple({0: 0, 1: +1, 2: -1}[m] for m in modes)  # centre/lower/upper
    plan = pchan.ChannelPlan(signs=signs, decimation=1 << k, channel_rate=0.0,
                             residual_offset=0.0)
    xx = x[(1 << k) - 1:]
    xx = xx[:len(xx) // (8 << k) * (8 << k)].astype(np.complex64)
    _, y = pchan.channelize(pchan.init_state(k, CPU), t(xx), plan)
    lag, snr, scale = best_lag(golden, n(y), range(-2, 3))
    assert snr > 57.0, f"{name}: snr {snr:.1f} dB (lag {lag})"
    assert lag == 0
    assert abs(abs(scale) - 1.0) < 5e-3


@pytest.mark.parametrize("name,rate,offset,bound", [
    ("nfm48", 48_000.0, 0.0, 300.0), ("nfm96", 96_000.0, 12_000.0, 130.0),
])
def test_nfm_stage_nco_meets_reference_golden(name, rate, offset, bound):
    x = load_golden_iq(name + "_input").astype(np.complex64)
    _, xm = pnco.mix_block(pnco.make_nco(CPU), t(x), pnco.freq_to_increment(-offset, rate))
    snr, s = fit_snr(load_golden_iq(name + "_postnco"), n(xm), skip=16)
    assert snr > bound, f"{name} postnco: {snr:.1f} dB"
    assert abs(abs(s) - 1.0) < 1e-4


@pytest.mark.parametrize("name,rate,bound", [
    ("nfm48", 48_000.0, 130.0), ("nfm96", 96_000.0, 130.0),
    # the reference's float32 distance accumulator against the exact
    # rational schedule (test_reference_golden.py:534-542)
    ("nfm156", 156_250.0, 50.0),
])
def test_nfm_stage_resampler_meets_reference_golden(name, rate, bound):
    """The reference's post-NCO tap through the resampler as NFMConfig
    plans it, against its post-resampler tap."""
    gn = load_golden_iq(name + "_postnco")
    per = pnfm.NFMConfig(channel_rate=rate, rf_bandwidth=12_500.0).resampler_plan.block_in
    plan = pnfm.NFMConfig(channel_rate=rate, rf_bandwidth=12_500.0,
                          block_in=(len(gn) // per) * per).resampler_plan
    _, ci = pres.resample_block(pres.init_state(plan, CPU),
                                t(gn[:plan.block_in].astype(np.complex64)), plan)
    lag, snr, s = best_lag(load_golden_iq(name + "_postresamp"), n(ci), range(-4, 5))
    assert snr > bound, f"{name} postresamp: {snr:.1f} dB (lag {lag})"
    assert abs(abs(s) - 1.0) < 1e-4


@pytest.mark.parametrize("name,bound", [("nfm48", 34.0), ("nfm96", 34.0)])
def test_nfm_stage_discriminator_meets_reference_golden(name, bound):
    """The floor is the reference's atan2_approximation2; the scale pins
    the fmScaling convention, 8·audioRate/fmDev = 192 against the unit one."""
    gr = load_golden_iq(name + "_postresamp").astype(np.complex64)
    _, dem, _ = pdis.discriminator_delta(pdis.make_state(CPU), t(gr), 1.0)
    lag, snr, s = best_lag(load_golden(name + "_postdiscri").astype(np.float64),
                           n(dem).astype(np.float64), range(-2, 3))
    assert snr > bound, f"{name} postdiscri: {snr:.1f} dB"
    assert abs(s.real - 192.0) < 0.2
