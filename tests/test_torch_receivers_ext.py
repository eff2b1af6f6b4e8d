"""The port's NFM with CTCSS and the AF squelch, synchronous AM and broadcast
FM against the JAX package, the compiled-reference goldens of sync AM and
broadcast FM, and the three through RxPipeline, the session and HTTP.

Tolerances: the receivers streamed over 3 blocks against JAX `process`
≥ 100 dB of audio agreement (measured 120–140 dB: f32 sums in another
order, the PLL's last-ulp sin/cos/atan2 differences round the loop), the
reference-exact PLL (`ref_pll_parity`) ≥ 65 dB on its first block and
≥ 90 dB after (measured 76.4 and ≥ 100.8: its K = 1000 loop amplifies
those ulps while it acquires); gate decisions, squelch counters and NCO
phases equal. The goldens at test_reference_golden.py's own bounds:
amsync96 > 20 dB at |scale| = rate/24 ± 2 %, full parity > 42 dB at
scale 2000 ± 1, the sync tail > 120 dB at scale 1 ± 1e-5; bfm384 mono sum
> 125 dB with JAX's separation bounds. Pipelines, the session and HTTP
≥ 80 dB against JAX's or the port's own RxPipeline.
"""

import io
import json
import math
import threading
import time
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdrangel_tpu.channels import demod_am as jam
from sdrangel_tpu.channels import demod_bfm as jbfm
from sdrangel_tpu.channels import demod_nfm as jnfm
from sdrangel_tpu.dsp import nco as jnco
from sdrangel_tpu.runtime import engine as jeng
from sdrangel_tpu_torch.api.server import make_server
from sdrangel_tpu_torch.channels import demod_am as pam
from sdrangel_tpu_torch.channels import demod_bfm as pbfm
from sdrangel_tpu_torch.channels import demod_nfm as pnfm
from sdrangel_tpu_torch.channels import registry as preg
from sdrangel_tpu_torch.dsp import agc as pagc
from sdrangel_tpu_torch.dsp import fftfilt as pff
from sdrangel_tpu_torch.dsp import nco as pnco
from sdrangel_tpu_torch.io import sdriq
from sdrangel_tpu_torch.runtime import engine as peng
from sdrangel_tpu_torch.runtime import session as psession
from sdrangel_tpu_torch.runtime.session import Session
from torch_port_util import CPU, agreement_db, load_golden, n, real_best_lag, t, tone_snr

NFM = "sdrangel.channel.nfmdemod"
AM = "sdrangel.channel.amdemod"
BFM = "sdrangel.channel.bfm"


def _noise(rng, size, level=0.003):
    return level * (rng.standard_normal(size) + 1j * rng.standard_normal(size))


def _am(rng, size, rate, offset, depth=0.8):
    tt = np.arange(size) / rate
    z = 0.4 * (1.0 + depth * np.sin(2 * np.pi * 1000.0 * tt)) * np.exp(
        1j * (2 * np.pi * offset * tt + 0.3))
    return (z + _noise(rng, size)).astype(np.complex64)


def _nfm(rng, size, rate, offset, ctcss_hz=88.5, noise=0.003):
    tt = np.arange(size) / rate
    af = 0.6 * np.sin(2 * np.pi * 1000.0 * tt) + 0.15 * np.sin(2 * np.pi * ctcss_hz * tt)
    ph = 2 * np.pi * 3000.0 * np.cumsum(af) / rate
    return (0.3 * np.exp(1j * (2 * np.pi * offset * tt + ph)) + _noise(rng, size, noise)
            ).astype(np.complex64)


def _mpx(size, rate, offset=0.0, left=1000.0, right=None, start=0):
    """Stereo broadcast FM: L a tone, R silent or a tone, a 10 % pilot sin(θ)
    with the 38 kHz subcarrier sin(2θ) (ITU-R BS.450), 75 kHz deviation."""
    tt = (start + np.arange(size)) / rate
    lft = np.sin(2 * np.pi * left * tt)
    rgt = np.zeros_like(tt) if right is None else np.sin(2 * np.pi * right * tt)
    mpx = (0.45 * (lft + rgt) + 0.45 * (lft - rgt) * np.sin(2 * np.pi * 38_000.0 * tt)
           + 0.1 * np.sin(2 * np.pi * 19_000.0 * tt))
    ph = 2 * np.pi * 75_000.0 * (np.cumsum(mpx) / rate) + 2 * np.pi * offset * tt
    return (0.5 * np.exp(1j * ph)).astype(np.complex64)


def _stream(jmod, pmod, kw, x, block, pick=lambda out: out):
    """JAX `process` and the port's over consecutive blocks of x; returns
    per block (jax output, port output) and the two end states."""
    jc, pc = getattr(jmod, _CFG[jmod])(**kw), getattr(pmod, _CFG[pmod])(**kw)
    js, ps = jmod.make_state(jc), pmod.make_state(pc, CPU)
    run = jax.jit(jmod.process, static_argnums=2)
    outs = []
    for b in range(len(x) // block):
        xb = x[b * block:(b + 1) * block]
        js, jy = run(js, jnp.asarray(xb), jc)
        ps, py = pmod.process(ps, t(xb), pc)
        outs.append((np.asarray(pick(jy)), n(pick(py))))
    return outs, js, ps


_CFG = {jam: "AMConfig", pam: "AMConfig", jnfm: "NFMConfig", pnfm: "NFMConfig",
        jbfm: "BFMConfig", pbfm: "BFMConfig"}


# -- NFM: CTCSS and the AF squelch ---------------------------------------------

@pytest.mark.parametrize("case", ["ctcss_right", "ctcss_wrong", "ctcss_detect_only",
                                  "delta_squelch", "delta_squelch_noise"])
def test_nfm_squelch_modes_stream_like_jax(case):
    """96 kHz, 3 blocks of 16384: the right tone (index 8 = 88.5 Hz) passes,
    the wrong one (index 9) shuts the audio; the delta squelch opens on the
    modulated carrier and stays shut on noise alone."""
    rng = np.random.default_rng(60)
    kw = dict(channel_rate=96_000.0, input_offset=12_000.0, block_in=16_384, squelch_db=-60.0)
    kw.update({"ctcss_right": dict(ctcss_on=True, ctcss_index=8),
               "ctcss_wrong": dict(ctcss_on=True, ctcss_index=9),
               "ctcss_detect_only": dict(ctcss_on=True),
               "delta_squelch": dict(delta_squelch=True, squelch_db=-15.0),
               "delta_squelch_noise": dict(delta_squelch=True, squelch_db=-15.0)}[case])
    x = _nfm(rng, 3 * 16_384, 96_000.0, 12_000.0)
    if case == "delta_squelch_noise":
        x = (_noise(rng, len(x), 0.3)).astype(np.complex64)
    outs, js, ps = _stream(jnfm, pnfm, kw, x, 16_384)
    for jy, py in outs:
        assert py.shape == jy.shape
        if np.any(jy):
            assert agreement_db(jy, py) >= 100.0
        else:
            assert not np.any(py)
    heard = np.concatenate([py for _, py in outs])
    if case in ("ctcss_wrong", "delta_squelch_noise"):
        assert not np.any(heard)
    else:
        assert tone_snr(heard[16_384:].astype(np.float64), 1000.0, 48_000.0) > 20.0
    np.testing.assert_array_equal(n(ps.af_squelch.squelch_count),
                                  np.asarray(js.af_squelch.squelch_count))
    np.testing.assert_array_equal(n(ps.af_squelch.is_open), np.asarray(js.af_squelch.is_open))
    np.testing.assert_allclose(n(ps.ctcss_lp.tail), np.asarray(js.ctcss_lp.tail), atol=1e-6)
    assert float(ps.squelch.count) == float(js.squelch.count)


def test_nfm_ctcss_bank_equals_single_channel_calls():
    """A (2,) bank, one channel on the right tone and one on a 100 Hz tone:
    the gate is per channel, as two one-channel calls."""
    rng = np.random.default_rng(61)
    cfg = pnfm.NFMConfig(channel_rate=96_000.0, input_offset=12_000.0, block_in=16_384,
                         squelch_db=-60.0, ctcss_on=True, ctcss_index=8)
    x = np.stack([_nfm(rng, 2 * 16_384, 96_000.0, 12_000.0),
                  _nfm(rng, 2 * 16_384, 96_000.0, 12_000.0, ctcss_hz=100.0)])
    bank = pnfm.make_state(cfg, CPU, (2,))
    singles = [pnfm.make_state(cfg, CPU) for _ in range(2)]
    for b in range(2):
        xb = x[:, b * 16_384:(b + 1) * 16_384]
        bank, yb = pnfm.process(bank, t(xb), cfg)
        for c in range(2):
            singles[c], yc = pnfm.process(singles[c], t(xb[c]), cfg)
            np.testing.assert_allclose(n(yb[c]), n(yc), atol=1e-6)
    assert np.any(n(yb[0])) and not np.any(n(yb[1]))


# -- synchronous AM --------------------------------------------------------------

AM_CASES = {
    "usb": {}, "lsb": {"sync_usb": False}, "dsb": {"sync_dsb": True},
    "ref_pll_parity": {"ref_pll_parity": True},
    "frame_offset": {"sync_frame_offset": 148, "bandpass_enable": False},
    "parity_all": {"ref_pll_parity": True, "ref_nco_quant": True, "sync_frame_offset": 148},
}


@pytest.mark.parametrize("case", list(AM_CASES))
def test_am_sync_streams_like_jax(case):
    """96 kHz, carrier 3 Hz off the channel offset, 3 blocks of 8192.

    With the reference NCO grid as well (`parity_all`) the reference loop
    acquires a carrier 10.8 Hz off, and its K = 1000 integrators turn the
    133 dB agreement of its prefiltered input (FFT rounding) into a 50 dB
    carrier difference in the first block; the AGC's 12000-sample memory
    carries that on (measured 30.2, 53.2, 58.6 dB). On one and the same
    input the two loops agree within 4e-5 (test_torch_phaselock)."""
    rng = np.random.default_rng(62)
    kw = dict(channel_rate=96_000.0, input_offset=5000.0, squelch_db=-30.0, block_in=8192,
              sync_am=True, **AM_CASES[case])
    outs, js, ps = _stream(jam, pam, kw, _am(rng, 3 * 8192, 96_000.0, 5003.0), 8192)
    parity = kw.get("ref_pll_parity", False)
    bounds = {"ref_pll_parity": (65.0, 90.0), "parity_all": (25.0, 45.0)}.get(case, (100.0,) * 2)
    for b, (jy, py) in enumerate(outs):
        assert py.shape == jy.shape == (4096,)
        assert agreement_db(jy, py) >= bounds[b > 0], (b, agreement_db(jy, py))
    audio = np.concatenate([py for _, py in outs])
    assert tone_snr(audio[4096:].astype(np.float64), 1000.0, 48_000.0) > 20.0
    if parity:
        np.testing.assert_allclose(n(ps.ref_pll.phi), np.asarray(js.ref_pll.phi), atol=1e-3)
    else:
        np.testing.assert_allclose(n(ps.pll.phase), np.asarray(js.pll.phase), atol=1e-4)
        np.testing.assert_allclose(n(ps.pll.freq), np.asarray(js.pll.freq), atol=1e-6)
    for f in ("gate_counter", "count", "ramp"):
        assert float(getattr(ps.agc, f)) == float(getattr(js.agc, f)), f
    assert int(ps.nco.phase) == int(js.nco.phase)
    assert float(ps.squelch.count) == float(js.squelch.count)


def test_am_sync_bank_equals_single_channel_calls():
    """A (2,) bank of sync-AM channels, carriers at different offsets: one
    K-PLL (plain loop here) over both rows equals two one-channel calls
    within 1e-5 of the block's peak (measured 1.4e-6: the batched FFTs and
    sums round in another order, and the loop carries it)."""
    rng = np.random.default_rng(63)
    cfg = pam.AMConfig(channel_rate=96_000.0, input_offset=5000.0, squelch_db=-30.0,
                       block_in=8192, sync_am=True)
    x = np.stack([_am(rng, 2 * 8192, 96_000.0, 5003.0), _am(rng, 2 * 8192, 96_000.0, 4990.0)])
    bank = pam.make_state(cfg, CPU, (2,))
    singles = [pam.make_state(cfg, CPU) for _ in range(2)]
    for b in range(2):
        xb = x[:, b * 8192:(b + 1) * 8192]
        bank, yb = pam.process(bank, t(xb), cfg)
        for c in range(2):
            singles[c], yc = pam.process(singles[c], t(xb[c]), cfg)
            np.testing.assert_allclose(n(yb[c]), n(yc), atol=1e-5 * max(1.0, n(yc).max()))
    np.testing.assert_allclose(n(bank.pll.phase), [float(s.pll.phase) for s in singles],
                               atol=1e-5)


def _amsync96():
    flat = load_golden("amsync96_input")
    return ((flat[0::2] / 32768.0) + 1j * (flat[1::2] / 32768.0)).astype(np.complex64)


def test_am_sync_meets_reference_golden():
    """test_reference_golden.py:965-987: > 20 dB with |scale| = rate/24."""
    x = _amsync96()
    cfg = pam.AMConfig(channel_rate=96_000.0, input_offset=5000.0, rf_bandwidth=5000.0,
                       squelch_db=-40.0, bandpass_enable=False, sync_am=True, block_in=len(x))
    _, audio = pam.process(pam.make_state(cfg, CPU), t(x), cfg)
    lag, snr, s = real_best_lag(load_golden("amsync96_audio").astype(float), n(audio),
                                range(300, 500, 2), 20_000)
    assert snr > 20.0, f"amsync96: snr {snr:.1f} dB (lag {lag})"
    assert abs(abs(s) / 2000.0 - 1.0) < 0.02, f"scale {s}"


def test_am_sync_full_parity_meets_reference_golden():
    """test_reference_golden.py:1013-1045: the three parity modes together,
    > 42 dB at scale 2000 ± 1."""
    x = _amsync96()
    cfg = pam.AMConfig(channel_rate=96_000.0, input_offset=5000.0, rf_bandwidth=5000.0,
                       squelch_db=-40.0, bandpass_enable=False, sync_am=True, block_in=len(x),
                       ref_nco_quant=True, ref_pll_parity=True, sync_frame_offset=148)
    _, audio = pam.process(pam.make_state(cfg, CPU), t(x), cfg)
    lag, snr, s = real_best_lag(load_golden("amsync96_audio").astype(float), n(audio),
                                range(-200, 200), 20_000)
    assert snr > 42.0, f"amsync96 full parity: snr {snr:.1f} dB (lag {lag})"
    assert abs(s - 2000.0) < 1.0, f"scale {s}"


def test_am_sync_residual_is_ref_nco_quant():
    """test_reference_golden.py:990-1010: the golden carrier rotates at
    +7.8125 Hz, the truncation of a 5000 Hz offset to the fs/4096 grid,
    which the port's reference-grid increment reproduces."""
    gc = load_golden("amsync96_pllcarrier")
    gcar = gc[0::2] + 1j * gc[1::2]
    d = np.angle(gcar[20001:32000] * np.conj(gcar[20000:31999]))
    assert abs(float(d.mean()) * 48_000.0 / (2.0 * np.pi) - 7.8125) < 0.5
    inc = pnco.freq_to_increment_ref_quant(-5000.0, 96_000.0)
    assert inc == jnco.freq_to_increment_ref_quant(-5000.0, 96_000.0)
    achieved = (float(np.int64(np.uint32(inc).astype(np.int64) - (1 << 32))) / (1 << 32)) * 96e3
    assert abs(achieved - (-4992.1875)) < 1e-6


def test_am_sync_tail_meets_reference_golden():
    """test_reference_golden.py:1048-1075: runSSB + MagAGC + (re+im)·4 on
    the reference's own post-mix stream, > 120 dB at scale 1 ± 1e-5."""
    gm = load_golden("amsync96_postmix")
    gd = load_golden("amsync96_demod")
    off = 148
    cfg = pam.AMConfig(channel_rate=96_000.0, input_offset=5000.0, rf_bandwidth=5000.0,
                       sync_am=True, bandpass_enable=False, block_in=len(gm) // 2)
    fed = np.concatenate([np.zeros(off), gm[0::2] + 1j * gm[1::2]])
    fed = fed[:len(fed) // 512 * 512].astype(np.complex64)
    _, filt = pff.run_ssb(pff.make_state(cfg.sync_fft_len, CPU), t(fed),
                          t(np.asarray(cfg.sync_filter)), usb=True, get_dc=False)
    _, lev, _, _ = pagc.mag_agc(pagc.make_state(cfg.sync_agc_config, CPU), filt,
                                cfg.sync_agc_config)
    dem = n((lev.real + lev.imag) * 4.0)
    lag, snr, s = real_best_lag(gd.astype(float), dem, range(-off - 520, -off + 530), 20_000)
    assert snr > 120.0, f"amsync tail: {snr:.1f} dB (lag {lag})"
    assert abs(s - 1.0) < 1e-5, f"scale {s}"


# -- broadcast FM ----------------------------------------------------------------

@pytest.mark.parametrize("stereo", [True, False])
def test_bfm_streams_like_jax(stereo):
    """384 kHz, 3 blocks of 6144 (the squelch opens inside the second): the
    stereo audio, the RDS baseband and the pilot level."""
    kw = dict(channel_rate=384_000.0, block_in=6144, audio_stereo=stereo)
    x = _mpx(3 * 6144, 384_000.0, left=1000.0, right=2500.0)
    outs, js, ps = _stream(jbfm, pbfm, kw, x, 6144, pick=lambda o: o.audio)
    for jy, py in outs:
        assert py.shape == jy.shape == (768, 2)
        if np.any(jy):
            assert agreement_db(jy, py) >= 100.0
        else:
            assert not np.any(py)
    if stereo:
        left, right = outs[-1][1][:, 0], outs[-1][1][:, 1]
        assert not np.allclose(left, right)
    else:
        np.testing.assert_array_equal(outs[-1][1][:, 0], outs[-1][1][:, 1])
    rds, _, _ = _stream(jbfm, pbfm, kw, x, 6144, pick=lambda o: o.rds_baseband)
    pilot, _, _ = _stream(jbfm, pbfm, kw, x, 6144, pick=lambda o: o.pilot_level)
    for (jr, pr), (jl, pl) in zip(rds[1:], pilot[1:]):
        assert agreement_db(np.abs(jr), np.abs(pr)) >= 90.0
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_array_equal(n(ps.squelch_count), np.asarray(js.squelch_count))
    np.testing.assert_allclose(n(ps.deemph_l.y1), np.asarray(js.deemph_l.y1), atol=1e-6)
    np.testing.assert_allclose(n(ps.pilot_fir.tail), np.asarray(js.pilot_fir.tail), atol=1e-6)


def test_bfm_meets_reference_golden():
    """test_reference_golden.py:912-943: the mono sum > 125 dB, the
    reference's own separation as its behaviour record, the port's analytic
    downmix > 35 dB; test_reference_golden.py:946-956: the golden's pilot
    harmonic is a locked unit 38 kHz tone."""
    flat = load_golden("bfm384_input")
    x = ((flat[0::2] / 32768.0) + 1j * (flat[1::2] / 32768.0)).astype(np.complex64)
    blk = (len(x) // math.lcm(768, 512)) * math.lcm(768, 512)
    x = x[:blk]
    g = load_golden("bfm384_audio_lr")
    gl, gr = g[0::2].astype(float), g[1::2].astype(float)
    cfg = pbfm.BFMConfig(channel_rate=384_000.0, rf_bandwidth=180_000.0,
                         af_bandwidth=15_000.0, audio_stereo=True, block_in=blk)
    _, out = pbfm.process(pbfm.make_state(cfg, CPU), t(x), cfg)
    y = n(out.audio)
    yl, yr = y[..., 0].astype(float), y[..., 1].astype(float)
    lag, snr, _ = real_best_lag(gl + gr, yl + yr, range(-40, 41), 12_000)
    assert snr > 125.0, f"bfm mono sum: {snr:.1f} dB (lag {lag})"

    def separation_db(left, right):
        w = np.hanning(16_384)
        fr = np.fft.rfftfreq(16_384, 1 / 48_000)
        sl = np.abs(np.fft.rfft(left[12_000:12_000 + 16_384] * w))
        return 20 * np.log10(sl[np.abs(fr - 1000) < 10].max() / sl[np.abs(fr - 2500) < 10].max())

    assert 5.0 < separation_db(gl, gr) < 25.0
    assert -25.0 < separation_db(gr, gl) < -3.0
    assert separation_db(yl, yr) > 35.0
    assert separation_db(yr, yl) < -30.0

    p = load_golden("bfm384_pilot")
    mid = p[100_000:165_536].astype(float)
    assert abs(mid.std() - 0.707) < 0.02
    spec = np.abs(np.fft.rfft(mid * np.hanning(len(mid))))
    assert abs(np.fft.rfftfreq(len(mid), 1 / 384_000)[int(np.argmax(spec))] - 38_000.0) < 50.0


# -- the pipeline, the session and HTTP ------------------------------------------

RATE = 768_000.0
PIPE_CHANNELS = [  # (uri, offset, settings)
    (BFM, 100_000.0, {}),
    (AM, -100_000.0, {"sync_am": True, "squelch_db": -40.0}),
    (NFM, -150_000.0, {"ctcss_on": True, "ctcss_index": 8, "squelch_db": -60.0}),
]


def _capture_iq(size, start=0):
    rng = np.random.default_rng(64 + start)
    tt = (start + np.arange(size)) / RATE
    am = 0.25 * (1 + 0.8 * np.sin(2 * np.pi * 1000 * tt)) * np.exp(2j * np.pi * -100_000 * tt)
    af = 0.6 * np.sin(2 * np.pi * 1000 * tt) + 0.15 * np.sin(2 * np.pi * 88.5 * tt)
    nfm = 0.2 * np.exp(1j * (2 * np.pi * -150_000 * tt + 2 * np.pi * 3000 * np.cumsum(af) / RATE))
    iq = 0.5 * _mpx(size, RATE, offset=100_000.0, start=start) + am + nfm
    return (iq + _noise(rng, size, 0.002)).astype(np.complex64)


def _raw(iq):
    raw = np.empty((len(iq), 2), np.int16)
    raw[:, 0] = np.clip(np.round(iq.real * 32768), -32768, 32767)
    raw[:, 1] = np.clip(np.round(iq.imag * 32768), -32768, 32767)
    return raw


def test_pipeline_matches_jax_with_state_handed_over():
    """BFM, sync AM and NFM with CTCSS in one RxPipeline (768 kS/s ÷2):
    each channel's audio ≥ 80 dB against JAX's per block; then JAX's state
    after 2 blocks carries the port through a third that matches JAX's."""
    specs = [(uri, off, st, preg.requested_rate(uri, st)) for uri, off, st in PIPE_CHANNELS]
    jp = jeng.RxPipeline(jeng.DeviceConfig(RATE, log2_decim=1),
                         [jeng.ChannelSpec(*s) for s in specs], block_size=32_768)
    pp = peng.RxPipeline(peng.DeviceConfig(RATE, log2_decim=1),
                         [peng.ChannelSpec(*s) for s in specs], CPU, block_size=32_768)
    assert pp.device_block == jp.device_block
    assert [p.signs for p in pp.plans] == [p.signs for p in jp.plans]
    raws = _raw(_capture_iq(3 * pp.device_block)).reshape(3, pp.device_block, 2)
    js, ps = jp.init_state(), pp.init_state()
    for b, raw in enumerate(raws):
        if b == 2:
            ps = pp.state_from_numpy(jax.tree.map(np.asarray, js))
        js, jo = jp._step(js, jnp.asarray(raw))
        ps, po = pp.step(ps, t(raw))
        for c in range(3):
            ja, pa = np.asarray(jo["channels"][c]["audio"]), n(po["channels"][c]["audio"])
            assert pa.shape == ja.shape
            if b:
                assert np.any(ja), (b, c)
                assert agreement_db(ja, pa) >= 80.0, (b, c, agreement_db(ja, pa))
            assert bool(po["channels"][c]["squelch"]) == bool(jo["channels"][c]["squelch"])
    assert pa.ndim == 1 and n(po["channels"][0]["audio"]).shape[-1] == 2


def test_device_set_matches_jax_device_set(tmp_path):
    """One .sdriq through the port's DeviceSet on the CPU and JAX's, BFM and
    sync AM: audio ≥ 80 dB, the same frames (stereo for BFM) and blocks."""
    from sdrangel_tpu.runtime.session import DeviceSet as JaxDeviceSet

    path = str(tmp_path / "cap.sdriq")
    sdriq.write(path, _capture_iq(3 * 98_304), sample_rate=int(RATE), sample_size=16,
                timestamp=0)
    source = {"kind": "filesource", "file_path": path, "log2_decim": 1, "run_blocks": 3}
    channels = [(BFM, {"inputFrequencyOffset": 100_000.0}),
                (AM, {"inputFrequencyOffset": -100_000.0, "sync_am": True,
                      "squelch_db": -40.0})]
    port = psession.DeviceSet(0, CPU)
    jax_ds = JaxDeviceSet(0)
    for ds in (port, jax_ds):
        ds.update_source(dict(source))
        for uri, st in channels:
            ds.add_channel(uri, dict(st))
        ds.start()
        t0 = time.time()
        while ds.running and time.time() - t0 < 300:
            time.sleep(0.02)
        ds.stop()
        assert not ds.error, ds.error
    assert port.blocks_processed == jax_ds.blocks_processed > 0
    for i in range(2):
        ja, pa = jax_ds.drain_audio(i), port.drain_audio(i)
        assert ja.shape == pa.shape and np.any(ja), (i, ja.shape, pa.shape)
        assert pa.ndim == (2 if i == 0 else 1)  # BFM's frames are stereo
        assert agreement_db(ja, pa) >= 80.0, (i, agreement_db(ja, pa))
        assert port.channels[i].audio_samples == jax_ds.channels[i].audio_samples


def test_bfm_channel_over_http(tmp_path):
    """A BFM channel added over HTTP on a file source: the drained WAV is
    stereo and equals RxPipeline.run on the same capture; the schema lists
    BFM's settings and the AM-sync and CTCSS fields."""
    path = str(tmp_path / "fm.sdriq")
    sdriq.write(path, 0.5 * _mpx(2 * 98_304, RATE, offset=100_000.0), sample_rate=int(RATE),
                sample_size=16, timestamp=0)
    session = Session(device=CPU)
    srv = make_server(session, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def req(p, method="GET", body=None):
        data = None if body is None else json.dumps(body).encode()
        r = urllib.request.Request(base + p, data=data, method=method)
        if data:
            r.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(r) as resp:
            raw = resp.read()
            return raw if resp.headers["Content-Type"] == "audio/wav" else json.loads(raw)

    try:
        req("/sdrangel/devicesets", "POST")
        req("/sdrangel/deviceset/0/device/settings", "PATCH", {
            "kind": "filesource", "file_path": path, "log2_decim": 1, "run_blocks": 2,
            "publish_every": 1})
        req("/sdrangel/deviceset/0/channel", "POST",
            {"channelType": BFM, "inputFrequencyOffset": 100_000.0})
        req("/sdrangel/deviceset/0/device/run", "POST")
        t0 = time.time()
        while req("/sdrangel/deviceset/0")["state"] == "running" and time.time() - t0 < 300:
            time.sleep(0.02)
        data = req("/sdrangel/deviceset/0/channel/0/audio")
        kinds = req("/sdrangel/channels")
    finally:
        session.shutdown()
        srv.shutdown()
        srv.server_close()
    with wave.open(io.BytesIO(data)) as w:
        assert w.getnchannels() == 2 and w.getframerate() == 48_000
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16).reshape(-1, 2)
    pipe = peng.RxPipeline(peng.DeviceConfig(RATE, log2_decim=1),
                           [peng.ChannelSpec(BFM, 100_000.0, {}, 180_000.0)], CPU,
                           block_size=1 << 16)
    info, mm = sdriq.open_mmap(path)
    ref = np.concatenate([o["channels"][0]["audio"] for _, o in pipe.run(
        lambda b, count: sdriq.read_block(mm, b * count, count), 2)])
    del mm
    ref_pcm = np.clip(ref * 32768.0, -32768, 32767).astype(np.int16)
    assert pcm.shape == ref_pcm.shape and np.any(pcm)
    assert agreement_db(ref_pcm[:, 0], pcm[:, 0]) >= 80.0
    text = json.dumps(kinds)
    for field in ("audio_stereo", "deemphasis_us", "sync_dsb", "ref_pll_parity", "ctcss_index",
                  "delta_squelch"):
        assert field in text, field


def test_cli_demod_bfm_writes_stereo_and_takes_settings(tmp_path):
    """`demod --channel bfm:<offset>` writes a 2-channel WAV equal to
    RxPipeline's audio; `--set` reaches every channel that has the field
    (sync AM here) and refuses one that no channel has."""
    from sdrangel_tpu_torch.__main__ import main
    from sdrangel_tpu_torch.io import wav

    path = str(tmp_path / "fm.sdriq")
    sdriq.write(path, 0.5 * _mpx(2 * 98_304, RATE, offset=100_000.0), sample_rate=int(RATE),
                sample_size=16, timestamp=0)
    out = str(tmp_path / "stereo.wav")
    assert main(["demod", "--device", "cpu", "--in", path, "--log2-decim", "1",
                 "--channel", "bfm:100000", "--channel", "am:-100000", "--set", "sync_am=true",
                 "--set", "audio_stereo=true", "--out", out]) == 0
    pcm, rate = wav.read_wav(out)
    assert rate == 48_000 and pcm.shape[1] == 2 and np.any(pcm)
    pipe = peng.RxPipeline(peng.DeviceConfig(RATE, log2_decim=1),
                           [peng.ChannelSpec(BFM, 100_000.0, {"audio_stereo": True}, 180_000.0),
                            peng.ChannelSpec(AM, -100_000.0, {"sync_am": True})], CPU)
    info, mm = sdriq.open_mmap(path)
    ref = np.concatenate([o["channels"][0]["audio"] for _, o in pipe.run(
        lambda b, count: sdriq.read_block(mm, b * count, count),
        max(1, info.n_samples // pipe.device_block))])
    del mm
    np.testing.assert_array_equal(pcm, np.clip(ref * 32768.0, -32768, 32767).astype(np.int16))
    am_pcm, _ = wav.read_wav(str(tmp_path / "stereo.ch1.wav"))
    assert am_pcm.shape[1] == 1
    with pytest.raises(SystemExit, match="no channel here"):
        main(["demod", "--device", "cpu", "--in", path, "--channel", "bfm:0",
              "--set", "ctcss_index=8", "--out", out])


def test_ctcss_and_sync_settings_are_live_over_rest():
    """A running NFM channel takes `ctcss_on`/`ctcss_index` by PATCH (the
    pipeline is rebuilt at a block boundary): the wrong tone shuts its audio
    (the test source carries no CTCSS tone), index 0 opens it again; the
    OpenAPI document carries the new AM, NFM and BFM fields."""
    from test_torch_api import _fm_set, _req, _serve, _wait_audio

    session = Session(device=CPU)
    srv, base = _serve(session)
    try:
        _fm_set(base, source={"run_blocks": 0})
        _req(base, "/sdrangel/deviceset/0/device/run", "POST")
        ds = session.device_sets[0]
        _wait_audio(ds, lambda a: np.abs(a).max() > 0.05)
        code, _ = _req(base, "/sdrangel/deviceset/0/channel/0/settings", "PATCH",
                       {"ctcss_on": True, "ctcss_index": 9})
        assert code == 200
        _wait_audio(ds, lambda a: np.abs(a).max() == 0.0, min_blocks=2)
        code, _ = _req(base, "/sdrangel/deviceset/0/channel/0/settings", "PATCH",
                       {"ctcss_index": 0})
        assert code == 200
        _wait_audio(ds, lambda a: np.abs(a).max() > 0.05, min_blocks=2)
        code, doc = _req(base, "/sdrangel/openapi")
    finally:
        session.shutdown()
        srv.shutdown()
        srv.server_close()
    schemas = doc["components"]["schemas"]
    assert {"ctcss_on", "ctcss_index", "delta_squelch"} <= set(
        schemas["ChannelSettings_nfmdemod"]["properties"])
    assert {"sync_am", "sync_usb", "sync_dsb", "ref_pll_parity", "sync_frame_offset"} <= set(
        schemas["ChannelSettings_amdemod"]["properties"])
    assert {"audio_stereo", "deemphasis_us", "rds_active"} <= set(
        schemas["ChannelSettings_bfm"]["properties"])
