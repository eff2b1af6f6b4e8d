"""The port's Tx path against the JAX package: the ×2 half-band stages, the
UpChannelizer, the device ×2^k cascade, the resampler's interpolation
schedule, the four modulators and TxPipeline, on the same numpy inputs made
from a seed; then the compiled-reference goldens of the Tx path (and the
resampler's decimation goldens) through the port's own functions, and
loopbacks decoded by the port's RxPipeline, all on the CPU.

Tolerances:
- the interpolators, the resampler, AM and SSB streamed over 3 blocks:
  2e-5 absolute (f32 sums taken in another order); banks of 3 channels
  against three one-channel calls: 1e-6;
- NFM: 2e-5 (measured 5.5e-6) — its phase stays within a few radians,
  where JAX's f32 running sum and the port's float64 one agree closely;
- WFM: 2e-4 absolute on outputs of amplitude 0.891 against JAX (measured
  6.8e-5): a phase of tens of radians summed over the block, then f32
  FFTs; the port is also held to a float64 oracle of the whole modulator
  at 1e-4 (measured 4.0e-5). The running sum itself is float64 in the port
  and f32 in JAX: on a WFM-sized step JAX's sum is 8× further from the
  float64 one (pinned, ROADMAP.md §3);
- TxPipeline against JAX's: int16 within 1 LSB (the clip-and-truncate of
  values within f32 rounding of an integer);
- the goldens at test_reference_golden.py's bounds and scale checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrangel_tpu.channels import modulators as jmods
from sdrangel_tpu.dsp import channelizer as jchan
from sdrangel_tpu.dsp import hbfilter as jhb
from sdrangel_tpu.dsp import interpolators as jint
from sdrangel_tpu.dsp import resampler as jres
from sdrangel_tpu.runtime import tx as jtx
from sdrangel_tpu_torch.channels import modulators as pmods
from sdrangel_tpu_torch.dsp import channelizer as pchan
from sdrangel_tpu_torch.dsp import interpolators as pint
from sdrangel_tpu_torch.dsp import resampler as pres
from sdrangel_tpu_torch.io import sdriq
from sdrangel_tpu_torch.runtime import tx as ptx
from sdrangel_tpu_torch.runtime.engine import ChannelSpec, DeviceConfig, RxPipeline
from torch_port_util import (_MANIFEST, CPU, best_lag, load_golden, load_golden_iq, n, t,
                             tone_snr)

ATOL = 2e-5
NFM, AM, SSB, WFM = (f"sdrangel.channeltx.mod{k}" for k in ("nfm", "am", "ssb", "wfm"))


def _iq(rng, shape, scale=0.5):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)


def _tone_af(tones, amp=0.8):
    """af_source(b, c, count): channel c's continuous tone."""
    def src(b, c, count):
        tt = (b * count + np.arange(count)) / 48_000.0
        return (amp * np.sin(2 * np.pi * tones[c] * tt)).astype(np.float32)
    return src


# -- the interpolators --------------------------------------------------------


@pytest.mark.parametrize("order", [64, 96])
def test_hb_interpolate2_streams_like_jax(order):
    rng = np.random.default_rng(order)
    jt = jint.init_state(1, batch_shape=(2,), order=order).tails[0]
    pt = pint.init_state(1, CPU, (2,), order).tails[0]
    assert pt.shape == jt.shape
    taps = jnp.asarray(jhb.hb_taps(order))
    for _ in range(3):
        x = _iq(rng, (2, 1000))
        jt, jy = jint.hb_interpolate2(jt, jnp.asarray(x), taps)
        pt, py = pint.hb_interpolate2(pt, t(x), order)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)
        np.testing.assert_array_equal(n(pt), np.asarray(jt))


@pytest.mark.parametrize("signs", [(0,), (1, -1), (-1, 1, 0), (0, 1, -1, 1)])
def test_upchannelize_streams_like_jax(signs):
    rng = np.random.default_rng(len(signs))
    plan = jchan.ChannelPlan(signs=signs, decimation=1 << len(signs), channel_rate=0.0,
                             residual_offset=0.0)
    pplan = pchan.ChannelPlan(signs, 1 << len(signs), 0.0, 0.0)
    js, ps = jint.init_state(len(signs)), pint.init_state(len(signs), CPU)
    for _ in range(3):
        x = _iq(rng, 512)
        js, jy = jint.upchannelize(js, jnp.asarray(x), plan)
        ps, py = pint.upchannelize(ps, t(x), pplan)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)


def test_upchannelize_bank_streams_like_jax_and_matches_single_channels():
    rng = np.random.default_rng(5)
    signs = np.array([[1, -1], [0, 0], [-1, 1]])
    js, ps = jint.init_state(2, batch_shape=(3,)), pint.init_state(2, CPU, (3,))
    singles = [pint.init_state(2, CPU) for _ in range(3)]
    for _ in range(3):
        x = _iq(rng, (3, 512))
        js, jy = jint.upchannelize_bank(js, jnp.asarray(x), signs)
        ps, py = pint.upchannelize_bank(ps, t(x), signs)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)
        for c in range(3):
            plan = pchan.ChannelPlan(tuple(int(s) for s in signs[c]), 4, 0.0, 0.0)
            singles[c], yc = pint.upchannelize(singles[c], t(x[c]), plan)
            np.testing.assert_allclose(n(py[c]), n(yc), atol=1e-6)


@pytest.mark.parametrize("log2", [1, 3, 6])
def test_interpolate_cascade_streams_like_jax(log2):
    rng = np.random.default_rng(log2)
    js, ps = jint.init_state(log2, order=64), pint.init_state(log2, CPU, order=64)
    for _ in range(3):
        x = _iq(rng, 256)
        js, jy = jint.interpolate_cascade(js, jnp.asarray(x), log2)
        ps, py = pint.interpolate_cascade(ps, t(x), log2)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)
    for jtail, ptail in zip(js.tails, ps.tails):
        np.testing.assert_allclose(n(ptail), np.asarray(jtail), atol=ATOL)


# -- the resampler's interpolation schedule ------------------------------------


@pytest.mark.parametrize("out_rate", [96_000.0, 120_000.0, 150_000.0])
def test_interpolation_plan_and_stream_like_jax(out_rate):
    kw = dict(cutoff=12_500.0 / 2.2, phase_steps=48, nb_taps_per_phase=3.0)
    pp = pres.make_plan(48_000.0, out_rate, 4096, **kw)
    jp = jres.make_plan(48_000.0, out_rate, 4096, **kw)
    assert (pp.p, pp.q, pp.block_out, pp.ntaps) == (jp.p, jp.q, jp.block_out, jp.ntaps)
    np.testing.assert_array_equal(pp.taps, jp.taps)
    np.testing.assert_array_equal(pp.start_idx, jp.start_idx)
    np.testing.assert_array_equal(pp.phase, jp.phase)
    np.testing.assert_array_equal(pp.residue_kernels, jp.residue_kernels[:, 0, :])
    rng = np.random.default_rng(int(out_rate))
    js, ps = jres.init_state(jp, (2,)), pres.init_state(pp, CPU, (2,))
    for _ in range(3):
        x = _iq(rng, (2, 4096))
        js, jy = jres.resample_block(js, jnp.asarray(x), jp)
        ps, py = pres.resample_block(ps, t(x), pp)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)


def test_block_rule_refuses_as_jax_does():
    """48 kHz → 156.25 kHz (10 MS/s ×64) needs blocks of 192 AF samples:
    4096 is refused, with JAX's message, as it refuses it; the rule is not
    widened (×64 at 9.6 MS/s, 8/25, takes 4096)."""
    with pytest.raises(AssertionError) as jerr:
        jtx.TxPipeline(jtx.TxDeviceConfig(10e6, 6), [jtx.TxChannelSpec(NFM, 20e3, {})]
                       ).init_state()
    with pytest.raises(ValueError) as perr:
        ptx.TxPipeline(ptx.TxDeviceConfig(10e6, 6), [ptx.TxChannelSpec(NFM, 20e3, {})],
                       device=CPU)
    assert str(perr.value) == str(jerr.value)
    assert "block_in=4096 must be a multiple of p=192" in str(perr.value)
    with pytest.raises(ValueError, match="denominator too large"):
        pres.make_plan(48_000.0, 48_000.0 * 257 / 2, 4096)


# -- the modulators ------------------------------------------------------------

_KINDS = {
    "nfm": (jmods.NFMModConfig, jmods.make_fm_state, jmods.fm_modulate,
            pmods.NFMModConfig, pmods.make_fm_state, pmods.fm_modulate),
    "am": (jmods.AMModConfig, jmods.make_am_state, jmods.am_modulate,
           pmods.AMModConfig, pmods.make_am_state, pmods.am_modulate),
    "ssb": (jmods.SSBModConfig, jmods.make_ssb_state, jmods.ssb_modulate,
            pmods.SSBModConfig, pmods.make_ssb_state, pmods.ssb_modulate),
    "wfm": (jmods.WFMModConfig, jmods.make_wfm_state, jmods.wfm_modulate,
            pmods.WFMModConfig, pmods.make_wfm_state, pmods.wfm_modulate),
}
_MOD_CASES = {
    "nfm": (dict(channel_rate=96_000.0, input_offset=12_000.0), ATOL),
    "nfm_ctcss": (dict(channel_rate=150_000.0, input_offset=-20_000.0, ctcss_on=True), ATOL),
    "am": (dict(channel_rate=96_000.0, input_offset=-7_000.0), ATOL),
    "ssb": (dict(channel_rate=96_000.0, input_offset=3_000.0), ATOL),
    "ssb_lsb": (dict(channel_rate=48_000.0, usb=False), ATOL),
    "wfm": (dict(channel_rate=384_000.0, input_offset=50_000.0), 2e-4),
}


def _speech_like(rng, shape):
    """Two tones and noise, peak below 1."""
    tt = np.arange(shape[-1] * 3) / 48_000.0
    x = 0.4 * np.sin(2 * np.pi * 900 * tt) + 0.3 * np.sin(2 * np.pi * 2300 * tt)
    x = x + 0.05 * rng.standard_normal((*shape[:-1], len(tt)))
    return x.astype(np.float32).reshape(*shape[:-1], 3, shape[-1])


@pytest.mark.parametrize("case", sorted(_MOD_CASES))
def test_modulator_streams_like_jax(case):
    kw, tol = _MOD_CASES[case]
    jcls, jmake, jmod, pcls, pmake, pmod = _KINDS[case.split("_")[0]]
    jc, pc = jcls(block_af=2048, **kw), pcls(block_af=2048, **kw)
    js, ps = jmake(jc), pmake(pc, CPU)
    af = _speech_like(np.random.default_rng(7), (2048,))
    for b in range(3):
        js, jy = jmod(js, jnp.asarray(af[b]), jc)
        ps, py = pmod(ps, t(af[b]), pc)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=tol)
    np.testing.assert_array_equal(n(ps.nco.phase), np.asarray(js.nco.phase).astype(np.int64))


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_modulator_bank_matches_single_channels(kind):
    """A (3,) bank with per-channel offsets against three one-channel
    calls, each given its offset as the same override (the f32 increment
    of JAX's jit arithmetic)."""
    _, _, _, pcls, pmake, pmod = _KINDS[kind]
    cfg = pcls(channel_rate=384_000.0 if kind == "wfm" else 96_000.0, block_af=2048)
    offsets = np.array([-9_000.0, 0.0, 12_500.0], np.float32)
    bank, singles = pmake(cfg, CPU, (3,)), [pmake(cfg, CPU) for _ in offsets]
    af = _speech_like(np.random.default_rng(3), (3, 2048))
    for b in range(2):
        bank, yb = pmod(bank, t(af[:, b]), cfg, t(offsets))
        for c, off in enumerate(offsets):
            singles[c], yc = pmod(singles[c], t(af[c, b]), cfg, float(off))
            np.testing.assert_allclose(n(yb[c]), n(yc), atol=1e-6)


def test_fm_phase_is_summed_in_float64():
    """The divergence ROADMAP.md §3 records: the port's FM phase is the
    float64 running sum rounded to f32; JAX's f32 cumulative sum drifts
    with the block (a WFM-sized step over 32,768 samples)."""
    rng = np.random.default_rng(11)
    dphi = (2 * np.pi * 75_000 / 384_000 * np.sin(np.arange(32_768) * 0.02)
            + 0.1 * rng.standard_normal(32_768)).astype(np.float32)
    oracle = 1.25 + np.cumsum(dphi.astype(np.float64))
    phase, last = pmods._integrate(torch.tensor(1.25), t(dphi))
    np.testing.assert_array_equal(n(phase), oracle.astype(np.float32))
    assert float(last) == np.float32(np.mod(oracle[-1], 2 * np.pi))
    jax_phase = np.asarray(jnp.float32(1.25) + jnp.cumsum(jnp.asarray(dphi)))
    assert np.abs(jax_phase - oracle).max() > 4 * np.abs(n(phase) - oracle).max()


def _wfm_oracle(cfg, af: np.ndarray) -> np.ndarray:
    """The WFM modulator in float64 numpy, from the same schedule and
    filter: interpolate, integrate, e^{iφ}, overlap-add, NCO."""
    plan = cfg.up
    k = plan.residue_kernels.astype(np.float64)
    ext = np.concatenate([np.zeros(plan.ntaps - 1), af.astype(np.float64),
                          np.zeros(k.shape[1])])
    m_per = plan.block_out // plan.q
    win = np.stack([ext[m * plan.p:m * plan.p + k.shape[1]] for m in range(m_per)])
    afi = (win @ k.T).reshape(-1)
    phase = np.cumsum(2 * np.pi * cfg.fm_deviation / cfg.channel_rate * afi)
    iq = cfg.amplitude * np.exp(1j * phase)
    h = cfg.rf_filter.astype(np.complex128)
    hop = len(h) // 2
    out, overlap = np.empty_like(iq), np.zeros(hop, np.complex128)
    for f in range(len(iq) // hop):
        y = np.fft.ifft(np.fft.fft(iq[f * hop:(f + 1) * hop], len(h)) * h)
        out[f * hop:(f + 1) * hop] = y[:hop] + overlap
        overlap = y[hop:]
    inc = int(np.round((cfg.input_offset / cfg.channel_rate % 1.0) * 2 ** 32))
    wheel = (inc * np.arange(1, len(out) + 1, dtype=np.int64)) & 0xFFFFFFFF
    return out * np.exp(1j * 2 * np.pi * wheel / 2 ** 32)


def test_wfm_modulator_meets_a_float64_oracle():
    cfg = pmods.WFMModConfig(channel_rate=384_000.0, input_offset=50_000.0, block_af=4096)
    af = _speech_like(np.random.default_rng(9), (4096,))[0]
    _, py = pmods.wfm_modulate(pmods.make_wfm_state(cfg, CPU), t(af), cfg)
    err = np.abs(n(py) - _wfm_oracle(cfg, af)).max()
    assert err < 1e-4, err


# -- the goldens -----------------------------------------------------------------


def band_fit(a: np.ndarray, b: np.ndarray, frac: float):
    """Least-squares fit restricted to |f| <= frac (normalized), as
    test_reference_golden.py fits the Tx cascades."""
    m = min(len(a), len(b))
    fa = np.fft.fft(np.asarray(a[:m]) * np.hanning(m))
    fb = np.fft.fft(np.asarray(b[:m]) * np.hanning(m))
    keep = np.abs(np.fft.fftfreq(m)) <= frac
    fa, fb = fa[keep], fb[keep]
    s = np.vdot(fb, fa) / max(abs(np.vdot(fb, fb)), 1e-30)
    err = fa - s * fb
    snr = 10 * np.log10(abs(np.vdot(s * fb, s * fb)) / max(abs(np.vdot(err, err)), 1e-30))
    return float(snr), complex(s)


def _txinterp_snr(log2: int, lag: int) -> tuple[float, complex]:
    x = load_golden_iq("txinterp_input")
    golden = load_golden_iq(f"txinterp_cen_l{log2}")
    _, y = pint.interpolate_cascade(pint.init_state(log2, CPU, order=64),
                                    t(x.astype(np.complex64)), log2)
    gg, oo = golden[max(0, lag):], n(y)[max(0, -lag):]
    if log2 == 6:  # the reference leaves 9 of every 64 outputs unwritten
        idx = np.arange(min(len(gg), len(oo)))
        oo = oo[:len(idx)] * ((idx % 64) < 55)
    return band_fit(gg[2048:2048 + (1 << 17)], oo[2048:2048 + (1 << 17)], 0.45 / (1 << log2))


@pytest.mark.parametrize("log2,lag,bound", [
    (1, 0, 60.0), (2, -16, 57.0), (4, -136, 55.0), (6, -618, 38.0)])
def test_tx_cascade_meets_reference_golden(log2, lag, bound):
    """test_reference_golden.py:379-411: Interpolators interpolateN_cen,
    in-band, with the 55-of-64 mask at ×64."""
    snr, s = _txinterp_snr(log2, lag)
    assert snr > bound, f"l{log2}: in-band snr {snr:.1f} dB"
    assert abs(abs(s) - 1.0) < 2e-3, f"l{log2}: scale {s}"


def _upchan_fit(name: str, modes: tuple, lag: int):
    x = load_golden_iq(name + "_input")
    golden = load_golden_iq(name)
    signs = tuple({0: 0, 1: +1, 2: -1}[m] for m in modes)
    plan = pchan.ChannelPlan(signs, 1 << len(signs), 0.0, 0.0)
    _, y = pint.upchannelize(pint.init_state(len(signs), CPU), t(x.astype(np.complex64)), plan)
    return best_lag(golden, n(y), range(lag - 4, lag + 5))


@pytest.mark.parametrize("name,modes,lag,bound", [
    ("upchan_cen_cen", (0, 0), 12, 54.0),
    ("upchan_low_up", (1, 2), 12, 55.0),
    ("upchan_up_low_cen", (2, 1, 0), 28, 53.0),
])
def test_upchannelizer_meets_reference_golden(name, modes, lag, bound):
    """test_reference_golden.py:414-436: the UpChannelizer pull chains."""
    got_lag, snr, s = _upchan_fit(name, modes, lag)
    assert snr > bound, f"{name}: snr {snr:.1f} dB (lag {got_lag})"
    assert abs(abs(s) - 1.0) < 2e-3


def _interp_fit(name: str):
    x = load_golden_iq("interp_input")
    golden = load_golden_iq(name)
    params = _MANIFEST[name]["params"]
    kw = {} if params["in_rate"] > params["out_rate"] else dict(phase_steps=48,
                                                                 nb_taps_per_phase=3.0)
    plan = pres.make_plan(params["in_rate"], params["out_rate"], 16_000,
                          cutoff=params["cutoff"], **kw)
    _, y = pres.resample_block(pres.init_state(plan, CPU), t(x[:16_000].astype(np.complex64)),
                               plan)
    return best_lag(golden, n(y), range(-4, 5))


@pytest.mark.parametrize("name,bound,scale_tol,lag0", [
    ("interp_48k_96k", 120.0, 1e-4, True),
    ("interp_48k_120k", 118.0, 1e-4, True),
    ("interp_96k_48k", 110.0, 2e-3, False),
    ("interp_125k_48k", 48.0, 2e-3, False),
])
def test_resampler_meets_reference_golden(name, bound, scale_tol, lag0):
    """Interpolator::interpolate (test_reference_golden.py:439-459) and
    Interpolator::decimate (:207-221) through the port's make_plan and
    resample_block."""
    lag, snr, s = _interp_fit(name)
    assert snr > bound, f"{name}: snr {snr:.1f} dB (lag {lag})"
    assert abs(abs(s) - 1.0) < scale_tol
    if lag0:
        assert lag == 0


def _inst_freq_rmse(golden, ours, lag, rate, skip):
    m = min(len(golden), len(ours))
    gg, oo = golden[max(0, lag):m], ours[max(0, -lag):m]
    k = min(len(gg), len(oo))
    fg = np.angle(gg[1:k] * np.conj(gg[:k - 1])) * rate / (2 * np.pi)
    fo = np.angle(oo[1:k] * np.conj(oo[:k - 1])) * rate / (2 * np.pi)
    return float(np.sqrt(np.mean((fg[skip:] - fo[skip:]) ** 2)))


def _nfmmod_fit(name: str, offset: float, ctcss: bool):
    af = load_golden(name + "_af")
    golden = load_golden_iq(name)
    cfg = pmods.NFMModConfig(channel_rate=96_000.0, input_offset=offset, fm_deviation=5000.0,
                             af_bandwidth=3000.0, rf_bandwidth=12_500.0,
                             amplitude=0.891235351562, block_af=len(af), ctcss_on=ctcss,
                             ctcss_freq=88.5)
    _, y = pmods.fm_modulate(pmods.make_fm_state(cfg, CPU), t(af.astype(np.float32)), cfg)
    y = n(y)
    lag, snr, s = best_lag(golden, y, range(-10, 11), skip=1024)
    return lag, snr, s, _inst_freq_rmse(golden, y, lag, 96_000.0, 4096)


@pytest.mark.parametrize("name,offset,ctcss,bound,f_bound", [
    ("nfmmod96", 0.0, False, 58.0, 2.0),
    ("nfmmod96_off12k", 12_000.0, False, 58.0, 2.0),
    ("nfmmod96_ctcss", 0.0, True, 24.0, 8.0),
])
def test_nfm_modulator_meets_reference_golden(name, offset, ctcss, bound, f_bound):
    """test_reference_golden.py:462-502: the NFMMod composition."""
    lag, snr, s, rmse = _nfmmod_fit(name, offset, ctcss)
    assert snr > bound, f"{name}: snr {snr:.1f} dB (lag {lag})"
    assert abs(abs(s) / 32768.0 - 1.0) < 2e-3, f"scale {s}"
    assert rmse < f_bound, f"{name}: inst-freq RMSE {rmse:.2f} Hz"


def _wfmmod_fit():
    af = load_golden("wfmmod384_af")
    af = af[:len(af) // 64 * 64]  # the fftfilt hop
    golden = load_golden_iq("wfmmod384")
    cfg = pmods.WFMModConfig(channel_rate=384_000.0, fm_deviation=75_000.0,
                             rf_bandwidth=180_000.0, amplitude=0.891235351562,
                             block_af=len(af))
    _, y = pmods.wfm_modulate(pmods.make_wfm_state(cfg, CPU), t(af.astype(np.float32)), cfg)
    y = n(y)
    lag, snr, s = best_lag(golden, y, range(129, 142), skip=2048)
    return lag, snr, s, _inst_freq_rmse(golden, y, lag, 384_000.0, 8192)


def test_wfm_modulator_meets_reference_golden():
    """test_reference_golden.py:592-621: the WFMMod composition."""
    lag, snr, s, rmse = _wfmmod_fit()
    assert snr > 30.0, f"wfm: snr {snr:.1f} dB (lag {lag})"
    assert abs(abs(s) / 32768.0 - 1.0) < 2e-3
    assert rmse < 60.0, f"wfm inst-freq RMSE {rmse:.1f} Hz"


# -- TxPipeline --------------------------------------------------------------------

_PIPES = {
    "384k_x1": (384_000.0, 0, [(NFM, 50_000.0, {})]),
    "2.4M_x4": (2.4e6, 2, [(NFM, -100_000.0, {}), (NFM, 100_000.0, {}),
                           (AM, 20_000.0, {}), (SSB, -30_000.0, {"usb": False})]),
}


@pytest.mark.parametrize("name", sorted(_PIPES))
def test_tx_pipeline_matches_jax_and_takes_its_state(name):
    """Four blocks within 1 LSB of JAX's TxPipeline; JAX's state after block
    2 handed to the port, which goes on within 1 LSB."""
    rate, log2, chans = _PIPES[name]
    jp = jtx.TxPipeline(jtx.TxDeviceConfig(rate, log2), [jtx.TxChannelSpec(*c) for c in chans])
    pp = ptx.TxPipeline(ptx.TxDeviceConfig(rate, log2), [ptx.TxChannelSpec(*c) for c in chans],
                        device=CPU)
    assert [g.idxs for g in pp.groups] == [tuple(g[0]) for g in jp.groups]
    src = _tone_af([700.0, 1100.0, 900.0, 1300.0])
    want = list(jp.run(src, 4))
    got = list(pp.run(src, 4))
    for b in range(4):
        assert got[b].shape == want[b].shape == (pp.device_block, 2)
        assert got[b].dtype == np.int16
        assert np.abs(got[b].astype(np.int32) - want[b]).max() <= 1, b
    jstate = jp.init_state()
    for b in range(2):
        jstate, _ = jp._step(jstate, [jnp.asarray(src(b, c, 4096)) for c in range(len(chans))])
    pstate = pp.state_from_numpy(jax.tree.map(np.asarray, jstate))
    for b in (2, 3):
        pstate, out = pp.step(pstate, pp.upload([src(b, c, 4096) for c in range(len(chans))]))
        assert np.abs(n(out).astype(np.int32) - want[b]).max() <= 1, b
    back = jax.tree.leaves(pp.state_to_numpy(pp.final_state))
    jfinal = jax.tree.leaves(jax.tree.map(np.asarray, jp.final_state))
    assert len(back) == len(jfinal)
    for a, j in zip(back, jfinal):
        assert a.dtype == j.dtype and a.shape == j.shape
        np.testing.assert_allclose(a, j, atol=1e-4)


def test_device_block_counts_what_comes_out():
    """The divergence ROADMAP.md §3 records: JAX's device_block floors the
    resampler's ratio (786,432 at 9.6 MS/s ×64, where 819,200 samples come
    out of a step); the port's counts the output."""
    jp = jtx.TxPipeline(jtx.TxDeviceConfig(9.6e6, 6), [jtx.TxChannelSpec(NFM, 20e3, {})])
    pp = ptx.TxPipeline(ptx.TxDeviceConfig(9.6e6, 6), [ptx.TxChannelSpec(NFM, 20e3, {})],
                        device=CPU)
    assert pp.plans[0].signs == () and pp.mod_cfgs[0].up.block_out == 12_800
    assert (pp.device_block, jp.device_block) == (819_200, 786_432)


def test_tx_pipeline_pins_f32_precision_and_refuses():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    pp = ptx.TxPipeline(ptx.TxDeviceConfig(96_000.0), [ptx.TxChannelSpec(AM, 0.0, {})],
                        device=CPU)
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    with pytest.raises(ValueError, match="at least one channel"):
        ptx.TxPipeline(ptx.TxDeviceConfig(96_000.0), [], device=CPU)
    with pytest.raises(KeyError):
        ptx.TxPipeline(ptx.TxDeviceConfig(96_000.0),
                       [ptx.TxChannelSpec("sdrangel.channel.nfmdemod", 0.0, {})], device=CPU)
    with pytest.raises(KeyError):  # no Tx kind, as JAX's TxPipeline (tx.py:25-28)
        ptx.TxPipeline(ptx.TxDeviceConfig(96_000.0),
                       [ptx.TxChannelSpec("sdrangel.channeltx.modatv", 0.0, {})], device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ptx.TxPipeline(ptx.TxDeviceConfig(96_000.0), [ptx.TxChannelSpec(AM, 0.0, {})])
    assert pp.device.type == "cpu"


# -- loopbacks through the port's Rx path (ports of tests/test_tx.py) --------------


def _decode(raw: np.ndarray, rate: float, log2: int, chans, block_size=None):
    """chans: (uri, offset, settings[, requested rate]) per Rx channel."""
    rx = RxPipeline(DeviceConfig(rate, log2_decim=log2), [ChannelSpec(*c) for c in chans], CPU,
                    block_size=block_size)
    n_rx = len(raw) // rx.device_block
    assert n_rx >= 2, (len(raw), rx.device_block)
    audio = [[] for _ in chans]
    for _, outs in rx.run(lambda b, count: raw[b * count:(b + 1) * count], n_rx):
        for c in range(len(chans)):
            audio[c].append(outs["channels"][c]["audio"])
    return [np.concatenate(a) for a in audio]


@pytest.mark.parametrize("kind,rx_uri,rate,offset,rx_settings,requested", [
    ("nfm", "sdrangel.channel.nfmdemod", 384_000.0, 50_000.0, {"squelch_db": -60.0}, 48e3),
    ("am", "sdrangel.channel.amdemod", 384_000.0, -40_000.0, {"squelch_db": -60.0}, 48e3),
    ("ssb", "sdrangel.channel.ssbdemod", 384_000.0, 30_000.0, {}, 48e3),
    ("wfm", "sdrangel.channel.wfmdemod", 768_000.0, -60_000.0, {"squelch_db": -60.0}, 250e3),
])
def test_tx_rx_loopback(kind, rx_uri, rate, offset, rx_settings, requested):
    """tests/test_tx.py:28-56 for the four kinds: Tx places a modulated
    channel at `offset` in the baseband (×2 to the DAC; WFM asks the
    channelizer for 250 kHz, as phase 6 of chip_smoke.py does), and the
    port's RxPipeline recovers the 1 kHz AF tone."""
    tx = ptx.TxPipeline(ptx.TxDeviceConfig(rate, 1), [ptx.TxChannelSpec(
        f"sdrangel.channeltx.mod{kind}", offset, {}, requested_rate=requested)], device=CPU)
    raw = np.concatenate(list(tx.run(_tone_af([1000.0]), 12)))
    (audio,) = _decode(raw, rate, 1, [(rx_uri, offset, rx_settings, requested)],
                       block_size=1 << 15)
    snr = tone_snr(audio[len(audio) // 2:].astype(np.float64), 1000.0, 48_000.0)
    assert snr > 20.0, f"{kind} loopback SNR {snr:.1f} dB"


def _spectrum(raw: np.ndarray, rate: float):
    x = raw.astype(np.float32) / 32768.0
    c = (x[:, 0] + 1j * x[:, 1])[4096:]
    spec = np.abs(np.fft.fft(c * np.hanning(len(c))))
    return np.fft.fftfreq(len(c), 1.0 / rate), spec


def test_tx_spectrum_placement():
    tx = ptx.TxPipeline(ptx.TxDeviceConfig(768_000.0), [ptx.TxChannelSpec(NFM, 96_000.0, {})],
                        device=CPU)
    freqs, spec = _spectrum(np.concatenate(list(tx.run(_tone_af([1000.0]), 4))), 768_000.0)
    assert abs(freqs[spec.argmax()] - 96_000.0) < 7_000.0


def test_tx_two_channel_merge(tmp_path):
    """Two modulators merged (sum/÷n) and recorded with the port's sdriq
    writer; both carriers stand 50× above the median bin."""
    tx = ptx.TxPipeline(ptx.TxDeviceConfig(384_000.0),
                        [ptx.TxChannelSpec(NFM, 60_000.0, {}), ptx.TxChannelSpec(AM, -90_000.0, {})],
                        device=CPU)
    raw = np.concatenate(list(tx.run(_tone_af([1000.0, 1000.0]), 4)))
    path = str(tmp_path / "tx.sdriq")
    sdriq.write(path, raw, sample_rate=384_000)
    assert sdriq.read_header(path).n_samples == len(raw)
    freqs, spec = _spectrum(raw, 384_000.0)
    noise = np.median(spec)
    for f0 in (60_000.0, -90_000.0):
        assert spec[np.abs(freqs - f0) < 10_000.0].max() > 50 * noise, f0


def test_tx_grouped_banks_mixed_kinds():
    """tests/test_tx.py:267-312: NFM+NFM+AM runs as two groups, and every
    channel demodulates back."""
    specs = [ptx.TxChannelSpec(NFM, -24_000.0, {}), ptx.TxChannelSpec(NFM, 24_000.0, {}),
             ptx.TxChannelSpec(AM, 0.0, {})]
    pipe = ptx.TxPipeline(ptx.TxDeviceConfig(384_000.0, 2), specs, device=CPU)
    assert sorted(len(g.idxs) for g in pipe.groups) == [1, 2]
    tones = [700.0, 1100.0, 900.0]
    raw = np.concatenate(list(pipe.run(_tone_af(tones), 6)))
    gate = {"squelch_db": -100.0, "squelch_gate_ms": 1.0}
    audio = _decode(raw, 384_000.0, 2, [
        ("sdrangel.channel.nfmdemod", -24_000.0, gate),
        ("sdrangel.channel.nfmdemod", 24_000.0, gate),
        ("sdrangel.channel.amdemod", 0.0, {"squelch_db": -100.0})], block_size=1 << 14)
    for c in range(3):
        assert tone_snr(audio[c][4096:].astype(np.float64), tones[c], 48_000.0) > 8.0, c
