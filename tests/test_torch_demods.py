"""The port's AM, SSB and WFM receivers and the stages they add (the long
moving average, the saturating counters of MagAGC, MagAGC, the
reference NCO grid) against the JAX package, and the whole receivers
against the compiled-reference goldens.

Tolerances: stages 2e-5 absolute (f32 sums taken in another order); the
long moving average also 1e-6 against a float64 oracle; the receivers
streamed over 3 blocks within 2e-5 of JAX `process`, and banks of 3
channels within 1e-6 of three one-channel calls, both absolute on audio
of peak ≤ 1 and relative to the block's peak above it (AM's normaliser
starts from its 0.003 fill, so its first block peaks near 100), with AGC
and squelch states equal; the goldens at test_reference_golden.py:647-838's
bounds and scale checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdrangel_tpu.channels import demod_am as jam
from sdrangel_tpu.channels import demod_ssb as jssb
from sdrangel_tpu.channels import demod_wfm as jwfm
from sdrangel_tpu.dsp import agc as jagc
from sdrangel_tpu.dsp import movingavg as jmavg
from sdrangel_tpu.dsp import nco as jnco
from sdrangel_tpu.dsp import scanops as jscan
from sdrangel_tpu_torch.channels import demod_am as pam
from sdrangel_tpu_torch.channels import demod_ssb as pssb
from sdrangel_tpu_torch.channels import demod_wfm as pwfm
from sdrangel_tpu_torch.dsp import agc as pagc
from sdrangel_tpu_torch.dsp import fftfilt as pff
from sdrangel_tpu_torch.dsp import movingavg as pmavg
from sdrangel_tpu_torch.dsp import nco as pnco
from sdrangel_tpu_torch.dsp import phasediscri as pdis
from sdrangel_tpu_torch.dsp import resampler as pres
from sdrangel_tpu_torch.dsp import scanops as pscan
from torch_port_util import CPU, load_golden, load_golden_iq, n, t

ATOL = 2e-5


# -- stages ------------------------------------------------------------------

@pytest.mark.parametrize("length,fill", [(4800, 0.003), (6144, 0.0), (1024, 0.0)])
def test_long_moving_average_streams_like_jax(length, fill):
    """The cumulative-sum form of a long window, in the magsq range, against
    JAX (whose f32 cumulative sum drifts with the block's running total, a
    few 1e-7 here) and against a float64 oracle at 1e-6."""
    rng = np.random.default_rng(31)
    js = jmavg.make_state(length, fill=fill)
    ps = pmavg.make_state(length, CPU, fill=fill)
    hist = np.full(length, fill)
    for _ in range(3):
        x = rng.uniform(0.0, 0.3, 12_288).astype(np.float32)
        js, jy = jmavg.moving_average(js, jnp.asarray(x))
        ps, py = pmavg.moving_average(ps, t(x))
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL)
        ext = np.concatenate([hist, x.astype(np.float64)])
        oracle = np.convolve(ext, np.ones(length) / length, mode="valid")[1:]
        np.testing.assert_allclose(n(py), oracle, atol=1e-6)
        hist = ext[-length:]
    np.testing.assert_array_equal(n(ps.window), np.asarray(js.window))


def test_long_window_form_beats_the_f32_cumulative_sum():
    """Pins the divergence ROADMAP §3 records: after a loud stretch, a long
    window over a quiet one. JAX's f32 cumulative sum carries the loud
    total's rounding into the quiet means; the port's float64 form stays at
    f32 rounding of each mean."""
    x = np.concatenate([np.full(40_000, 0.9), np.full(8_192, 1e-4)]).astype(np.float32)
    _, jy = jmavg.moving_average(jmavg.make_state(6144), jnp.asarray(x))
    _, py = pmavg.moving_average(pmavg.make_state(6144, CPU), t(x))
    quiet = slice(40_000 + 6144, None)  # windows wholly inside the quiet stretch
    port_err = np.abs(n(py)[quiet] - 1e-4).max()
    jax_err = np.abs(np.asarray(jy)[quiet] - 1e-4).max()
    assert port_err < 1e-10
    assert jax_err > 100 * port_err


@pytest.mark.parametrize("shape", ["gate", "step_down", "ramp"])
def test_mag_agc_counters_match_jax(shape):
    """MagAGC's three saturating counters (agc.py:95-104 in the JAX package):
    +1/−gate clamped to [0, gate], −delay/+1 clamped to [0, delay], ±1
    clamped to [0, step_length]; exact in f32."""
    rng = np.random.default_rng(32)
    size = 20_000
    runs = np.repeat(rng.random(size // 50 + 1) < 0.5, 50)[:size]
    flip = rng.random(size) < 0.1
    cond = np.where(flip, ~runs, runs)
    lo, hi, up, down = {
        "gate": (0.0, 192.0, 1.0, -192.0),
        "step_down": (0.0, 6144.0, -6144.0, 1.0),
        "ramp": (0.0, 3072.0, 1.0, -1.0),
    }[shape]
    deltas = np.where(cond, up, down).astype(np.float32)
    init = np.asarray([0.0, hi / 2, hi], np.float32)
    deltas = np.stack([deltas, np.roll(deltas, 7), -deltas])
    want = np.asarray(jscan.saturating_counter(jnp.asarray(deltas), lo, hi, jnp.asarray(init)))
    got = n(pscan.saturating_counter(t(deltas), lo, hi, t(init)))
    np.testing.assert_array_equal(got, want)


def _bursts(rng, size, level=0.3, floor=1e-4):
    """Complex noise bursts with gaps, so a squelch opens and closes."""
    env = np.repeat(rng.random(size // 1500 + 1) < 0.6, 1500)[:size] * level + floor
    z = rng.standard_normal(size) + 1j * rng.standard_normal(size)
    return (z * env).astype(np.complex64)


@pytest.mark.parametrize("variant,floor,rtol", [
    (dict(order_r=0.1, history_size=6144, threshold=1e-3, gate=192, step_length=3072,
          step_down_delay=6144), 1e-4, 1e-4),  # SSB's configuration
    # the sync-AM form, threshold off: nothing gates the gain in the gaps, so
    # they keep a floor of 0.02; at 1e-4, JAX's f32 cumulative sum leaves the
    # gaps' means at 0 or below and its gain at 1e15 (the divergence pinned
    # by test_long_window_form_beats_the_f32_cumulative_sum)
    (dict(order_r=0.1, history_size=2400, threshold_enable=False, step_length=1200,
          step_down_delay=2400), 0.02, 1e-4),
    # squared and clamped, floor 0.02 for the same reason; the gain R/avg
    # carries JAX's cumulative-sum error into y one to one (4e-4 measured)
    (dict(order_r=0.5, history_size=1000, threshold=1e-3, squared=True, clamping=True,
          clamp_max=0.2, step_length=500, step_down_delay=1000), 0.02, 1e-3),
])
def test_mag_agc_streams_like_jax(variant, floor, rtol):
    """magsq and the ramp within 2e-5; y within 2e-5 plus `rtol` relative."""
    rng = np.random.default_rng(33)
    jc, pc = jagc.MagAGCConfig(**variant), pagc.MagAGCConfig(**variant)
    js, ps = jagc.make_state(jc), pagc.make_state(pc, CPU)
    run = jax.jit(jagc.mag_agc, static_argnums=2)
    for _ in range(3):
        x = _bursts(rng, 12_288, floor=floor)
        js, jy, jm, jr = run(js, jnp.asarray(x), jc)
        ps, py, pm, pr = pagc.mag_agc(ps, t(x), pc)
        np.testing.assert_allclose(n(pm), np.asarray(jm), atol=ATOL)
        np.testing.assert_allclose(n(pr), np.asarray(jr), atol=ATOL)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL, rtol=rtol)
    for f in ("gate_counter", "count", "ramp"):
        assert float(getattr(ps, f)) == float(getattr(js, f)), f


@pytest.mark.parametrize("rate", [48_000.0, 96_000.0, 156_250.0])
def test_ref_quant_increments_equal_jax(rate):
    f = np.asarray([0.0, 5000.0, -5000.0, 12_345.6, -47_999.0, 1e6, -3.3], np.float64)
    np.testing.assert_array_equal(pnco.freq_to_increment_ref_quant(f, rate),
                                  jnco.freq_to_increment_ref_quant(f, rate))


# -- receivers against JAX `process` ---------------------------------------

def _assert_close(got, want, tol):
    """|got − want| ≤ tol · max(1, peak |want|) over the block."""
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= bound, f"max abs error {err:.3e} over bound {bound:.3e}"


def _carrier(rng, size, rate, offset, kind, side=1.0):
    tt = np.arange(size) / rate
    tone = np.sin(2 * np.pi * 1000.0 * tt)
    if kind == "am":
        z = 0.4 * (1.0 + 0.8 * tone) * np.exp(2j * np.pi * offset * tt)
    elif kind == "ssb":  # two tones on the `side` of the carrier, as ssb96's
        z = 0.2 * (np.exp(2j * np.pi * (offset + side * 700.0) * tt)
                   + np.exp(2j * np.pi * (offset + side * 1900.0) * tt))
    else:  # wideband FM, 75 kHz deviation
        z = 0.4 * np.exp(1j * (2 * np.pi * offset * tt - 75.0 * np.cos(2 * np.pi * 1000.0 * tt)))
    z = z + 0.003 * (rng.standard_normal(size) + 1j * rng.standard_normal(size))
    return z.astype(np.complex64)


DEMODS = {
    "am": (jam, pam, jam.AMConfig, pam.AMConfig,
           dict(channel_rate=96_000.0, input_offset=5000.0, squelch_db=-30.0, block_in=8192)),
    "ssb": (jssb, pssb, jssb.SSBConfig, pssb.SSBConfig,
            dict(channel_rate=96_000.0, input_offset=3000.0, block_in=8192)),
    "wfm": (jwfm, pwfm, jwfm.WFMConfig, pwfm.WFMConfig,
            dict(channel_rate=384_000.0, input_offset=20_000.0, block_in=16_384)),
}

CASES = {
    "am": ("am", {}),
    "am_no_bandpass": ("am", {"bandpass_enable": False}),
    "am_ref_nco_quant": ("am", {"ref_nco_quant": True, "volume": 0.5}),
    "ssb_usb": ("ssb", {}),
    "ssb_lsb": ("ssb", {"usb": False}),
    "ssb_dsb": ("ssb", {"dsb": True}),
    "ssb_usb_agc_off": ("ssb", {"agc_enable": False}),
    "ssb_lsb_agc_off": ("ssb", {"usb": False, "agc_enable": False}),
    "ssb_binaural": ("ssb", {"audio_binaural": True}),
    "ssb_binaural_flip": ("ssb", {"audio_binaural": True, "audio_flip_channels": True,
                                  "agc_enable": False}),
    "wfm": ("wfm", {}),
    "wfm_approx": ("wfm", {"ref_atan2_approx": True}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_receiver_streams_like_jax(case):
    kind, extra = CASES[case]
    jmod, pmod, jcfg, pcfg, kw = DEMODS[kind]
    kw = dict(kw, **extra)
    jc, pc = jcfg(**kw), pcfg(**kw)
    js, ps = jmod.make_state(jc), pmod.make_state(pc, CPU)
    run = jax.jit(jmod.process, static_argnums=2)
    rng = np.random.default_rng(35)
    block = pc.resampler_plan.block_in
    x = _carrier(rng, 3 * block, pc.channel_rate, kw["input_offset"], kind,
                 side=1.0 if kw.get("usb", True) else -1.0)
    for b in range(3):
        xb = x[b * block:(b + 1) * block]
        js, jy = run(js, jnp.asarray(xb), jc)
        ps, py = pmod.process(ps, t(xb), pc)
        jy = np.asarray(jy)
        assert py.shape == jy.shape
        _assert_close(n(py), jy, ATOL)
    assert np.abs(jy).max() > 0.05, "nothing came through to compare"
    if kind in ("am",):
        assert float(ps.squelch.count) == float(js.squelch.count)
    if kind == "ssb":
        for f in ("gate_counter", "count", "ramp"):
            assert float(getattr(ps.agc, f)) == float(getattr(js.agc, f)), f
    assert int(ps.nco.phase) == int(js.nco.phase)


@pytest.mark.parametrize("kind", ["am", "ssb", "wfm"])
def test_receiver_overrides_match_jax(kind):
    """Per-block offset (f32 increment on the device) and volume overrides
    act as in the JAX function."""
    jmod, pmod, jcfg, pcfg, kw = DEMODS[kind]
    jc, pc = jcfg(**kw), pcfg(**kw)
    js, ps = jmod.make_state(jc), pmod.make_state(pc, CPU)
    run = jax.jit(jmod.process, static_argnums=2)
    rng = np.random.default_rng(36)
    block = pc.resampler_plan.block_in
    x = _carrier(rng, 2 * block, pc.channel_rate, kw["input_offset"] + 40.0, kind)
    dyn = {"offset_hz": kw["input_offset"] + 40.0, "volume": 0.5}
    for b in range(2):
        xb = x[b * block:(b + 1) * block]
        js, jy = run(js, jnp.asarray(xb), jc, offset_hz=jnp.float32(dyn["offset_hz"]),
                     volume=jnp.float32(dyn["volume"]))
        ps, py = pmod.process(ps, t(xb), pc, **dyn)
        _assert_close(n(py), np.asarray(jy), ATOL)
    assert int(ps.nco.phase) == int(js.nco.phase)


@pytest.mark.parametrize("kind", ["am", "ssb", "wfm"])
def test_receiver_bank_equals_single_channel_calls(kind):
    """A (3,) bank with per-channel offsets and volumes (and squelch levels
    where the kind has one) equals three one-channel calls within 1e-6, as
    the JAX package's test_vmapped_banks_other_demods holds its vmap."""
    _, pmod, _, pcfg, kw = DEMODS[kind]
    cfg = pcfg(**kw)
    rng = np.random.default_rng(37)
    block = cfg.resampler_plan.block_in
    offs = np.asarray([kw["input_offset"], kw["input_offset"] - 1000.0,
                       kw["input_offset"] + 500.0], np.float32)
    x = np.stack([_carrier(rng, 2 * block, cfg.channel_rate, float(o), kind) for o in offs])
    dyn = {"offset_hz": offs, "volume": np.asarray([1.0, 0.5, 2.0], np.float32)}
    if kind != "ssb":
        dyn["squelch_db"] = np.asarray([-30.0, 0.0, -30.0], np.float32)  # channel 1 shut
    bank = pmod.make_state(cfg, CPU, batch_shape=(3,))
    singles = [pmod.make_state(cfg, CPU) for _ in range(3)]
    for b in range(2):
        xb = x[:, b * block:(b + 1) * block]
        bank, yb = pmod.process(bank, t(xb), cfg, **{k: t(v) for k, v in dyn.items()})
        for c in range(3):
            singles[c], yc = pmod.process(singles[c], t(xb[c]), cfg,
                                          **{k: float(v[c]) for k, v in dyn.items()})
            _assert_close(n(yb[c]), n(yc), 1e-6)
    assert np.any(n(yb[0])) and np.any(n(yb[2]))
    if kind != "ssb":
        assert not np.any(n(yb[1]))
    for c in range(3):
        assert int(bank.nco.phase[c]) == int(singles[c].nco.phase)


@pytest.mark.parametrize("field", ["sync_am", "ref_pll_parity"])
def test_unported_am_sync_modes_raise(field):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pam.AMConfig(channel_rate=48_000.0, **{field: True})


def test_am_state_carries_jax_fields_by_name():
    """The port's AM state has JAX's names and shapes for the envelope
    path's fields, so a JAX state crosses over by name; the sync-mode
    fields, which no ported path reads, are the ones it leaves out."""
    kw = dict(channel_rate=96_000.0, block_in=8192)
    js = jax.tree.map(np.asarray, jam.make_state(jam.AMConfig(**kw), batch_shape=(2,)))
    ps = pam.make_state(pam.AMConfig(**kw), CPU, batch_shape=(2,))
    assert [f for f in js._fields if f in ps._fields] == list(ps._fields)
    assert set(js._fields) - set(ps._fields) == {
        "pll", "pll_fir", "ref_pll", "sync_delay", "sync_align", "fft", "agc"}
    for f in ps._fields:
        jl, pl = jax.tree.leaves(getattr(js, f)), jax.tree.leaves(getattr(ps, f))
        assert [n(a).shape for a in pl] == [a.shape for a in jl], f
    np.testing.assert_array_equal(n(ps.vol_agc.window), js.vol_agc.window)


@pytest.mark.parametrize("kind,cached", [("ssb", "_device_filter"), ("wfm", "_device_rf_filter")])
def test_receiver_filter_is_uploaded_once(kind, cached):
    """The fftfilt response reaches the device once per (config, device):
    blocks after the first hit the cache, and the filter in use is the
    config's own response."""
    _, pmod, _, pcfg, kw = DEMODS[kind]
    cfg = pcfg(**kw)
    cache = getattr(pmod, cached)
    state = pmod.make_state(cfg, CPU)
    block = cfg.resampler_plan.block_in
    x = _carrier(np.random.default_rng(38), 3 * block, cfg.channel_rate, kw["input_offset"], kind)
    state, _ = pmod.process(state, t(x[:block]), cfg)
    before = cache.cache_info()
    for b in (1, 2):
        state, _ = pmod.process(state, t(x[b * block:(b + 1) * block]), cfg)
    after = cache.cache_info()
    assert after.misses == before.misses and after.hits == before.hits + 2
    want = cfg.filter_freq if kind == "ssb" else cfg.rf_filter
    np.testing.assert_array_equal(n(cache(cfg, CPU)), want)


# -- goldens -----------------------------------------------------------------

def _golden_x(name):
    return (load_golden_iq(name + "_input") / 32768.0).astype(np.complex64)


def _real_best_lag(golden, ours, lags, skip):
    """test_reference_golden.py's real-valued lag and scale fit."""
    def fit(a, b):
        m = min(len(a), len(b))
        a, b = np.asarray(a[skip:m], float), np.asarray(b[skip:m], float)
        s = np.dot(b, a) / max(np.dot(b, b), 1e-30)
        err = a - s * b
        return 10 * np.log10(max(np.dot(s * b, s * b), 1e-30) / max(np.dot(err, err), 1e-30)), s
    return max(((lag, *fit(golden[max(0, lag):], ours[max(0, -lag):])) for lag in lags),
               key=lambda r: r[1])


def test_am_meets_reference_golden():
    """am96: > 100 dB at lags 1890–1960, scale audioRate/24 within 0.1 %."""
    x = _golden_x("am96")
    cfg = pam.AMConfig(channel_rate=96_000.0, input_offset=5000.0, rf_bandwidth=5000.0,
                       squelch_db=-40.0, volume=1.0, bandpass_enable=True, block_in=len(x))
    _, audio = pam.process(pam.make_state(cfg, CPU), t(x), cfg)
    lag, snr, s = _real_best_lag(load_golden("am96_audio").astype(float), n(audio),
                                 range(1890, 1960), 16_000)
    assert snr > 100.0, f"am96: snr {snr:.1f} dB (lag {lag})"
    assert abs(s / 2000.0 - 1.0) < 0.001, f"scale {s} (expect rate/24)"


@pytest.mark.parametrize("name,usb", [("ssb96agc", True), ("ssb96lsb", False)])
def test_ssb_meets_reference_golden(name, usb):
    """> 110 dB, scale 1.0 within 1e-4 (in 32768 units)."""
    x = _golden_x(name)
    cfg = pssb.SSBConfig(channel_rate=96_000.0, input_offset=3000.0, bandwidth=3000.0,
                         low_cutoff=300.0, usb=usb, volume=2.0, agc_enable=True,
                         block_in=len(x))
    _, audio = pssb.process(pssb.make_state(cfg, CPU), t(x), cfg)
    lag, snr, s = _real_best_lag(load_golden(name + "_audio").astype(float),
                                 n(audio) * 32768.0, range(-5, 6), 12_000)
    assert snr > 110.0, f"{name}: snr {snr:.1f} dB (lag {lag})"
    assert abs(s - 1.0) < 1e-4, f"scale {s}"


def _wfm_cfg(n_in, **kw):
    return pwfm.WFMConfig(channel_rate=384_000.0, input_offset=0.0, rf_bandwidth=180_000.0,
                          af_bandwidth=15_000.0, squelch_db=-60.0, volume=1.0,
                          block_in=n_in, **kw)


@pytest.mark.parametrize("approx,bound", [(False, 70.0), (True, 120.0)])
def test_wfm_meets_reference_golden(approx, bound):
    """wfmrx384: > 70 dB exact, > 120 dB with the reference's atan2."""
    x = _golden_x("wfmrx384")
    cfg = _wfm_cfg(len(x), ref_atan2_approx=approx)
    _, audio = pwfm.process(pwfm.make_state(cfg, CPU), t(x), cfg)
    lag, snr, _ = _real_best_lag(load_golden("wfmrx384_audio").astype(float), n(audio),
                                 range(-30, 31), 8000)
    assert snr > bound, f"wfmrx384 approx={approx}: snr {snr:.1f} dB (lag {lag})"


def _snr_c(g, o, skip=8192):
    m = min(len(g), len(o))
    g, o = g[skip:m], o[skip:m]
    sc = np.vdot(o, g) / max(np.vdot(o, o).real, 1e-30)
    e = g - sc * o
    return 10 * np.log10(max(np.vdot(sc * o, sc * o).real, 1e-30) / max(np.vdot(e, e).real, 1e-30))


def test_wfm_stage_taps_meet_reference_golden():
    """Each stage on the reference's own input to it, at
    test_wfm_stage_taps_match_reference's bounds: NCO 135, OLA rf filter
    125, discriminator 20 (exact) / 130 (approx), resampler 125 dB with
    scale 3276.8."""
    x = _golden_x("wfmrx384")
    gn = load_golden_iq("wfmrx384_postnco")
    gr = load_golden_iq("wfmrx384_postrf")
    gd = load_golden("wfmrx384_postdiscri")
    ga = load_golden("wfmrx384_audio")
    cfg = _wfm_cfg(len(x))

    _, xm = pnco.mix_block(pnco.make_nco(CPU), t(x), pnco.freq_to_increment(0.0, 384_000.0))
    assert _snr_c(gn, n(xm).astype(np.complex128) * 32768.0) > 135.0

    _, rf = pff.run_filt(pff.make_state(cfg.fft_len, CPU), t(gn.astype(np.complex64)),
                         t(cfg.rf_filter))
    assert _snr_c(gr, n(rf).astype(np.complex128)) > 125.0

    for approx, bound in ((False, 20.0), (True, 130.0)):
        _, dem, _ = pdis.discriminator_delta(pdis.make_state(CPU), t(gr.astype(np.complex64)),
                                             384_000.0 / 180_000.0, approx=approx)
        lag, snr, _ = _real_best_lag(gd.astype(float), n(dem), range(-3, 4), 16_384)
        assert snr > bound, f"discriminator approx={approx}: {snr:.1f} dB"

    plan = cfg.resampler_plan
    blk = len(gd) // plan.block_in * plan.block_in
    _, au = pres.resample_block(pres.init_state(plan, CPU), t(gd[:blk].astype(np.complex64)),
                                plan)
    lag, snr, s = _real_best_lag(ga.astype(float), n(au.real), range(-5, 6), 8000)
    assert snr > 125.0, f"resampler stage: {snr:.1f} dB (lag {lag})"
    assert abs(s - 3276.8) < 1.0, f"scale {s}"
