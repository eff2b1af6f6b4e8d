"""Print the port's and the JAX package's SNR on each golden of the AM, SSB,
WFM and fftfilt slice, of the Tx slice (the device interpolators, the
UpChannelizer, the resampler both ways, the NFM and WFM modulators) and of
the sync-AM / CTCSS / broadcast-FM slice (the NCO LUT, the CTCSS scene,
amsync96, bfm384), on the CPU, with the fits the tests use:

    python tests/torch_golden_report.py

Not a test: the bounds live in tests/test_torch_demods.py,
tests/test_torch_fftfilt.py, tests/test_torch_tx.py,
tests/test_torch_phaselock.py and tests/test_torch_receivers_ext.py; this
prints where each side lands.
"""

import os
import sys

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_demods as td  # noqa: E402
import test_torch_tx as ttx  # noqa: E402
from sdrangel_tpu.channels import demod_am as jam  # noqa: E402
from sdrangel_tpu.channels import demod_bfm as jbfm  # noqa: E402
from sdrangel_tpu.dsp import agc as jagc  # noqa: E402
from sdrangel_tpu.dsp import goertzel as jgz  # noqa: E402
from sdrangel_tpu.dsp import nco as jnco  # noqa: E402
from sdrangel_tpu.channels import demod_ssb as jssb  # noqa: E402
from sdrangel_tpu.channels import demod_wfm as jwfm  # noqa: E402
from sdrangel_tpu.channels import modulators as jmods  # noqa: E402
from sdrangel_tpu.dsp import channelizer as jchan  # noqa: E402
from sdrangel_tpu.dsp import fftfilt as jff  # noqa: E402
from sdrangel_tpu.dsp import interpolators as jint  # noqa: E402
from sdrangel_tpu.dsp import resampler as jres  # noqa: E402
from sdrangel_tpu_torch.channels import demod_bfm as pbfm  # noqa: E402
from sdrangel_tpu_torch.dsp import agc as pagc  # noqa: E402
from sdrangel_tpu_torch.dsp import fftfilt as pff  # noqa: E402
from sdrangel_tpu_torch.dsp import goertzel as pgz  # noqa: E402
from sdrangel_tpu_torch.dsp import nco as pnco  # noqa: E402
from torch_port_util import (  # noqa: E402
    CPU, fit_snr, load_golden, load_golden_iq, n, real_best_lag, t)

# name -> (JAX module, port module, config kwargs without block_in, output
# scale, lags, skip), as test_reference_golden.py:647-838 runs each
RECEIVERS = {
    "am96": (jam, td.pam, "AMConfig", dict(
        channel_rate=96_000.0, input_offset=5000.0, rf_bandwidth=5000.0, squelch_db=-40.0,
        volume=1.0, bandpass_enable=True), 1.0, range(1890, 1960), 16_000),
    **{name: (jssb, td.pssb, "SSBConfig", dict(
        channel_rate=96_000.0, input_offset=3000.0, bandwidth=3000.0, low_cutoff=300.0,
        usb=usb, volume=2.0, agc_enable=True), 32768.0, range(-5, 6), 12_000)
       for name, usb in (("ssb96agc", True), ("ssb96lsb", False))},
    **{name: (jwfm, td.pwfm, "WFMConfig", dict(
        channel_rate=384_000.0, input_offset=0.0, rf_bandwidth=180_000.0,
        af_bandwidth=15_000.0, squelch_db=-60.0, volume=1.0, ref_atan2_approx=approx),
        1.0, range(-30, 31), 8000)
       for name, approx in (("wfmrx384", False), ("wfmrx384 (ref atan2)", True))},
}


def receivers() -> None:
    for name, (jmod, pmod, cls, kw, scale, lags, skip) in RECEIVERS.items():
        golden = name.split()[0]
        x = td._golden_x(golden)
        kw = dict(kw, block_in=len(x))
        jc, pc = getattr(jmod, cls)(**kw), getattr(pmod, cls)(**kw)
        _, ja = jmod.process(jmod.make_state(jc), jnp.asarray(x), jc)
        _, pa = pmod.process(pmod.make_state(pc, CPU), t(x), pc)
        g = load_golden(golden + "_audio").astype(float)
        for side, audio in (("jax", np.asarray(ja)), ("port", n(pa))):
            lag, snr, s = td._real_best_lag(g, audio * scale, lags, skip)
            print(f"{name:22s} {side:4s} {snr:8.3f} dB lag {lag} scale {s:.6f}")


def fftfilt() -> None:
    x = load_golden_iq("fftfilt_input").astype(np.complex64)
    h = jff.create_filter(300 / 48_000, 3000 / 48_000, 1024)
    h_dsb = jff.create_dsb_filter(3000 / 48_000, 1024)
    h_in, h_opp = jff.create_asym_filter(500 / 48_000, 3000 / 48_000, 1024)
    runs = {
        "fftfilt_ssb_usb": lambda m, s, xx, a: m.run_ssb(s, xx, a(h), usb=True),
        "fftfilt_ssb_lsb": lambda m, s, xx, a: m.run_ssb(s, xx, a(h), usb=False),
        "fftfilt_dsb": lambda m, s, xx, a: m.run_dsb(s, xx, a(h_dsb)),
        "fftfilt_asym_usb": lambda m, s, xx, a: m.run_asym(s, xx, a(h_in), a(h_opp), usb=True),
    }
    for name, run in runs.items():
        _, jy = run(jff, jff.make_state(1024), jnp.asarray(x), jnp.asarray)
        _, py = run(pff, pff.make_state(1024, CPU), t(x), t)
        for side, y in (("jax", np.asarray(jy)), ("port", n(py))):
            snr, s = fit_snr(load_golden_iq(name), y, skip=0)
            print(f"{name:22s} {side:4s} {snr:8.3f} dB scale {abs(s):.7f}")


def _jax_side(fn):
    """Run one of test_torch_tx.py's golden fits with the JAX package's
    functions in place of the port's."""
    saved = ttx.pint, ttx.pres, ttx.pmods, ttx.pchan, ttx.CPU, ttx.t
    ttx.pint, ttx.pres, ttx.pmods, ttx.pchan = _JaxInterp, _JaxRes, _JaxMods, jchan
    ttx.t = jnp.asarray
    try:
        return fn()
    finally:
        ttx.pint, ttx.pres, ttx.pmods, ttx.pchan, ttx.CPU, ttx.t = saved


class _JaxInterp:
    """The JAX interpolators under the port's call signatures."""

    @staticmethod
    def init_state(n_stages, device=None, batch_shape=(), order=96):
        return jint.init_state(n_stages, batch_shape, order)

    upchannelize = staticmethod(jint.upchannelize)
    interpolate_cascade = staticmethod(jint.interpolate_cascade)


class _JaxRes:
    make_plan = staticmethod(jres.make_plan)
    resample_block = staticmethod(jres.resample_block)

    @staticmethod
    def init_state(plan, device=None, batch_shape=()):
        return jres.init_state(plan, batch_shape)


class _JaxMods:
    NFMModConfig, WFMModConfig = jmods.NFMModConfig, jmods.WFMModConfig
    fm_modulate, wfm_modulate = staticmethod(jmods.fm_modulate), staticmethod(jmods.wfm_modulate)

    @staticmethod
    def make_fm_state(cfg, device=None):
        return jmods.make_fm_state(cfg)

    @staticmethod
    def make_wfm_state(cfg, device=None):
        return jmods.make_wfm_state(cfg)


def tx() -> None:
    ttx.n = np.asarray  # both sides' outputs as numpy
    fits = {f"txinterp_cen_l{k}": (lambda k=k, lag=lag: ttx._txinterp_snr(k, lag))
            for k, lag in ((1, 0), (2, -16), (4, -136), (6, -618))}
    fits.update({name: (lambda name=name, modes=modes, lag=lag: ttx._upchan_fit(
        name, modes, lag)[1:]) for name, modes, lag in (
        ("upchan_cen_cen", (0, 0), 12), ("upchan_low_up", (1, 2), 12),
        ("upchan_up_low_cen", (2, 1, 0), 28))})
    fits.update({name: (lambda name=name: ttx._interp_fit(name)[1:]) for name in (
        "interp_48k_96k", "interp_48k_120k", "interp_96k_48k", "interp_125k_48k")})
    fits.update({name: (lambda name=name, off=off, c=c: ttx._nfmmod_fit(name, off, c)[1:3])
                 for name, off, c in (("nfmmod96", 0.0, False),
                                      ("nfmmod96_off12k", 12_000.0, False),
                                      ("nfmmod96_ctcss", 0.0, True))})
    fits["wfmmod384"] = lambda: ttx._wfmmod_fit()[1:3]
    for name, fit in fits.items():
        for side, run in (("jax", lambda: _jax_side(fit)), ("port", fit)):
            snr, scale = run()
            print(f"{name:22s} {side:4s} {snr:8.3f} dB scale {abs(scale):.7f}")


def _amsync_run(mod, make, arr, **extra):
    flat = load_golden("amsync96_input")
    x = ((flat[0::2] / 32768.0) + 1j * (flat[1::2] / 32768.0)).astype(np.complex64)
    cfg = mod.AMConfig(channel_rate=96_000.0, input_offset=5000.0, rf_bandwidth=5000.0,
                       squelch_db=-40.0, bandpass_enable=False, sync_am=True,
                       block_in=len(x), **extra)
    _, audio = mod.process(make(cfg), arr(x), cfg)
    return np.asarray(audio) if mod is jam else n(audio)


def sync_ctcss_bfm() -> None:
    """The goldens of the sync-AM / CTCSS / broadcast-FM slice, both sides."""
    for name, (freq, rate) in (("nco_m12000_48k", (-12000.0, 48000.0)),
                               ("nco_1234p5_48k", (1234.5, 48000.0)),
                               ("nco_100k_768k", (100000.0, 768000.0))):
        g = load_golden_iq(name).astype(np.complex64)
        _, jz = jnco.nco_lut_block(jnco.make_nco_lut(), jnco.lut_increment(freq, rate), len(g))
        _, pz = pnco.nco_lut_block(pnco.make_nco_lut(CPU), pnco.lut_increment(freq, rate),
                                   len(g))
        for side, z in (("jax", np.asarray(jz)), ("port", n(pz))):
            print(f"{name:22s} {side:4s} max |diff| {np.abs(z - g).max():.1e} "
                  f"(bit-exact: {np.array_equal(z, g)})")
    tt = np.arange(48000 * 2)
    sig = 0.15 * np.sin(2 * np.pi * 88.5 * tt / 48000.0) + 0.5 * np.sin(2 * np.pi * 700.0 * tt
                                                                         / 48000.0)
    frames = sig[7::8].astype(np.float32)[:12_000].reshape(-1, 3000)
    ref_hz = jgz.CTCSS_TONES[int(load_golden("ctcss_detected_idx")[-1])]
    for side, idx in (("jax", np.asarray(jgz.ctcss_detect(jnp.asarray(frames), 6000.0)
                                         .tone_index)),
                      ("port", n(pgz.ctcss_detect(t(frames), 6000.0).tone_index))):
        print(f"{'ctcss_detected_idx':22s} {side:4s} {jgz.CTCSS_TONES[int(idx[-1])]:.1f} Hz "
              f"(reference {ref_hz:.1f} Hz, tone 88.5 Hz)")
    g = load_golden("amsync96_audio").astype(float)
    for label, extra, lags in (
            ("amsync96", {}, range(300, 500, 2)),
            ("amsync96 (full parity)", dict(ref_nco_quant=True, ref_pll_parity=True,
                                            sync_frame_offset=148), range(-200, 200))):
        for side, mod, make, arr in (
                ("jax", jam, jam.make_state, jnp.asarray),
                ("port", td.pam, lambda c: td.pam.make_state(c, CPU), t)):
            lag, snr, s = real_best_lag(g, _amsync_run(mod, make, arr, **extra), lags, 20_000)
            print(f"{label:22s} {side:4s} {snr:8.3f} dB lag {lag} scale {s:.6f}")
    gm, gd = load_golden("amsync96_postmix"), load_golden("amsync96_demod")
    fed = np.concatenate([np.zeros(148), gm[0::2] + 1j * gm[1::2]])
    fed = fed[:len(fed) // 512 * 512].astype(np.complex64)
    cfg = jam.AMConfig(channel_rate=96_000.0, sync_am=True, bandpass_enable=False)
    for side, ff, ag, arr, make in (("jax", jff, jagc, jnp.asarray, lambda m, *a: m(*a)),
                                    ("port", pff, pagc, t, lambda m, *a: m(*a, CPU))):
        _, filt = ff.run_ssb(make(ff.make_state, cfg.sync_fft_len), arr(fed),
                             arr(np.asarray(cfg.sync_filter)), usb=True, get_dc=False)
        _, lev, _, _ = ag.mag_agc(make(ag.make_state, cfg.sync_agc_config), filt,
                                  cfg.sync_agc_config)
        dem = np.asarray(lev.real + lev.imag) * 4.0 if side == "jax" else n(
            (lev.real + lev.imag) * 4.0)
        lag, snr, s = real_best_lag(gd.astype(float), dem, range(-668, 382), 20_000)
        print(f"{'amsync96 (tail)':22s} {side:4s} {snr:8.3f} dB lag {lag} scale {s:.6f}")
    flat = load_golden("bfm384_input")
    x = ((flat[0::2] / 32768.0) + 1j * (flat[1::2] / 32768.0)).astype(np.complex64)
    x = x[:len(x) // 1536 * 1536]
    gl2 = load_golden("bfm384_audio_lr").astype(float)
    gsum = gl2[0::2] + gl2[1::2]
    for side, mod, make, arr in (("jax", jbfm, jbfm.make_state, jnp.asarray),
                                 ("port", pbfm, lambda c: pbfm.make_state(c, CPU), t)):
        cfg = mod.BFMConfig(channel_rate=384_000.0, block_in=len(x))
        _, out = mod.process(make(cfg), arr(x), cfg)
        y = np.asarray(out.audio) if side == "jax" else n(out.audio)
        lag, snr, _ = real_best_lag(gsum, (y[:, 0] + y[:, 1]).astype(float), range(-40, 41),
                                    12_000)
        w = np.hanning(16_384)
        fr = np.fft.rfftfreq(16_384, 1 / 48_000)
        sl = np.abs(np.fft.rfft(y[12_000:12_000 + 16_384, 0] * w))
        sep = 20 * np.log10(sl[np.abs(fr - 1000) < 10].max() / sl[np.abs(fr - 2500) < 10].max())
        print(f"{'bfm384 (mono sum)':22s} {side:4s} {snr:8.3f} dB lag {lag}; left "
              f"separation {sep:.2f} dB")


if __name__ == "__main__":
    receivers()
    fftfilt()
    tx()
    sync_ctcss_bfm()
