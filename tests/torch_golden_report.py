"""Print the port's and the JAX package's SNR on each golden of the AM, SSB,
WFM and fftfilt slice and of the Tx slice (the device interpolators, the
UpChannelizer, the resampler both ways, the NFM and WFM modulators), on the
CPU, with the fits the tests use:

    python tests/torch_golden_report.py

Not a test: the bounds live in tests/test_torch_demods.py,
tests/test_torch_fftfilt.py and tests/test_torch_tx.py; this prints where
each side lands.
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
from sdrangel_tpu.channels import demod_ssb as jssb  # noqa: E402
from sdrangel_tpu.channels import demod_wfm as jwfm  # noqa: E402
from sdrangel_tpu.channels import modulators as jmods  # noqa: E402
from sdrangel_tpu.dsp import channelizer as jchan  # noqa: E402
from sdrangel_tpu.dsp import fftfilt as jff  # noqa: E402
from sdrangel_tpu.dsp import interpolators as jint  # noqa: E402
from sdrangel_tpu.dsp import resampler as jres  # noqa: E402
from sdrangel_tpu_torch.dsp import fftfilt as pff  # noqa: E402
from torch_port_util import CPU, fit_snr, load_golden, load_golden_iq, n, t  # noqa: E402

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


if __name__ == "__main__":
    receivers()
    fftfilt()
    tx()
