"""Print the port's and the JAX package's SNR on each golden of the AM, SSB,
WFM and fftfilt slice, on the CPU, with the fits the tests use:

    python tests/torch_golden_report.py

Not a test: the bounds live in tests/test_torch_demods.py and
tests/test_torch_fftfilt.py; this prints where each side lands.
"""

import os
import sys

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_demods as td  # noqa: E402
from sdrangel_tpu.channels import demod_am as jam  # noqa: E402
from sdrangel_tpu.channels import demod_ssb as jssb  # noqa: E402
from sdrangel_tpu.channels import demod_wfm as jwfm  # noqa: E402
from sdrangel_tpu.dsp import fftfilt as jff  # noqa: E402
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


if __name__ == "__main__":
    receivers()
    fftfilt()
