"""The port's scan, IIR, FIR-design, NCO-LUT, Goertzel, discriminator and
phase-lock stages (the parts synchronous AM, NFM's CTCSS and AF squelch and
broadcast FM add) against the JAX package on the same numpy inputs, and
the NCO and CTCSS goldens.

Tolerances: the doubling scans 2e-6 absolute on outputs within ±1 (f32
sums taken in another order than JAX's two-level scan), the biquad 2e-5
(its feedback gain 1/(1 − r) = 33 scales the rounding: the port lies
5.5e-6 and JAX 8.4e-6 from a float64 direct form); the FIR designers
and the NCO LUT bit-equal; the Goertzel powers 1e-4 relative; the
discriminator 2e-6; the PLL loops' carriers within 1e-4 absolute
and their end phases within 1e-4 rad of JAX's after 3 streamed blocks
(the plain loop rounds every operation where the JAX scan does; only the
last ulp of sin/cos/atan2 differs, and it goes round the loop), the pilot
loop's harmonics within 2e-2 (its phase is not locked yet over these
blocks and drifts with the last-ulp differences, measured 2.6e-3).
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrangel_tpu.dsp import firdesign as jfd
from sdrangel_tpu.dsp import goertzel as jgz
from sdrangel_tpu.dsp import iir as jiir
from sdrangel_tpu.dsp import nco as jnco
from sdrangel_tpu.dsp import phasediscri as jdis
from sdrangel_tpu.dsp import phaselock as jpl
from sdrangel_tpu.dsp import scanops as jscan
from sdrangel_tpu_torch.dsp import firdesign as pfd
from sdrangel_tpu_torch.dsp import goertzel as pgz
from sdrangel_tpu_torch.dsp import iir as piir
from sdrangel_tpu_torch.dsp import nco as pnco
from sdrangel_tpu_torch.dsp import phasediscri as pdis
from sdrangel_tpu_torch.dsp import phaselock as ppl
from sdrangel_tpu_torch.dsp import scanops as pscan
from sdrangel_tpu_torch.kernels import pll_scan
from torch_port_util import CPU, load_golden, load_golden_iq, n, t

CU_SOURCE = (pathlib.Path(__file__).parent.parent / "sdrangel_tpu_torch" / "kernels" / "csrc"
             / "pll_scan.cu")


# -- scans and IIR -------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.5, 10.0 / 48_000.0, 1.0 - np.exp(-1.0 / 2.4)])
def test_ema_streams_like_jax(alpha):
    rng = np.random.default_rng(40)
    jy0 = jnp.asarray(np.asarray([0.1, -0.3], np.float32))
    py0 = t(np.asarray([0.1, -0.3], np.float32))
    run = jax.jit(jscan.ema, static_argnums=1)
    for size in (3000, 777, 3000):  # above and below JAX's two-level threshold
        x = rng.uniform(-1.0, 1.0, (2, size)).astype(np.float32)
        jy = np.asarray(run(jnp.asarray(x), alpha, jy0))
        py = n(pscan.ema(t(x), alpha, py0))
        np.testing.assert_allclose(py, jy, atol=2e-6)
        jy0, py0 = jnp.asarray(jy[:, -1]), t(py[:, -1])


def test_rc_lowpass_streams_like_jax():
    rng = np.random.default_rng(41)
    tau = 50e-6 * 48_000.0  # the 50 µs deemphasis at 48 kHz
    js, ps = jiir.make_iir1((3,)), piir.make_iir1(CPU, (3,))
    run = jax.jit(jiir.rc_lowpass, static_argnums=2)
    for _ in range(3):
        x = rng.uniform(-1.0, 1.0, (3, 2048)).astype(np.float32)
        js, jy = run(js, jnp.asarray(x), tau)
        ps, py = piir.rc_lowpass(ps, t(x), tau)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=2e-6)
    np.testing.assert_allclose(n(ps.y1), np.asarray(js.y1), atol=2e-6)


@pytest.mark.parametrize("f0", [1000.0, 6000.0])
def test_biquad_streams_like_jax(f0):
    """The 2×2 companion-matrix scan (with the JAX function's zero-history
    feed-forward at each block start) against JAX, and against a float64
    direct-form oracle of one block."""
    b, a = piir.bandpass_biquad_coeffs(f0, 48_000.0)
    jb, ja = jiir.bandpass_biquad_coeffs(f0, 48_000.0)
    assert b == tuple(jb) and a == tuple(ja)
    rng = np.random.default_rng(42)
    js, ps = jiir.make_biquad((2,)), piir.make_biquad(CPU, (2,))
    run = jax.jit(jiir.biquad, static_argnums=(2, 3))
    for k in range(3):
        x = rng.uniform(-1.0, 1.0, (2, 1500)).astype(np.float32)
        js, jy = run(js, jnp.asarray(x), b, a)
        ps, py = piir.biquad(ps, t(x), b, a)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=2e-5)
        if k == 0:
            y = np.zeros(x.shape[-1] + 2)
            xx = np.concatenate([np.zeros(2), x[0].astype(np.float64)])
            for i in range(2, len(y)):
                y[i] = b[0] * xx[i] + b[1] * xx[i - 1] + b[2] * xx[i - 2] \
                    - a[0] * y[i - 1] - a[1] * y[i - 2]
            np.testing.assert_allclose(n(py[0]), y[2:], atol=2e-5)
    np.testing.assert_allclose(n(ps.s), np.asarray(js.s), atol=2e-5)


# -- FIR designers and the complex FIR ------------------------------------------

@pytest.mark.parametrize("design,args", [
    ("highpass", (63, 300.0 / 48_000.0)), ("highpass", (301, 0.01)),
    ("bandpass", (301, 300.0 / 48_000.0, 3000.0 / 48_000.0)), ("bandpass", (127, 0.05, 0.2)),
    ("kaiser_lowpass", (101, 0.1)), ("kaiser_lowpass", (64, 0.2, 40.0)),
    ("kaiser_lowpass", (31, 0.25, 15.0)),
])
def test_fir_designers_equal_jax(design, args):
    np.testing.assert_array_equal(getattr(pfd, design)(*args), getattr(jfd, design)(*args))


def test_complex_fir_streams_like_jax():
    """fir_apply over a complex block with a complex tail (the AM-sync
    prefilter, BFM's RDS lowpass)."""
    rng = np.random.default_rng(43)
    taps = jfd.lowpass(101, 200.0 / 48_000.0)
    js = jfd.make_state(101, (2,), dtype=jnp.complex64)
    ps = pfd.make_state(101, CPU, (2,), torch.complex64)
    for _ in range(3):
        x = (rng.standard_normal((2, 1024)) + 1j * rng.standard_normal((2, 1024))
             ).astype(np.complex64)
        js, jy = jfd.fir_apply(js, jnp.asarray(x), jnp.asarray(taps))
        ps, py = pfd.fir_apply(ps, t(x), t(taps))
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=2e-6)
    np.testing.assert_array_equal(n(ps.tail), np.asarray(js.tail))


# -- NCO LUT parity mode -------------------------------------------------------

@pytest.mark.parametrize("name", ["nco_m12000_48k", "nco_1234p5_48k", "nco_100k_768k"])
def test_nco_lut_bit_exact_on_golden(name):
    golden = load_golden_iq(name).astype(np.complex64)
    params = {"nco_m12000_48k": (-12000.0, 48000.0), "nco_1234p5_48k": (1234.5, 48000.0),
              "nco_100k_768k": (100000.0, 768000.0)}[name]
    inc = pnco.lut_increment(*params)
    assert inc == jnco.lut_increment(*params)
    _, z = pnco.nco_lut_block(pnco.make_nco_lut(CPU), inc, len(golden))
    np.testing.assert_array_equal(n(z), golden)


def test_nco_lut_streams_like_jax_past_int32_wrap():
    """Three blocks from a phase near the table's end; phase + increment·n
    wraps JAX's int32 at the first block's last sample and lands on the
    same table entries as the port's int64."""
    inc = 2_147_480
    js, ps = jnco.make_nco_lut((2,), 4000), pnco.make_nco_lut(CPU, (2,), 4000)
    for _ in range(3):
        js, jz = jnco.nco_lut_block(js, inc, 1000)
        ps, pz = pnco.nco_lut_block(ps, inc, 1000)
        np.testing.assert_array_equal(n(pz), np.asarray(jz))
    np.testing.assert_array_equal(n(ps.phase), np.asarray(js.phase))


# -- Goertzel: the CTCSS bank and the AF squelch -------------------------------

def test_goertzel_power_and_ctcss_match_jax():
    rng = np.random.default_rng(44)
    tt = np.arange(6 * 750) / 6000.0
    x = (0.15 * np.sin(2 * np.pi * 88.5 * tt) + 0.05 * rng.standard_normal(len(tt)))
    frames = x.astype(np.float32).reshape(2, 3, 750)
    jp = np.asarray(jgz.goertzel_power(jnp.asarray(frames), tuple(jgz.CTCSS_TONES), 6000.0))
    pp = n(pgz.goertzel_power(t(frames), pgz.CTCSS_TONES, 6000.0))
    np.testing.assert_allclose(pp, jp, rtol=1e-4, atol=1e-4 * jp.max())
    jr, pr = jgz.ctcss_detect(jnp.asarray(frames), 6000.0), pgz.ctcss_detect(t(frames), 6000.0)
    np.testing.assert_array_equal(n(pr.detected), np.asarray(jr.detected))
    np.testing.assert_array_equal(n(pr.tone_index), np.asarray(jr.tone_index))
    assert np.all(n(pr.tone_index) == 7) and np.all(n(pr.detected))  # 88.5 Hz
    np.testing.assert_array_equal(pgz.CTCSS_TONES, jgz.CTCSS_TONES)


def test_ctcss_golden_scene_detects_88p5():
    """The ctcss_detected_idx scene of test_reference_golden.py:332-350:
    88.5 Hz under a 700 Hz voice tone, ÷8 to 6 kHz, 3000-sample frames;
    the reference settles on one tone within 3 Hz of 88.5, ours within 0.5."""
    golden = load_golden("ctcss_detected_idx")
    idx = int(golden[-1])
    assert np.all(golden[1:] == idx)
    tt = np.arange(48000 * 2)
    s = 0.15 * np.sin(2 * np.pi * 88.5 * tt / 48000.0) + 0.5 * np.sin(2 * np.pi * 700.0 * tt
                                                                       / 48000.0)
    x6k = s[7::8].astype(np.float32)
    frames = x6k[:len(x6k) // 3000 * 3000].reshape(-1, 3000)
    got = n(pgz.ctcss_detect(t(frames), 6000.0).tone_index)
    assert abs(pgz.CTCSS_TONES[int(got[-1])] - 88.5) < 0.5
    assert abs(pgz.CTCSS_TONES[idx] - 88.5) < 3.0


def test_af_squelch_streams_like_jax():
    """Open on a 1 kHz tone (its 32-sample Goertzel puts the 6 kHz power
    20 dB under it; the threshold is −15 dB), shut on white noise (where
    the two are alike), streamed over 3 blocks of (3,) channels."""
    rng = np.random.default_rng(45)
    js = jgz.make_af_squelch(32, 2, (3,))
    run = jax.jit(jgz.af_squelch_run, static_argnums=(2, 3, 4, 5))
    ps = pgz.make_af_squelch(CPU, 32, 2, (3,))
    opened = []
    for b in range(3):
        tt = (b * 96 * 32 + np.arange(96 * 32)) / 48_000.0
        tone = 0.5 * np.sin(2 * np.pi * 1000.0 * tt)
        noise = 0.3 * rng.standard_normal(len(tt))
        x = np.stack([tone + 0.01 * noise, noise, tone if b != 1 else noise])
        frames = x.astype(np.float32).reshape(3, 96, 32)
        js, jo = run(js, jnp.asarray(frames), 48_000.0, 10 ** (-15 / 10), 2, 4)
        ps, po = pgz.af_squelch_run(ps, t(frames), 48_000.0, 10 ** (-15 / 10), 2, 4)
        np.testing.assert_array_equal(n(po), np.asarray(jo))
        opened.append(n(po))
    for f in ("squelch_count", "is_open"):
        np.testing.assert_array_equal(n(getattr(ps, f)), np.asarray(getattr(js, f)))
    np.testing.assert_allclose(n(ps.avg_window), np.asarray(js.avg_window), rtol=1e-4)
    assert opened[0][0, -1] and not opened[0][1].any()


# -- the plain discriminator ---------------------------------------------------

def test_discriminator_conj_streams_like_jax():
    rng = np.random.default_rng(46)
    js, ps = jdis.make_state((2,)), pdis.make_state(CPU, (2,))
    phase = np.cumsum(rng.uniform(-2.0, 2.0, (2, 3 * 2048)), axis=-1)
    x = (0.7 * np.exp(1j * phase)).astype(np.complex64)
    for b in range(3):
        xb = x[:, b * 2048:(b + 1) * 2048]
        js, jy = jdis.discriminator_conj(js, jnp.asarray(xb), 2.56)
        ps, py = pdis.discriminator_conj(ps, t(xb), 2.56)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=2e-6)
    np.testing.assert_array_equal(n(ps.prev), np.asarray(js.prev))


# -- phase-lock loops: the plain versions K-PLL is held to --------------------

def _am_carrier(rng, shape, size, rate, f_off):
    tt = np.arange(size) / rate
    phi = rng.uniform(-np.pi, np.pi, shape)[..., None]
    z = (1.0 + 0.5 * np.sin(2 * np.pi * 1000.0 * tt)) * np.exp(1j * (2 * np.pi * f_off * tt + phi))
    z = z + 0.05 * (rng.standard_normal((*shape, size)) + 1j * rng.standard_normal((*shape, size)))
    return z.astype(np.complex64)


@pytest.mark.parametrize("loop", ["pll", "ref_pll"])
def test_pll_streams_like_jax(loop):
    """3 blocks of 1024 with a (2,) batch, carriers 20 and −35 Hz off."""
    rng = np.random.default_rng(47)
    x = _am_carrier(rng, (2,), 3 * 1024, 48_000.0, np.asarray([[20.0], [-35.0]]))
    if loop == "pll":
        js, ps = jpl.make_pll((2,)), ppl.make_pll(CPU, (2,))
        jrun = jax.jit(lambda s, xb: jpl.pll_run(s, xb, 48_000.0))
        prun = lambda s, xb: ppl.pll_run(s, xb, 48_000.0)
    else:
        js, ps = jpl.make_ref_pll((2,)), ppl.make_ref_pll(CPU, (2,))
        jrun, prun = jax.jit(jpl.ref_pll_run), ppl.ref_pll_run
    for b in range(3):
        xb = x[:, b * 1024:(b + 1) * 1024]
        js, jc = jrun(js, jnp.asarray(xb))
        ps, pc = prun(ps, t(xb))
        assert pc.dtype == torch.complex64 and pc.shape == (2, 1024)
        np.testing.assert_allclose(n(pc), np.asarray(jc), atol=1e-4)
    phase = ps.phase if loop == "pll" else ps.phi
    jphase = js.phase if loop == "pll" else js.phi
    err = np.angle(np.exp(1j * (n(phase).astype(np.float64) - np.asarray(jphase))))
    assert np.abs(err).max() < 1e-4
    # locked: the carrier rotates at the input's offset
    rot = np.angle(n(pc[:, 1:] * pc[:, :-1].conj())).mean(axis=-1) * 48_000.0 / (2 * np.pi)
    np.testing.assert_allclose(rot, [20.0, -35.0], atol=2.0)


def _pll_blocks_like_jax(x, block):
    """The port's pll_run and JAX's streamed over x (C, T) in blocks of
    `block`: the carriers within 1e-4 and the end phases within 1e-4 rad."""
    shape = x.shape[:-1]
    js, ps = jpl.make_pll(shape), ppl.make_pll(CPU, shape)
    jrun = jax.jit(lambda s, xb: jpl.pll_run(s, xb, 48_000.0))
    for b in range(x.shape[-1] // block):
        xb = x[..., b * block:(b + 1) * block]
        js, jc = jrun(js, jnp.asarray(xb))
        ps, pc = ppl.pll_run(ps, t(xb), 48_000.0)
        np.testing.assert_allclose(n(pc), np.asarray(jc), atol=1e-4, err_msg=f"block {b}")
    err = np.angle(np.exp(1j * (n(ps.phase).astype(np.float64) - np.asarray(js.phase))))
    assert np.abs(err).max() < 1e-4
    return ps, pc


def test_pll_zero_runs_stream_like_jax():
    """The split form on a gated input: a leading run of exact zeros and a
    zeroed stretch mid-block (the squelch's shape), 3 blocks of 1024 with a
    (2,) batch. On a zero the loop takes the rotated product's detector, as
    JAX's scan does, so the zeros feed 0 or ±π into the loop, not −θ."""
    rng = np.random.default_rng(52)
    x = _am_carrier(rng, (2,), 3 * 1024, 48_000.0, np.asarray([[20.0], [-35.0]]))
    x[:, :100] = 0.0
    x[:, 1500:1700] = 0.0
    x[1, 2100:2110] = complex(-0.0, -0.0)
    _pll_blocks_like_jax(x, 1024)


def test_pll_long_block_wraps_like_jax():
    """One block of 8,192 samples, the carrier 37 Hz off: θ wraps through
    ±π six times, and each wrap goes through the floor-mod's fast path."""
    rng = np.random.default_rng(53)
    x = _am_carrier(rng, (1,), 8192, 48_000.0, np.asarray([[37.0]]))
    _, pc = _pll_blocks_like_jax(x, 8192)
    pc = n(pc[:, 4096:])  # locked after the first half
    rot = np.angle(pc[:, 1:] * pc[:, :-1].conj()).mean(axis=-1) * 48_000.0 / (2 * np.pi)
    np.testing.assert_allclose(rot, [37.0], atol=2.0)


def test_pll_error_on_an_exact_zero_is_the_rotated_products():
    """An exact-zero sample's error is _phase_error's on the rotated zero (0
    or ±π from the signs of its products), at θ in each quadrant and on each
    axis, for each sign of the zero's parts. With g1 = 0 and g2 = 1 one step
    leaves freq' = −0 + the error = the error exactly."""
    thetas = np.float32([0.0, -0.0, 0.7, 2.2, -2.2, -0.7, ppl.PI_F, -ppl.PI_F, 1.5707964])
    zeros = [complex(a, b) for a in (0.0, -0.0) for b in (0.0, -0.0)]
    x = np.asarray([[z] for _ in thetas for z in zeros], np.complex64)
    phase = np.repeat(thetas, len(zeros))
    state = torch.stack([t(phase), torch.full((len(phase),), -0.0)])  # −0 + e = e
    _, st = ppl.pll_plain(t(x), state, 0.0, 1.0)
    th = t(phase)
    want = ppl._phase_error(t(x.real[:, 0].copy()), t(x.imag[:, 0].copy()), torch.cos(th),
                            torch.sin(th))
    assert n(st[1]).tobytes() == n(want).tobytes()  # bit for bit, signed zeros too
    assert set(np.abs(n(st[1])).tolist()) == {0.0, ppl.PI_F}  # both occur, nothing else


def test_pilot_pll_streams_like_jax():
    """The 19 kHz pilot loop on an MPX at 192 kHz, (3,) batch, 3 blocks."""
    rng = np.random.default_rng(48)
    size = 3 * 2048
    tt = np.arange(size) / 192_000.0
    phi = rng.uniform(-np.pi, np.pi, (3, 1))
    x = (0.1 * np.cos(2 * np.pi * 19_000.0 * tt + phi) + 0.4 * np.sin(2 * np.pi * 1000.0 * tt)
         + 0.01 * rng.standard_normal((3, size))).astype(np.float32)
    js = jpl.make_pilot_pll(19_000.0, 192_000.0, (3,))
    ps = ppl.make_pilot_pll(19_000.0, 192_000.0, CPU, (3,))
    jrun = jax.jit(lambda s, xb: jpl.pilot_pll_run(s, xb, 19_000.0, 192_000.0))
    for b in range(3):
        xb = x[:, b * 2048:(b + 1) * 2048]
        js, *jh = jrun(js, jnp.asarray(xb))
        ps, *ph = ppl.pilot_pll_run(ps, t(xb), 19_000.0, 192_000.0)
        for k in range(3):
            np.testing.assert_allclose(n(ph[k]), np.asarray(jh[k]), atol=2e-2)
    for f in ps._fields:
        np.testing.assert_allclose(n(getattr(ps, f)), np.asarray(getattr(js, f)), atol=2e-3,
                                   err_msg=f)


def test_fll_streams_like_jax():
    rng = np.random.default_rng(49)
    x = _am_carrier(rng, (2,), 3 * 2048, 48_000.0, np.asarray([[150.0], [-90.0]]))
    js, ps = jpl.make_fll((2,)), ppl.make_fll(CPU, (2,))
    run = jax.jit(jpl.fll_run, static_argnums=2)
    for b in range(3):
        xb = x[:, b * 2048:(b + 1) * 2048]
        js, jy, jf = run(js, jnp.asarray(xb), 48_000.0)
        ps, py, pf = ppl.fll_run(ps, t(xb), 48_000.0)
        np.testing.assert_allclose(n(pf), np.asarray(jf), atol=1e-6)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=1e-4)


def test_pll_scan_wrappers_launch_on_cuda_only():
    """K-PLL's wrappers take CUDA tensors only: a CPU tensor goes through
    phaselock's plain loop, never to the wrapper, and the wrapper refuses
    one (no fallback inside it); the launch counts start at zero."""
    x = torch.zeros((1, 8), dtype=torch.complex64)
    with pytest.raises(ValueError, match="cuda"):
        pll_scan.pll_run(x, torch.zeros((2, 1)), 0.1, 0.01)
    with pytest.raises(ValueError, match="cuda"):
        pll_scan.pilot_pll_run(x.real.contiguous(), torch.zeros((8, 1)), (0.0,) * 7)
    assert pll_scan.pll_run.launches == pll_scan.ref_pll_run.launches == 0


def test_pll_scan_source_constants_are_jax_float32_values():
    """The kernel's π and 2π literals are float32(π) and float32(2π), the
    values JAX's weak-typed np.pi takes in the scan, and the plain loop's."""
    src = CU_SOURCE.read_text()
    pi = float(re.search(r"kPi = ([0-9.]+)f", src).group(1))
    two_pi = float(re.search(r"kTwoPi = ([0-9.]+)f", src).group(1))
    assert np.float32(pi) == np.float32(np.pi) == np.float32(ppl.PI_F)
    assert np.float32(two_pi) == np.float32(2 * np.pi) == np.float32(ppl.TWO_PI_F)
    assert "__fmul_rn" in src and "fmodf" in src
