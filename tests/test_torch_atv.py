"""The port's ATV receiver, its frame assembly and the ATV modulator against
the JAX package: `demod_atv.process` for each modulation (am, fm, usb, lsb)
and each standard, streamed over 3 blocks with its state carried;
`atv_composite` and `atv_modulate` (am, usb, lsb, vusb, vlsb; fm against a
float64 oracle, as the port's other FM modulators); the port's copy of
`atvframe.FrameAssembler` on the synthetic frames of tests/test_atv.py; and
the modulator-to-receiver loopback at tests/test_atv.py:53's bounds.

Tolerances: 2e-5 absolute on video levels and baseband samples (the Pallas
kernel's own tolerance), the sync phase equal; the FM modulator within
2e-5 of a float64 oracle (its phase is summed in float64, ROADMAP.md §3;
measured 1.4e-5) and 2e-4 of JAX, whose f32 running sum is 1.1e-4 from the
oracle by the third block; frame assembly exactly equal.

The JAX receiver's usb/lsb forms do not trace under jit (fftfilt.run_asym
reads its filters as numpy), so the JAX engine cannot run them
(ROADMAP.md §3); here the JAX functions run op by op.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrangel_tpu.channels import atvframe as jframe
from sdrangel_tpu.channels import demod_atv as jatv
from sdrangel_tpu.channels import modulators as jmods
from sdrangel_tpu_torch.channels import atvframe as pframe
from sdrangel_tpu_torch.channels import demod_atv as patv
from sdrangel_tpu_torch.channels import modulators as pmods
from torch_port_util import CPU, n, t

ATOL = 2e-5
BLOCK = 8192  # a multiple of the 512-sample fftfilt hop


def _video(spl: int, n_samples: int, rng) -> np.ndarray:
    """Lines of a sync tip (8 %), a porch and a ramp with a little noise."""
    sync = max(1, int(0.08 * spl))
    line = np.concatenate([np.zeros(sync), np.full(spl // 16, 0.3),
                           np.linspace(0.35, 1.0, spl - sync - spl // 16)])
    v = np.tile(line, n_samples // spl + 2)[spl // 3:spl // 3 + n_samples]  # mid-line start
    return v + 0.01 * rng.standard_normal(n_samples)


def _signal(modulation: str, rate: float, spl: int, rng) -> np.ndarray:
    v = _video(spl, 3 * BLOCK, rng)
    tt = np.arange(len(v)) / rate
    if modulation == "fm":
        phase = 2 * np.pi * np.cumsum(0.4 * rate * (v - 0.5)) / rate
        x = 0.5 * np.exp(1j * phase)
    else:
        x = (0.1 + 0.8 * v) * np.exp(1j * (2 * np.pi * 0.01 * rate * tt + 0.3))
    return x.astype(np.complex64)


@pytest.mark.parametrize("standard", sorted(jatv.ATV_STANDARDS))
@pytest.mark.parametrize("modulation", ["am", "fm", "usb", "lsb"])
def test_atv_streams_like_jax(modulation, standard):
    std = jatv.ATV_STANDARDS[standard]
    rate = std.lines * std.fps * 64  # 64 samples a line
    kw = dict(channel_rate=rate, input_offset=0.01 * rate, modulation=modulation,
              standard=standard, rf_bandwidth=0.6 * rate, fm_deviation=0.4 * rate,
              fft_filtering=modulation == "am")
    jc, pc = jatv.ATVConfig(**kw), patv.ATVConfig(**kw)
    assert pc.samples_per_line == jc.samples_per_line == 64
    x = _signal(modulation, rate, 64, np.random.default_rng(81))
    js, ps = jatv.make_state(jc), patv.make_state(pc, CPU)
    for b in range(3):
        xb = x[b * BLOCK:(b + 1) * BLOCK]
        js, jo = jatv.process(js, jnp.asarray(xb), jc)
        ps, po = patv.process(ps, t(xb), pc)
        np.testing.assert_allclose(n(po.lines), np.asarray(jo.lines), atol=ATOL, rtol=0)
        assert float(po.sync_phase) == float(jo.sync_phase)
        np.testing.assert_allclose(float(po.sync_quality), float(jo.sync_quality), atol=ATOL)
    np.testing.assert_allclose(n(ps.fft.overlap), np.asarray(js.fft.overlap), atol=ATOL)
    assert int(ps.nco.phase) == int(js.nco.phase)
    if modulation != "fm":  # the tip of a stream that starts a third into a line
        assert float(po.sync_quality) > 0.3 and 40.0 <= float(po.sync_phase) <= 50.0


def test_atv_standards_and_geometry_equal_jax():
    for name, std in jatv.ATV_STANDARDS.items():
        assert patv.ATV_STANDARDS[name].__dict__ == std.__dict__, name
        for rate, lines, fps in ((10e6, 0, 0.0), (1e6, 100, 20.0)):
            kw = dict(channel_rate=rate, standard=name, lines=lines, fps=fps)
            j, p = jatv.ATVConfig(**kw), patv.ATVConfig(**kw)
            assert (p.line_rate, p.samples_per_line, p.visible_lines) == (
                j.line_rate, j.samples_per_line, j.visible_lines)
    with pytest.raises(ValueError, match="unknown ATV standard"):
        _ = patv.ATVConfig(channel_rate=1e6, standard="ntsc!").std


# -- the modulator ----------------------------------------------------------------------

_MOD_CASES = ["am", "usb", "lsb", "vusb", "vlsb"]


def _frame(n_lines=48, width=64):
    """Bars and a ramp: the test pattern of phase 10b."""
    ramp = np.tile(np.linspace(0.0, 1.0, width, dtype=np.float32), (n_lines, 1))
    ramp[::8] = (np.arange(width) // 8 % 2).astype(np.float32)  # a bar row every 8th line
    return ramp


@pytest.mark.parametrize("modulation", _MOD_CASES)
def test_atv_modulator_streams_like_jax(modulation):
    kw = dict(channel_rate=1_250_000.0, input_offset=60_000.0, modulation=modulation,
              rf_bandwidth=400_000.0, rf_opp_bandwidth=60_000.0)
    jc, pc = jmods.ATVModConfig(**kw), pmods.ATVModConfig(**kw)
    comp = n(pmods.atv_composite(pc, t(_frame())))
    np.testing.assert_array_equal(comp, np.asarray(jmods.atv_composite(jc, jnp.asarray(_frame()))))
    blocks = np.tile(comp, 3)[:3 * 1024].reshape(3, 1024)
    js, ps = jmods.make_atv_state(jc), pmods.make_atv_state(pc, CPU)
    for b in range(3):
        js, jy = jmods.atv_modulate(js, jnp.asarray(blocks[b]), jc)
        ps, py = pmods.atv_modulate(ps, t(blocks[b]), pc)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=ATOL, rtol=0)
    assert int(ps.off_nco.phase) == int(js.off_nco.phase)


def test_atv_fm_modulator_meets_a_float64_oracle():
    """FM: the port sums the phase in float64 (the divergence ROADMAP.md §3
    records for the FM modulators); held to a float64 oracle, and to JAX's
    f32 running sum, whose error grows with the block."""
    kw = dict(channel_rate=1_250_000.0, modulation="fm", fm_deviation=300_000.0)
    jc, pc = jmods.ATVModConfig(**kw), pmods.ATVModConfig(**kw)
    comp = np.tile(n(pmods.atv_composite(pc, t(_frame()))), 2)[:3 * 2048].reshape(3, 2048)
    js, ps = jmods.make_atv_state(jc), pmods.make_atv_state(pc, CPU)
    phase0 = 0.0
    for b in range(3):
        js, jy = jmods.atv_modulate(js, jnp.asarray(comp[b]), jc)
        ps, py = pmods.atv_modulate(ps, t(comp[b]), pc)
        dphi = np.float32(2 * np.pi * 300_000.0 / 1_250_000.0) * (comp[b] - np.float32(0.5))
        phase = phase0 + np.cumsum(dphi.astype(np.float64))
        phase0 = float(np.float32(np.mod(phase[-1], 2 * np.pi)))
        np.testing.assert_allclose(n(py), 0.891 * np.exp(1j * phase), atol=ATOL, rtol=0)
        np.testing.assert_allclose(n(py), np.asarray(jy), atol=2e-4, rtol=0)
    assert float(ps.phase) == np.float32(phase0)


def test_atv_loopback_recovers_the_frame():
    """tests/test_atv.py:53 through the port: PAL 625/25 at 1.25 MS/s (80
    samples a line), AM, 256 lines of a luma ramp; the sync notch deep
    (> 0.3), the tip rolled to column 0, the ramp recovered with ρ > 0.95."""
    rate = 1_250_000.0
    mcfg = pmods.ATVModConfig(channel_rate=rate, modulation="am")
    assert mcfg.samples_per_line == 80
    ramp = np.tile(np.linspace(0.0, 1.0, 64, dtype=np.float32), (256, 1))
    _, x = pmods.atv_modulate(pmods.make_atv_state(mcfg, CPU),
                              pmods.atv_composite(mcfg, t(ramp)), mcfg)
    dcfg = patv.ATVConfig(channel_rate=rate, modulation="am", lines=625, fps=25.0)
    _, outs = patv.process(patv.make_state(dcfg, CPU), x, dcfg)
    lines = n(outs.lines)
    assert float(outs.sync_quality) > 0.3
    mid = lines[50:200]
    assert mid[:, :4].mean() < mid[:, 20:].mean() - 0.2
    active = mid[:, 12:78].mean(axis=0)
    assert active[-8:].mean() > active[:8].mean() + 0.3
    assert np.corrcoef(np.arange(active.size), active)[0, 1] > 0.95


# -- frame assembly (the port's copy of atvframe.py) ----------------------------------------

def _synth_standard(cfg, n_frames, row_level):
    """tests/test_atv.py's synthetic baseband video per the standard's
    field structure (hsync, porch, a level per row; interleaved standards
    send two fields, the second's broad pulses starting mid-line)."""
    std, spl, vis = cfg.std, cfg.samples_per_line, cfg.visible_lines
    hs = max(2, int(0.073 * spl))

    def make_line(content, broad=False, half=False):
        line = np.full(spl, 0.35, np.float32)
        if broad:
            line[:] = 0.4
            if half:
                line[spl // 2:] = 0.0
                line[:int(0.2 * spl)] = 0.0
            else:
                line[:int(0.7 * spl)] = 0.0
            line[spl // 2 - 6:spl // 2] = 1.0
            return line
        line[:hs] = 0.0
        line[hs:] = content
        line[-6:] = 1.0
        return line

    lines = []
    if cfg.standard == "hskip":
        for f in range(n_frames):
            nos = np.full(spl, 0.5, np.float32)
            nos[-6:] = 1.0
            lines.append(nos)
            lines += [make_line(row_level(f, r)) for r in range(std.lines - 1)]
    elif std.interleaved:
        for f in range(n_frames):
            for half, rows in ((False, range(0, vis, 2)), (True, range(1, vis, 2))):
                lines += [make_line(0.0, broad=True, half=half)] * (std.black_lines // 2)
                lines += [make_line(row_level(f, r)) for r in rows]
    else:
        for f in range(n_frames):
            lines += [make_line(0.0, broad=True)] * std.black_lines
            lines += [make_line(row_level(f, r)) for r in range(vis)]
    return np.concatenate(lines)


@pytest.mark.parametrize("standard,lines_override", [
    ("shortinterleaved", 0), ("short", 0), ("hskip", 0), ("405", 91),
])
def test_frame_assembly_equals_jax(standard, lines_override):
    """The port's receiver feeds its lines to both FrameAssemblers: the
    same frames, report and field order, block by block; and the frames
    keep the rows in order (tests/test_atv.py:281's check)."""
    kw = dict(standard=standard)
    if lines_override:
        kw.update(lines=lines_override, fps=15625.0 / lines_override)
    cfg = patv.ATVConfig(channel_rate=15625.0 * 64, modulation="am", **kw)
    jcfg = jatv.ATVConfig(channel_rate=15625.0 * 64, modulation="am", **kw)
    vis = cfg.visible_lines
    video = _synth_standard(cfg, 4, lambda f, r: 0.3 + 0.6 * (r / max(vis - 1, 1)))
    iq = ((0.1 + 0.85 * video) * np.exp(2j * np.pi * 0.11 * np.arange(len(video)))).astype(
        np.complex64)
    block = cfg.samples_per_line * 32
    st = patv.make_state(cfg, CPU)
    pasm, jasm = pframe.FrameAssembler(cfg), jframe.FrameAssembler(jcfg)
    frames = []
    for b in range(len(iq) // block):
        st, outs = patv.process(st, t(iq[b * block:(b + 1) * block]), cfg)
        lines = n(outs.lines)
        got, want = pasm.feed(lines), jasm.feed(lines)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert pasm.report() == jasm.report()
        frames += got
    assert pasm.frames >= 2
    if standard != "hskip":
        levels = frames[-1][:, max(2, int(0.073 * 64)) + 4:-10].mean(axis=1)
        assert float(np.mean(np.diff(levels) > -0.01)) > 0.9
