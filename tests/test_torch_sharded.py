"""The one-card channel-bank gear against the JAX gear on a 1×1 mesh.

Sizes of tests/test_sharding.py:410-440 (÷8, 2^15-sample blocks, PFB-4,
4 NFM demods) and a `pfb_m=0, chan_stages=1` bank. The JAX gear runs two
blocks first; its state, handed over with `state_from_numpy`, starts the
port, and both then run 3 more blocks of the same input. Every channel's
audio agrees to ≥ 80 dB with the JAX audio in every block. The input is an
FM carrier plus white noise, so each demod's squelch (−100 dB) is open.
A bank of an NFM group beside an AM group is held to the JAX gear the
same way.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrangel_tpu.dsp import spectrum as jspec
from sdrangel_tpu.io import testsource
from sdrangel_tpu.parallel import sharded as jsh
from sdrangel_tpu_torch.dsp import spectrum as pspec
from sdrangel_tpu_torch.parallel import sharded as psh
from torch_port_util import CPU, agreement_db, n, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(log2_decim=3, block=1 << 15, n_channels=4)
GEARS = {
    "pfb4": (dict(BASE, pfb_m=4), [390_000.0, 391_440.0, -388_560.0, 385_680.0]),
    "chan1": (dict(BASE, chan_stages=1), [30_000.0, 31_440.0, 25_680.0, 34_320.0]),
    "pfb4_inf": (dict(BASE, pfb_m=4, fc_pos="inf"), [390_000.0, 391_440.0, -388_560.0,
                                                     385_680.0]),
}


def _raw(cfg, n_blocks, carrier, seed=0):
    src = testsource.TestSourceConfig(
        sample_rate=cfg.device_rate, carrier_freq=carrier, modulation="fm",
        tone_freq=700.0, fm_deviation=4000.0, amplitude=0.4)
    iq = testsource.generate(src, cfg.block * n_blocks)
    rng = np.random.default_rng(seed)
    iq = iq + 0.01 * (rng.standard_normal(len(iq)) + 1j * rng.standard_normal(len(iq)))
    raw = np.empty((len(iq), 2), np.int16)
    raw[:, 0] = np.clip(iq.real * 32768, -32768, 32767)
    raw[:, 1] = np.clip(iq.imag * 32768, -32768, 32767)
    return raw.reshape(n_blocks, cfg.block, 2)


def _gears(kw, spectrum=None):
    jc = jsh.ShardedPipelineConfig(n_time=1, n_channel=1, spectrum=spectrum, **kw)
    pc = psh.ShardedPipelineConfig(
        n_time=1, n_channel=1, **kw,
        spectrum=None if spectrum is None else pspec.SpectrumConfig(
            fft_size=spectrum.fft_size, averaging_mode=spectrum.averaging_mode))
    jstep, jinit = jsh.build_sharded_step(jc, jsh.make_mesh(1, 1, jax.devices()[:1]))
    pstep, pinit = psh.build_sharded_step(pc, CPU)
    return jc, pc, (jstep, jinit), (pstep, pinit)


def _offsets(jc, offs):
    """(JAX extra step args, port extra step args) for the bank's offsets."""
    if jc.pfb_m:
        idx, res = jsh.grid_split(jc, np.asarray(offs))
        return (jnp.asarray(res), jnp.asarray(idx)), (t(res), t(idx))
    res = np.asarray(offs, np.float32)
    return (jnp.asarray(res),), (t(res),)


@pytest.mark.parametrize("gear", list(GEARS))
def test_gear_matches_jax_on_one_card(gear):
    kw, offs = GEARS[gear]
    jc, pc, (jstep, jinit), (pstep, pinit) = _gears(kw)
    carrier = offs[0] - (jc.device_rate / 4 if kw.get("fc_pos") == "inf" else 0.0)
    raws = _raw(jc, 5, carrier)
    jargs, pargs = _offsets(jc, offs)
    js, jcarry = jinit()
    for raw in raws[:2]:  # a non-zero state to start both from
        js, _, jcarry = jstep(js, jnp.asarray(raw), jcarry, *jargs)
    ps, pcarry = psh.state_from_numpy(pc, jax.tree.map(np.asarray, js), np.asarray(jcarry), CPU)
    assert pcarry.dtype == torch.int16
    for raw in raws[2:]:
        js, ja, jcarry = jstep(js, jnp.asarray(raw), jcarry, *jargs)
        ps, pa, pcarry = pstep(ps, t(raw), pcarry, *pargs)
        ja = np.asarray(ja)
        assert pa.shape == ja.shape == (4, 128)
        for c in range(4):
            assert np.any(ja[c] != 0.0), f"channel {c}: squelch never opened"
            assert agreement_db(ja[c], n(pa[c])) >= 80.0, f"channel {c}"
    # the state maps back onto the JAX state
    back, carry_np = psh.state_to_numpy(ps, pcarry)
    np.testing.assert_array_equal(carry_np, np.asarray(jcarry))
    jtree = jax.tree.map(np.asarray, js)
    groups_p, groups_j = (back[0], jtree[0]) if jc.pfb_m else (back, jtree)
    np.testing.assert_array_equal(groups_p[0][1].nco.phase, groups_j[0][1].nco.phase)
    np.testing.assert_array_equal(groups_p[0][1].squelch.count, groups_j[0][1].squelch.count)


def test_am_group_beside_nfm_group_matches_jax():
    """A bank of two groups, 2 NFM and 2 AM demods (chan_stages=1, 2^17
    blocks, so each AM squelch gate opens within the run), against the JAX
    gear with the same groups: state handed over after 2 blocks, then every
    channel ≥ 80 dB in each of 3 blocks."""
    groups = (("sdrangel.channel.nfmdemod", {"squelch_db": -100.0, "squelch_gate_ms": 1.0}),
              ("sdrangel.channel.amdemod", {"squelch_db": -100.0}))
    kw = dict(BASE, block=1 << 17, chan_stages=1)
    kw.pop("n_channels")
    jc = jsh.ShardedPipelineConfig(n_time=1, n_channel=1, **kw, bank=tuple(
        jsh.BankGroup(u, 2, s) for u, s in groups))
    pc = psh.ShardedPipelineConfig(n_time=1, n_channel=1, **kw, bank=tuple(
        psh.BankGroup(u, 2, s) for u, s in groups))
    jstep, jinit = jsh.build_sharded_step(jc, jsh.make_mesh(1, 1, jax.devices()[:1]))
    pstep, _ = psh.build_sharded_step(pc, CPU)
    nfm_offs = np.asarray([30_000.0, 31_440.0], np.float32)
    am_offs = np.asarray([-40_000.0, -41_440.0], np.float32)
    fm = _raw(jc, 5, 30_000.0).astype(np.float64)
    tt = np.arange(5 * jc.block) / jc.device_rate
    am = 0.3 * (1.0 + 0.8 * np.sin(2 * np.pi * 1000.0 * tt)) * np.exp(-2j * np.pi * 40_000.0 * tt)
    raws = np.clip(fm.reshape(-1, 2) + 32768.0 * np.stack([am.real, am.imag], -1),
                   -32768, 32767).astype(np.int16).reshape(5, jc.block, 2)
    js, jcarry = jinit()
    jargs = (jnp.asarray(nfm_offs), jnp.asarray(am_offs))
    for raw in raws[:2]:
        js, _, jcarry = jstep(js, jnp.asarray(raw), jcarry, jargs)
    ps, pcarry = psh.state_from_numpy(pc, jax.tree.map(np.asarray, js), np.asarray(jcarry), CPU)
    for raw in raws[2:]:
        js, ja, jcarry = jstep(js, jnp.asarray(raw), jcarry, jargs)
        ps, pa, pcarry = pstep(ps, t(raw), pcarry, (t(nfm_offs), t(am_offs)))
        for g in range(2):
            jg = np.asarray(ja[g])
            assert pa[g].shape == jg.shape == (2, 512)
            for c in range(2):
                assert np.any(jg[c] != 0.0), f"group {g} channel {c}: silent"
                assert agreement_db(jg[c], n(pa[g][c])) >= 80.0, f"group {g} channel {c}"


def test_spectrum_tap_matches_jax():
    scfg = jspec.SpectrumConfig(fft_size=256, averaging_mode="moving")
    kw, offs = GEARS["pfb4"]
    jc, pc, (jstep, jinit), (pstep, pinit) = _gears(kw, spectrum=scfg)
    raws = _raw(jc, 2, offs[0], seed=1)
    jargs, pargs = _offsets(jc, offs)
    (js, jcarry), (ps, pcarry) = jinit(), pinit()
    for raw in raws:
        js, ja, jcarry, jv = jstep(js, jnp.asarray(raw), jcarry, *jargs)
        ps, pa, pcarry, pv = pstep(ps, t(raw), pcarry, *pargs)
        jv = np.asarray(jv)
        assert pv.shape == jv.shape == (256,)
        # the two decimators' basebands differ by ~1e-7, which moves a bin
        # at −90 dB by ~1e-2 dB: compare the bins above −80 dB
        live = jv > -80.0
        assert live.sum() > 128
        np.testing.assert_allclose(n(pv)[live], jv[live], atol=1e-2)


def test_helpers_match_jax():
    for k in range(7):
        assert psh.halo_samples(k) == jsh.halo_samples(k)
    kw, offs = GEARS["pfb4"]
    jc = jsh.ShardedPipelineConfig(n_time=1, n_channel=1, **kw)
    pc = psh.ShardedPipelineConfig(n_time=1, n_channel=1, **kw)
    bench = [(k % 4 - 1.5) * 96_000.0 + (-4320.0, -1440.0, 1440.0, 4320.0)[k // 4]
             for k in range(16)]  # bench.py:185-192's 16 demods
    for o in (offs, bench):
        for a, b in zip(psh.grid_split(pc, o), jsh.grid_split(jc, o)):
            np.testing.assert_array_equal(a, b)
    assert pc.demod_cfg.block_in == jc.demod_cfg.block_in == 1024
    assert pc.demod_cfg.channel_rate == jc.demod_cfg.channel_rate


def test_what_one_card_does_not_run_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        psh.build_sharded_step(psh.ShardedPipelineConfig(n_time=2, n_channel=1, **BASE), CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        psh.build_sharded_step(psh.ShardedPipelineConfig(
            n_time=1, n_channel=1, pfb_all_to_all=True, pfb_m=4, **BASE), CPU)
    with pytest.raises(ValueError, match="unknown channel kind"):
        psh.build_sharded_step(psh.ShardedPipelineConfig(
            n_time=1, n_channel=1, bank=(psh.BankGroup("sdrangel.channel.nope", 2),)), CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            psh.build_sharded_step(psh.ShardedPipelineConfig(n_time=1, n_channel=1, **BASE))


_NO_JAX_GEAR = textwrap.dedent("""
    import sys

    class NoJax:
        # refuse jax and the JAX package (the port must need neither)
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "sdrangel_tpu"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, NoJax())
    import numpy as np
    import torch
    from sdrangel_tpu_torch.kernels import decimator
    from sdrangel_tpu_torch.parallel import sharded

    cfg = sharded.ShardedPipelineConfig(n_time=1, n_channel=1, log2_decim=3,
                                        block=1 << 14, n_channels=2, pfb_m=4)
    step, init_fn = sharded.build_sharded_step(cfg, "cpu")
    state, carry = init_fn()
    raw = torch.zeros((cfg.block, 2), dtype=torch.int16)
    state, audio, carry = step(state, raw, carry, torch.zeros(2), torch.tensor([0, 1]))
    assert audio.shape == (2, 64)
    y = decimator.decimate_cascade_fused_mxu(
        torch.zeros((decimator.HALO + 1024, 2), dtype=torch.int16), 6)
    assert y.shape == (2, 16)
    assert not any(m.split(".")[0] in ("jax", "sdrangel_tpu") for m in sys.modules)
    print("ok")
""")


def test_gear_and_kernel_decimators_import_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_GEAR], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
