"""The port's mesh gears (parallel/mesh.py, parallel/sharded.py,
parallel/hostfeed.py) on meshes of CPU shards against the JAX package's on
the same mesh of conftest's 8 virtual devices.

Sizes of tests/test_sharding.py: ÷8 at 12.288 MS/s, 2^15-sample blocks,
4–8 demods. The collectives alone equal JAX's ppermute, all_gather and
all_to_all inside shard_map exactly. Each gear runs 2 blocks on JAX, whose
state is handed to the port with `state_from_numpy`; both then run 3 more
blocks of the same input and every channel agrees to ≥ 80 dB in each block.
The port's 2×2 stays within 2e-5 of its 1×1, the build errors and the
replicated-analysis warning are JAX's, and the feeder's shards are JAX's
feeder's shard for shard.
"""

import logging
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sdrangel_tpu.dsp import spectrum as jspec
from sdrangel_tpu.io import sdriq as jsdriq
from sdrangel_tpu.parallel import sharded as jsh
from sdrangel_tpu.parallel.hostfeed import ShardedSdriqFeeder as JaxFeeder
from sdrangel_tpu_torch.dsp import spectrum as pspec
from sdrangel_tpu_torch.parallel import mesh as pmesh
from sdrangel_tpu_torch.parallel import sharded as psh
from sdrangel_tpu_torch.parallel.hostfeed import ShardedSdriqFeeder
from test_torch_sharded import _raw
from torch_port_util import CPU, agreement_db, n, stop_orphaned_jax_device_sets, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(2, 2), (4, 2)]
BASE = dict(log2_decim=3, block=1 << 15)
NFM = jsh.NFM_URI
AM = "sdrangel.channel.amdemod"
OPEN = {"squelch_db": -100.0, "squelch_gate_ms": 1.0}


@pytest.fixture(scope="module")
def devices():
    d = jax.devices()
    if len(d) < 8:
        pytest.skip("needs 8 virtual devices")
    return d


@pytest.fixture(autouse=True)
def _no_jax_worker_beside_the_mesh():
    stop_orphaned_jax_device_sets()


def _meshes(n_time, n_channel, devices):
    return (jsh.make_mesh(n_time, n_channel, devices),
            pmesh.make_mesh(n_time, n_channel, [CPU] * (n_time * n_channel)))


# -- the collectives alone ------------------------------------------------------------

def _jax_collective(name, mesh, x):
    both = ("time", "channel")
    n_time = mesh.shape["time"]
    fns = {
        "ring_shift": lambda v: jax.lax.ppermute(
            v, "time", [(i, (i + 1) % n_time) for i in range(n_time)]),
        "all_gather_time": lambda v: jax.lax.all_gather(v, "time", tiled=True),
        "all_gather": lambda v: jax.lax.all_gather(v, both, axis=0, tiled=True),
        "all_to_all": lambda v: jax.lax.all_to_all(v, both, split_axis=1, concat_axis=0,
                                                   tiled=True),
    }
    f = jax.shard_map(fns[name], mesh=mesh, in_specs=P(both), out_specs=P(both),
                      check_vma=False)
    return np.asarray(jax.jit(f)(x))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["ring_shift", "all_gather_time", "all_gather", "all_to_all"])
def test_collectives_equal_jax(devices, name, shape):
    """Each shard holds a distinct (16, 8) complex64 part (an (H, 2) int16
    part for the ring, as the cascade's halo travels); every shard's result
    equals JAX's bit for bit."""
    jmesh, mesh = _meshes(*shape, devices)
    rng = np.random.default_rng(3)
    rows = 16
    if name == "ring_shift":
        x = rng.integers(-32768, 32767, size=(mesh.size * rows, 2), dtype=np.int16)
    else:
        x = (rng.standard_normal((mesh.size * rows, 8))
             + 1j * rng.standard_normal((mesh.size * rows, 8))).astype(np.complex64)
    want = _jax_collective(name, jmesh, jnp.asarray(x))
    parts = {k: t(x[mesh.index(k) * rows:(mesh.index(k) + 1) * rows]) for k in mesh.local}
    got = getattr(mesh, name)(parts)
    size = want.shape[0] // mesh.size
    assert set(got) == set(mesh.coords)
    for k in mesh.coords:
        np.testing.assert_array_equal(n(got[k]), want[mesh.index(k) * size:(mesh.index(k) + 1)
                                                      * size], err_msg=str(k))


# -- every gear against JAX's same mesh -----------------------------------------------

SPACING = 12_288_000.0 / 8 / 8  # the PFB-8 grid at ÷8: 192 kHz
# one demod per grid channel, each shard's chunk out of order (a2a_placement)
A2A_OFFS = [(g if g < 4 else g - 8) * SPACING + 300.0 * g for g in (5, 1, 6, 2, 3, 0, 7, 4)]


def _gear(name):
    """(config kwargs, per-group offsets, the FM carrier Hz)."""
    nfm = jsh.BankGroup(NFM, 8, OPEN)
    gears = {
        "cen": (dict(BASE, n_channels=8), [[30_000.0] * 8], 30_000.0),
        # the inf/sup passband at ÷8 is centred on ∓fs/8
        "inf": (dict(BASE, n_channels=8, fc_pos="inf"), [[2_000.0] * 8],
                -1_536_000.0 + 2_000.0),
        "sup": (dict(BASE, n_channels=8, fc_pos="sup"), [[2_000.0] * 8],
                1_536_000.0 + 2_000.0),
        "pfb": (dict(BASE, n_channels=8, pfb_m=8),
                [[390_000.0, 391_440.0, -388_560.0, 385_680.0] * 2], 390_000.0),
        "a2a_local_idx": (dict(BASE, n_channels=8, pfb_m=8, pfb_all_to_all=True),
                          [A2A_OFFS], A2A_OFFS[0]),
        "a2a_identity": (dict(BASE, n_channels=8, pfb_m=8, pfb_all_to_all=True),
                         [[(g if g < 4 else g - 8) * SPACING + 300.0 for g in range(8)]],
                         SPACING + 300.0),
        "hetero": (dict(BASE, device_rate=768_000.0,
                        bank=(jsh.BankGroup(NFM, 4, OPEN),
                              jsh.BankGroup(AM, 4, {"squelch_db": -100.0}))),
                   [[30_000.0] * 4, [-40_000.0] * 4], 30_000.0),
        "chan_stages": (dict(BASE, bank=(nfm,), chan_stages=1), [[30_000.0] * 8], 30_000.0),
        "split_on": (dict(BASE, bank=(nfm,), time_axis_channels=True), [[30_000.0] * 8],
                     30_000.0),
        "split_off": (dict(BASE, bank=(nfm,), time_axis_channels=False),
                      [np.linspace(-30e3, 30e3, 8)], 30_000.0),
        "spectrum": (dict(BASE, n_channels=8, pfb_m=8), [[390_000.0] * 8], 390_000.0),
        "a2a_spectrum": (dict(BASE, n_channels=8, pfb_m=8, pfb_all_to_all=True),
                         [A2A_OFFS], A2A_OFFS[0]),
    }
    return gears[name]


def _port_cfg(n_time, n_channel, kw, spectrum):
    kw = dict(kw)
    if "bank" in kw:
        kw["bank"] = tuple(psh.BankGroup(g.uri, g.count, g.settings) for g in kw["bank"])
    return psh.ShardedPipelineConfig(
        n_time=n_time, n_channel=n_channel, **kw,
        spectrum=None if spectrum is None else pspec.SpectrumConfig(
            fft_size=spectrum.fft_size, averaging_mode=spectrum.averaging_mode))


def _args(name, jc, offs):
    """(JAX step args, port step args, per-group placement orders or None)."""
    single = len(jc.groups) == 1
    pack = (lambda xs: xs[0]) if single else tuple
    if jc.pfb_all_to_all:
        orders, local_idx, residuals = jsh.a2a_placement(jc, offs)
        if name == "a2a_identity":
            assert all(np.array_equal(o, np.arange(8)) for o in orders)
            return ((pack([jnp.asarray(r) for r in residuals]),),
                    (pack([t(r) for r in residuals]),), None)
        return ((pack([jnp.asarray(r) for r in residuals]),
                 pack([jnp.asarray(i) for i in local_idx])),
                (pack([t(r) for r in residuals]), pack([t(i) for i in local_idx])), orders)
    if jc.pfb_m:
        split = [jsh.grid_split(jc, np.asarray(o)) for o in offs]
        return ((pack([jnp.asarray(r) for _, r in split]),
                 pack([jnp.asarray(i) for i, _ in split])),
                (pack([t(r) for _, r in split]), pack([t(i) for i, _ in split])), None)
    res = [np.asarray(o, np.float32) for o in offs]
    return (pack([jnp.asarray(r) for r in res]),), (pack([t(r) for r in res]),), None


def _groups(audio, single):
    return [audio] if single else list(audio)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("gear", ["cen", "inf", "sup", "pfb", "a2a_local_idx", "a2a_identity",
                                  "hetero", "chan_stages", "split_on", "split_off",
                                  "spectrum", "a2a_spectrum"])
def test_gear_matches_jax_on_the_same_mesh(devices, gear, shape):
    kw, offs, carrier = _gear(gear)
    spectrum = (jspec.SpectrumConfig(fft_size=256, averaging_mode="none")
                if "spectrum" in gear else None)
    jc = jsh.ShardedPipelineConfig(n_time=shape[0], n_channel=shape[1], spectrum=spectrum, **kw)
    pc = _port_cfg(*shape, kw, spectrum)
    if gear == "split_on":
        assert pc.channel_split == jc.channel_split == pc.n_time * pc.n_channel
    if gear == "split_off":
        assert pc.channel_split == jc.channel_split == pc.n_channel
    assert pc.channel_split == jc.channel_split  # hetero: 4 of 8 shards on 4x2
    jmesh, mesh = _meshes(*shape, devices)
    jstep, jinit = jsh.build_sharded_step(jc, jmesh)
    pstep, _ = psh.build_sharded_step(pc, mesh)
    single = len(jc.groups) == 1
    raws = _raw(jc, 5, carrier)
    if gear == "hetero":  # an AM carrier (a 1 kHz tone at 80 %) for the AM group
        tt = np.arange(raws.size // 2) / jc.device_rate
        am = 0.3 * (1.0 + 0.8 * np.sin(2 * np.pi * 1000.0 * tt)) * np.exp(-2j * np.pi * 4e4 * tt)
        raws = np.clip(raws.reshape(-1, 2) + 32768.0 * np.stack([am.real, am.imag], -1),
                       -32768, 32767).astype(np.int16).reshape(raws.shape)
    jargs, pargs, _ = _args(gear, jc, offs)
    js, jcarry = jinit()
    for raw in raws[:2]:  # a state in mid-stream to start both from
        js, *_, jcarry = jstep(js, jnp.asarray(raw), jcarry, *jargs)[:3]
    ps, pcarry = psh.state_from_numpy(pc, jax.tree.map(np.asarray, js),
                                      jax.tree.map(np.asarray, jcarry), mesh)
    for b, raw in enumerate(raws[2:]):
        jout = jstep(js, jnp.asarray(raw), jcarry, *jargs)
        pout = pstep(ps, t(raw), pcarry, *pargs)
        (js, ja, jcarry), (ps, pa, pcarry) = jout[:3], pout[:3]
        for g, (jg, pg) in enumerate(zip(_groups(ja, single), _groups(pa, single))):
            jg = np.asarray(jg)
            assert pg.shape == jg.shape
            for c in range(jg.shape[0]):
                assert np.any(jg[c] != 0.0), f"block {b} group {g} channel {c}: silent"
                assert agreement_db(jg[c], n(pg[c])) >= 80.0, f"block {b} group {g} channel {c}"
        if spectrum is not None:
            jv = np.asarray(jout[3])
            live = jv > -80.0
            assert pout[3].shape == jv.shape == (256,) and live.sum() > 64
            np.testing.assert_allclose(n(pout[3])[live], jv[live], atol=1e-2)
    back, carry_np = psh.state_to_numpy(ps, pcarry)
    for a, b in zip(jax.tree.leaves(carry_np), jax.tree.leaves(jax.tree.map(np.asarray, jcarry))):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_two_by_two_matches_one_by_one():
    """The PFB gear on a 2×2 mesh of CPU shards equals the same gear on one
    shard to 2e-5 over 3 blocks (test_sharded_pfb_matches_single_device's
    bar), and so does the all-to-all gear against the all-gather gear."""
    kw = dict(BASE, n_channels=8, pfb_m=8)
    pc_m = psh.ShardedPipelineConfig(n_time=2, n_channel=2, **kw)
    pc_s = psh.ShardedPipelineConfig(n_time=1, n_channel=1, **kw)
    pc_a = psh.ShardedPipelineConfig(n_time=2, n_channel=2, pfb_all_to_all=True, **kw)
    mesh = pmesh.make_mesh(2, 2, [CPU] * 4)
    steps = [psh.build_sharded_step(pc_m, mesh), psh.build_sharded_step(pc_s, CPU),
             psh.build_sharded_step(pc_a, mesh)]
    orders, local_idx, residuals = jsh.a2a_placement(pc_a, [A2A_OFFS])
    idx, res = psh.grid_split(pc_m, np.asarray(A2A_OFFS))
    states = [init() for _, init in steps]
    for raw in _raw(pc_m, 3, A2A_OFFS[0]):
        outs = []
        for i, (step, _) in enumerate(steps):
            s, c = states[i]
            args = (t(residuals[0]), t(local_idx[0])) if i == 2 else (t(res), t(idx))
            s, a, c = step(s, t(raw), c, *args)
            states[i] = (s, c)
            outs.append(n(a))
        unperm = np.empty_like(outs[2])
        unperm[orders[0]] = outs[2]
        assert np.abs(outs[0]).max() > 0.01
        np.testing.assert_allclose(outs[0], outs[1], atol=2e-5)
        np.testing.assert_allclose(unperm, outs[0], atol=2e-5)


# -- the build's errors and the degraded analysis ------------------------------------

ERRORS = {
    "too_few_devices": "need 4 devices, have 1",
    "a2a_without_pfb": "pfb_all_to_all requires pfb_m",
    "a2a_count": "multiple of n_time",
    "a2a_pfb_m": "must divide over the mesh",
    "a2a_spectrum": "multiple of the display fft",
    "unknown_kind": "unknown channel kind",
    "data_kind": "supports audio kinds",
    "channel_axis": "multiple of the channel mesh axis",
    "time_axis_channels": "time_axis_channels needs group counts",
}


def _error_case(case, sh, make_mesh, devices, spectrum_cls):
    kw = dict(n_time=2, n_channel=2)
    mesh = (lambda: make_mesh(2, 2, devices[:1])) if case == "too_few_devices" \
        else (lambda: make_mesh(2, 2, devices))
    cfg = {
        "too_few_devices": dict(n_channels=8),
        "a2a_without_pfb": dict(n_channels=8, pfb_all_to_all=True),
        "a2a_count": dict(pfb_m=8, pfb_all_to_all=True, bank=(sh.BankGroup(NFM, 3),)),
        "a2a_pfb_m": dict(pfb_m=6, n_channels=8, pfb_all_to_all=True),
        "a2a_spectrum": dict(log2_decim=3, block=1 << 15, pfb_m=8, n_channels=8,
                             pfb_all_to_all=True,
                             spectrum=spectrum_cls(fft_size=4096, averaging_mode="none")),
        "unknown_kind": dict(bank=(sh.BankGroup("sdrangel.channel.nope", 2),)),
        "data_kind": dict(bank=(sh.BankGroup("sdrangel.channel.chanalyzer", 2),)),
        "channel_axis": dict(bank=(sh.BankGroup(NFM, 3),)),
        "time_axis_channels": dict(bank=(sh.BankGroup(NFM, 6),), time_axis_channels=True),
    }[case]
    sh.build_sharded_step(sh.ShardedPipelineConfig(**kw, **cfg), mesh())


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_build_errors_are_jax(devices, case):
    with pytest.raises(ValueError, match=ERRORS[case]) as jerr:
        _error_case(case, jsh, jsh.make_mesh, devices, jspec.SpectrumConfig)
    with pytest.raises(ValueError, match=ERRORS[case]) as perr:
        _error_case(case, psh, pmesh.make_mesh, [CPU] * 4, pspec.SpectrumConfig)
    assert type(perr.value) is type(jerr.value)


def test_replicated_analysis_fallback_is_loud_as_jax(devices, caplog):
    """1028 frames a block do not split over 8 shards: both gears warn, flag
    `replicated_analysis`, and still agree block for block; 1024 frames
    stay frame-sharded."""
    kw = dict(log2_decim=3, n_channels=8, pfb_m=8, n_time=4, n_channel=2)
    jmesh, mesh = _meshes(4, 2, devices)
    ok_j, _ = jsh.build_sharded_step(jsh.ShardedPipelineConfig(block=1 << 16, **kw), jmesh)
    ok_p, _ = psh.build_sharded_step(psh.ShardedPipelineConfig(block=1 << 16, **kw), mesh)
    assert ok_j.replicated_analysis is ok_p.replicated_analysis is False
    jc = jsh.ShardedPipelineConfig(block=1028 * 8 << 3, **kw)
    pc = psh.ShardedPipelineConfig(block=1028 * 8 << 3, **kw)
    with caplog.at_level(logging.WARNING):
        jstep, jinit = jsh.build_sharded_step(jc, jmesh)
        pstep, pinit = psh.build_sharded_step(pc, mesh)
    assert jstep.replicated_analysis is pstep.replicated_analysis is True
    warned = [r.name for r in caplog.records if "DEGRADED to replicated analysis" in r.message]
    assert "sdrangel_tpu_torch.parallel.sharded" in warned
    assert "sdrangel_tpu.parallel.sharded" in warned
    idx, res = jsh.grid_split(jc, np.full(8, 390_000.0))
    (js, jcarry), (ps, pcarry) = jinit(), pinit()
    for raw in _raw(jc, 2, 390_000.0):
        js, ja, jcarry = jstep(js, jnp.asarray(raw), jcarry, jnp.asarray(res), jnp.asarray(idx))
        ps, pa, pcarry = pstep(ps, t(raw), pcarry, t(res), t(idx))
        ja = np.asarray(ja)
        assert min(agreement_db(ja[c], n(pa[c])) for c in range(8)) >= 80.0


# -- the feeder ----------------------------------------------------------------------

def test_feeder_shards_equal_jax_feeder(devices, tmp_path):
    """The port's feeder gives every shard of a 4×2 mesh the samples JAX's
    feeder gives the same shard, looping at EOF, and drives the gear to the
    audio of the whole block fed at once."""
    jmesh, mesh = _meshes(4, 2, devices)
    block = 1 << 15
    cfg = psh.ShardedPipelineConfig(n_time=4, n_channel=2, **BASE, n_channels=8)
    raw = _raw(cfg, 3, 20_000.0).reshape(-1, 2)
    path = str(tmp_path / "cap.sdriq")
    jsdriq.write(path, raw, sample_rate=int(cfg.device_rate))
    jfeed, pfeed = JaxFeeder(path, jmesh, block), ShardedSdriqFeeder(path, mesh, block)
    assert pfeed.n_blocks() == jfeed.n_blocks() == 3
    for b in (1, 3):  # block 3 lies past the end: both loop to the start
        jarr, parts = jfeed.block(b), pfeed.block(b)
        jshards = {s.device: s for s in jarr.addressable_shards}
        for k in mesh.coords:
            shard = jshards[jmesh.devices[k]]
            assert shard.index[0].start == k[0] * block // 4
            np.testing.assert_array_equal(n(parts[k]), np.asarray(shard.data))
    with pytest.raises(EOFError):
        ShardedSdriqFeeder(path, mesh, block, wrap=False).block(3)
    step, init_fn = psh.build_sharded_step(cfg, mesh)
    offs = t(np.full(8, 20_000.0, np.float32))
    (s1, c1), (s2, c2) = init_fn(), init_fn()
    for b in range(3):
        s1, fed, c1 = step(s1, pfeed.block(b), c1, offs)
        s2, whole, c2 = step(s2, t(raw[b * block:(b + 1) * block]), c2, offs)
        np.testing.assert_array_equal(n(fed), n(whole))


def test_rows_and_shards_of_a_mesh():
    """`step.rows` and the shard layout: each of four shards on one device
    runs its own cascade and holds its own bank chunk, as JAX's devices do,
    and a bank split over both axes comes back in row order."""
    mesh = pmesh.make_mesh(2, 2, [CPU] * 4)
    assert mesh.local == mesh.coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert mesh.shape == {"time": 2, "channel": 2} and mesh.home == CPU
    cfg = psh.ShardedPipelineConfig(n_time=2, n_channel=2, **BASE, n_channels=8)
    step, init_fn = psh.build_sharded_step(cfg, mesh)
    np.testing.assert_array_equal(step.rows[0], np.arange(8))
    calls = []
    real = psh._cascade_with_halo
    psh._cascade_with_halo = lambda *a: calls.append(a[0].shape) or real(*a)
    try:
        state, carry = init_fn()
        state, audio, carry = step(state, t(_raw(cfg, 1, 20_000.0)[0]), carry,
                                   t(np.full(8, 20_000.0, np.float32)))
    finally:
        psh._cascade_with_halo = real
    assert calls == [(cfg.block // 2, 2)] * 4  # one cascade per shard
    assert audio.shape == (8, 128) and carry.shape == (psh.halo_samples(3), 2)
    assert sorted(state.units) == list(enumerate(mesh.coords))


def test_init_distributed_without_a_card_raises(monkeypatch):
    """With no local devices named, a process takes the card LOCAL_RANK
    names; without a card that raises before any process group starts,
    as `resolve_device` does, and never falls back to CPU shards."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        pmesh.init_distributed(0, 1, "tcp://127.0.0.1:1")
    assert not dist.is_initialized() and pmesh.group_places() == []


_NO_JAX_MESH = textwrap.dedent("""
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
    from sdrangel_tpu_torch.io import sdriq
    from sdrangel_tpu_torch.parallel import hostfeed, mesh, sharded, worker

    m = mesh.make_mesh(2, 2, ["cpu"] * 4)
    cfg = sharded.ShardedPipelineConfig(n_time=2, n_channel=2, log2_decim=3,
                                        block=1 << 14, n_channels=4, pfb_m=8,
                                        pfb_all_to_all=True)
    sdriq.write(sys.argv[1], np.zeros((cfg.block, 2), np.int16), sample_rate=768000)
    feeder = hostfeed.ShardedSdriqFeeder(sys.argv[1], m, cfg.block)
    step, init_fn = sharded.build_sharded_step(cfg, m)
    state, carry = init_fn()
    idx = torch.tensor([0, 0, 0, 0], dtype=torch.int32)
    state, audio, carry = step(state, feeder.block(0), carry, torch.zeros(4), idx)
    assert audio.shape == (4, 64), audio.shape
    assert not any(k.split(".")[0] in ("jax", "sdrangel_tpu") for k in sys.modules)
    print("ok")
""")


def test_mesh_step_and_feeder_import_without_jax(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_MESH, str(tmp_path / "zero.sdriq")], cwd=REPO,
        capture_output=True, text=True, timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
