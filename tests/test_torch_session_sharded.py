"""The port's sharded session worker against the JAX session's, the cases of
tests/test_session_sharded.py on a 4×2 mesh (the port's every shard on the
CPU, JAX's on conftest's 8 virtual devices).

Each case first runs the same device set on both sessions for `run_blocks`
blocks of the same capture or test source and holds the port's published
audio (and spectrum) to JAX's: ≥ 80 dB per channel. The live behaviours
JAX's test checks (a retune mid-run, the all-to-all gear's fallback after an
unbalanceable retune) then run on the port's session as they run on JAX's.
"""

import time

import numpy as np
import pytest
import torch

from sdrangel_tpu.runtime.session import Session as JaxSession
from sdrangel_tpu_torch.io import sdriq, testsource
from sdrangel_tpu_torch.parallel import mesh as pmesh
from sdrangel_tpu_torch.parallel import sharded
from sdrangel_tpu_torch.parallel.hostfeed import ShardedSdriqFeeder
from sdrangel_tpu_torch.runtime.session import Session
from torch_port_util import CPU, agreement_db, n, stop_orphaned_jax_device_sets, tone_snr

NFM = "sdrangel.channel.nfmdemod"
MESH = {"sharded": True, "mesh_time": 4, "mesh_channel": 2, "sharded_block": 1 << 15}
FM_SOURCE = {"kind": "testsource", "sample_rate": 768_000.0, "log2_decim": 3,
             "modulation": "fm", "tone_freq": 1000.0, **MESH}
#: 8 channels, one per grid slot of PFB-8 at 96 kHz (12 kHz apart), channel 2
#: on the carrier's slot at +26 kHz: one demod per shard of the a2a gear
A2A_OFFSETS = [(g if g <= 4 else g - 8) * 12_000.0 + (2_000.0 if g == 2 else 500.0)
               for g in range(8)]


@pytest.fixture(autouse=True)
def _no_jax_worker_beside_the_mesh():
    stop_orphaned_jax_device_sets()


def _set(session, source: dict, channels: list):
    ds = session.add_device_set()
    ds.update_source(source)
    for off, st in channels:
        ds.add_channel(NFM, {"inputFrequencyOffset": off, **st})
    return ds


def _run(session, source: dict, channels: list, n_blocks: int, timeout: float = 120.0):
    """The set played for n_blocks (run_blocks) to its end."""
    ds = _set(session, {**source, "run_blocks": n_blocks}, channels)
    ds.start()
    t0 = time.time()
    while ds.running:
        assert time.time() - t0 < timeout, f"{ds.blocks_processed}/{n_blocks} blocks"
        time.sleep(0.02)
    ds.stop()
    return ds


def _both(source: dict, channels: list, n_blocks: int):
    """(port set, JAX set) after the same run."""
    port = _run(Session(device=CPU), source, channels, n_blocks)
    jax_ = _run(JaxSession(), source, channels, n_blocks)
    assert not port.error and not jax_.error, (port.error, jax_.error)
    assert port.blocks_processed == jax_.blocks_processed == n_blocks
    return port, jax_


def _agree(port, jax_, n_channels: int, audible: tuple = ()) -> None:
    for c in range(n_channels):
        want, got = jax_.drain_audio(c), port.drain_audio(c)
        assert got.shape == want.shape and want.size > 0, c
        if c in audible:
            assert np.abs(want).max() > 0.05, f"channel {c} silent"
        if np.any(want != 0.0):
            assert agreement_db(want, got) >= 80.0, f"channel {c}"
        else:
            assert np.abs(got).max() < 1e-6, f"channel {c}"


def _wait_blocks(ds, count, timeout=120.0):
    t0 = time.time()
    while ds.blocks_processed < count:
        assert not ds.error, ds.error
        assert time.time() - t0 < timeout, f"only {ds.blocks_processed}/{count} blocks"
        time.sleep(0.02)


def _drain_at_least(ds, c, count, timeout=60.0):
    parts, t0 = [], time.time()
    while sum(a.size for a in parts) < count and time.time() - t0 < timeout:
        a = ds.drain_audio(c)
        if a.size:
            parts.append(a)
        time.sleep(0.02)
    return np.concatenate(parts) if parts else np.zeros(0, np.float32)


def _retune_silences(ds, on_tune, new_offset):
    for c in range(len(ds.channels)):
        ds.update_channel(c, {"inputFrequencyOffset": new_offset})
    _wait_blocks(ds, ds.blocks_processed + 3)
    ds.drain_audio(0)  # the blocks from before and during the retune
    off_tune = np.abs(_drain_at_least(ds, 0, 2048))
    assert off_tune.size >= 2048
    assert np.sqrt((off_tune ** 2).mean()) < 0.5 * np.sqrt((on_tune ** 2).mean())


def test_session_sharded_filesource_matches_direct(tmp_path):
    """A sharded filesource set publishes the direct step's audio (the same
    mesh, bank and feeder) and the JAX session's."""
    rate, block, n_blocks = 768_000.0, 1 << 15, 3
    src = testsource.TestSourceConfig(sample_rate=rate, carrier_freq=20_000.0,
                                      modulation="fm", tone_freq=900.0, fm_deviation=5000.0,
                                      amplitude=0.4)
    cap = str(tmp_path / "cap.sdriq")
    sdriq.write(cap, testsource.to_iq_int16(testsource.generate(src, block * n_blocks)),
                sample_rate=int(rate))
    source = {"kind": "filesource", "file_path": cap, "log2_decim": 3, **MESH}
    channels = [(20_000.0, {"squelch_db": -100.0, "squelch_gate_ms": 1.0})] * 8
    port, jax_ = _both(source, channels, n_blocks)
    assert port.realtime_factor > 0
    got = [port.drain_audio(c) for c in range(8)]
    cfg = sharded.ShardedPipelineConfig(
        n_time=4, n_channel=2, log2_decim=3, block=block, device_rate=rate,
        bank=(sharded.BankGroup(NFM, 8, {"squelch_db": -100.0, "squelch_gate_ms": 1.0}),))
    mesh = pmesh.make_mesh(4, 2, [CPU] * 8)
    step, init_fn = sharded.build_sharded_step(cfg, mesh)
    state, carry = init_fn()
    feeder = ShardedSdriqFeeder(cap, mesh, block)
    ref = []
    for b in range(n_blocks):
        state, audio, carry = step(state, feeder.block(b), carry, torch.full((8,), 20_000.0))
        ref.append(n(audio))
    ref = np.concatenate(ref, axis=-1)
    assert np.abs(ref).max() > 0.01
    for c in range(8):
        np.testing.assert_allclose(got[c], ref[c], atol=1e-6)
        assert agreement_db(jax_.drain_audio(c), got[c]) >= 80.0


def test_session_sharded_testsource_and_live_offset():
    """A sharded test source set agrees with JAX's; a retune off the carrier
    mid-run (a per-block argument) quietens it without a stop."""
    source = {**FM_SOURCE, "carrier_freq": 20_000.0}
    channels = [(20_000.0, {"squelch_db": -30.0, "squelch_gate_ms": 1.0})] * 8
    _agree(*_both(source, channels, 2), 8, audible=(0,))
    ds = _set(Session(device=CPU), source, channels)
    ds.start()
    try:
        _wait_blocks(ds, 2)
        on_tune = np.abs(ds.drain_audio(0))
        assert on_tune.max() > 0.05
        _retune_silences(ds, on_tune, -40_000.0)  # the carrier at +60 kHz ≡ −36 kHz
    finally:
        ds.stop()
    assert not ds.error, ds.error


def test_session_sharded_rejects_data_kinds():
    source = {"kind": "testsource", "log2_decim": 3, **MESH}
    errors = []
    for session in (Session(device=CPU), JaxSession()):
        ds = session.add_device_set()
        ds.update_source(source)
        ds.add_channel("sdrangel.channel.chanalyzer", {})
        ds.start()
        t0 = time.time()
        while not ds.error and time.time() - t0 < 30:
            time.sleep(0.02)
        ds.stop()
        errors.append(ds.error)
    assert all("audio channel kinds" in e for e in errors), errors


def test_session_sharded_spectrum_tap():
    """The spectrum and waterfall fill while a sharded set runs, as JAX's
    do, and the pure carrier at +20 kHz is the peak."""
    source = {**FM_SOURCE, "carrier_freq": 20_000.0, "modulation": "none",
              "spectrum_fft_size": 512}
    port, jax_ = _both(source, [(20_000.0, {"squelch_db": -30.0})] * 8, 3)
    assert port.spectrum is not None and len(port.spectrum) == 512
    assert len(port.waterfall) == len(jax_.waterfall) == 3
    live = jax_.spectrum > -80.0
    np.testing.assert_allclose(port.spectrum[live], jax_.spectrum[live], atol=1e-2)
    peak = int(np.argmax(port.spectrum))
    assert abs(peak - (256 + round(20_000.0 / 96_000.0 * 512))) <= 6


def test_session_sharded_pfb_gear():
    """sharded_pfb_m: the grid channel and its residual, as JAX's; a retune
    to another grid channel applies without a stop."""
    source = {**FM_SOURCE, "carrier_freq": 26_000.0, "sharded_pfb_m": 4}
    channels = [(26_000.0, {"squelch_db": -30.0, "squelch_gate_ms": 1.0})] * 8
    _agree(*_both(source, channels, 2), 8, audible=(0,))
    ds = _set(Session(device=CPU), source, channels)
    ds.start()
    try:
        _wait_blocks(ds, 2)
        on_tune = np.abs(ds.drain_audio(0))
        assert on_tune.max() > 0.05
        _retune_silences(ds, on_tune, -24_000.0)  # grid −1: no carrier there
    finally:
        ds.stop()
    assert not ds.error, ds.error


def test_session_sharded_a2a_gear():
    """sharded_pfb_a2a: channels placed by grid chunk and un-permuted before
    publishing, as JAX's; channel 2 on the carrier's slot hears the tone, a
    quiet slot's squelch is shut, and the spectrum tap is live."""
    source = {**FM_SOURCE, "carrier_freq": 26_000.0, "sharded_pfb_m": 8,
              "sharded_pfb_a2a": True}
    channels = [(off, {"squelch_db": -40.0, "squelch_gate_ms": 1.0}) for off in A2A_OFFSETS]
    port, jax_ = _both(source, channels, 3)
    assert not port.a2a_fallback and not jax_.a2a_fallback
    np.testing.assert_allclose(port.spectrum[jax_.spectrum > -80.0],
                               jax_.spectrum[jax_.spectrum > -80.0], atol=1e-2)
    fr = (np.arange(1024) / 1024.0 - 0.5) * 96_000.0
    assert abs(fr[int(np.argmax(port.spectrum))] - 26_000.0) <= 5_000.0
    audio, quiet = port.channels[2].audio[:], port.channels[5].audio[:]
    _agree(port, jax_, 8, audible=(2,))
    audio = np.concatenate(audio)
    assert tone_snr(audio, 1000.0, 48_000.0) > 10.0
    assert np.abs(np.concatenate(quiet)).max() < 0.05


def test_session_a2a_unbalanceable_retune_falls_back():
    """Two demods on one grid chunk cannot be placed: both sessions run the
    all-gather gear and report a2aFallback. Live on the port: a balanced
    start, a retune that unbalances it (audio keeps flowing, the flag set),
    a static change that clears it."""
    source = {**FM_SOURCE, "carrier_freq": 26_000.0, "sharded_pfb_m": 8,
              "sharded_pfb_a2a": True}
    unbalanced = list(A2A_OFFSETS)
    unbalanced[5] = 2 * 12_000.0 + 500.0  # channel 5 onto channel 2's slot
    settings = {"squelch_db": -40.0, "squelch_gate_ms": 1.0}
    port, jax_ = _both(source, [(off, settings) for off in unbalanced], 3)
    assert port.a2a_fallback and jax_.a2a_fallback
    assert Session._device_set_summary(port)["a2aFallback"] is True
    for c in (2, 5):
        assert agreement_db(jax_.drain_audio(c), port.drain_audio(c)) >= 80.0

    ds = _set(Session(device=CPU), source, [(off, settings) for off in A2A_OFFSETS])
    ds.start()
    try:
        _wait_blocks(ds, 2)
        assert ds.a2a_fallback is False
        ds.update_channel(5, {"inputFrequencyOffset": unbalanced[5]})
        _wait_blocks(ds, ds.blocks_processed + 3)
        assert ds.a2a_fallback is True
        audio = _drain_at_least(ds, 2, 4096)
        assert tone_snr(audio, 1000.0, 48_000.0) > 10.0
        ds.update_channel(5, {"inputFrequencyOffset": A2A_OFFSETS[5]})
        for c in range(8):
            ds.update_channel(c, {"af_bandwidth": 2990.0})
        _wait_blocks(ds, ds.blocks_processed + 2)
        assert ds.a2a_fallback is False
    finally:
        ds.stop()
    assert not ds.error, ds.error
