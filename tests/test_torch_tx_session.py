"""The port's Tx device set (`runtime/session.py TxDeviceSet`), its BlockFifo
and CW keyer, and the `mod` CLI, on the CPU: the ports of tests/test_fifo.py
and of the session cases of tests/test_tx.py, the set's recording held
sample for sample against `TxPipeline.run`, JAX Tx presets, and the CLI with
jax blocked.
"""

import os
import subprocess
import sys
import threading
import time
import wave

import numpy as np
import pytest

from sdrangel_tpu.channels import cwkeyer as jcw
from sdrangel_tpu_torch.channels import cwkeyer as pcw
from sdrangel_tpu_torch.io import sdriq
from sdrangel_tpu_torch.runtime import session as psession
from sdrangel_tpu_torch.runtime.engine import ChannelSpec, DeviceConfig, RxPipeline
from sdrangel_tpu_torch.runtime.fifo import BlockFifo
from sdrangel_tpu_torch.runtime.tx import TxChannelSpec, TxDeviceConfig, TxPipeline
from torch_port_util import CPU, tone_snr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NFM_MOD = "sdrangel.channeltx.modnfm"
SSB_MOD = "sdrangel.channeltx.modssb"


# -- BlockFifo (tests/test_fifo.py) -------------------------------------------


def test_fifo_order_and_close_drain():
    f = BlockFifo(depth=4)
    for i in range(3):
        assert f.put(np.full(4, i))
    f.close()
    got = []
    while (b := f.get()) is not None:
        got.append(int(b[0]))
    assert got == [0, 1, 2]
    assert f.get() is None  # stays closed
    assert not f.put(np.zeros(1))  # writes after close are refused


def test_fifo_backpressure_blocks_producer():
    f = BlockFifo(depth=2)
    assert f.put(0) and f.put(1)
    t0 = time.perf_counter()
    assert not f.put(2, timeout=0.1)  # full: blocks, then times out
    assert time.perf_counter() - t0 >= 0.1
    assert f.backpressure_waits == 1
    assert f.get() == 0
    assert f.put(2, timeout=0.1)  # space freed
    assert [f.get(), f.get()] == [1, 2]


def test_fifo_producer_consumer_threads():
    f = BlockFifo(depth=3)
    n_blocks = 200
    got = []

    def produce():
        for i in range(n_blocks):
            assert f.put(i)
        f.close()

    def consume():
        while (b := f.get(timeout=5.0)) is not None:
            got.append(b)
            time.sleep(0.0005)  # a slow consumer forces backpressure

    tp, tc = threading.Thread(target=produce), threading.Thread(target=consume)
    tc.start()
    tp.start()
    tp.join(10.0)
    tc.join(10.0)
    assert got == list(range(n_blocks))
    assert f.backpressure_waits > 0
    assert f.blocks_in == f.blocks_out == n_blocks


# -- the CW keyer --------------------------------------------------------------


@pytest.mark.parametrize("text,wpm", [("cq de k1abc", 20.0), ("e e", 30.0), ("sos 73", 12.0)])
def test_cw_keyer_equals_jax(text, wpm):
    cfg_p, cfg_j = pcw.CWConfig(wpm=wpm), jcw.CWConfig(wpm=wpm)
    assert pcw.text_to_schedule(text, cfg_p) == jcw.text_to_schedule(text, cfg_j)
    kp, kj = pcw.CWKeyer(text, cfg_p, loop=True), jcw.CWKeyer(text, cfg_j, loop=True)
    for count in (4096, 1000, 4096, 77, 4096):
        np.testing.assert_array_equal(kp.next_block(count), kj.next_block(count))


# -- the Tx device set -----------------------------------------------------------


def _run_tx(ds, n_blocks, deadline_s=120.0):
    """Start the set, stop it once n_blocks have been handed to the sink."""
    ds.start()
    t0 = time.time()
    while ds.blocks_processed < n_blocks:
        assert ds.running or not ds.error, ds.error
        assert time.time() - t0 < deadline_s, "Tx set too slow"
        time.sleep(0.01)
    ds.stop()
    assert not ds.running and not ds.error, ds.error


def _tx_set(tmp_path, sink, channels):
    s = psession.Session(device=CPU)
    ds = s.add_device_set("tx")
    assert ds.direction == "tx" and s.device_sets == [ds]
    ds.update_source({"file_path": str(tmp_path / "tx.sdriq"), **sink})
    for uri, settings in channels:
        ds.add_channel(uri, settings)
    return s, ds


def test_tx_set_records_what_tx_pipeline_makes(tmp_path):
    """The set's .sdriq holds TxPipeline.run's blocks sample for sample
    (NFM +20 kHz, 384 kS/s ×2 to a 768 kS/s DAC), runs past its first
    blocks until stopped, reports its realtimeFactor and stays idle with
    no error (the CPU form of chip_smoke.py phase 8e)."""
    s, ds = _tx_set(tmp_path, {"sample_rate": 768_000.0, "log2_interp": 1,
                               "center_frequency": 100e6},
                    [(NFM_MOD, {"inputFrequencyOffset": 20_000.0, "toneFrequency": 800.0})])
    _run_tx(ds, 5)
    n_blocks = ds.blocks_processed
    assert ds.realtime_factor > 0 and ds.elapsed_s > 0
    assert ds.channels[0].audio_samples == 4096 * n_blocks
    summary = s.summary()["devicesetlist"]["deviceSets"][0]
    assert summary["direction"] == "tx" and summary["state"] == "idle"
    assert summary["source"]["log2_interp"] == 1
    info, mm = sdriq.open_mmap(ds.sink.file_path)
    assert (info.sample_rate, info.center_frequency) == (768_000, 100_000_000)
    pipe = TxPipeline(TxDeviceConfig(768_000.0, 1), [TxChannelSpec(NFM_MOD, 20_000.0, {})],
                      device=CPU)
    assert info.n_samples == n_blocks * pipe.device_block

    def tone(b, c, count):
        tt = (b * count + np.arange(count)) / 48_000.0
        return np.sin(2 * np.pi * 800.0 * tt).astype(np.float32)

    want = np.concatenate(list(pipe.run(tone, n_blocks)))
    np.testing.assert_array_equal(np.asarray(mm), want)


def test_tx_set_runs_until_stopped(tmp_path):
    """The Tx worker has no block bound (the reference's sink engine runs
    until stopped; tests/test_tx.py:126-161): it passes 64 blocks and the
    capture grows while it runs."""
    _, ds = _tx_set(tmp_path, {"sample_rate": 48_000.0}, [(SSB_MOD, {})])
    ds.start()
    try:
        t0 = time.time()
        while ds.blocks_processed < 64:
            assert ds.running, ds.error
            assert time.time() - t0 < 120.0
            time.sleep(0.01)
        size_at_64 = os.path.getsize(ds.sink.file_path)
        while ds.blocks_processed < 72:
            assert ds.running, ds.error
            time.sleep(0.01)
        assert ds.running
    finally:
        ds.stop()
    assert not ds.error, ds.error
    assert os.path.getsize(ds.sink.file_path) > size_at_64


def test_tx_set_throttle_paces_real_time(tmp_path):
    """throttle: each 85.3 ms block of signal takes at least its own time."""
    _, ds = _tx_set(tmp_path, {"sample_rate": 48_000.0, "throttle": True}, [(SSB_MOD, {})])
    t0 = time.perf_counter()
    _run_tx(ds, 3)
    assert time.perf_counter() - t0 > 2 * 4096 / 48_000.0
    assert ds.realtime_factor < 1.2


def test_tx_session_cw_keyer_source(tmp_path):
    """tests/test_tx.py:164-201: cwText keys the channel's tone with the
    Morse envelope; the recorded baseband shows the dot timing."""
    _, ds = _tx_set(tmp_path, {"sample_rate": 48_000.0},
                    [(SSB_MOD, {"toneFrequency": 700.0, "cwText": "e e", "cwWpm": 30.0})])
    _run_tx(ds, 12)
    _, mm = sdriq.open_mmap(ds.sink.file_path)
    x = np.asarray(mm[:12 * 4096]).astype(np.float32) / 32768.0
    env = np.abs(x[:, 0] + 1j * x[:, 1])
    sm = np.convolve(env, np.ones(96) / 96, mode="same")  # ~2 ms
    on = sm > 0.5 * sm.max()
    edges = np.flatnonzero(np.diff(on.astype(np.int8)))
    assert len(edges) >= 4, "no keying transitions found"
    spans = np.diff(edges)
    dot = 1.2 / 30.0 * 48_000.0  # 40 ms at 30 wpm
    downs = [sp for i, sp in enumerate(spans) if on[edges[i] + 1]]
    assert any(abs(sp - dot) < 0.35 * dot for sp in downs), (downs, dot)


def test_tx_session_wav_file_source(tmp_path):
    """tests/test_tx.py:204-264: afFile feeds the channel from a looped
    48 kHz WAV; the port's Rx path demodulates the file's tone back."""
    tone = 800.0
    wav_path = str(tmp_path / "voice.wav")
    tt = np.arange(9600) / 48_000.0
    pcm = np.clip(np.sin(2 * np.pi * tone * tt) * 0.8 * 32768, -32768, 32767).astype(np.int16)
    with wave.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(48_000)
        w.writeframes(pcm.tobytes())
    _, ds = _tx_set(tmp_path, {"sample_rate": 192_000.0, "log2_interp": 2},
                    [(NFM_MOD, {"afFile": wav_path})])
    _run_tx(ds, 8)
    _, mm = sdriq.open_mmap(ds.sink.file_path)
    rx = RxPipeline(DeviceConfig(192_000.0, log2_decim=2), [ChannelSpec(
        "sdrangel.channel.nfmdemod", 0.0, {"squelch_db": -100.0, "squelch_gate_ms": 1.0})],
        CPU, block_size=1 << 14)
    raw = np.asarray(mm)
    audio = np.concatenate([o["channels"][0]["audio"] for _, o in rx.run(
        lambda b, count: raw[b * count:(b + 1) * count], 2)])
    assert tone_snr(audio[4096:].astype(np.float64), tone, 48_000.0) > 10.0


def test_tx_set_refusals(tmp_path):
    s = psession.Session(device=CPU)
    ds = s.add_device_set("tx")
    ds.start()  # no channels: the worker fails with a clear message
    t0 = time.time()
    while ds.running and time.time() - t0 < 30:
        time.sleep(0.01)
    assert "no channels" in ds.error
    ds.add_channel(NFM_MOD, {"audioFile": "ignored.wav"})  # a session key: harmless
    ds.start()  # no file_path
    while ds.running:
        time.sleep(0.01)
    assert "file_path" in ds.error
    with pytest.raises(KeyError):
        ds.add_channel("sdrangel.channel.nfmdemod")  # an Rx kind on a Tx set
    with pytest.raises(KeyError):
        s.add_device_set("rx").add_channel(NFM_MOD)  # and the other way round
    with pytest.raises(ValueError, match="unknown"):
        ds.add_channel(NFM_MOD, {"not_a_setting": 1})
    with pytest.raises(ValueError, match="unknown sink kind"):
        ds.update_source({"kind": "testsource"})
    ds.update_source({"daemon_fec": 8, "daemon_port": 9094})  # the daemonsink's fields
    assert ds.sink.daemon_fec == 8 and ds.sink.kind == "filesink"
    with pytest.raises(ValueError, match="direction"):
        s.add_device_set("both")


def test_jax_tx_presets_load(tmp_path):
    """A JAX preset with an Rx and a Tx set loads: the Tx set's sink fields
    at the daemonsink's defaults change nothing."""
    from sdrangel_tpu.runtime.session import Session as JaxSession

    js = JaxSession()
    js.add_device_set("rx").add_channel("sdrangel.channel.amdemod", {"volume": 2.0})
    jtx = js.add_device_set("tx")
    jtx.update_source({"sample_rate": 96_000.0, "log2_interp": 1})
    jtx.add_channel(NFM_MOD, {"inputFrequencyOffset": 12_000.0, "toneFrequency": 600.0,
                              "fm_deviation": 3000.0})
    s = psession.Session(device=CPU)
    s.presets["g/jax"] = js.save_preset("g", "jax")
    s.load_preset("g", "jax")
    rx, tx = s.device_sets
    assert (rx.direction, tx.direction) == ("rx", "tx")
    assert (tx.sink.sample_rate, tx.sink.log2_interp) == (96_000.0, 1)
    ch = tx.channels[0]
    assert (ch.uri, ch.frequency_offset) == (NFM_MOD, 12_000.0)
    assert ch.settings == {"toneFrequency": 600.0, "fm_deviation": 3000.0}
    saved = s.save_preset("g", "port")
    assert saved["deviceSets"][1]["direction"] == "tx"
    assert saved["deviceSets"][1]["source"]["log2_interp"] == 1


# -- the CLI ---------------------------------------------------------------------

_NO_JAX = """
import runpy, sys

class NoJax:
    # refuse jax and the JAX package (the port must need neither)
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sdrangel_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, NoJax())
sys.argv = ["sdrangel_tpu_torch"] + sys.argv[1:]
runpy.run_module("sdrangel_tpu_torch", run_name="__main__")
"""


def _mod_cli(tmp_path, device):
    return subprocess.run(
        [sys.executable, "-c", _NO_JAX, "mod", "--device", device, "--channel", "nfm:-30000",
         "--rate", "384000", "--tone", "1000", "--seconds", "1.0",
         "--out", str(tmp_path / "tx.sdriq")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})


def test_cli_mod_without_jax(tmp_path):
    proc = _mod_cli(tmp_path, "cpu")
    assert proc.returncode == 0, proc.stderr
    info, mm = sdriq.open_mmap(str(tmp_path / "tx.sdriq"))
    assert info.sample_rate == 384_000 and info.n_samples == 11 * 32_768
    rx = RxPipeline(DeviceConfig(384_000.0), [ChannelSpec(
        "sdrangel.channel.nfmdemod", -30_000.0, {"squelch_db": -60.0})], CPU, block_size=1 << 15)
    raw = np.asarray(mm)
    audio = np.concatenate([o["channels"][0]["audio"] for _, o in rx.run(
        lambda b, count: raw[b * count:(b + 1) * count], len(raw) // rx.device_block)])
    assert tone_snr(audio[len(audio) // 2:].astype(np.float64), 1000.0, 48_000.0) > 25.0


def test_cli_mod_cuda_fails_loudly_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the no-card refusal")
    proc = _mod_cli(tmp_path, "cuda")
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not (tmp_path / "tx.sdriq").exists()
