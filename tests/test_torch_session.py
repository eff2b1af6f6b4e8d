"""The port's Rx session (`sdrangel_tpu_torch/runtime/session.py`) against the
JAX session, and the parts of it the JAX package lacks.

- Session against session: one .sdriq capture (768 kS/s, ÷8, an NFM and an
  AM channel, 4 blocks) through the port's DeviceSet on the CPU and the JAX
  DeviceSet: audio ≥ 80 dB, channel power within rtol 1e-5, the spectrum by
  f32 rounding relative to its peak (the bounds of
  `test_torch_engine._compare_outs`), the same squelch state and block count.
- Preload: the capture uploaded once and sliced equals the streaming reader
  bit for bit, for 16- and 24-bit .sdriq and a raw cu8 capture; the size
  guard refuses an oversize capture.
- Packed outputs: integer leaves come back exactly, above 2^24 too, where
  the JAX engine's unpack_outs rounds them.
- The two repairs: the read-back stays one block behind at publish_every=1,
  and a generation bump publishes the pending burst (only the part of a
  removed channel is dropped).
- The sharded source's settings, and the requests that named UDP/RTP or
  the reference presets while they were left out, answer as the JAX
  session does. The kernel build runs nvcc once
  for many threads.
"""

import ctypes
import os
import pathlib
import subprocess
import sys
import textwrap
import threading
import time
import wave

import numpy as np
import pytest
import torch

from sdrangel_tpu_torch.io import sdriq, testsource
from sdrangel_tpu_torch.kernels import build
from sdrangel_tpu_torch.runtime import engine as peng
from sdrangel_tpu_torch.runtime import session as psession
from test_torch_engine import _compare_spectrum
from torch_port_util import CPU, agreement_db

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE = 768_000.0
NFM = "sdrangel.channel.nfmdemod"
AM = "sdrangel.channel.amdemod"


def _capture(path, n, sample_size=16, carriers=((20_000.0, "fm"),)):
    """A .sdriq capture of FM/AM carriers (1 kHz tones) at RATE."""
    iq = sum(testsource.generate(testsource.TestSourceConfig(
        sample_rate=RATE, carrier_freq=f, modulation=mod, tone_freq=1000.0,
        fm_deviation=5000.0, amplitude=0.3), n) for f, mod in carriers)
    sdriq.write(path, iq, sample_rate=int(RATE), sample_size=sample_size, timestamp=0)
    return path


def _run(ds, deadline_s=120.0):
    ds.start()
    t0 = time.time()
    while ds.running and time.time() - t0 < deadline_s:
        time.sleep(0.02)
    ds.stop()
    assert not ds.error, ds.error


def _port_set(source, channels):
    ds = psession.DeviceSet(0, CPU)
    ds.update_source(source)
    for uri, settings in channels:
        ds.add_channel(uri, settings)
    return ds


def test_session_matches_jax_session(tmp_path):
    from sdrangel_tpu.runtime.session import DeviceSet as JaxDeviceSet

    path = _capture(str(tmp_path / "cap.sdriq"), 1 << 20,
                    carriers=((20_000.0, "fm"), (-15_000.0, "am")))
    source = {"kind": "filesource", "file_path": path, "log2_decim": 3, "run_blocks": 4}
    channels = [(NFM, {"inputFrequencyOffset": 20_000.0, "squelch_db": -60.0}),
                (AM, {"inputFrequencyOffset": -15_000.0, "squelch_db": -60.0})]
    port = _port_set(source, channels)
    jax_ds = JaxDeviceSet(0)
    jax_ds.update_source(source)
    for uri, settings in channels:
        jax_ds.add_channel(uri, dict(settings))
    _run(port)
    _run(jax_ds)
    assert port.blocks_processed == jax_ds.blocks_processed == 4
    for i in range(2):
        ja, pa = jax_ds.drain_audio(i), port.drain_audio(i)
        assert ja.shape == pa.shape and np.any(ja != 0.0)
        assert agreement_db(ja, pa) >= 80.0, (i, agreement_db(ja, pa))
        jc, pc = jax_ds.channels[i], port.channels[i]
        np.testing.assert_allclose(pc.channel_power_db, jc.channel_power_db, rtol=1e-5)
        assert pc.squelch == jc.squelch
        assert pc.audio_samples == jc.audio_samples
    _compare_spectrum(jax_ds.spectrum, port.spectrum)


def _preload_pair(path, source, channel_offset):
    audio = {}
    for preload in (False, True):
        ds = _port_set({**source, "kind": "filesource", "file_path": path,
                        "file_preload": preload},
                       [(NFM, {"inputFrequencyOffset": channel_offset, "squelch_db": -100.0})])
        _run(ds)
        assert ds.blocks_processed == source["run_blocks"]
        audio[preload] = ds.drain_audio(0)
    assert audio[False].size and np.any(audio[False] != 0.0)
    np.testing.assert_array_equal(audio[False], audio[True])


@pytest.mark.parametrize("fmt", ["sdriq16", "sdriq24"])
def test_preload_equals_streaming(tmp_path, fmt):
    """A capture shorter than the run, so the reads wrap at its end."""
    path = _capture(str(tmp_path / "cap.sdriq"), 3 << 17,
                    sample_size=16 if fmt == "sdriq16" else 24)
    _preload_pair(path, {"log2_decim": 2, "run_blocks": 5, "publish_every": 2}, 20_000.0)


def test_preload_equals_streaming_cu8(tmp_path):
    c = testsource.generate(testsource.TestSourceConfig(
        sample_rate=RATE, carrier_freq=20_000.0, modulation="fm", amplitude=0.5), 1 << 19)
    u8 = np.empty((len(c), 2), np.uint8)
    u8[:, 0] = np.clip(c.real * 128.0 + 127.4, 0, 255)
    u8[:, 1] = np.clip(c.imag * 128.0 + 127.4, 0, 255)
    path = str(tmp_path / "cap.cu8")
    u8.tofile(path)
    _preload_pair(path, {"sample_rate": RATE, "log2_decim": 2, "run_blocks": 3}, 20_000.0)


def test_preload_size_guard(tmp_path):
    path = str(tmp_path / "cap.sdriq")
    sdriq.write(path, np.zeros((1 << 16, 2), np.int16), sample_rate=int(RATE))
    ds = _port_set({"kind": "filesource", "file_path": path, "file_preload": True,
                    "file_preload_max_mb": 0}, [(NFM, {})])
    ds.start()
    t0 = time.time()
    while ds.running and time.time() - t0 < 60:
        time.sleep(0.02)
    assert "file_preload" in ds.error


def test_record_file_equals_the_stream(tmp_path):
    """record_file writes the device stream as .sdriq: the testsource's own
    int16 blocks, header rate and centre from the settings."""
    out = str(tmp_path / "rec.sdriq")
    ds = _port_set({"kind": "testsource", "sample_rate": 192_000.0, "center_frequency": 1e6,
                    "carrier_freq": 20_000.0, "record_file": out, "run_blocks": 2},
                   [(NFM, {"inputFrequencyOffset": 20_000.0})])
    _run(ds)
    info, mm = sdriq.open_mmap(out)
    assert (info.sample_rate, info.center_frequency, info.sample_size) == (192_000, 1_000_000, 16)
    want = testsource.to_iq_int16(testsource.generate(testsource.TestSourceConfig(
        sample_rate=192_000.0, carrier_freq=20_000.0, modulation="fm"), mm.shape[0]))
    assert mm.shape[0] == 2 * (1 << 16)
    np.testing.assert_array_equal(np.asarray(mm), want)


def test_writer_files_equal_jax_writer(tmp_path):
    from sdrangel_tpu.io import sdriq as jsdriq

    rng = np.random.default_rng(5)
    iq = (rng.uniform(-1.1, 1.1, 5000) + 1j * rng.uniform(-1.1, 1.1, 5000)).astype(np.complex64)
    raw = rng.integers(-32768, 32767, size=(3000, 2), dtype=np.int16)
    for size in (16, 24):
        files = {}
        for name, mod in (("port", sdriq), ("jax", jsdriq)):
            mod.write(str(tmp_path / f"{name}{size}.sdriq"), iq, 2_000_000, 433_000_000,
                      sample_size=size, timestamp=17)
            w = mod.SdriqWriter(str(tmp_path / f"{name}{size}w.sdriq"), 2_000_000,
                                sample_size=size, timestamp=17)
            w.write(iq)
            if size == 16:
                w.write(raw)
            w.close()
            files[name] = [(tmp_path / f"{name}{size}{s}.sdriq").read_bytes() for s in ("", "w")]
        assert files["port"] == files["jax"]
    n = 4096
    _, mm = sdriq.open_mmap(str(tmp_path / "port16w.sdriq"))
    np.testing.assert_array_equal(sdriq.to_complex64(sdriq.read_block(mm, 0, n)),
                                  jsdriq.to_complex64(jsdriq.read_block(mm, 0, n)))
    with pytest.raises(EOFError):
        sdriq.read_block(mm, mm.shape[0] - 10, 11, wrap=False)


def test_packed_outputs_roundtrip_exactly_where_jax_rounds():
    big = 2 ** 24 + 1
    outs = {
        "channels": [{"audio": torch.linspace(-1, 1, 7), "power": torch.tensor(0.25),
                      "squelch": torch.tensor(True), "count": torch.tensor(big, dtype=torch.int32)}],
        "spectrum": torch.arange(5, dtype=torch.float32),
        "frames": torch.tensor([[big, -big], [2 ** 40 + 3, 7]], dtype=torch.int64),
        "small": torch.tensor([-3, 200], dtype=torch.int16),
    }
    flat, layout = peng.pack_outs(outs)
    assert flat.dtype == torch.float32 and flat.dim() == 1 and flat.numel() == layout.size
    back = peng.unpack_outs(peng.fetch(flat), layout)
    assert back["channels"][0]["count"] == big and back["channels"][0]["count"].dtype == np.int32
    np.testing.assert_array_equal(back["frames"], outs["frames"].numpy())
    np.testing.assert_array_equal(back["small"], [-3, 200])
    assert back["small"].dtype == np.int16
    assert back["channels"][0]["squelch"].dtype == np.bool_ and bool(back["channels"][0]["squelch"])
    np.testing.assert_array_equal(back["channels"][0]["audio"], outs["channels"][0]["audio"].numpy())
    assert float(back["channels"][0]["power"]) == 0.25

    # the JAX engine packs every leaf as float32 and unpacks by casting back
    import jax
    import jax.numpy as jnp

    from sdrangel_tpu.runtime import engine as jeng

    tree = {"count": jnp.asarray(big, jnp.int32), "power": jnp.asarray(0.25, jnp.float32)}
    leaves, treedef = jax.tree.flatten(tree)
    jp = object.__new__(jeng.RxPipeline)
    jp._out_layout = (treedef, [(leaf.shape, leaf.dtype) for leaf in leaves])
    jflat = np.asarray(jnp.concatenate([jnp.ravel(leaf).astype(jnp.float32) for leaf in leaves]))
    assert int(jp.unpack_outs(jflat)["count"]) == 2 ** 24  # 2^24 + 1 lost


def _instrument(ds, monkeypatch, on_step=None):
    """Log the worker's queued and published blocks in order."""
    log = []
    step_packed = peng.RxPipeline.step_packed
    publish = psession.DeviceSet._publish_block

    def traced_step(pipe, *a, **k):
        out = step_packed(pipe, *a, **k)
        log.append(("step", sum(1 for e in log if e[0] == "step")))
        if on_step is not None:
            on_step(log[-1][1])
        return out

    def traced_publish(self, outs, chans, wav):
        log.append(("publish", sum(1 for e in log if e[0] == "publish")))
        return publish(self, outs, chans, wav)

    monkeypatch.setattr(peng.RxPipeline, "step_packed", traced_step)
    monkeypatch.setattr(psession.DeviceSet, "_publish_block", traced_publish)
    return log


def _testsource_set(n_blocks, publish_every=1, channels=1):
    return _port_set(
        {"kind": "testsource", "sample_rate": 192_000.0, "carrier_freq": 20_000.0,
         "run_blocks": n_blocks, "publish_every": publish_every},
        [(NFM, {"inputFrequencyOffset": 20_000.0, "squelch_db": -60.0})] * channels)


def test_publish_stays_one_block_behind(monkeypatch):
    """At publish_every=1 block N is read back once block N+1 is queued (the
    JAX session reads back the block it has just queued, session.py:942)."""
    ds = _testsource_set(4)
    log = _instrument(ds, monkeypatch)
    _run(ds)
    assert log == [("step", 0), ("step", 1), ("publish", 0), ("step", 2), ("publish", 1),
                   ("step", 3), ("publish", 2), ("publish", 3)]


def test_publish_every_reads_bursts_behind_the_newest_block(monkeypatch):
    ds = _testsource_set(5, publish_every=2)
    log = _instrument(ds, monkeypatch)
    _run(ds)
    assert log == [("step", 0), ("step", 1), ("step", 2), ("publish", 0), ("publish", 1),
                   ("step", 3), ("step", 4), ("publish", 2), ("publish", 3), ("publish", 4)]


def test_generation_bump_publishes_the_pending_burst(monkeypatch):
    """A static change while 3 blocks are pending (publish_every=4): the JAX
    session drops them (session.py:956, 987-989); here each is published, so
    the channel's audio covers every block."""
    ds = _testsource_set(6, publish_every=4)
    gen = ds._gen
    log = _instrument(ds, monkeypatch, on_step=lambda i: i == 2 and ds.update_channel(
        0, {"rf_bandwidth": 11_000.0}))
    _run(ds)
    assert ds._gen == gen + 1
    # six blocks queued, six published: none was dropped and queued again
    assert [e[0] for e in log].count("step") == 6
    assert ds.blocks_processed == 6
    per_block = (1 << 16) * 48_000 // 192_000
    assert ds.channels[0].audio_samples == 6 * per_block
    assert ds.drain_audio(0).shape == (6 * per_block,)


def test_generation_bump_drops_only_a_removed_channel(monkeypatch):
    """Channel 1 removed while blocks 0-2 are pending: those blocks reach
    channel 0 (and the spectrum), and channel 1's part of them is dropped
    with the channel."""
    ds = _testsource_set(6, publish_every=4, channels=2)
    removed = ds.channels[1]
    log = _instrument(ds, monkeypatch, on_step=lambda i: i == 2 and ds.remove_channel(1))
    _run(ds)
    per_block = (1 << 16) * 48_000 // 192_000
    assert [e[0] for e in log].count("step") == 6
    assert ds.blocks_processed == 6 and len(ds.channels) == 1
    assert ds.channels[0].audio_samples == 6 * per_block
    assert removed.audio_samples == 0 and removed.audio == []


#: the sharded source's settings, each with a value and a value of the wrong type
_SHARDED_SETTINGS = {"sharded": (True, 1), "mesh_time": (4, 4.0), "mesh_channel": (2, "2"),
                     "sharded_block": (1 << 15, True), "sharded_pfb_m": (8, 8.5),
                     "sharded_pfb_a2a": (True, "yes")}


@pytest.mark.parametrize("name", sorted(_SHARDED_SETTINGS))
def test_sharded_settings_apply_as_jax(tmp_path, name):
    """Each setting of the sharded source, which raised while the mesh gears
    were left out, applies as the JAX session applies it: the value set, a
    static change (the generation moves), a wrong type refused, the preset
    carrying it."""
    from sdrangel_tpu.runtime.session import Session as JaxSession

    value, wrong = _SHARDED_SETTINGS[name]
    outcomes = []
    for s in (psession.Session(device=CPU, preset_dir=str(tmp_path)), JaxSession()):
        ds = s.add_device_set()
        gen = ds._gen
        ds.update_source({name: value})
        with pytest.raises(ValueError, match=name):
            ds.update_source({name: wrong})
        s.save_preset("g", "p")
        s.load_preset("g", "p")
        outcomes.append((getattr(ds.source, name), ds._gen - gen,
                         s.presets["g/p"]["deviceSets"][0]["source"][name],
                         getattr(s.device_sets[0].source, name)))
    assert outcomes[0] == outcomes[1] == (value, 1, value, value)


def _session_actions(s, ds, tmp_path):
    """The requests that named a part not ported before the UDP/RTP egress,
    the afUdp ingest and the reference presets were ported."""
    def tx_preset():
        s.presets["g/tx"] = {"schema": 2, "deviceSets": [
            {"direction": "tx", "source": {}, "channels": [{
                "uri": "sdrangel.channeltx.modnfm", "inputFrequencyOffset": 0.0,
                "settings": {"afUdp": "127.0.0.1:9999"}}]}]}
        s.load_preset("g", "tx")

    def reference_export():
        ds.update_source({"center_frequency": 433_500_000.0})
        ds.add_channel(NFM, {"inputFrequencyOffset": -25_000.0, "squelch_db": -45.0})
        s.save_preset("g", "p")
        s.export_preset_file("g", "p", "p.b64", fmt="reference")

    def tlv_import(text):
        (tmp_path / "ref.b64").write_text(text)
        return s.import_preset_file("ref.b64")

    return {
        "afUdp": tx_preset,
        "audioUdp": lambda: ds.add_channel(NFM, {"audioUdp": "127.0.0.1:9999"}),
        "audioRtp": lambda: ds.add_channel(NFM, {"audioRtp": "127.0.0.1:9999"}),
        "udpAddress": lambda: ds.add_channel(NFM, {"udpAddress": "127.0.0.1"}),
        "reference_export": reference_export,
        "tlv_import": lambda: tlv_import("AAAAAAE="),
        "tlv_import_golden": lambda: tlv_import(
            (pathlib.Path(REPO) / "tests" / "goldens" / "refpreset.b64").read_text()),
    }


def _session_outcome(make_session, tmp_path, case):
    """What one request does to a fresh session: its answer (a value or the
    exception's type), the device sets and channels, the presets and the
    exported file."""
    s = make_session(str(tmp_path))
    ds = s.add_device_set()
    try:
        answer = _session_actions(s, ds, tmp_path)[case]()
    except Exception as e:  # the answer is the exception's type
        answer = type(e).__name__
    sets = [(d.direction, [(c.uri, c.frequency_offset, dict(c.settings)) for c in d.channels])
            for d in s.device_sets]
    presets = {k: [[(c["uri"], c["inputFrequencyOffset"], c["settings"])
                    for c in e["channels"]] for e in v["deviceSets"]]
               for k, v in s.presets.items()}
    exported = tmp_path / "p.b64"
    return answer, sets, presets, exported.read_text() if exported.exists() else None


@pytest.mark.parametrize("case", ["afUdp", "audioUdp", "audioRtp", "udpAddress",
                                  "reference_export", "tlv_import", "tlv_import_golden"])
def test_udp_rtp_and_reference_presets_answer_as_jax(tmp_path, case):
    """Each request the port refused while UDP/RTP and the reference presets
    were left out now answers as the JAX session does: the same value or
    error, the same channels and presets, the same exported blob."""
    from sdrangel_tpu.runtime.session import Session as JaxSession

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _session_outcome(lambda d: JaxSession(preset_dir=d), tmp_path / "jax", case)
    got = _session_outcome(lambda d: psession.Session(device=CPU, preset_dir=d),
                           tmp_path / "port", case)
    assert got == want
    if case in ("afUdp", "audioUdp", "audioRtp", "udpAddress", "tlv_import_golden"):
        assert want[0] not in ("ValueError", "NotImplementedError", "KeyError")


def test_a_failing_udp_sink_stops_the_run_and_closes_the_rest(tmp_path, monkeypatch):
    """A UDP audio sink whose sends fail (port 0: the kernel refuses it
    locally) stops the run with the error recorded, as the JAX session does;
    its close fails again, and every other sink and the recorder still
    close: the other channel's WAV and the .sdriq are whole, and no
    exception escapes the worker thread."""
    escaped = []
    monkeypatch.setattr(threading, "excepthook", escaped.append)
    wav_path, rec_path = str(tmp_path / "a.wav"), str(tmp_path / "rec.sdriq")
    ds = _port_set({"kind": "testsource", "sample_rate": 192_000.0, "carrier_freq": 20_000.0,
                    "record_file": rec_path, "run_blocks": 4},
                   [(NFM, {"inputFrequencyOffset": 20_000.0, "audioFile": wav_path}),
                    (NFM, {"inputFrequencyOffset": 20_000.0, "audioUdp": "127.0.0.1:0"})])
    ds.start()
    t0 = time.time()
    while ds.running and time.time() - t0 < 120:
        time.sleep(0.02)
    ds.stop()
    assert not ds.running and ds.error.startswith("OSError"), ds.error
    assert escaped == []
    per_block = (1 << 16) * 48_000 // 192_000
    with wave.open(wav_path, "rb") as w:
        n = w.getnframes()
        assert n > 0 and n % per_block == 0
        assert len(w.readframes(n)) == 2 * n
    info, mm = sdriq.open_mmap(rec_path)
    assert mm.shape[0] > 0 and mm.shape[0] % (1 << 16) == 0
    want = testsource.to_iq_int16(testsource.generate(testsource.TestSourceConfig(
        sample_rate=192_000.0, carrier_freq=20_000.0, modulation="fm"), mm.shape[0]))
    np.testing.assert_array_equal(np.asarray(mm), want)


DSD = "sdrangel.channel.dsddemod"


def _dmr_capture(path, n):
    """A .sdriq capture at RATE of DMR voice bursts (the sync and random
    payload) as 4FSK at +20 kHz, ±2.7 kHz outer deviation, with noise."""
    from sdrangel_tpu_torch.channels import dsdsync

    rng = np.random.default_rng(91)
    n_sym = int(n / RATE * 4800) + 2
    bursts = [np.concatenate([dsdsync.DMR_BS_VOICE, rng.integers(0, 4, 120)])
              for _ in range(n_sym // dsdsync.DMR_BURST_DIBITS + 1)]
    dibits = np.concatenate(bursts)[:n_sym]
    m = (np.arange(n) * 4800.0 / RATE).astype(np.int64)
    freq = dsdsync.DIBIT_LEVELS[dibits].astype(np.float64)[m] / 3.0 * 2700.0 + 20_000.0
    iq = 0.3 * np.exp(2j * np.pi * np.cumsum(freq) / RATE)
    iq = iq + 0.003 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    sdriq.write(path, iq.astype(np.complex64), sample_rate=int(RATE), sample_size=16,
                timestamp=0)
    return path


@pytest.mark.parametrize("publish_every", [1, 3])
def test_dsd_host_report_equals_jax_session(tmp_path, publish_every):
    """A DSD channel on a DMR capture through the port's DeviceSet and the
    JAX DeviceSet: the same "dsd" host report (sync counts, the last sync,
    AMBE frames), the same dibits in the newest block, the same block count,
    whether the port reads one block or bursts of 3 back: the frame sync
    sees every block's dibits in order."""
    from sdrangel_tpu.runtime.session import DeviceSet as JaxDeviceSet

    path = _dmr_capture(str(tmp_path / "dmr.sdriq"), 6 * 262_144)
    source = {"kind": "filesource", "file_path": path, "log2_decim": 3, "run_blocks": 6,
              "publish_every": publish_every}
    settings = {"inputFrequencyOffset": 20_000.0, "fm_deviation": 2700.0}
    port = _port_set(source, [(DSD, settings)])
    jax_ds = JaxDeviceSet(0)
    jax_ds.update_source(source)
    jax_ds.add_channel(DSD, dict(settings))
    _run(port)
    _run(jax_ds)
    assert port.blocks_processed == jax_ds.blocks_processed == 6
    pc, jc = port.channels[0], jax_ds.channels[0]
    assert pc.data_blocks == jc.data_blocks == 6
    np.testing.assert_array_equal(pc.latest_data["dibits"], jc.latest_data["dibits"])
    assert pc.host_report == jc.host_report
    report = pc.host_report["dsd"]
    assert report["syncCounts"].get("dmr:bs_voice", 0) >= 20, report["syncCounts"]
    assert report["ambeFrameCount"] >= 60
    assert pc.audio_samples == 0 and pc.audio == []


def test_jax_presets_load_with_inert_defaults():
    """A JAX preset carries every JAX source field; at their defaults the
    sharded and daemon fields change nothing and the preset loads."""
    from sdrangel_tpu.runtime.session import Session as JaxSession

    js = JaxSession()
    jds = js.add_device_set()
    jds.update_source({"kind": "testsource", "sample_rate": 96_000.0})
    jds.add_channel(AM, {"inputFrequencyOffset": 1000.0, "volume": 2.0})
    preset = js.save_preset("g", "jax")
    s = psession.Session(device=CPU)
    s.presets["g/jax"] = preset
    s.load_preset("g", "jax")
    ds = s.device_sets[0]
    assert ds.source.sample_rate == 96_000.0
    assert (ds.channels[0].uri, ds.channels[0].frequency_offset) == (AM, 1000.0)
    assert ds.channels[0].settings == {"volume": 2.0}


def test_jax_daemon_presets_load():
    """A JAX preset with a daemon source and a daemon sink at settings of
    their own loads into the port with those settings."""
    from sdrangel_tpu.runtime.session import Session as JaxSession

    js = JaxSession()
    js.add_device_set().update_source({"kind": "daemonsource", "daemon_address": "127.0.0.2",
                                       "daemon_port": 9200, "sample_rate": 1.536e6})
    js.add_device_set("tx").update_source({"kind": "daemonsink", "daemon_port": 9201,
                                           "daemon_fec": 16, "daemon_auto_fec": True})
    s = psession.Session(device=CPU)
    s.presets["g/jax"] = js.save_preset("g", "jax")
    s.load_preset("g", "jax")
    rx, tx = s.device_sets
    assert (rx.source.kind, rx.source.daemon_address, rx.source.daemon_port) == (
        "daemonsource", "127.0.0.2", 9200)
    assert (tx.sink.kind, tx.sink.daemon_port, tx.sink.daemon_fec, tx.sink.daemon_auto_fec) == (
        "daemonsink", 9201, 16, True)


def test_daemon_source_set_equals_the_file_set(tmp_path):
    """An Rx set whose daemon source is fed a capture as superframes (a
    port DaemonSender, paced) gives the same NFM audio, block for block, as
    a file set playing the capture: the stream reaches the pipeline whole
    and in order. Its frame statistics count the frames it decoded, none
    failed."""
    from sdrangel_tpu_torch.io import daemon

    n_blocks = 4
    path = _capture(str(tmp_path / "d.sdriq"), 4 * 65536 * n_blocks)
    mm = sdriq.open_mmap(path)[1]
    channels = [(NFM, {"inputFrequencyOffset": 20_000.0})]
    ref = _port_set({"kind": "filesource", "file_path": path, "run_blocks": n_blocks}, channels)
    _run(ref)
    ds = _port_set({"kind": "daemonsource", "daemon_port": 0, "sample_rate": RATE,
                    "run_blocks": n_blocks}, channels)
    ds.start()
    t0 = time.time()
    while ds._daemon is None and time.time() - t0 < 30:
        time.sleep(0.01)
    tx = daemon.DaemonSender("127.0.0.1", ds._daemon.rx.port, n_fec=2)
    room = tx.payload_room // 4
    try:
        for k in range(-(-mm.shape[0] // room)):
            tx.send_iq(np.ascontiguousarray(mm[k * room:(k + 1) * room]))
            time.sleep(0.002)
        while ds.running and time.time() - t0 < 120:
            time.sleep(0.02)
    finally:
        tx.close()
        ds.stop()
    assert not ds.error, ds.error
    assert ds.blocks_processed == ref.blocks_processed == n_blocks
    np.testing.assert_array_equal(ds.drain_audio(0), ref.drain_audio(0))
    assert 0 < ds.daemon_stats.frames_ok <= tx.frame_index and ds.daemon_stats.frames_failed == 0
    assert ds._daemon is None  # closed with the worker


def test_build_runs_nvcc_once_for_many_threads(tmp_path, monkeypatch):
    """Device sets starting at once (more threads than cores, a short switch
    interval): the locked build runs the compiler once, into a temporary
    file of its own, and every thread gets the one library."""
    calls = []
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys, time
        time.sleep(0.3)
        out = sys.argv[sys.argv.index("-o") + 1]
        open(out, "w").write("stub library")
        """))
    nvcc.chmod(0o755)

    class StubLib:
        def __init__(self, path):
            calls.append(path)
            self.path = path

        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(ctypes, "CDLL", StubLib)
    build._build.cache_clear()
    build._library.cache_clear()
    n_threads = (os.cpu_count() or 4) + 2
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        barrier = threading.Barrier(n_threads)
        got = []

        def start():
            barrier.wait()
            got.append(build.library())

        threads = [threading.Thread(target=start) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert len(got) == n_threads and all(lib is got[0] for lib in got)
        assert len(calls) == 1
        files = sorted(os.listdir(tmp_path / "_build"))
        assert [f for f in files if f.endswith(".so")] == [os.path.basename(calls[0])]
        assert not [f for f in files if f.endswith(".tmp")]
    finally:
        sys.setswitchinterval(switch)
        build._build.cache_clear()
        build._library.cache_clear()


_NO_JAX = textwrap.dedent("""
    import json, socket, sys, threading, time, urllib.request

    class NoJax:
        # refuse jax and the JAX package: the port must need neither
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "sdrangel_tpu"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, NoJax())
    from sdrangel_tpu_torch.__main__ import main
    from sdrangel_tpu_torch.api import server
    from sdrangel_tpu_torch.runtime.session import Session

    s = Session(device="cpu")
    ds = s.add_device_set()
    ds.update_source({"sample_rate": 192000.0, "carrier_freq": 20000.0, "run_blocks": 2})
    ds.add_channel("sdrangel.channel.nfmdemod", {"inputFrequencyOffset": 20000.0})
    ds.start()
    while ds.running:
        time.sleep(0.02)
    assert not ds.error and ds.blocks_processed == 2, ds.error

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    args = ["server", "--device", "cpu", "--api-port", str(port)]
    threading.Thread(target=main, args=(args,), daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    for _ in range(200):
        try:
            with urllib.request.urlopen(base + "/sdrangel") as r:
                summary = json.loads(r.read())
            break
        except OSError:
            time.sleep(0.05)
    assert summary["appname"] == "sdrangel_tpu_torch" and summary["device"] == "cpu"
    req = urllib.request.Request(base + "/sdrangel/devicesets", data=b"{}", method="POST")
    with urllib.request.urlopen(req) as r:
        assert r.status == 201
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "sdrangel_tpu"))
    assert not loaded, loaded
    print("ok")
""")


def test_session_and_server_cli_without_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_server_cli_cuda_fails_loudly_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the no-card refusal")
    proc = subprocess.run([sys.executable, "-m", "sdrangel_tpu_torch", "server", "--api-port", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
