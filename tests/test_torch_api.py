"""The port's REST server (`sdrangel_tpu_torch/api/server.py`) driven over HTTP
on a CPU session: the Rx and Tx cases of tests/test_api.py and the cases of
tests/test_live_settings.py, the route ↔ document checks of
tests/test_openapi.py, the data channels' route and reports against the
JAX server, UDP/RTP audio egress, afUdp ingest, the reference presets and
the sharded source's settings against the JAX server's answers.

Sources are the testsource at 192 kS/s (65,536-sample blocks, 16,384 audio
samples each) or small captures; every run ends by `run_blocks` or a stop.
"""

import contextlib
import dataclasses
import inspect
import io
import json
import re
import threading
import time
import urllib.request
import wave

import numpy as np
import pytest

from sdrangel_tpu_torch.api import openapi, server
from sdrangel_tpu_torch.api.server import make_server
from sdrangel_tpu_torch.channels.registry import CONFIG_CLASSES
from sdrangel_tpu_torch.io import sdriq, testsource
from sdrangel_tpu_torch.runtime import engine
from sdrangel_tpu_torch.runtime import session as session_mod
from sdrangel_tpu_torch.runtime.session import PRESET_SCHEMA_VERSION, Session, migrate_preset
from torch_port_util import CPU, tone_snr

NFM = "sdrangel.channel.nfmdemod"
FM_SOURCE = {"kind": "testsource", "sample_rate": 192000.0, "modulation": "fm",
             "carrier_freq": 20000.0, "tone_freq": 1000.0}


def _serve(session, token=None):
    srv = make_server(session, "127.0.0.1", 0, auth_token=token)
    threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture()
def api():
    session = Session(device=CPU)
    srv, base = _serve(session)
    yield base, session
    session.shutdown()
    srv.shutdown()
    srv.server_close()


def _req(base, path, method="GET", body=None, raw=None, headers=()):
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(base + path, data=data, method=method)
    if data:
        req.add_header("Content-Type", "application/json")
    for k, v in headers:
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wav(base, path):
    with urllib.request.urlopen(base + path) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        with wave.open(io.BytesIO(r.read())) as w:
            assert w.getframerate() == 48000
            return np.frombuffer(w.readframes(w.getnframes()), np.int16) / 32768.0


def _fm_set(base, index=0, source=None, channel=None):
    code, _ = _req(base, "/sdrangel/devicesets", "POST")
    assert code == 201
    code, _ = _req(base, f"/sdrangel/deviceset/{index}/device/settings", "PATCH",
                   {**FM_SOURCE, **(source or {})})
    assert code == 200
    code, _ = _req(base, f"/sdrangel/deviceset/{index}/channel", "POST",
                   {"channelType": NFM, "inputFrequencyOffset": 20000.0, "squelch_db": -60.0,
                    **(channel or {})})
    assert code == 201


def _poll(fn, deadline_s=60.0):
    t0 = time.time()
    while time.time() - t0 < deadline_s:
        got = fn()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError("condition not reached before the deadline")


def _wait_idle(session, index=0):
    ds = session.device_sets[index]
    _poll(lambda: not ds.running)
    assert not ds.error, ds.error
    return ds


def _wait_audio(ds, predicate, min_blocks=1, deadline_s=60.0):
    """Drain audio until predicate(audio) holds over at least min_blocks new
    blocks; returns that audio."""
    t0 = time.time()
    while time.time() - t0 < deadline_s:
        start = ds.blocks_processed
        _poll(lambda: ds.blocks_processed >= start + min_blocks or not ds.running)
        assert ds.running, ds.error
        audio = ds.drain_audio(0)
        if audio.size and predicate(audio):
            return audio
    raise AssertionError("audio condition not reached before the deadline")


# -- instance, control flow, reports --------------------------------------------


def test_instance_summary(api):
    base, _ = api
    code, body = _req(base, "/sdrangel")
    assert code == 200
    assert body["appname"] == "sdrangel_tpu_torch" and body["device"] == "cpu"
    assert body["torchVersion"] and "jaxVersion" not in body
    assert body["dspRxBits"] == 16 and body["devicesetlist"]["devicesetcount"] == 0


def test_unknown_path_404(api):
    base, _ = api
    code, body = _req(base, "/sdrangel/bogus")
    assert code == 404 and "message" in body


def test_full_control_flow(api):
    """Device set → FM testsource → NFM channel → run → the report shows the
    signal → retune → stop."""
    base, session = api
    _fm_set(base)
    code, body = _req(base, "/sdrangel/deviceset/0/channel/0/settings")
    assert code == 200 and body["channelType"] == NFM
    assert body["inputFrequencyOffset"] == 20000.0
    code, _ = _req(base, "/sdrangel/deviceset/0/device/run", "POST")
    assert code == 200
    rep = _poll(lambda: (lambda r: r if r["audioSamples"] > 0 else None)(
        _req(base, "/sdrangel/deviceset/0/channel/0/report")[1]))
    assert rep["channelPowerDB"] > -30.0 and rep["squelch"] is True
    code, body = _req(base, "/sdrangel/deviceset/0/channel/0/settings", "PATCH",
                      {"inputFrequencyOffset": 25000.0})
    assert code == 200 and body["inputFrequencyOffset"] == 25000.0
    code, body = _req(base, "/sdrangel/deviceset/0/device/run", "DELETE")
    assert code == 200 and body["state"] == "idle"
    code, body = _req(base, "/sdrangel")
    assert body["devicesetlist"]["deviceSets"][0]["state"] == "idle"


def test_device_report_and_run_blocks(api):
    base, session = api
    _fm_set(base, source={"run_blocks": 3})
    code, rep = _req(base, "/sdrangel/deviceset/0/device/report")
    assert code == 200 and rep["state"] == "idle" and rep["sampleRate"] == 192000.0
    _req(base, "/sdrangel/deviceset/0/device/run", "POST")
    ds = _wait_idle(session)
    code, rep = _req(base, "/sdrangel/deviceset/0/device/report")
    assert rep["state"] == "idle" and rep["blocksProcessed"] == ds.blocks_processed == 3
    assert rep["realtimeFactor"] > 0.0 and rep["elapsedSeconds"] > 0.0
    code, rep = _req(base, "/sdrangel/deviceset/0/channel/0/report")
    assert rep["audioSamples"] == 3 * 16384


def test_fast_failing_start_is_restartable(api):
    """A worker that dies at once (a missing file) leaves the set idle with
    its error, and a corrected configuration starts again."""
    base, session = api
    _req(base, "/sdrangel/devicesets", "POST")
    _req(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
         {"kind": "filesource", "file_path": "/nonexistent.sdriq"})
    _req(base, "/sdrangel/deviceset/0/channel", "POST", {"channelType": NFM})
    _req(base, "/sdrangel/deviceset/0/device/run", "POST")
    ds = session.device_sets[0]
    _poll(lambda: ds.error and not ds.running)
    code, body = _req(base, "/sdrangel/deviceset/0")
    assert body["state"] == "error" and "FileNotFoundError" in body["error"]
    _req(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
         {"kind": "testsource", "run_blocks": 1})
    _req(base, "/sdrangel/deviceset/0/device/run", "POST")
    _wait_idle(session)
    assert ds.blocks_processed == 1


def test_channels_listing_and_schema(api):
    base, _ = api
    code, body = _req(base, "/sdrangel/channels")
    assert code == 200
    by_uri = {c["uri"]: c for c in body["channels"]}
    assert {u for u, c in by_uri.items() if c["direction"] == "rx"} == {
        NFM, "sdrangel.channel.amdemod", "sdrangel.channel.ssbdemod", "sdrangel.channel.wfmdemod",
        "sdrangel.channel.bfm", "sdrangel.channel.chanalyzer", "sdrangel.channel.lorademod",
        "sdrangel.channel.dsddemod", "sdrangel.channel.demodatv", "sdrangel.channel.udpsrc",
        "sdrangel.channel.demoddatv"}
    assert {u for u, c in by_uri.items() if c["direction"] == "tx"} == {
        f"sdrangel.channeltx.mod{k}" for k in ("nfm", "am", "ssb", "wfm")}
    assert body["channelcount"] == 15
    nfm = by_uri[NFM]["settings"]
    assert nfm["fm_deviation"] == {"type": "float", "default": 5000.0}
    assert "squelch_db" in nfm and "channel_rate" not in nfm
    modnfm = by_uri["sdrangel.channeltx.modnfm"]["settings"]
    assert modnfm["af_filter"] == {"type": "str", "default": "nfm_ref"}
    assert "block_af" not in modnfm and "input_offset" not in modnfm
    assert body["sessionKeys"] == ["afFile", "afUdp", "audioFile", "audioRtp", "audioUdp",
                                   "cwText", "cwWpm", "datvContinuous", "inputFrequencyOffset",
                                   "toneFrequency", "udpAddress", "udpFormat", "udpPort"]
    code, body = _req(base, "/sdrangel/devices")
    assert {d["kind"] for d in body["devices"]} == {"testsource", "filesource", "daemonsource"}


def test_channels_report_aggregate(api):
    base, _ = api
    _req(base, "/sdrangel/devicesets", "POST")
    _req(base, "/sdrangel/deviceset/0/channel", "POST",
         {"channelType": NFM, "inputFrequencyOffset": 10_000.0})
    _req(base, "/sdrangel/deviceset/0/channel", "POST",
         {"channelType": "sdrangel.channel.amdemod"})
    code, body = _req(base, "/sdrangel/deviceset/0/channels/report")
    assert code == 200 and body["channelcount"] == 2
    assert body["channels"][0]["channelType"] == NFM
    assert body["channels"][0]["inputFrequencyOffset"] == 10_000.0
    code, body = _req(base, "/sdrangel/deviceset/0/channel/1", "DELETE")
    assert code == 200 and body["channelcount"] == 1


# -- display taps and audio -------------------------------------------------------


def test_spectrum_scope_waterfall_histogram(api):
    """A plain carrier at +24 kHz: the spectrum peaks at its bin, the scope
    reads its −6 dB magnitude, the waterfall gathers rows and the decayed
    histogram's hottest column is the carrier's."""
    base, session = api
    _req(base, "/sdrangel/devicesets", "POST")
    code, _ = _req(base, "/sdrangel/deviceset/0/spectrum")
    assert code == 404  # not running yet
    _req(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
         {"kind": "testsource", "sample_rate": 192000.0, "modulation": "none",
          "carrier_freq": 24000.0, "amplitude": 0.5, "run_blocks": 4})
    _req(base, "/sdrangel/deviceset/0/channel", "POST",
         {"channelType": NFM, "inputFrequencyOffset": 24000.0})
    _req(base, "/sdrangel/deviceset/0/device/run", "POST")
    _wait_idle(session)
    expect = 512 + int(24000.0 / 192000.0 * 1024)
    code, spec = _req(base, "/sdrangel/deviceset/0/spectrum")
    assert code == 200 and spec["fftSize"] == 1024
    assert abs(int(np.argmax(spec["spectrum"])) - expect) <= 2
    code, scope = _req(base, "/sdrangel/deviceset/0/scope")
    assert code == 200 and scope["length"] == 1024
    assert abs(np.median(scope["traces"]["magdb"]) - (-6.0)) < 1.5
    re_t = np.asarray(scope["traces"]["real"])
    assert re_t.max() > 0.3 and re_t.min() < -0.3
    code, wf = _req(base, "/sdrangel/deviceset/0/spectrum/waterfall")
    assert code == 200 and wf["rows"] == 4 and len(wf["waterfall"][0]) == wf["fftSize"]
    code, hist = _req(base, "/sdrangel/deviceset/0/spectrum/histogram")
    h = np.asarray(hist["histogram"], np.int32)
    assert code == 200 and h.shape == (hist["powerBins"], hist["fftSize"])
    col = h.max(axis=0)
    assert col[expect] == col.max() and col[expect - 100] < col.max() / 2


def test_spectrum_settings(api):
    base, session = api
    _req(base, "/sdrangel/devicesets", "POST")
    code, body = _req(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
                      {"kind": "testsource", "sample_rate": 192000.0, "modulation": "none",
                       "carrier_freq": 24000.0, "spectrum_fft_size": 512,
                       "spectrum_averaging": "none", "run_blocks": 1})
    assert code == 200 and body["spectrum_fft_size"] == 512
    _req(base, "/sdrangel/deviceset/0/channel", "POST",
         {"channelType": NFM, "inputFrequencyOffset": 24000.0})
    _req(base, "/sdrangel/deviceset/0/device/run", "POST")
    _wait_idle(session)
    code, spec = _req(base, "/sdrangel/deviceset/0/spectrum")
    assert code == 200 and spec["fftSize"] == 512
    assert abs(int(np.argmax(spec["spectrum"])) - (256 + 64)) <= 2


def test_audio_endpoint_returns_wav(api):
    base, session = api
    _fm_set(base, source={"run_blocks": 4})
    _req(base, "/sdrangel/deviceset/0/device/run", "POST")
    _wait_idle(session)
    pcm = _wav(base, "/sdrangel/deviceset/0/channel/0/audio")
    assert len(pcm) == 4 * 16384
    assert tone_snr(pcm[len(pcm) // 2:], 1000.0, 48000.0) > 20.0
    assert len(_wav(base, "/sdrangel/deviceset/0/channel/0/audio")) == 0  # drained


def test_channel_wav_file_egress(api, tmp_path):
    """A channel with audioFile streams its audio to that WAV while it runs."""
    base, session = api
    out = str(tmp_path / "rec.wav")
    _fm_set(base, source={"run_blocks": 4}, channel={"audioFile": out})
    code, body = _req(base, "/sdrangel/audio")
    assert body["nbOutputDevices"] == 1 and body["outputs"][0]["kind"] == "wav"
    _req(base, "/sdrangel/deviceset/0/device/run", "POST")
    _wait_idle(session)
    with wave.open(out) as w:
        n = w.getnframes()
        pcm = np.frombuffer(w.readframes(n), np.int16) / 32768.0
    assert n == 4 * 16384
    assert tone_snr(pcm[n // 2:], 1000.0, 48000.0) > 20.0


def test_two_device_sets_concurrently(api):
    """Two Rx device sets acquire at once, each with its own worker and
    pipeline, without interference."""
    base, session = api
    for i, (cf, tone) in enumerate(((15000.0, 700.0), (-30000.0, 1100.0))):
        _fm_set(base, i, source={"carrier_freq": cf, "tone_freq": tone, "run_blocks": 4},
                channel={"inputFrequencyOffset": cf})
    for i in range(2):
        _req(base, f"/sdrangel/deviceset/{i}/device/run", "POST")
    for i, tone in enumerate((700.0, 1100.0)):
        _wait_idle(session, i)
        pcm = _wav(base, f"/sdrangel/deviceset/{i}/channel/0/audio")
        assert len(pcm) == 4 * 16384
        assert tone_snr(pcm[len(pcm) // 2:], tone, 48000.0) > 10.0, i


def test_24bit_capture_through_session(api, tmp_path):
    """A 24-bit .sdriq demodulates with the 2^23 scale (dsptypes.h:25-35)."""
    rate = 192000.0
    iq = testsource.generate(testsource.TestSourceConfig(
        sample_rate=rate, carrier_freq=20_000.0, modulation="fm", amplitude=0.4), 3 * 65536)
    path = str(tmp_path / "cap24.sdriq")
    sdriq.write(path, iq, sample_rate=int(rate), sample_size=24)
    base, session = api
    _fm_set(base, source={"kind": "filesource", "file_path": path, "run_blocks": 3})
    _req(base, "/sdrangel/deviceset/0/device/run", "POST")
    _wait_idle(session)
    code, rep = _req(base, "/sdrangel/deviceset/0/channel/0/report")
    assert -20.0 < rep["channelPowerDB"] < 0.0, rep  # 0.4 amplitude, not 256× off
    pcm = _wav(base, "/sdrangel/deviceset/0/channel/0/audio")
    assert tone_snr(pcm[len(pcm) // 2:], 1000.0, 48000.0) > 15.0


# -- live settings (tests/test_live_settings.py) -------------------------------


def test_dynamic_squelch_applies_without_rebuild(api):
    base, session = api
    _fm_set(base)
    _req(base, "/sdrangel/deviceset/0/device/run", "POST")
    ds = session.device_sets[0]
    _wait_audio(ds, lambda a: np.abs(a).max() > 0.05)
    gen = ds._gen
    code, _ = _req(base, "/sdrangel/deviceset/0/channel/0/settings", "PATCH",
                   {"squelch_db": 10.0})
    assert code == 200
    ds.drain_audio(0)
    _wait_audio(ds, lambda a: np.abs(a).max() < 1e-6, min_blocks=2)
    assert _req(base, "/sdrangel/deviceset/0/channel/0/report")[1]["squelch"] is False
    _req(base, "/sdrangel/deviceset/0/channel/0/settings", "PATCH", {"squelch_db": -60.0})
    _wait_audio(ds, lambda a: np.abs(a).max() > 0.05, min_blocks=2)
    assert _req(base, "/sdrangel/deviceset/0/channel/0/report")[1]["squelch"] is True
    assert ds._gen == gen and ds.running and not ds.error


def _dominant_tone(audio, rate=48000.0):
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    return float(np.argmax(spec) * rate / len(audio))


def test_dynamic_retune_within_passband(api):
    """An in-passband retune rides the NCO: an SSB channel hears a +20 kHz
    carrier at 1 kHz from 19 kHz, at 1.5 kHz from 18.5 kHz, no rebuild."""
    base, session = api
    _req(base, "/sdrangel/devicesets", "POST")
    _req(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
         {"kind": "testsource", "sample_rate": 192000.0, "modulation": "none",
          "carrier_freq": 20000.0})
    code, _ = _req(base, "/sdrangel/deviceset/0/channel", "POST",
                   {"channelType": "sdrangel.channel.ssbdemod",
                    "inputFrequencyOffset": 19000.0, "usb": True})
    assert code == 201
    _req(base, "/sdrangel/deviceset/0/device/run", "POST")
    ds = session.device_sets[0]
    audio = _wait_audio(ds, lambda a: np.abs(a).max() > 0.01)
    assert abs(_dominant_tone(audio) - 1000.0) < 50.0
    gen = ds._gen
    _req(base, "/sdrangel/deviceset/0/channel/0/settings", "PATCH",
         {"inputFrequencyOffset": 18500.0})
    ds.drain_audio(0)
    _wait_audio(ds, lambda a: abs(_dominant_tone(a) - 1500.0) < 50.0, min_blocks=2)
    assert ds._gen == gen and ds.running and not ds.error


def test_static_retune_rebuilds_running_pipeline(api):
    base, session = api
    _fm_set(base)
    _req(base, "/sdrangel/deviceset/0/device/run", "POST")
    ds = session.device_sets[0]
    _wait_audio(ds, lambda a: np.abs(a).max() > 0.05)
    gen = ds._gen
    _req(base, "/sdrangel/deviceset/0/channel/0/settings", "PATCH",
         {"inputFrequencyOffset": -60000.0})
    ds.drain_audio(0)
    _wait_audio(ds, lambda a: np.abs(a).max() < 1e-6, min_blocks=2)
    assert ds._gen > gen and ds.running and not ds.error
    _req(base, "/sdrangel/deviceset/0/channel/0/settings", "PATCH",
         {"inputFrequencyOffset": 20000.0})
    _wait_audio(ds, lambda a: np.abs(a).max() > 0.05, min_blocks=2)


def test_static_channel_setting_applies_mid_run(api):
    base, session = api
    _fm_set(base)
    _req(base, "/sdrangel/deviceset/0/device/run", "POST")
    ds = session.device_sets[0]
    _wait_audio(ds, lambda a: np.abs(a).max() > 0.05)
    gen = ds._gen
    code, _ = _req(base, "/sdrangel/deviceset/0/channel/0/settings", "PATCH",
                   {"rf_bandwidth": 25000.0})
    assert code == 200 and ds._gen > gen
    ds.drain_audio(0)
    _wait_audio(ds, lambda a: np.abs(a).max() > 0.05, min_blocks=2)
    assert _req(base, "/sdrangel/deviceset/0/channel/0/settings")[1]["rf_bandwidth"] == 25000.0


def test_device_settings_change_rebuilds_mid_run(api):
    base, session = api
    _fm_set(base)
    _req(base, "/sdrangel/deviceset/0/device/run", "POST")
    ds = session.device_sets[0]
    _wait_audio(ds, lambda a: np.abs(a).max() > 0.05)
    code, _ = _req(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
                   {"carrier_freq": -50000.0})
    assert code == 200
    ds.drain_audio(0)
    _wait_audio(ds, lambda a: np.abs(a).max() < 1e-6, min_blocks=2)
    assert ds.running and not ds.error


# -- bad requests -------------------------------------------------------------------


def test_device_settings_typed_validation(api):
    base, _ = api
    _req(base, "/sdrangel/devicesets", "POST")
    for body in ({"sample_rate": "fast"}, {"log2_decim": 2.5}, {"no_such_setting": 1},
                 {"kind": "hackrf"}):
        code, msg = _req(base, "/sdrangel/deviceset/0/device/settings", "PATCH", body)
        assert code == 400, body
    code, body = _req(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
                      {"sample_rate": 96000})
    assert code == 200 and body["sample_rate"] == 96000.0


def test_malformed_json_400(api):
    base, _ = api
    code, body = _req(base, "/sdrangel/devicesets", "POST", raw=b"{not json")
    assert code == 400 and "malformed" in body["message"]
    code, body = _req(base, "/sdrangel/devicesets", "POST", body=[1, 2])
    assert code == 400 and "object" in body["message"]


def test_channel_settings_validation_400(api):
    base, _ = api
    _req(base, "/sdrangel/devicesets", "POST")
    code, body = _req(base, "/sdrangel/deviceset/0/channel", "POST",
                      {"inputFrequencyOffset": 0.0})
    assert code == 400 and "channelType" in body["message"]
    code, body = _req(base, "/sdrangel/deviceset/0/channel", "POST",
                      {"channelType": NFM, "fmDeviation": 5000.0})
    assert code == 400 and "fmDeviation" in body["message"]
    code, _ = _req(base, "/sdrangel/deviceset/0/channel", "POST",
                   {"channelType": NFM, "fm_deviation": 5000.0})
    assert code == 201
    code, body = _req(base, "/sdrangel/deviceset/0/channel/0/settings", "PATCH",
                      {"bogus_knob": 1})
    assert code == 400 and "bogus_knob" in body["message"]
    code, _ = _req(base, "/sdrangel/deviceset/0/channel", "POST",
                   {"channelType": "sdrangel.channel.nosuchdemod"})
    assert code == 404
    code, _ = _req(base, "/sdrangel/deviceset/3/channel/0/report")
    assert code == 404


def test_api_bearer_token():
    session = Session(device=CPU)
    srv, base = _serve(session, token="s3cret")
    try:
        assert _req(base, "/sdrangel")[0] == 401
        assert _req(base, "/sdrangel/devicesets", "POST")[0] == 401
        assert _req(base, "/sdrangel/devicesets", "DELETE")[0] == 401
        code, body = _req(base, "/sdrangel", headers=[("Authorization", "Bearer s3cret")])
        assert code == 200 and body["appname"] == "sdrangel_tpu_torch"
    finally:
        srv.shutdown()
        srv.server_close()


# -- the sharded source's settings over HTTP ---------------------------------------------

#: PATCH bodies of the device settings that answered 501 while the mesh gears
#: were left out
_SHARDED_PATCHES = {
    "sharded": {"sharded": True},
    "mesh": {"mesh_time": 4},
    "mesh_channel": {"mesh_channel": 2, "sharded_block": 1 << 15},
    "pfb": {"sharded_pfb_m": 8, "sharded_pfb_a2a": True},
    "wrong_type": {"mesh_time": "4"},
}


def _sharded_patch_outcome(base, case):
    _req(base, "/sdrangel/devicesets", "POST")
    _req(base, "/sdrangel/deviceset/0/channel", "POST", {"channelType": NFM})
    code, _ = _req(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
                   _SHARDED_PATCHES[case])
    _, settings = _req(base, "/sdrangel/deviceset/0/device/settings")
    _, summary = _req(base, "/sdrangel")
    names = ("sharded", "mesh_time", "mesh_channel", "sharded_block", "sharded_pfb_m",
             "sharded_pfb_a2a")
    return (code, {k: settings[k] for k in names},
            summary["devicesetlist"]["deviceSets"][0]["a2aFallback"])


@pytest.mark.parametrize("case", sorted(_SHARDED_PATCHES))
def test_sharded_settings_patch_as_jax(api, case):
    """Each PATCH answers as the JAX server does: the same status, the same
    device settings after it, the device set's a2aFallback report."""
    from sdrangel_tpu.api.server import make_server as jax_make_server
    from sdrangel_tpu.runtime.session import Session as JaxSession

    base, session = api
    jax_session = JaxSession()
    jsrv = jax_make_server(jax_session, "127.0.0.1", 0)
    threading.Thread(target=jsrv.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    try:
        want = _sharded_patch_outcome(f"http://127.0.0.1:{jsrv.server_address[1]}", case)
        got = _sharded_patch_outcome(base, case)
    finally:
        jax_session.shutdown()
        jsrv.shutdown()
        jsrv.server_close()
    assert got == want
    assert want[0] == (400 if case == "wrong_type" else 200) and want[2] is False


# -- UDP/RTP egress, afUdp ingest and the reference presets over HTTP ---------------------

#: the requests that answered 501 while these parts were left out
_FORMERLY_LEFT_OUT = {
    "afUdp": ("/sdrangel/config", "PUT", {"deviceSets": [
        {"direction": "tx", "source": {}, "channels": [
            {"uri": "sdrangel.channeltx.modnfm", "inputFrequencyOffset": 0.0,
             "settings": {"afUdp": "127.0.0.1:9999"}}]}]}),
    "audioUdp": ("/sdrangel/deviceset/0/channel", "POST",
                 {"channelType": NFM, "audioUdp": "127.0.0.1:9999"}),
    "audioRtp": ("/sdrangel/deviceset/0/channel/0/settings", "PATCH",
                 {"audioRtp": "127.0.0.1:9999"}),
    "udpPort": ("/sdrangel/deviceset/0/channel/0/settings", "PUT", {"udpPort": 9999}),
    "reference_export": ("/sdrangel/preset/file", "POST",
                         {"groupName": "g", "name": "p", "filePath": "p.b64",
                          "format": "reference"}),
    "tlv_import": ("/sdrangel/preset/file", "PUT", {"filePath": "ref.b64"}),
}


def _formerly_left_out_outcome(base, session, preset_dir, case):
    session.preset_dir = str(preset_dir)
    (preset_dir / "ref.b64").write_text("AAAAAAE=")
    _req(base, "/sdrangel/devicesets", "POST")
    _req(base, "/sdrangel/deviceset/0/channel", "POST", {"channelType": NFM})
    _req(base, "/sdrangel/preset", "POST", {"groupName": "g", "name": "p"})
    path, method, body = _FORMERLY_LEFT_OUT[case]
    code, _ = _req(base, path, method, body)
    _, config = _req(base, "/sdrangel/config")
    sets = [(d["direction"], d["channels"]) for d in config["deviceSets"]]
    exported = preset_dir / "p.b64"
    return code, sets, exported.read_text() if exported.exists() else None


@pytest.mark.parametrize("case", sorted(_FORMERLY_LEFT_OUT))
def test_udp_rtp_and_reference_preset_requests_answer_as_jax(api, tmp_path, case):
    """Each request that answered 501 while UDP/RTP and the reference presets
    were left out answers as the JAX server does: the same status, the same
    channels after it, the same exported blob."""
    from sdrangel_tpu.api.server import make_server as jax_make_server
    from sdrangel_tpu.runtime.session import Session as JaxSession

    base, session = api
    jax_session = JaxSession()
    jsrv = jax_make_server(jax_session, "127.0.0.1", 0)
    threading.Thread(target=jsrv.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    try:
        (tmp_path / "jax").mkdir()
        (tmp_path / "port").mkdir()
        want = _formerly_left_out_outcome(f"http://127.0.0.1:{jsrv.server_address[1]}",
                                          jax_session, tmp_path / "jax", case)
        got = _formerly_left_out_outcome(base, session, tmp_path / "port", case)
    finally:
        jax_session.shutdown()
        jsrv.shutdown()
        jsrv.server_close()
    assert got == want
    assert want[0] == (400 if case == "tlv_import" else 201 if case == "audioUdp" else 200)


def _rtp_ports() -> tuple:
    """A bound RTP socket on a free port p whose p + 1 is free for RTCP."""
    import socket

    for _ in range(50):
        rtp_rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rtp_rx.bind(("127.0.0.1", 0))
        rtcp_rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            rtcp_rx.bind(("127.0.0.1", rtp_rx.getsockname()[1] + 1))
            return rtp_rx, rtcp_rx
        except OSError:
            rtp_rx.close()
            rtcp_rx.close()
    raise RuntimeError("no free RTP/RTCP port pair")


def test_channel_udp_rtp_audio_egress(api):
    """audioUdp / audioRtp stream the demod audio as UDP mono16 datagrams and
    RTP L16 packets with an RTCP sender report (the AudioNetSink roles, JAX's
    test_api.py case): the datagrams carry the channel's audio within 1 LSB,
    the RTP samples equal the UDP stream's, in contiguous sequence, and the
    /sdrangel/audio route lists both destinations."""
    import socket

    from sdrangel_tpu_torch.io import rtp, udp

    udp_rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    udp_rx.bind(("127.0.0.1", 0))
    rtp_rx, rtcp_rx = _rtp_ports()
    for sock in (udp_rx, rtp_rx, rtcp_rx):
        sock.settimeout(0.5)
    base, session = api
    _req(base, "/sdrangel/devicesets", "POST")
    _req(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
         {**FM_SOURCE, "run_blocks": 4})
    udp_to = f"127.0.0.1:{udp_rx.getsockname()[1]}"
    rtp_to = f"127.0.0.1:{rtp_rx.getsockname()[1]}"
    code, _ = _req(base, "/sdrangel/deviceset/0/channel", "POST",
                   {"channelType": NFM, "inputFrequencyOffset": 20000.0, "squelch_db": -60.0,
                    "audioUdp": udp_to, "audioRtp": rtp_to})
    assert code == 201
    code, audio_route = _req(base, "/sdrangel/audio")
    assert code == 200 and [(o["kind"], o["destination"]) for o in audio_route["outputs"]] == [
        ("udp", udp_to), ("rtp", rtp_to)]
    received = {sock: [] for sock in (udp_rx, rtp_rx, rtcp_rx)}
    done = threading.Event()

    def drain(sock):  # while the set runs: a burst overflows a socket's buffer
        while not done.is_set():
            with contextlib.suppress(socket.timeout):
                received[sock].append(sock.recv(65536))
        sock.close()

    readers = [threading.Thread(target=drain, args=(sock,)) for sock in received]
    for r in readers:
        r.start()
    try:
        _req(base, "/sdrangel/deviceset/0/device/run", "POST")
        ds = _wait_idle(session)
        time.sleep(1.0)
    finally:
        done.set()
        for r in readers:
            r.join()
    got = np.concatenate([udp.decode_payload(d, "mono16") for d in received[udp_rx]])
    pkts = [rtp.parse_packet(d) for d in received[rtp_rx]]
    reports = [r for d in received[rtcp_rx] for r in rtp.parse_rtcp(d)]
    audio = ds.drain_audio(0)
    assert len(audio) == 4 * 16384 and tone_snr(audio, 1000.0, 48000.0) > 25.0
    # the sink flushes its partial datagram when the set stops
    assert len(got) == len(audio)
    assert np.max(np.abs(got * 32768.0 - np.clip(audio * 32768.0, -32768, 32767))) <= 1.0
    rtp_pcm = np.concatenate([np.frombuffer(p["payload"], ">i2") for p in pkts])
    assert all(p["payload_type"] == rtp.PT_L16_MONO for p in pkts)
    assert all((b["seq"] - a["seq"]) & 0xFFFF == 1 for a, b in zip(pkts, pkts[1:]))
    n = len(rtp_pcm)
    assert n == len(audio) // 480 * 480
    np.testing.assert_array_equal(rtp_pcm, np.round(got[:n] * 32768.0).astype(np.int16))
    assert any(r["type"] == "SR" and r["ssrc"] == pkts[0]["ssrc"] for r in reports)


def test_tx_udp_af_ingest(api, tmp_path):
    """afUdp on a Tx channel takes the modulator's audio from UDP mono16
    datagrams (the channeltx/udpsink ingest role, JAX's test_api.py case):
    the recorded capture demodulates back to the streamed 700 Hz tone."""
    import socket

    from sdrangel_tpu_torch.runtime.engine import ChannelSpec, DeviceConfig, RxPipeline

    base, session = api
    _req(base, "/sdrangel/devicesets", "POST", {"direction": "tx"})
    out_path = str(tmp_path / "txudp.sdriq")
    _req(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
         {"file_path": out_path, "sample_rate": 192000.0})
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    code, _ = _req(base, "/sdrangel/deviceset/0/channel", "POST",
                   {"channelType": "sdrangel.channeltx.modnfm", "inputFrequencyOffset": 20000.0,
                    "afUdp": f"127.0.0.1:{port}"})
    assert code == 201
    _req(base, "/sdrangel/deviceset/0/device/run", "POST")
    ds = session.device_sets[0]
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    n_sent = 0
    t0 = time.time()
    while ds.blocks_processed < 12 and time.time() - t0 < 60.0:
        t = (n_sent + np.arange(480)) / 48000.0
        pcm = np.clip(np.sin(2 * np.pi * 700.0 * t) * 24000, -32768, 32767).astype(np.int16)
        tx.sendto(pcm.tobytes(), ("127.0.0.1", port))
        n_sent += 480
        time.sleep(0.002)
    tx.close()
    _req(base, "/sdrangel/deviceset/0/device/run", "DELETE")
    _poll(lambda: not ds.running)
    assert not ds.error, ds.error
    info, mm = sdriq.open_mmap(out_path)
    assert info.sample_rate == 192000 and ds.blocks_processed >= 12
    pipe = RxPipeline(DeviceConfig(192000.0, log2_decim=0),
                      [ChannelSpec(NFM, 20000.0, {"squelch_db": -100.0})], CPU)
    n_blocks = mm.shape[0] // pipe.device_block
    audio = np.concatenate([outs["channels"][0]["audio"] for _, outs in pipe.run(
        lambda b, count: sdriq.read_block(mm, b * count, count), n_blocks)])
    a = audio[len(audio) // 4:]
    assert tone_snr(a - a.mean(), 700.0, 48000.0) > 8.0
# -- the data channels: the data route, dataKeys, the DSD host report ----------------------

DATA_CHANNELS = [
    ("sdrangel.channel.chanalyzer", {"inputFrequencyOffset": 20_000.0}),
    ("sdrangel.channel.lorademod", {"inputFrequencyOffset": 0.0}),
    ("sdrangel.channel.dsddemod", {"inputFrequencyOffset": 20_000.0}),
    ("sdrangel.channel.demodatv", {"inputFrequencyOffset": 0.0, "standard": "hskip",
                                   "lines": 64, "fps": 25.0}),
    ("sdrangel.channel.udpsrc", {"inputFrequencyOffset": 20_000.0, "fmt": "nfm"}),
    (NFM, {"inputFrequencyOffset": 20_000.0}),
]


def _data_set(base, n_blocks):
    """A device set of the five data kinds and an NFM channel on the FM
    testsource, run for n_blocks to idle over HTTP."""
    assert _req(base, "/sdrangel/devicesets", "POST")[0] == 201
    assert _req(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
                {**FM_SOURCE, "run_blocks": n_blocks})[0] == 200
    for uri, settings in DATA_CHANNELS:
        code, body = _req(base, "/sdrangel/deviceset/0/channel", "POST",
                          {"channelType": uri, **settings})
        assert code == 201, body
    code, body = _req(base, "/sdrangel/deviceset/0/channel/0/data")
    assert code == 404 and "no data yet" in body["message"]
    assert _req(base, "/sdrangel/deviceset/0/device/run", "POST")[0] == 200


def _trimmed(v: np.ndarray):
    """The data route's form of one array (JAX server.py:303-318)."""
    if v.ndim == 0:
        return round(float(v), 5)
    a = v.reshape(-1) if v.ndim > 2 else v
    return np.round(a[..., -2048:], 5).tolist()


def test_data_route_and_reports_over_http(api):
    """The data route answers each data channel's newest block, tail-trimmed
    to 2048 and rounded to 5 places, and the block count; an audio channel
    has no data (404); the report carries dataBlocks, dataKeys and the DSD
    channel's "dsd" host report; the OpenAPI document's report schema names
    the same keys."""
    from sdrangel_tpu_torch.channels import registry

    base, session = api
    _data_set(base, 3)
    ds = _wait_idle(session)
    assert ds.blocks_processed == 3
    _, doc = _req(base, "/sdrangel/openapi")
    for j, (uri, _) in enumerate(DATA_CHANNELS):
        ch = ds.channels[j]
        code, body = _req(base, f"/sdrangel/deviceset/0/channel/{j}/data")
        _, rep = _req(base, f"/sdrangel/deviceset/0/channel/{j}/report")
        if uri == NFM:
            assert code == 404 and "dataKeys" not in rep and rep["audioSamples"] > 0
            continue
        assert code == 200 and body["dataBlocks"] == 3 == rep["dataBlocks"]
        keys = registry.REGISTRY[uri].data_keys
        assert sorted(body["data"]) == sorted(keys) == rep["dataKeys"]
        for k, v in ch.latest_data.items():
            assert body["data"][k] == _trimmed(v), (uri, k)
        schema = doc["components"]["schemas"]
        props = next(v for v in schema.values() if v.get("x-channel-uri") == uri
                     and "dataKeys" in v.get("properties", {}))["properties"]
        assert props["dataKeys"]["enum"] == [list(keys)]
        if uri == "sdrangel.channel.dsddemod":
            assert rep["dsd"] == ch.host_report["dsd"] and "syncCounts" in rep["dsd"]
            assert "dsd" in props
        else:
            assert "dsd" not in rep


def test_data_route_answers_as_the_jax_server(api):
    """The same device set through the JAX server: the same data keys and
    shapes, the integer outputs equal, the floats within 2e-5 and the
    5-place rounding (the dB spectrum within 1e-2 dB within 60 dB of its
    peak), the same block counts and DSD report."""
    from sdrangel_tpu.api.server import make_server as jax_make_server
    from sdrangel_tpu.runtime.session import Session as JaxSession

    base, session = api
    jax_session = JaxSession()
    jsrv = jax_make_server(jax_session, "127.0.0.1", 0)
    threading.Thread(target=jsrv.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    jbase = f"http://127.0.0.1:{jsrv.server_address[1]}"
    try:
        for b, s in ((base, session), (jbase, jax_session)):
            _data_set(b, 2)
            _wait_idle(s)
        for j, (uri, _) in enumerate(DATA_CHANNELS[:-1]):
            if uri == "sdrangel.channel.demodatv":
                # an FM carrier has no line structure: ATV's sync phase is
                # the argmin of a flat fold, which f32 rounding decides (ATV
                # is held to JAX on line patterns in test_torch_atv.py)
                continue
            code, got = _req(base, f"/sdrangel/deviceset/0/channel/{j}/data")
            jcode, want = _req(jbase, f"/sdrangel/deviceset/0/channel/{j}/data")
            assert code == jcode == 200 and got["dataBlocks"] == want["dataBlocks"] == 2
            assert sorted(got["data"]) == sorted(want["data"])
            for k in want["data"]:
                g, w = np.asarray(got["data"][k]), np.asarray(want["data"][k])
                assert g.shape == w.shape, (uri, k)
                if k in ("symbols", "dibits", "squelch_open", "squelch"):
                    np.testing.assert_array_equal(g, w, err_msg=f"{uri} {k}")
                elif k == "spectrum":  # dB: by f32 rounding relative to the peak
                    live = w > w.max() - 60.0
                    np.testing.assert_allclose(g[live], w[live], atol=1e-2)
                else:
                    np.testing.assert_allclose(g, w, atol=3e-5, rtol=1e-5, err_msg=f"{uri} {k}")
            _, rep = _req(base, f"/sdrangel/deviceset/0/channel/{j}/report")
            _, jrep = _req(jbase, f"/sdrangel/deviceset/0/channel/{j}/report")
            assert rep["dataKeys"] == jrep["dataKeys"] and rep["dataBlocks"] == jrep["dataBlocks"]
            assert rep.get("dsd") == jrep.get("dsd")
    finally:
        jax_session.shutdown()
        jsrv.shutdown()
        jsrv.server_close()


def test_daemon_hw_types_and_fields_over_http(api):
    """PUT …/device selects the daemon source on an Rx set and the daemon
    sink on a Tx set, as the JAX server does; their fields take typed
    PATCHes (a wrong type is a 400), answer as the session's settings, and
    stand in the OpenAPI document."""
    base, session = api
    _req(base, "/sdrangel/devicesets", "POST")
    _req(base, "/sdrangel/devicesets", "POST", {"direction": "tx"})
    code, body = _req(base, "/sdrangel/deviceset/0/device", "PUT", {"hwType": "daemonsource"})
    assert code == 200 and body["kind"] == "daemonsource"
    code, body = _req(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
                      {"daemon_address": "127.0.0.2", "daemon_port": 9300})
    assert code == 200 and body == dataclasses.asdict(session.device_sets[0].source)
    assert (body["daemon_address"], body["daemon_port"]) == ("127.0.0.2", 9300)
    assert _req(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
                {"daemon_port": "9300"})[0] == 400
    code, body = _req(base, "/sdrangel/deviceset/1/device", "PUT", {"hwType": "daemonsink"})
    assert code == 200 and body["kind"] == "daemonsink"
    code, body = _req(base, "/sdrangel/deviceset/1/device/settings", "PATCH",
                      {"daemon_address": "127.0.0.3", "daemon_port": 9301, "daemon_fec": 16,
                       "daemon_auto_fec": True})
    assert code == 200 and body == dataclasses.asdict(session.device_sets[1].sink)
    assert _req(base, "/sdrangel/deviceset/1/device/settings", "PATCH",
                {"daemon_auto_fec": 1})[0] == 400
    _, doc = _req(base, "/sdrangel/openapi")
    schemas = doc["components"]["schemas"]
    assert {"daemon_address", "daemon_port"} <= set(schemas["SourceSettings"]["properties"])
    assert "daemonsource" in schemas["SourceSettings"]["properties"]["kind"]["enum"]
    assert {"daemon_address", "daemon_port", "daemon_fec", "daemon_auto_fec"} <= set(
        schemas["SinkSettings"]["properties"])
    assert "daemonFrames" in schemas["DeviceReport"]["properties"]


def test_datv_and_the_daemon_source_over_http(api, tmp_path):
    """A DVB-S capture (tests/test_torch_datv.py) reaches a DATV channel in
    continuous mode through a daemon source fed superframes by a port
    DaemonSender: the report's "datv" carries the decode (rounds, packets,
    no RS failure, programme 7's H.264 stream) as the session holds it, the
    data route carries soft_i/soft_q as the channel's newest block, and the
    device report the daemon source's frame counts."""
    from sdrangel_tpu_torch.io import daemon
    from test_torch_datv import _datv_capture

    base, session = api
    mm = sdriq.open_mmap(_datv_capture(tmp_path, "1/2"))[1]
    _req(base, "/sdrangel/devicesets", "POST")
    assert _req(base, "/sdrangel/deviceset/0/device", "PUT", {"hwType": "daemonsource"})[0] == 200
    assert _req(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
                {"daemon_port": 0, "sample_rate": 1_000_000.0, "run_blocks": 4})[0] == 200
    code, body = _req(base, "/sdrangel/deviceset/0/channel", "POST",
                      {"channelType": "sdrangel.channel.demoddatv", "symbol_rate": 250_000.0,
                       "datvContinuous": True})
    assert code == 201, body
    assert _req(base, "/sdrangel/deviceset/0/device/run", "POST")[0] == 200
    ds = session.device_sets[0]
    src = _poll(lambda: ds._daemon)
    tx = daemon.DaemonSender("127.0.0.1", src.rx.port, n_fec=4, sample_rate=1_000_000)
    try:
        room = tx.payload_room // 4
        for k in range(-(-mm.shape[0] // room)):
            tx.send_iq(np.ascontiguousarray(mm[k * room:(k + 1) * room]))
            time.sleep(0.002)
        _wait_idle(session)
    finally:
        tx.close()
    ch = ds.channels[0]
    _, rep = _req(base, "/sdrangel/deviceset/0/channel/0/report")
    assert rep["dataBlocks"] == 4 and rep["dataKeys"] == ["soft_i", "soft_q"]
    assert rep["datv"] == ch.host_report["datv"]
    datv = rep["datv"]
    assert datv["rounds"] == 1 and datv["packets"] > 20 and datv["rsFailed"] == 0, datv
    progs = {p["program"]: p for p in datv["ts"]["programs"]}
    assert progs[7]["streams"][0]["codec"] == "H.264 video"
    code, body = _req(base, "/sdrangel/deviceset/0/channel/0/data")
    assert code == 200 and body["dataBlocks"] == 4
    for k in ("soft_i", "soft_q"):
        assert body["data"][k] == _trimmed(ch.latest_data[k])
    _, dev = _req(base, "/sdrangel/deviceset/0/device/report")
    assert dev["daemonFrames"]["framesOk"] > 0 and dev["daemonFrames"]["framesFailed"] == 0


def test_modatv_is_no_tx_kind_as_in_jax(api):
    """sdrangel.channeltx.modatv: the JAX package has an ATV modulator as
    library code and no Tx kind for it, so its sessions and TxPipeline raise
    KeyError and its server answers 404, on an Rx set and on a Tx set; the
    port answers the same (it raised NotImplementedError before its ATV
    modulator was ported)."""
    from sdrangel_tpu.api.server import make_server as jax_make_server
    from sdrangel_tpu.runtime import tx as jtx
    from sdrangel_tpu.runtime.session import Session as JaxSession
    from sdrangel_tpu_torch.runtime import tx as ptx

    modatv = "sdrangel.channeltx.modatv"
    base, session = api
    jax_session = JaxSession()
    jsrv = jax_make_server(jax_session, "127.0.0.1", 0)
    threading.Thread(target=jsrv.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    jbase = f"http://127.0.0.1:{jsrv.server_address[1]}"
    try:
        for s in (session, jax_session):
            for direction in ("rx", "tx"):
                with pytest.raises(KeyError):
                    s.add_device_set(direction).add_channel(modatv)
        for b in (base, jbase):
            for i in (0, 1):  # the Rx set, the Tx set
                code, _ = _req(b, f"/sdrangel/deviceset/{i}/channel", "POST",
                               {"channelType": modatv})
                assert code == 404
        assert all(not ds.channels for ds in session.device_sets)
    finally:
        jax_session.shutdown()
        jsrv.shutdown()
        jsrv.server_close()
    with pytest.raises(KeyError):
        ptx.TxPipeline(ptx.TxDeviceConfig(96_000.0), [ptx.TxChannelSpec(modatv, 0.0, {})],
                       device=CPU)
    with pytest.raises(KeyError):
        jtx.TxPipeline(jtx.TxDeviceConfig(96_000.0), [jtx.TxChannelSpec(modatv, 0.0, {})])
    from sdrangel_tpu_torch.channels import registry as preg

    with pytest.raises(KeyError):
        preg.check_kind(modatv, "tx")


# -- Tx device sets (tests/test_api.py:192, :356, :1016, :1268) ----------------------------

NFM_MOD = "sdrangel.channeltx.modnfm"


def _run_tx_set(base, session, index, n_blocks):
    code, _ = _req(base, f"/sdrangel/deviceset/{index}/device/run", "POST")
    assert code == 200
    _poll(lambda: _req(base, f"/sdrangel/deviceset/{index}/device/report")[1][
        "blocksProcessed"] >= n_blocks)
    code, body = _req(base, f"/sdrangel/deviceset/{index}/device/run", "DELETE")
    assert code == 200 and body["state"] == "idle"
    return _wait_idle(session, index)


def test_tx_device_set_flow(api, tmp_path):
    """A Tx set over HTTP: the NFM modulator at +30 kHz records a .sdriq
    whose carrier sits at the offset; the device report is the sink's."""
    base, session = api
    code, body = _req(base, "/sdrangel/devicesets", "POST", {"direction": "tx"})
    assert code == 201 and body == {"index": 0, "direction": "tx"}
    out_path = str(tmp_path / "tx.sdriq")
    code, body = _req(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
                      {"file_path": out_path, "sample_rate": 192000.0})
    assert code == 200 and body["file_path"] == out_path and body["kind"] == "filesink"
    assert _req(base, "/sdrangel/deviceset/0/device/settings")[1]["sample_rate"] == 192000.0
    code, _ = _req(base, "/sdrangel/deviceset/0/channel", "POST",
                   {"channelType": NFM_MOD, "inputFrequencyOffset": 30000.0,
                    "toneFrequency": 800.0})
    assert code == 201
    _run_tx_set(base, session, 0, 3)
    code, report = _req(base, "/sdrangel/deviceset/0/device/report")
    assert report["state"] == "idle" and report["sampleRate"] == 192000.0
    assert report["blocksProcessed"] >= 3 and report["realtimeFactor"] > 0
    code, channel = _req(base, "/sdrangel/deviceset/0/channel/0/report")
    assert channel["audioSamples"] == 4096 * report["blocksProcessed"]
    info = sdriq.read_header(out_path)
    assert info.sample_rate == 192000
    _, mm = sdriq.open_mmap(out_path)
    iq = sdriq.to_complex64(sdriq.read_block(mm, 0, min(info.n_samples, 1 << 16), wrap=False))
    spec = np.abs(np.fft.fft(iq[4096:] * np.hanning(len(iq) - 4096)))
    freqs = np.fft.fftfreq(len(iq) - 4096, 1.0 / 192000.0)
    assert abs(freqs[spec.argmax()] - 30000.0) < 6000.0


def test_preset_with_tx_set(api):
    """Presets keep mixed Rx and Tx sets, direction-aware."""
    base, _ = api
    _req(base, "/sdrangel/devicesets", "POST", {})
    _req(base, "/sdrangel/devicesets", "POST", {"direction": "tx"})
    _req(base, "/sdrangel/deviceset/1/device/settings", "PATCH", {"log2_interp": 2})
    _req(base, "/sdrangel/deviceset/1/channel", "POST",
         {"channelType": "sdrangel.channeltx.modam", "inputFrequencyOffset": 12000.0})
    assert _req(base, "/sdrangel/preset", "POST", {"groupName": "g", "name": "tx"})[0] == 200
    _req(base, "/sdrangel/devicesets", "DELETE")
    _req(base, "/sdrangel/devicesets", "DELETE")
    assert _req(base, "/sdrangel/preset/load", "POST", {"groupName": "g", "name": "tx"})[0] == 200
    code, body = _req(base, "/sdrangel")
    sets = body["devicesetlist"]["deviceSets"]
    assert [d["direction"] for d in sets] == ["rx", "tx"]
    assert sets[1]["channels"][0]["inputFrequencyOffset"] == 12000.0
    assert sets[1]["source"]["log2_interp"] == 2


def test_singular_deviceset_tx_query(api):
    base, session = api
    code, body = _req(base, "/sdrangel/deviceset?tx=1", "POST")
    assert code == 201 and body["direction"] == "tx"
    code, body = _req(base, "/sdrangel/deviceset/0")
    assert body["direction"] == "tx" and body["source"]["kind"] == "filesink"
    code, body = _req(base, "/sdrangel/deviceset/0/device", "PUT", {"hwType": "daemonsink"})
    assert code == 200 and body["kind"] == "daemonsink"
    code, body = _req(base, "/sdrangel/deviceset", "DELETE")
    assert code == 200 and body["devicesetcount"] == 0


def test_tx_session_keys_stripped_and_empty_tx_refuses(api):
    """A Tx set without channels fails its run with a clear message; a
    session key on a modulator is accepted and harmless; the Rx audio
    endpoint on a Tx set is a 400; an Rx kind on a Tx set a 404."""
    base, session = api
    _req(base, "/sdrangel/devicesets", "POST", {"direction": "tx"})
    _req(base, "/sdrangel/deviceset/0/device/run", "POST")
    rep = _poll(lambda: (r := _req(base, "/sdrangel/deviceset/0")[1])["error"] and r)
    assert "no channels" in rep["error"]
    _req(base, "/sdrangel/deviceset/0/device/run", "DELETE")
    code, _ = _req(base, "/sdrangel/deviceset/0/channel", "POST",
                   {"channelType": NFM_MOD, "audioFile": "unused.wav"})
    assert code == 201
    code, body = _req(base, "/sdrangel/deviceset/0/channel/0/audio")
    assert code == 400 and "tx" in body["message"]
    code, _ = _req(base, "/sdrangel/deviceset/0/channel", "POST", {"channelType": NFM})
    assert code == 404


# -- presets, config, commands ------------------------------------------------------------


def test_presets_roundtrip_and_delete(api):
    base, session = api
    _req(base, "/sdrangel/devicesets", "POST")
    _req(base, "/sdrangel/deviceset/0/channel", "POST",
         {"channelType": "sdrangel.channel.amdemod", "inputFrequencyOffset": -5000.0})
    code, _ = _req(base, "/sdrangel/preset", "POST", {"groupName": "test", "name": "one"})
    assert code == 200
    assert _req(base, "/sdrangel/presets")[1]["presets"] == ["test/one"]
    _req(base, "/sdrangel/devicesets", "DELETE")
    code, _ = _req(base, "/sdrangel/preset/load", "POST", {"groupName": "test", "name": "one"})
    assert code == 200
    code, body = _req(base, "/sdrangel/deviceset/0/channel/0/settings")
    assert body["channelType"] == "sdrangel.channel.amdemod"
    assert body["inputFrequencyOffset"] == -5000.0
    code, body = _req(base, "/sdrangel/preset/test/one", "DELETE")
    assert code == 200 and body["presets"] == []
    assert _req(base, "/sdrangel/preset/test/one", "DELETE")[0] == 404


def test_preset_persistence_and_migration(tmp_path):
    path = str(tmp_path / "presets.json")
    s1 = Session(preset_path=path, device=CPU)
    s1.add_device_set().add_channel("sdrangel.channel.amdemod")
    s1.save_preset("g", "p")
    s2 = Session(preset_path=path, device=CPU)
    s2.load_preset("g", "p")
    assert s2.device_sets[0].channels[0].uri == "sdrangel.channel.amdemod"

    v1 = {"group": "g", "name": "old", "deviceSets": [{
        "source": {"kind": "testsource", "sample_rate": 96000.0, "a_removed_field": 42},
        "channels": [{"uri": NFM, "inputFrequencyOffset": 1000.0,
                      "settings": {"squelch_db": -50.0, "renamed_old_knob": True}}]}]}
    future = {"schema": PRESET_SCHEMA_VERSION + 7, "deviceSets": []}
    with open(path, "w") as f:
        json.dump({"g/old": v1, "g/future": future}, f)
    s = Session(preset_path=path, device=CPU)  # one newer entry does not stop it
    assert s.presets["g/old"]["schema"] == PRESET_SCHEMA_VERSION
    s.load_preset("g", "old")
    ds = s.device_sets[0]
    assert ds.source.sample_rate == 96000.0
    assert ds.channels[0].settings == {"squelch_db": -50.0}
    assert ds.channels[0].frequency_offset == 1000.0
    with pytest.raises(ValueError, match="newer"):
        s.load_preset("g", "future")
    with pytest.raises(ValueError, match="newer"):
        migrate_preset({"schema": PRESET_SCHEMA_VERSION + 1, "deviceSets": []})
    s.save_preset("g", "new")
    with open(path) as f:
        persisted = json.load(f)
    assert persisted["g/future"]["schema"] == PRESET_SCHEMA_VERSION + 7
    assert persisted["g/new"]["schema"] == PRESET_SCHEMA_VERSION


def test_preset_not_mutated_by_later_patch():
    s = Session(device=CPU)
    ds = s.add_device_set()
    ds.add_channel(NFM, {"volume": 1.0})
    s.save_preset("g", "snap")
    ds.update_channel(0, {"volume": 5.0})
    assert s.presets["g/snap"]["deviceSets"][0]["channels"][0]["settings"]["volume"] == 1.0


def test_preset_file_roundtrip(api, tmp_path):
    base, session = api
    _req(base, "/sdrangel/devicesets", "POST")
    _req(base, "/sdrangel/deviceset/0/device/settings", "PATCH",
         {"kind": "testsource", "sample_rate": 384000.0})
    _req(base, "/sdrangel/deviceset/0/channel", "POST",
         {"channelType": "sdrangel.channel.amdemod", "inputFrequencyOffset": 12000.0})
    _req(base, "/sdrangel/preset", "POST", {"groupName": "g", "name": "p1"})
    session.preset_dir = str(tmp_path)
    path = str(tmp_path / "p1.json")
    code, body = _req(base, "/sdrangel/preset/file", "POST",
                      {"groupName": "g", "name": "p1", "filePath": path})
    assert code == 200 and body["exported"] == path
    for escape in ("/tmp/outside_preset_dir.json", "../escape.json"):
        code, _ = _req(base, "/sdrangel/preset/file", "POST",
                       {"groupName": "g", "name": "p1", "filePath": escape})
        assert code == 400
    session.presets.clear()
    code, body = _req(base, "/sdrangel/preset/file", "PUT", {"filePath": path})
    assert code == 200 and body["imported"] == "g/p1"
    _req(base, "/sdrangel/preset/load", "POST", {"groupName": "g", "name": "p1"})
    code, body = _req(base, "/sdrangel/deviceset/0/channel/0/settings")
    assert body["channelType"] == "sdrangel.channel.amdemod"
    assert session.device_sets[0].source.sample_rate == 384000.0
    assert _req(base, "/sdrangel/preset/file", "POST", {"name": "p1"})[0] == 400
    assert _req(base, "/sdrangel/preset/file", "PUT",
                {"filePath": str(tmp_path / "missing.json")})[0] == 404


def test_instance_config_roundtrip(api):
    base, _ = api
    _req(base, "/sdrangel/devicesets", "POST")
    _req(base, "/sdrangel/deviceset/0/device/settings", "PATCH", {"sample_rate": 384000.0})
    _req(base, "/sdrangel/deviceset/0/channel", "POST",
         {"channelType": NFM, "inputFrequencyOffset": 10000.0})
    code, config = _req(base, "/sdrangel/config")
    assert code == 200 and len(config["deviceSets"]) == 1
    _req(base, "/sdrangel/devicesets", "DELETE")
    assert _req(base, "/sdrangel/devicesets")[1]["devicesetcount"] == 0
    code, _ = _req(base, "/sdrangel/config", "PUT", config)
    assert code == 200
    code, body = _req(base, "/sdrangel/deviceset/0/channel/0/settings")
    assert code == 200 and body["channelType"] == NFM
    assert _req(base, "/sdrangel/config", "PUT", {"bogus": 1})[0] == 400


def test_commands_api(api):
    base, _ = api
    code, _ = _req(base, "/sdrangel/command", "POST",
                   {"name": "whoru", "command": "echo", "args": "api at %1"})
    assert code == 201
    assert _req(base, "/sdrangel/commands")[1]["commands"] == ["whoru"]
    code, body = _req(base, "/sdrangel/command/whoru/run", "POST")
    assert code == 200 and body["returncode"] == 0 and "api at 127.0.0.1:" in body["stdout"]
    assert _req(base, "/sdrangel/command/whoru")[1]["command"] == "echo"
    code, body = _req(base, "/sdrangel/command/whoru", "DELETE")
    assert code == 200 and body["commands"] == []
    assert _req(base, "/sdrangel/command/whoru")[0] == 404


# -- instance-level endpoints ---------------------------------------------------------------


def test_logging_idempotent_and_rotating(api, tmp_path, monkeypatch):
    import logging
    from logging.handlers import RotatingFileHandler

    base, _ = api
    monkeypatch.setenv("SDRANGEL_TPU_FILES_DIR", str(tmp_path))
    assert _req(base, "/sdrangel/logging", "PUT",
                {"consoleLevel": "INFO", "fileName": "/etc/hosts"})[0] == 400
    root = logging.getLogger()
    before = len(root.handlers)
    for name in ("a.log", "b.log"):
        assert _req(base, "/sdrangel/logging", "PUT",
                    {"consoleLevel": "WARNING", "fileName": str(tmp_path / name)})[0] == 200
    assert len(root.handlers) == before + 1
    fh = [h for h in root.handlers if isinstance(h, RotatingFileHandler)]
    assert len(fh) == 1 and fh[0].baseFilename == str(tmp_path / "b.log")
    body = _req(base, "/sdrangel/logging")[1]
    assert body["consoleLevel"] == "WARNING" and body["fileName"] == str(tmp_path / "b.log")
    assert _req(base, "/sdrangel/logging", "PUT", {"consoleLevel": "NOPE"})[0] == 400
    assert _req(base, "/sdrangel/logging", "PUT", {"consoleLevel": "INFO", "fileName": ""})[0] == 200
    assert not [h for h in root.handlers if isinstance(h, RotatingFileHandler)]


def test_audio_location_dvserial_endpoints(api):
    base, _ = api
    code, body = _req(base, "/sdrangel/audio")
    assert code == 200 and body["nbOutputDevices"] == 0 and body["audioSampleRate"] == 48000
    assert _req(base, "/sdrangel/audio", "PATCH", {"udpPort": 7000})[1]["udpPort"] == 7000
    assert _req(base, "/sdrangel/audio", "PATCH", {"nope": 1})[0] == 400
    code, body = _req(base, "/sdrangel/audio/output/parameters", "PATCH",
                      {"udpAddress": "10.0.0.1", "copyToUDP": 1})
    assert code == 200 and _req(base, "/sdrangel/audio")[1]["outputParameters"]["copyToUDP"] == 1
    assert _req(base, "/sdrangel/audio/input/parameters", "PATCH", {"bogus": 1})[0] == 400
    code, body = _req(base, "/sdrangel/audio/output/parameters", "DELETE")
    assert code == 200 and body["udpAddress"] == "127.0.0.1"
    assert "input" in _req(base, "/sdrangel/audio/input/cleanup", "PATCH", {})[1]["message"]
    assert _req(base, "/sdrangel/location", "PUT",
                {"latitude": 48.86, "longitude": 2.35})[0] == 200
    assert _req(base, "/sdrangel/location")[1] == {"latitude": 48.86, "longitude": 2.35}
    assert _req(base, "/sdrangel/location", "PUT", {"latitude": 123.0})[0] == 400
    assert _req(base, "/sdrangel/dvserial")[1]["nbDevices"] == 0
    assert _req(base, "/sdrangel/dvserial?dvserial=1", "PATCH", {})[1]["dvSerialSupport"] == 1


def test_singular_deviceset_focus_select_and_instance_delete(api):
    base, session = api
    code, body = _req(base, "/sdrangel/deviceset", "POST")
    assert code == 201 and body["direction"] == "rx"
    code, body = _req(base, "/sdrangel/deviceset/0/focus", "PATCH", {})
    assert code == 400 and "server instance" in body["message"]
    code, body = _req(base, "/sdrangel/deviceset/0/device", "PUT", {"hwType": "filesource"})
    assert code == 200 and body["kind"] == "filesource"
    assert _req(base, "/sdrangel/deviceset/0/device", "PUT", {})[0] == 400
    code, body = _req(base, "/sdrangel", "DELETE")
    assert code == 202 and not session.device_sets[0].running
    code, body = _req(base, "/sdrangel/deviceset", "DELETE")
    assert code == 200 and body["devicesetcount"] == 0


def test_profile_endpoint(api, tmp_path, monkeypatch):
    """POST /sdrangel/profile writes a torch.profiler Chrome trace holding the
    running worker's operations; paths stay inside SDRANGEL_TPU_FILES_DIR."""
    monkeypatch.setenv("SDRANGEL_TPU_FILES_DIR", str(tmp_path))
    base, session = api
    _fm_set(base, source={"throttle": True})
    _req(base, "/sdrangel/deviceset/0/device/run", "POST")
    _poll(lambda: session.device_sets[0].blocks_processed > 0)
    out = str(tmp_path / "trace")
    code, body = _req(base, "/sdrangel/profile", "POST", {"seconds": 0.5, "path": out})
    _req(base, "/sdrangel/deviceset/0/device/run", "DELETE")
    assert code == 200 and body["trace"] == out
    with open(body["file"]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
    assert _req(base, "/sdrangel/profile", "POST", {"path": "/etc/x"})[0] == 400


def test_profile_endpoint_returns_the_port_spans(api, tmp_path, monkeypatch):
    """POST /sdrangel/profile also returns the spans and counters the port
    tallied over the traced seconds: the Rx step's layers and the worker's
    read and publish, from the running set's thread."""
    monkeypatch.setenv("SDRANGEL_TPU_FILES_DIR", str(tmp_path))
    base, session = api
    _fm_set(base)
    _req(base, "/sdrangel/deviceset/0/device/run", "POST")
    _poll(lambda: session.device_sets[0].blocks_processed > 0)
    code, body = _req(base, "/sdrangel/profile", "POST",
                      {"seconds": 1.0, "path": str(tmp_path / "trace")})
    _req(base, "/sdrangel/deviceset/0/device/run", "DELETE")
    assert code == 200
    names = {*engine.LAYERS, session_mod.READ, session_mod.PUBLISH}
    assert names <= set(body["spans"]), sorted(body["spans"])
    for name in names:
        assert body["spans"][name]["calls"] > 0 and body["spans"][name]["seconds"] > 0
    assert isinstance(body["counters"], dict)


# -- the OpenAPI document against the routes (tests/test_openapi.py) ----------------------


def _normalize(path):
    path = re.sub(r"\{[^}]+\}", "*", path)
    return path.replace(r"(\d+)", "*").replace(r"([\w-]+)", "*")


def _served_routes():
    src = inspect.getsource(server)
    routes = {_normalize(m.group(1))
              for m in re.finditer(r're\.compile\(r"\^(/sdrangel[^"]*?)\$"\)', src)}
    routes |= {_normalize(m.group(1)) for m in re.finditer(r'p\s*==\s*"(/sdrangel[^"]*)"', src)}
    for m in re.finditer(r"p\s+in\s+\(([^)]*)\)", src):
        routes |= {_normalize(lit) for lit in re.findall(r'"(/sdrangel[^"]*)"', m.group(1))}
    assert len(routes) > 20, "route extraction regressed"
    return routes


def test_every_served_route_is_documented():
    missing = _served_routes() - {_normalize(p) for p in openapi.PATHS}
    assert not missing, f"served but not documented: {sorted(missing)}"


def test_every_documented_path_is_served():
    phantom = {_normalize(p) for p in openapi.PATHS} - _served_routes()
    assert not phantom, f"documented but not served: {sorted(phantom)}"


def test_document_schemas(api):
    base, _ = api
    code, doc = _req(base, "/sdrangel/openapi")
    assert code == 200 and doc["openapi"].startswith("3.")
    schemas = doc["components"]["schemas"]
    for uri in CONFIG_CLASSES:
        name = uri.rsplit(".", 1)[-1]
        assert schemas[f"ChannelSettings_{name}"]["x-channel-uri"] == uri
        assert schemas[f"ChannelSettings_{name}"]["properties"]
        assert f"ChannelReport_{name}" in schemas
    for path, ops in doc["paths"].items():
        for verb, op in ops.items():
            for resp in op.get("responses", {}).values():
                ref = resp["content"]["application/json"]["schema"]["$ref"]
                assert ref.rsplit("/", 1)[-1] in schemas, (path, verb, ref)
    report = schemas["DeviceReport"]["properties"]
    assert {"realtimeFactor", "elapsedSeconds", "blocksProcessed"} <= set(report)
