"""REST API server — the swagger-path-compatible control plane of the port.

Reference: sdrbase/webapi/webapirequestmapper.cpp:62-160 routes the URL table
of webapiadapterinterface.h:646-672; the server implementation is
sdrsrv/webapi/webapiadaptersrv.cpp. This is a stdlib ThreadingHTTPServer
with the JAX package's path layout (a subset of the reference's):

  GET  /sdrangel                                  instance summary
  GET  /sdrangel/devicesets                       device-set list
  POST /sdrangel/devicesets                       add a device set
  DELETE /sdrangel/devicesets                     remove last device set
  GET  /sdrangel/deviceset/{i}                    one device set
  GET/PUT/PATCH /sdrangel/deviceset/{i}/device/settings
  POST/DELETE   /sdrangel/deviceset/{i}/device/run     start/stop acquisition
  POST          /sdrangel/deviceset/{i}/channel        add channel {channelType,...}
  DELETE        /sdrangel/deviceset/{i}/channel/{j}
  GET/PUT/PATCH /sdrangel/deviceset/{i}/channel/{j}/settings
  GET           /sdrangel/deviceset/{i}/channel/{j}/report
  GET           /sdrangel/deviceset/{i}/channel/{j}/data   a data channel's newest block
  GET/POST/DELETE /sdrangel/presets  (+ /preset load/save/delete/file)
  GET/PUT       /sdrangel/config                  whole-instance config
  GET/PATCH     /sdrangel/audio                   egress list + prefs
  GET/PUT       /sdrangel/logging                 level + rotated log file

A device set is Rx (a source and its demods) or Tx (a sink and its
modulators: POST /sdrangel/devicesets {"direction": "tx"}, or
/sdrangel/deviceset?tx=1); the device settings and report of a Tx set are
its sink's.

Errors: a malformed request or setting is a 400, an unknown index or key a
404. An unknown channel kind is a 404, the Tx kind sdrangel.channeltx.modatv
included, as the JAX server answers. The sharded source's settings
(`sharded`, `mesh_*`, `sharded_*`) apply as any other device setting.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..channels import registry
from ..runtime import tracing
from ..runtime.session import SOURCE_KINDS, Session, device_settings

logger = logging.getLogger("sdrangel_tpu_torch.api")

_DEVICESET = re.compile(r"^/sdrangel/deviceset/(\d+)$")
_DEVICE_SETTINGS = re.compile(r"^/sdrangel/deviceset/(\d+)/device/settings$")
_DEVICE_RUN = re.compile(r"^/sdrangel/deviceset/(\d+)/device/run$")
_DEVICE_REPORT = re.compile(r"^/sdrangel/deviceset/(\d+)/device/report$")
_SPECTRUM = re.compile(r"^/sdrangel/deviceset/(\d+)/spectrum$")
_WATERFALL = re.compile(r"^/sdrangel/deviceset/(\d+)/spectrum/waterfall$")
_HISTOGRAM = re.compile(r"^/sdrangel/deviceset/(\d+)/spectrum/histogram$")
_SCOPE = re.compile(r"^/sdrangel/deviceset/(\d+)/scope$")
_CHANNEL = re.compile(r"^/sdrangel/deviceset/(\d+)/channel$")
_COMMAND_RUN = re.compile(r"^/sdrangel/command/([\w-]+)/run$")
_COMMAND_DETAILS = re.compile(r"^/sdrangel/command/([\w-]+)$")
_PRESET_KEY = re.compile(r"^/sdrangel/preset/([\w-]+)/([\w-]+)$")

#: instance audio preferences (AudioDeviceManager prefs role,
#: audiodevicemanager.h:34-137 — headless: rate + default UDP copy target)
_AUDIO_DEFAULTS = {"audioSampleRate": 48000, "udpAddress": "127.0.0.1",
                   "udpPort": 9998}
#: per-direction device parameters (instanceAudio{Input,Output}ParametersPatch
#: role — headless: stored prefs applied as defaults to new channel egress)
_AUDIO_INPUT_DEFAULTS = {"sampleRate": 48000, "volume": 1.0}
_AUDIO_OUTPUT_DEFAULTS = {"sampleRate": 48000, "udpAddress": "127.0.0.1",
                          "udpPort": 9998, "copyToUDP": 0, "udpUsesRTP": 0}
_CHANNELS_REPORT = re.compile(r"^/sdrangel/deviceset/(\d+)/channels/report$")
_DEVICE_SELECT = re.compile(r"^/sdrangel/deviceset/(\d+)/device$")
_FOCUS = re.compile(r"^/sdrangel/deviceset/(\d+)/focus$")
_CHANNEL_IDX = re.compile(r"^/sdrangel/deviceset/(\d+)/channel/(\d+)$")
_CHANNEL_SETTINGS = re.compile(r"^/sdrangel/deviceset/(\d+)/channel/(\d+)/settings$")
_CHANNEL_REPORT = re.compile(r"^/sdrangel/deviceset/(\d+)/channel/(\d+)/report$")
_CHANNEL_AUDIO = re.compile(r"^/sdrangel/deviceset/(\d+)/channel/(\d+)/audio$")
_CHANNEL_DATA = re.compile(r"^/sdrangel/deviceset/(\d+)/channel/(\d+)/data$")


def _daemon_report(ds) -> dict:
    """An Rx set's daemon-source link statistics (the reference's
    SDRdaemonSource status: sdrdaemonsourcebuffer.h:100-115), once it has
    run one."""
    stats = getattr(ds, "daemon_stats", None)
    if stats is None:
        return {}
    return {"daemonFrames": {"framesOk": stats.frames_ok, "framesFailed": stats.frames_failed,
                             "blocksReceived": stats.blocks_received,
                             "blocksRecovered": stats.blocks_recovered}}


class _BadRequest(Exception):
    """Client error in the request body (mapped to HTTP 400)."""


#: one profiler trace at a time; also serializes the logging handler swap
_PROFILE_LOCK = threading.Lock()

#: singleton log-file handler (idempotent PUT /sdrangel/logging)
_LOG_FILE: dict = {"handler": None, "name": None}


class ApiHandler(BaseHTTPRequestHandler):
    session: Session  # injected by make_server
    auth_token: str | None = None  # optional bearer token (make_server)

    # -- helpers -----------------------------------------------------------

    def _authorized(self) -> bool:
        """Optional bearer-token auth. The reference binds localhost only
        (mainparser.cpp default) and has no auth; same default here, but a
        token hardens non-local binds: --api-token / SDRANGEL_TPU_API_TOKEN."""
        if not self.auth_token:
            return True
        import hmac

        got = self.headers.get("Authorization", "")
        if hmac.compare_digest(got, f"Bearer {self.auth_token}"):
            return True
        self._error(401, "missing or invalid bearer token")
        return False

    def _json(self, code: int, payload) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0) or 0)
        if not length:
            return {}
        try:
            body = json.loads(self.rfile.read(length))
        except json.JSONDecodeError as e:
            raise _BadRequest(f"malformed JSON body: {e}") from e
        if not isinstance(body, dict):
            raise _BadRequest("JSON body must be an object")
        return body

    def _error(self, code: int, message: str) -> None:
        self._json(code, {"message": message})

    def _path(self) -> str:
        """Path with any query string split off into self.query."""
        from urllib.parse import parse_qs

        p, _, q = self.path.partition("?")
        self.query = parse_qs(q)
        return p.rstrip("/") or "/"

    def _qflag(self, name: str) -> bool:
        v = self.query.get(name, ["0"])[-1].lower()
        return v in ("1", "true", "yes")

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug("%s " + fmt, self.address_string(), *args)

    # -- dispatch ----------------------------------------------------------

    def do_GET(self):
        if not self._authorized():
            return None
        s = self.session
        p = self._path()
        try:
            if p == "/sdrangel":
                return self._json(200, s.summary())
            if p == "/sdrangel/devicesets":
                return self._json(200, s.summary()["devicesetlist"])
            if m := _DEVICESET.match(p):
                ds = s.device_sets[int(m.group(1))]
                return self._json(200, s.summary()["devicesetlist"]["deviceSets"][ds.index])
            if m := _DEVICE_SETTINGS.match(p):
                ds = s.device_sets[int(m.group(1))]
                return self._json(200, dataclasses.asdict(device_settings(ds)))
            if m := _DEVICE_REPORT.match(p):
                # devicesetDeviceReportGet role: live acquisition state
                ds = s.device_sets[int(m.group(1))]
                target = device_settings(ds)
                return self._json(
                    200,
                    {
                        "state": "error" if ds.error else (
                            "running" if ds.running else "idle"),
                        "error": ds.error,
                        "sampleRate": target.sample_rate,
                        "centerFrequency": target.center_frequency,
                        "blocksProcessed": ds.blocks_processed,
                        "realtimeFactor": ds.realtime_factor,
                        "elapsedSeconds": ds.elapsed_s,
                        **_daemon_report(ds),
                    },
                )
            if m := _SCOPE.match(p):
                ds = s.device_sets[int(m.group(1))]
                if ds.scope is None:
                    return self._error(404, "no scope trace yet (device not running)")
                tr = ds.scope
                return self._json(
                    200,
                    {"length": tr.shape[-1],
                     "traces": {
                         "real": [round(float(v), 5) for v in tr[0]],
                         "imag": [round(float(v), 5) for v in tr[1]],
                         "magdb": [round(float(v), 2) for v in tr[2]],
                     }},
                )
            if m := _WATERFALL.match(p):
                # scrolling waterfall rows (GLSpectrum texture role)
                ds = s.device_sets[int(m.group(1))]
                wf = list(ds.waterfall)
                if not wf:
                    return self._error(404, "no spectra yet (device not running)")
                return self._json(
                    200,
                    {"rows": len(wf), "fftSize": len(wf[0]),
                     "waterfall": [[round(float(v), 1) for v in row] for row in wf]},
                )
            if m := _HISTOGRAM.match(p):
                # histogram-with-decay intensity grid (glspectrum.h:135-174)
                ds = s.device_sets[int(m.group(1))]
                h = ds.histogram
                if h is None:
                    return self._error(404, "no histogram yet (device not running)")
                return self._json(
                    200,
                    {"powerBins": h.shape[0], "fftSize": h.shape[1],
                     "dbRange": [-100.0, 0.0],
                     "histogram": h.tolist()},
                )
            if m := _SPECTRUM.match(p):
                ds = s.device_sets[int(m.group(1))]
                if ds.spectrum is None:
                    return self._error(404, "no spectrum yet (device not running)")
                return self._json(
                    200,
                    {"fftSize": len(ds.spectrum),
                     "spectrum": [round(float(v), 2) for v in ds.spectrum]},
                )
            if m := _CHANNEL_SETTINGS.match(p):
                ds = s.device_sets[int(m.group(1))]
                ch = ds.channels[int(m.group(2))]
                return self._json(
                    200,
                    {
                        "channelType": ch.uri,
                        "inputFrequencyOffset": ch.frequency_offset,
                        **ch.settings,
                    },
                )
            if m := _CHANNEL_AUDIO.match(p):
                # demodulated audio as a WAV download (drains the channel's
                # buffered blocks — the AudioFifo egress over HTTP)
                import io as _io
                import wave as _wave

                ds = s.device_sets[int(m.group(1))]
                if ds.direction == "tx":  # a Tx set has no demodulated audio
                    return self._error(400, "audio drain is an Rx channel endpoint; "
                                            "this device set is tx")
                audio = ds.drain_audio(int(m.group(2)))
                buf = _io.BytesIO()
                pcm = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
                if pcm.ndim == 1:
                    pcm = pcm[:, None]
                with _wave.open(buf, "wb") as w:
                    w.setnchannels(pcm.shape[1])
                    w.setsampwidth(2)
                    w.setframerate(48000)
                    w.writeframes(pcm.tobytes())
                body = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return None
            if m := _CHANNEL_REPORT.match(p):
                ds = s.device_sets[int(m.group(1))]
                ch = ds.channels[int(m.group(2))]
                rep = {
                    "channelPowerDB": ch.channel_power_db,
                    "squelch": ch.squelch,
                    "audioSampleRate": ch.audio_sample_rate,
                    "audioSamples": ch.audio_samples,
                }
                if ch.data_blocks:
                    rep["dataBlocks"] = ch.data_blocks
                    rep["dataKeys"] = sorted(ch.latest_data)
                if ch.host_report:
                    rep.update(ch.host_report)
                return self._json(200, rep)
            if m := _CHANNELS_REPORT.match(p):
                # devicesetChannelsReportGet: all channels of a set at once
                ds = s.device_sets[int(m.group(1))]
                reports = []
                for j, ch in enumerate(ds.channels):
                    reports.append({
                        "index": j,
                        "channelType": ch.uri,
                        "inputFrequencyOffset": ch.frequency_offset,
                        "channelPowerDB": ch.channel_power_db,
                        "squelch": ch.squelch,
                        "audioSampleRate": ch.audio_sample_rate,
                        "audioSamples": ch.audio_samples,
                    })
                return self._json(200, {"channelcount": len(reports),
                                        "channels": reports})
            if p == "/sdrangel/dvserial":
                # instanceDVSerialGet: DV dongle enumeration — a headless
                # host has none; the stored flag mirrors setDVSerialSupport
                return self._json(200, {
                    "nbDevices": 0, "dvSerialDevices": [],
                    "dvSerialSupport": int(getattr(s, "dv_serial", False)),
                })
            if m := _CHANNEL_DATA.match(p):
                # the data channels' newest block (chanalyzer, LoRa, DSD,
                # ATV, UDPSrc), arrays tail-trimmed to stay JSON-sized
                ch = s.device_sets[int(m.group(1))].channels[int(m.group(2))]
                if not ch.latest_data:
                    return self._error(404, "no data yet (device not running "
                                            "or not a data channel)")
                out = {}
                for k, v in ch.latest_data.items():
                    if v.ndim == 0:
                        out[k] = round(float(v), 5)
                        continue
                    a = v.reshape(-1) if v.ndim > 2 else v
                    out[k] = np.round(a[..., -2048:], 5).tolist()
                return self._json(200, {"dataBlocks": ch.data_blocks, "data": out})
            if p == "/sdrangel/openapi":
                # OpenAPI 3 document of the implemented path layout +
                # per-kind settings/report schemas, built from the code
                # (api/openapi.py; route<->doc drift is test-enforced)
                from .. import __version__
                from . import openapi

                return self._json(200, openapi.build_document(__version__))
            if p == "/sdrangel/devices":
                return self._json(
                    200,
                    {"devicecount": len(SOURCE_KINDS),
                     "devices": [
                         {"kind": k, "description": d}
                         for k, d in sorted(SOURCE_KINDS.items())
                     ]},
                )
            if p == "/sdrangel/channels":
                kinds = [(uri, "rx") for uri in sorted(registry.REGISTRY)]
                kinds += [(uri, "tx") for uri in sorted(registry.TX_KINDS)]
                return self._json(
                    200,
                    {"channelcount": len(kinds),
                     "sessionKeys": sorted(registry.SESSION_KEYS),
                     "channels": [
                         {"uri": uri, "direction": direction,
                          "settings": registry.settings_schema(uri)}
                         for uri, direction in kinds
                     ]},
                )
            if p == "/sdrangel/audio":
                # instanceAudioGet role: the audio egress (no sound card on
                # a headless host: the "devices" are the channels' WAV files
                # and their UDP and RTP destinations)
                sinks = []
                for ds in s.device_sets:
                    for j, ch in enumerate(ds.channels):
                        for key, kind in (("audioFile", "wav"), ("audioUdp", "udp"),
                                          ("audioRtp", "rtp")):
                            if ch.settings.get(key):
                                sinks.append({"deviceSet": ds.index, "channel": j,
                                              "kind": kind,
                                              "destination": ch.settings[key]})
                return self._json(
                    200, {"nbOutputDevices": len(sinks), "outputs": sinks,
                          "inputParameters": getattr(
                              s, "audio_input_params", _AUDIO_INPUT_DEFAULTS),
                          "outputParameters": getattr(
                              s, "audio_output_params", _AUDIO_OUTPUT_DEFAULTS),
                          **getattr(s, "audio_prefs", _AUDIO_DEFAULTS)}
                )
            if p == "/sdrangel/location":
                return self._json(200, dict(getattr(s, "location", None)
                                            or {"latitude": 0.0, "longitude": 0.0}))
            if p == "/sdrangel/commands":
                return self._json(200, {"commands": sorted(self.session.commands)})
            if m := _COMMAND_DETAILS.match(p):
                # command details (the reference returns the stored Command)
                name = m.group(1)
                return self._json(200, {"name": name, **s.commands[name]})
            if p == "/sdrangel/presets":
                return self._json(
                    200, {"presets": sorted(self.session.presets.keys())}
                )
            if p == "/sdrangel/config":
                # instanceConfigGet: the whole instance state as one document
                return self._json(200, s.config_get())
            if p == "/sdrangel/logging":
                resp = {"consoleLevel": logging.getLevelName(logging.getLogger().level)}
                if _LOG_FILE["handler"] is not None:
                    resp["fileName"] = _LOG_FILE["name"]
                    resp["fileLevel"] = logging.getLevelName(
                        _LOG_FILE["handler"].level
                    )
                return self._json(200, resp)
            return self._error(404, f"unknown path {p}")
        except (IndexError, KeyError) as e:
            return self._error(404, f"not found: {e}")

    def do_POST(self):
        if not self._authorized():
            return None
        s = self.session
        p = self._path()
        try:
            body = self._body()
            if p in ("/sdrangel/devicesets", "/sdrangel/deviceset"):
                # singular path is the reference's (instanceDeviceSetPost,
                # ?tx=1 selects a sink set); the plural is kept as an alias
                direction = body.get(
                    "direction", "tx" if self._qflag("tx") else "rx")
                ds = s.add_device_set(direction)
                return self._json(201, {"index": ds.index, "direction": ds.direction})
            if m := _DEVICE_RUN.match(p):
                ds = s.device_sets[int(m.group(1))]
                ds.start()
                return self._json(200, {"state": "running"})
            if m := _CHANNEL.match(p):
                ds = s.device_sets[int(m.group(1))]
                if "channelType" not in body:
                    raise _BadRequest("missing required field 'channelType'")
                uri = body.pop("channelType")
                idx = ds.add_channel(uri, body)
                return self._json(201, {"index": idx})
            if p == "/sdrangel/command":
                name = body["name"]
                s.set_command(name, body["command"], body.get("args", ""))
                return self._json(201, {"name": name})
            if m := _COMMAND_RUN.match(p):
                import subprocess

                try:
                    result = s.run_command(
                        m.group(1), self.server.server_address[1])
                except subprocess.TimeoutExpired as e:
                    return self._json(
                        504, {"message": f"command timed out after "
                                         f"{e.timeout:g}s and was killed"})
                except OSError as e:
                    return self._json(400, {"message": str(e)})
                return self._json(200, result)
            if p == "/sdrangel/profile":
                # a torch.profiler trace of the running pipelines for
                # `seconds`, written as a Chrome trace (trace.json) under
                # `path`; on the card it holds the device's kernels too.
                # The port's spans and counters over those seconds come back
                # beside it (runtime/tracing.py)
                path = s.server_file_path(body.get("path", "trace"), "profile")
                seconds = max(0.1, min(float(body.get("seconds", 2.0)), 30.0))
                if not _PROFILE_LOCK.acquire(blocking=False):
                    return self._error(409, "a profiler trace is already running")
                try:
                    trace, spans, counters = _profile(s, path, seconds)
                except RuntimeError as e:  # a trace already open elsewhere
                    return self._error(500, f"profiler: {e}")
                finally:
                    _PROFILE_LOCK.release()
                return self._json(200, {
                    "trace": path, "file": trace, "seconds": seconds,
                    "spans": {k: {"calls": c, "seconds": t} for k, (c, t) in spans.items()},
                    "counters": counters})
            if p == "/sdrangel/preset":
                key = body.get("groupName", "default"), body.get("name", "preset")
                s.save_preset(*key)
                return self._json(200, {"saved": "/".join(key)})
            if p == "/sdrangel/preset/load":
                s.load_preset(body.get("groupName", "default"), body.get("name", "preset"))
                return self._json(200, {"loaded": True})
            if p == "/sdrangel/preset/file":
                # export a stored preset to a server-side file
                # (webapiadaptersrv.cpp instancePresetFilePost)
                if "filePath" not in body:
                    raise _BadRequest("missing required field 'filePath'")
                s.export_preset_file(
                    body.get("groupName", "default"), body.get("name", "preset"),
                    body["filePath"], fmt=body.get("format", "json"),
                )
                return self._json(200, {"exported": body["filePath"]})
            return self._error(404, f"unknown path {p}")
        except (_BadRequest, ValueError) as e:
            return self._error(400, str(e))
        except (IndexError, KeyError) as e:
            return self._error(404, f"not found: {e}")

    def do_PUT(self):
        return self._put_patch()

    def do_PATCH(self):
        return self._put_patch()

    def _put_patch(self):
        if not self._authorized():
            return None
        s = self.session
        p = self._path()
        try:
            body = self._body()
            if m := _DEVICE_SETTINGS.match(p):
                # typed validation/coercion — wrong types are a 400 here
                # instead of a deferred engine-thread error (the reference's
                # SWG DTOs reject malformed settings at parse time)
                ds = s.device_sets[int(m.group(1))]
                ds.update_source(body)
                return self._json(200, dataclasses.asdict(device_settings(ds)))
            if m := _FOCUS.match(p):
                # devicesetFocusPatch: GUI-only — exact server-instance parity
                # (webapiadaptersrv.cpp:1004-1011)
                return self._error(400, "Not supported in server instance")
            if m := _DEVICE_SELECT.match(p):
                # devicesetDevicePut: select the device by hwType/kind
                ds = s.device_sets[int(m.group(1))]
                kind = body.get("hwType") or body.get("kind")
                if not kind:
                    raise _BadRequest("missing required field 'hwType'")
                ds.update_source({"kind": kind})
                return self._json(200, dataclasses.asdict(device_settings(ds)))
            if p == "/sdrangel/dvserial":
                # instanceDVSerialPatch (?dvserial=1): store the support flag;
                # a headless host has no dongles, so no scan happens
                s.dv_serial = self._qflag("dvserial") or bool(body.get("dvserial"))
                return self._json(200, {
                    "message": "DV serial support "
                               + ("set" if s.dv_serial else "unset"),
                    "dvSerialSupport": int(s.dv_serial),
                })
            if p in ("/sdrangel/audio/input/parameters",
                     "/sdrangel/audio/output/parameters"):
                direction = "input" if "/input/" in p else "output"
                defaults = (_AUDIO_INPUT_DEFAULTS if direction == "input"
                            else _AUDIO_OUTPUT_DEFAULTS)
                attr = f"audio_{direction}_params"
                params = dict(getattr(s, attr, defaults))
                unknown = set(body) - set(defaults)
                if unknown:
                    raise _BadRequest(
                        f"unknown audio {direction} parameters: {sorted(unknown)}")
                params.update(body)
                setattr(s, attr, params)
                return self._json(200, params)
            if p in ("/sdrangel/audio/input/cleanup",
                     "/sdrangel/audio/output/cleanup"):
                # instanceAudio{Input,Output}CleanupPatch: drop stored prefs
                # for devices that no longer exist — headless equivalent:
                # reset the stored per-direction parameters to defaults
                direction = "input" if "/input/" in p else "output"
                defaults = (_AUDIO_INPUT_DEFAULTS if direction == "input"
                            else _AUDIO_OUTPUT_DEFAULTS)
                had = hasattr(s, f"audio_{direction}_params")
                setattr(s, f"audio_{direction}_params", dict(defaults))
                return self._json(200, {
                    "message": f"unregistered parameters for all {direction} "
                               f"audio devices",
                    "cleaned": int(had),
                })
            if m := _CHANNEL_SETTINGS.match(p):
                ds = s.device_sets[int(m.group(1))]
                j = int(m.group(2))
                body.pop("channelType", None)
                ds.update_channel(j, body)
                ch = ds.channels[j]
                return self._json(
                    200,
                    {"channelType": ch.uri, "inputFrequencyOffset": ch.frequency_offset,
                     **ch.settings},
                )
            if p == "/sdrangel/preset/file":
                # import a preset file into the preset store
                # (webapiadaptersrv.cpp instancePresetFilePut)
                if "filePath" not in body:
                    raise _BadRequest("missing required field 'filePath'")
                try:
                    key = s.import_preset_file(body["filePath"])
                except FileNotFoundError as e:
                    return self._error(404, str(e))
                return self._json(200, {"imported": key})
            if p == "/sdrangel/location":
                # instanceLocationPut role (station lat/long for az/el tools)
                lat = float(body.get("latitude", 0.0))
                lon = float(body.get("longitude", 0.0))
                if not (-90.0 <= lat <= 90.0 and -180.0 <= lon <= 180.0):
                    raise _BadRequest("latitude/longitude out of range")
                s.location = {"latitude": lat, "longitude": lon}
                return self._json(200, s.location)
            if p == "/sdrangel/config":
                # instanceConfigPutPatch: apply a whole-instance config
                s.config_put(body)
                return self._json(200, s.config_get())
            if p == "/sdrangel/audio":
                prefs = dict(getattr(s, "audio_prefs", _AUDIO_DEFAULTS))
                unknown = set(body) - set(_AUDIO_DEFAULTS)
                if unknown:
                    raise _BadRequest(f"unknown audio prefs: {sorted(unknown)}")
                prefs.update(body)
                s.audio_prefs = prefs
                return self._json(200, prefs)
            if p == "/sdrangel/logging":
                # console level + optional rotated log file (LoggerWithFile
                # role, logging/loggerwithfile.h:37-44; REST-adjustable like
                # /sdrangel/logging, swagger.yaml:124-167). Idempotent: the
                # file handler is a singleton — repeated PUTs reconfigure it
                # rather than stacking duplicates.
                level = body.get("consoleLevel", "INFO")
                if not isinstance(logging.getLevelName(level), int):
                    raise _BadRequest(f"unknown log level {level!r}")
                logging.getLogger().setLevel(level)
                resp = {"consoleLevel": level}
                with _PROFILE_LOCK:
                    if "fileName" in body and _LOG_FILE["handler"] is not None:
                        logging.getLogger().removeHandler(_LOG_FILE["handler"])
                        _LOG_FILE["handler"].close()
                        _LOG_FILE["handler"] = None
                        _LOG_FILE["name"] = None
                    if body.get("fileName"):
                        from logging.handlers import RotatingFileHandler

                        # confined (rotation RENAMES the target — an
                        # unconfined path is a destructive primitive)
                        log_path = s.server_file_path(
                            body["fileName"], "logs")
                        fh = RotatingFileHandler(
                            log_path,
                            maxBytes=int(body.get("maxBytes", 10 << 20)),
                            backupCount=int(body.get("backupCount", 3)),
                        )
                        fh.setLevel(body.get("fileLevel", level))
                        logging.getLogger().addHandler(fh)
                        _LOG_FILE["handler"] = fh
                        _LOG_FILE["name"] = log_path
                        resp["fileName"] = log_path
                return self._json(200, resp)
            return self._error(404, f"unknown path {p}")
        except (_BadRequest, ValueError) as e:
            return self._error(400, str(e))
        except (IndexError, KeyError) as e:
            return self._error(404, f"not found: {e}")

    def do_DELETE(self):
        if not self._authorized():
            return None
        s = self.session
        p = self._path()
        try:
            if p == "/sdrangel":
                # instanceDelete: stop the whole instance (202 like the
                # reference, which submits MsgDeleteInstance asynchronously)
                s.shutdown()
                return self._json(202, {
                    "message": "Message to stop the instance was submitted "
                               "successfully"})
            if p in ("/sdrangel/devicesets", "/sdrangel/deviceset"):
                s.remove_last_device_set()
                return self._json(200, {"devicesetcount": len(s.device_sets)})
            if p in ("/sdrangel/audio/input/parameters",
                     "/sdrangel/audio/output/parameters"):
                # instanceAudio{Input,Output}ParametersDelete: back to defaults
                direction = "input" if "/input/" in p else "output"
                defaults = (_AUDIO_INPUT_DEFAULTS if direction == "input"
                            else _AUDIO_OUTPUT_DEFAULTS)
                setattr(s, f"audio_{direction}_params", dict(defaults))
                return self._json(200, dict(defaults))
            if m := _DEVICE_RUN.match(p):
                ds = s.device_sets[int(m.group(1))]
                ds.stop()
                return self._json(200, {"state": "idle"})
            if m := _CHANNEL_IDX.match(p):
                ds = s.device_sets[int(m.group(1))]
                ds.remove_channel(int(m.group(2)))
                return self._json(200, {"channelcount": len(ds.channels)})
            if m := _PRESET_KEY.match(p):
                # instancePresetDelete (webapiadapterinterface.h URL table)
                s.delete_preset(m.group(1), m.group(2))
                return self._json(200, {"presets": sorted(s.presets)})
            if p == "/sdrangel/preset":
                body = self._body()
                s.delete_preset(body.get("groupName", "default"),
                                body.get("name", "preset"))
                return self._json(200, {"presets": sorted(s.presets)})
            if m := _COMMAND_DETAILS.match(p):
                s.delete_command(m.group(1))
                return self._json(200, {"commands": sorted(s.commands)})
            return self._error(404, f"unknown path {p}")
        except (IndexError, KeyError) as e:
            return self._error(404, f"not found: {e}")


def _profile(session: Session, path: str, seconds: float) -> tuple[str, dict, dict]:
    """Record every thread's torch operations (and, on the card, the
    device's kernels) for `seconds`; returns the Chrome trace's file and
    the port's span tallies and counters over those seconds."""
    import os
    import time

    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if session.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    # the device sets' workers run in threads of their own
    config = _ExperimentalConfig(profile_all_threads=True)
    before = tracing.totals()
    with profile(activities=activities, experimental_config=config) as prof:
        time.sleep(seconds)
    spans, counters = tracing.since(before)
    os.makedirs(path, exist_ok=True)
    trace = os.path.join(path, "trace.json")
    prof.export_chrome_trace(trace)
    return trace, spans, counters


def make_server(session: Session, host: str = "127.0.0.1", port: int = 8091,
                auth_token: str | None = None):
    """The default bind is the reference's (mainparser.cpp:25-80); port 0
    takes a free port (`server_address[1]`). auth_token (or
    SDRANGEL_TPU_API_TOKEN) requires `Authorization: Bearer <token>`."""
    import os

    token = auth_token or os.environ.get("SDRANGEL_TPU_API_TOKEN") or None
    handler = type("BoundApiHandler", (ApiHandler,),
                   {"session": session, "auth_token": token})
    return ThreadingHTTPServer((host, port), handler)


def serve_forever(host: str = "127.0.0.1", port: int = 8091, auth_token: str | None = None,
                  device: str = "cuda") -> None:
    """Serve a new Session on `device` until interrupted, then stop its
    device sets."""
    session = Session(device=device)
    srv = make_server(session, host, port, auth_token)
    logger.info("REST API on http://%s:%d/sdrangel (device %s)",
                host, srv.server_address[1], session.device)
    try:
        srv.serve_forever()
    finally:
        session.shutdown()
        srv.server_close()
