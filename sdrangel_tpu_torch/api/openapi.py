"""OpenAPI document of the port's REST surface.

The reference ships a hand-written swagger.yaml and per-plugin yamls
(swagger/sdrangel/api/swagger/swagger.yaml:38-1203 and include/), which rot
unless regenerated. Here the document is built from the code:
- PATHS is the path layout, held against the routes of api/server.py in
  both directions by tests/test_torch_api.py, so a route served but not
  documented, or documented but not served, fails a test;
- each channel kind's settings and report schemas come from the registry,
  the Rx demods' and the Tx modulators';
- the device settings of an Rx set (its source) and of a Tx set (its sink)
  come from the session's dataclasses, the daemon source's and sink's fields
  among them.
"""

from __future__ import annotations

import dataclasses

from ..channels.registry import CONFIG_CLASSES, report_schema, settings_schema
from ..runtime.session import SINK_KINDS, SOURCE_KINDS, SinkSettings, SourceSettings

#: the served path layout (parameters: {i}/{j} device/channel index,
#: {group}/{name} preset key, {name} command name)
PATHS = {
    "/sdrangel": {"get": {"summary": "instance summary"}},
    "/sdrangel/devicesets": {
        "get": {"summary": "device set list"},
        "post": {"summary": "add a device set (body: {direction}: rx, or tx for a sink)"},
        "delete": {"summary": "remove last device set"},
    },
    "/sdrangel/devices": {"get": {"summary": "available source kinds"}},
    "/sdrangel/channels": {"get": {"summary": "available channel types"}},
    "/sdrangel/deviceset/{i}": {"get": {"summary": "one device set"}},
    "/sdrangel/deviceset/{i}/device/settings": {
        "get": {}, "put": {}, "patch": {}},
    "/sdrangel/deviceset/{i}/device/report": {"get": {}},
    "/sdrangel/deviceset/{i}/device/run": {
        "post": {"summary": "start"}, "delete": {"summary": "stop"}},
    "/sdrangel/deviceset/{i}/spectrum": {"get": {}},
    "/sdrangel/deviceset/{i}/spectrum/waterfall": {"get": {}},
    "/sdrangel/deviceset/{i}/spectrum/histogram": {"get": {}},
    "/sdrangel/deviceset/{i}/scope": {"get": {}},
    "/sdrangel/deviceset/{i}/channel": {
        "post": {"summary": "add channel (body: {channelType,...})"}},
    "/sdrangel/deviceset/{i}/channel/{j}": {"delete": {}},
    "/sdrangel/deviceset/{i}/channel/{j}/settings": {
        "get": {}, "put": {}, "patch": {}},
    "/sdrangel/deviceset/{i}/channel/{j}/report": {"get": {}},
    "/sdrangel/deviceset/{i}/channel/{j}/audio": {
        "get": {"summary": "drain demod audio as WAV (an Rx set's; 400 on a Tx set)"}},
    "/sdrangel/deviceset/{i}/channel/{j}/data": {
        "get": {"summary": "latest data-channel block (chanalyzer/LoRa/DSD/ATV/DATV/UDPSrc)"}},
    "/sdrangel/presets": {"get": {}},
    "/sdrangel/preset": {"post": {"summary": "save"}, "delete": {}},
    "/sdrangel/preset/{group}/{name}": {"delete": {}},
    "/sdrangel/preset/load": {"post": {}},
    "/sdrangel/preset/file": {
        "put": {"summary": "import preset from file"},
        "post": {"summary": "export preset to file"}},
    "/sdrangel/config": {
        "get": {"summary": "whole-instance config"},
        "put": {"summary": "apply an instance config"}},
    "/sdrangel/commands": {"get": {"summary": "stored command list"}},
    "/sdrangel/command": {"post": {"summary": "store a command "
                                              "(body: {name, command, args})"}},
    "/sdrangel/command/{name}": {"get": {}, "delete": {}},
    "/sdrangel/command/{name}/run": {"post": {}},
    "/sdrangel/logging": {"get": {}, "put": {}},
    "/sdrangel/audio": {
        "get": {"summary": "audio egress list + prefs"},
        "patch": {"summary": "set audio prefs"}},
    "/sdrangel/location": {"get": {}, "put": {}},
    "/sdrangel/profile": {
        "post": {"summary": "capture a torch.profiler trace "
                            "(body: {seconds, path})"}},
    "/sdrangel/openapi": {"get": {}},
    "/sdrangel/deviceset": {
        "post": {"summary": "add a device set (?tx=1 for a sink)"},
        "delete": {"summary": "remove last device set"}},
    "/sdrangel/deviceset/{i}/device": {
        "put": {"summary": "select device kind (body: {hwType})"}},
    "/sdrangel/deviceset/{i}/focus": {
        "patch": {"summary": "GUI focus — 400 in server instance"}},
    "/sdrangel/deviceset/{i}/channels/report": {
        "get": {"summary": "all channel reports of a set"}},
    "/sdrangel/audio/input/parameters": {"patch": {}, "delete": {}},
    "/sdrangel/audio/output/parameters": {"patch": {}, "delete": {}},
    "/sdrangel/audio/input/cleanup": {"patch": {}},
    "/sdrangel/audio/output/cleanup": {"patch": {}},
    "/sdrangel/dvserial": {"get": {}, "patch": {"summary": "?dvserial=1"}},
}


def _ref(n: str) -> dict:
    return {"$ref": f"#/components/schemas/{n}"}


#: static DTO schemas (the SWG* response-model role)
STATIC_SCHEMAS = {
    "ErrorResponse": {
        "type": "object",
        "properties": {"message": {"type": "string"}},
        "required": ["message"]},
    "InstanceSummary": {
        "type": "object",
        "properties": {
            "version": {"type": "string"},
            "appname": {"type": "string"},
            "torchVersion": {"type": "string"},
            "device": {"type": "string"},
            "uptime_s": {"type": "number"},
            "devicesetlist": _ref("DeviceSetList")}},
    "DeviceSetList": {
        "type": "object",
        "properties": {
            "devicesetcount": {"type": "integer"},
            "deviceSets": {"type": "array", "items": _ref("DeviceSet")}}},
    "DeviceSet": {
        "type": "object",
        "properties": {
            "index": {"type": "integer"},
            "direction": {"type": "string", "enum": ["rx", "tx"]},
            "state": {"type": "string"},
            "error": {"type": "string"},
            "realtimeFactor": {"type": "number"},
            # the sharded all-to-all gear fell back to the all-gather gear
            # after a live retune it could not place (DeviceSet.a2a_fallback)
            "a2aFallback": {"type": "boolean"},
            "channelcount": {"type": "integer"},
            "channels": {"type": "array", "items": _ref("ChannelSummary")}}},
    "ChannelSummary": {
        "type": "object",
        "properties": {
            "index": {"type": "integer"},
            "uri": {"type": "string"},
            "inputFrequencyOffset": {"type": "number"}}},
    "DeviceReport": {
        "type": "object",
        "properties": {
            "state": {"type": "string", "enum": ["idle", "running", "error"]},
            "error": {"type": "string"},
            "sampleRate": {"type": "number"},
            "centerFrequency": {"type": "number"},
            "blocksProcessed": {"type": "integer"},
            # seconds of signal published per wall second since the run's
            # first queued block
            "realtimeFactor": {"type": "number"},
            # wall seconds from the run's first queued block to its latest
            # publish (host clock)
            "elapsedSeconds": {"type": "number"},
            # an Rx set that has run a daemon source: its receiver's counts
            "daemonFrames": {
                "type": "object",
                "properties": {k: {"type": "integer"} for k in (
                    "framesOk", "framesFailed", "blocksReceived", "blocksRecovered")}}}},
    "ChannelReport": {
        "type": "object",
        "properties": {
            "channelPowerDB": {"type": "number"},
            "squelch": {"type": "boolean"},
            "audioSampleRate": {"type": "number"},
            "audioSamples": {"type": "integer"}}},
    "Spectrum": {
        "type": "object",
        "properties": {
            "fftSize": {"type": "integer"},
            "spectrum": {"type": "array", "items": {"type": "number"}}}},
    "AudioDevices": {
        "type": "object",
        "properties": {
            "nbOutputDevices": {"type": "integer"},
            "outputs": {"type": "array", "items": {"type": "object"}},
            "audioSampleRate": {"type": "integer"},
            "inputParameters": {"type": "object"},
            "outputParameters": {"type": "object"}}},
    "LoggingInfo": {
        "type": "object",
        "properties": {
            "consoleLevel": {"type": "string"},
            "fileLevel": {"type": "string"},
            "fileName": {"type": "string"}}},
    "LocationInformation": {
        "type": "object",
        "properties": {"latitude": {"type": "number"},
                       "longitude": {"type": "number"}}},
    "SuccessResponse": {
        "type": "object",
        "properties": {"message": {"type": "string"}}},
}

#: response-schema attachments to the path table
RESPONSES = {
    "/sdrangel": ("get", "InstanceSummary"),
    "/sdrangel/devicesets": ("get", "DeviceSetList"),
    "/sdrangel/deviceset/{i}": ("get", "DeviceSet"),
    "/sdrangel/deviceset/{i}/device/report": ("get", "DeviceReport"),
    "/sdrangel/deviceset/{i}/device/settings": ("get", "DeviceSettings"),
    "/sdrangel/deviceset/{i}/channel/{j}/report": ("get", "ChannelReport"),
    "/sdrangel/deviceset/{i}/spectrum": ("get", "Spectrum"),
    "/sdrangel/audio": ("get", "AudioDevices"),
    "/sdrangel/logging": ("get", "LoggingInfo"),
    "/sdrangel/location": ("get", "LocationInformation"),
}


def _kind_name(uri: str) -> str:
    return uri.rsplit(".", 1)[-1]


_JSON_TYPES = {"float": "number", "int": "integer", "bool": "boolean", "str": "string"}


def _type_name(t) -> str:
    return t if isinstance(t, str) else getattr(t, "__name__", str(t))


def _device_settings_schema(cls: type, kinds: dict) -> dict:
    """An Rx source's or a Tx sink's settings, from its dataclass."""
    props = {}
    for f in dataclasses.fields(cls):
        props[f.name] = {"type": _JSON_TYPES.get(_type_name(f.type), "string"),
                         "default": f.default}
    props["kind"]["enum"] = sorted(kinds)
    return {"type": "object", "properties": props}


def build_document(version: str) -> dict:
    import copy

    paths = copy.deepcopy(PATHS)
    schemas = copy.deepcopy(STATIC_SCHEMAS)

    schemas["SourceSettings"] = _device_settings_schema(SourceSettings, SOURCE_KINDS)
    schemas["SinkSettings"] = _device_settings_schema(SinkSettings, SINK_KINDS)
    schemas["DeviceSettings"] = {"oneOf": [_ref("SourceSettings"), _ref("SinkSettings")]}

    # each channel kind's settings and report schemas, from the registry
    for uri in sorted(CONFIG_CLASSES):
        name = _kind_name(uri)
        props = {}
        for field, info in settings_schema(uri).items():
            props[field] = {"type": _JSON_TYPES.get(info["type"], "string")}
            if info["default"] is not None:
                props[field]["default"] = info["default"]
        schemas[f"ChannelSettings_{name}"] = {
            "type": "object", "x-channel-uri": uri, "properties": props}
        schemas[f"ChannelReport_{name}"] = {
            "x-channel-uri": uri, **report_schema(uri)}

    for path, (verb, schema) in RESPONSES.items():
        paths[path][verb]["responses"] = {
            "200": {"description": "OK",
                    "content": {"application/json": {"schema": _ref(schema)}}},
            "default": {"description": "error",
                        "content": {"application/json": {
                            "schema": _ref("ErrorResponse")}}},
        }
    return {
        "openapi": "3.0.0",
        "info": {"title": "sdrangel_tpu_torch", "version": version},
        "paths": paths,
        "components": {"schemas": schemas},
    }
