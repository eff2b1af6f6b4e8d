"""The port's reference-preset copy (`runtime/refpreset.py`) and the
session's Base64-TLV import and export against the JAX package's.

- The code: the copy's module body equals the JAX module's, docstrings
  aside.
- JAX's seven cases of tests/test_refpreset.py run on the port: its
  refpreset, its registry and its Session (on the CPU) stand where JAX's
  stood.
- Export: the port's to_reference_preset of a preset, and its session's
  `export_preset_file(fmt="reference")`, write the bytes JAX's write;
  parse_preset of either blob is equal.
- The imported golden preset (tests/goldens/refpreset.b64: NFM, AM, SSB,
  WFM, BFM, DSD and UDPSrc on a 1.024 MS/s front end ÷32) runs on the
  port's DeviceSet and JAX's for 3 blocks: each audio channel ≥ 80 dB
  (BFM's L+R: its channel holds no pilot, see the test), DSD's last block
  within 3e-5.
  JAX's DeviceSet runs six of the seven channels: its UDPSrc in the usb
  format does not trace under jit (TracerArrayConversionError), so the
  JAX set runs without it; the port's set runs all seven.
"""

from __future__ import annotations

import base64
import inspect
import pathlib
import sys
import time

import numpy as np
import pytest

import sdrangel_tpu.runtime
import test_refpreset
from sdrangel_tpu.runtime import refpreset as jrefpreset
from sdrangel_tpu_torch.channels import registry as pregistry
from sdrangel_tpu_torch.runtime import refpreset as prefpreset
from sdrangel_tpu_torch.runtime import session as psession
from torch_port_util import CPU, agreement_db, code_without_docstrings

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "goldens" / "refpreset.b64"
UDPSRC = "sdrangel.channel.udpsrc"


def test_copy_code_equals_jax():
    assert (code_without_docstrings(REPO / "sdrangel_tpu_torch" / "runtime" / "refpreset.py")
            == code_without_docstrings(REPO / "sdrangel_tpu" / "runtime" / "refpreset.py"))


_JAX_CASES = sorted(name for name in dir(test_refpreset) if name.startswith("test_"))


@pytest.mark.parametrize("name", _JAX_CASES)
def test_jax_refpreset_case_on_the_port(monkeypatch, tmp_path, name):
    """JAX's case with the port's refpreset, registry and Session."""
    monkeypatch.setattr(test_refpreset, "refpreset", prefpreset)
    monkeypatch.setattr(test_refpreset, "registry", pregistry)
    monkeypatch.setattr(test_refpreset, "Session",
                        lambda **kw: psession.Session(device=CPU, **kw))
    monkeypatch.setattr(sdrangel_tpu.runtime, "refpreset", prefpreset)
    monkeypatch.setitem(sys.modules, "sdrangel_tpu.runtime.refpreset", prefpreset)
    fn = getattr(test_refpreset, name)
    fn(*([tmp_path] if "tmp_path" in inspect.signature(fn).parameters else []))
    assert len(_JAX_CASES) == 7


_DOCS = {
    "audio_kinds": {"group": "G", "name": "N", "deviceSets": [{
        "direction": "rx", "source": {"center_frequency": 145500000.0},
        "channels": [
            {"uri": "sdrangel.channel.nfmdemod", "inputFrequencyOffset": 12500.0,
             "settings": {"rf_bandwidth": 12500.0, "af_bandwidth": 4000.0, "volume": 2.0,
                          "squelch_db": -40.0, "ctcss_index": 3, "ctcss_on": True,
                          "squelch_gate_ms": 70.0}},
            {"uri": "sdrangel.channel.amdemod", "inputFrequencyOffset": -7000.0,
             "settings": {"rf_bandwidth": 5000.0, "squelch_db": -35.0}},
            {"uri": "sdrangel.channel.ssbdemod", "inputFrequencyOffset": 3000.0,
             "settings": {"bandwidth": 2800.0, "low_cutoff": 300.0, "usb": False,
                          "volume": 1.2, "agc_enable": True}},
            {"uri": "sdrangel.channel.wfmdemod", "inputFrequencyOffset": 0.0,
             "settings": {"rf_bandwidth": 180000.0, "af_bandwidth": 15000.0}},
            {"uri": "sdrangel.channel.chanalyzer", "inputFrequencyOffset": 0.0,
             "settings": {}},
        ]}]},
    "golden": None,  # the imported golden, exported again
}


def _doc(case: str) -> dict:
    if _DOCS[case] is not None:
        return _DOCS[case]
    return jrefpreset.to_session_preset(jrefpreset.parse_preset(GOLDEN.read_text()))


@pytest.mark.parametrize("case", sorted(_DOCS))
def test_export_equals_jax(case):
    doc = _doc(case)
    blob = jrefpreset.to_reference_preset(doc)
    assert prefpreset.to_reference_preset(doc) == blob
    assert prefpreset.parse_preset(blob) == jrefpreset.parse_preset(blob)
    assert (prefpreset.to_session_preset(prefpreset.parse_preset(blob))
            == jrefpreset.to_session_preset(jrefpreset.parse_preset(blob)))


def test_session_export_and_import_equal_jax(tmp_path):
    """The same instance exported by both sessions: the same Base64 text;
    each session imports the other's file to the same preset."""
    from sdrangel_tpu.runtime.session import Session as JaxSession

    texts, sessions = {}, {}
    for name, make in (("jax", lambda d: JaxSession(preset_dir=d)),
                       ("port", lambda d: psession.Session(device=CPU, preset_dir=d))):
        d = tmp_path / name
        d.mkdir()
        s = make(str(d))
        ds = s.add_device_set()
        ds.update_source({"kind": "testsource", "center_frequency": 433_500_000.0})
        ds.add_channel("sdrangel.channel.nfmdemod",
                       {"inputFrequencyOffset": -25000.0, "squelch_db": -45.0})
        ds.add_channel("sdrangel.channel.wfmdemod", {"inputFrequencyOffset": 100000.0})
        s.save_preset("Grp", "RefExport")
        s.export_preset_file("Grp", "RefExport", "out.prex", fmt="reference")
        texts[name] = (d / "out.prex").read_text()
        sessions[name] = s
    assert texts["port"] == texts["jax"]
    base64.b64decode(texts["jax"], validate=True)
    (tmp_path / "jax" / "other.prex").write_text(texts["port"])
    (tmp_path / "port" / "other.prex").write_text(texts["jax"])
    keys = {name: s.import_preset_file("other.prex") for name, s in sessions.items()}
    assert keys["port"] == keys["jax"] == "Grp/RefExport"
    assert sessions["port"].presets[keys["port"]] == sessions["jax"].presets[keys["jax"]]


def _run(ds, deadline_s: float = 300.0) -> None:
    ds.start()
    t0 = time.time()
    while ds.running and time.time() - t0 < deadline_s:
        time.sleep(0.05)
    ds.stop()
    assert not ds.error, ds.error


def test_imported_golden_preset_runs_as_jax(tmp_path):
    from sdrangel_tpu.runtime.session import Session as JaxSession

    sets = {}
    for name, make in (("jax", lambda d: JaxSession(preset_dir=d)),
                       ("port", lambda d: psession.Session(device=CPU, preset_dir=d))):
        d = tmp_path / name
        d.mkdir()
        (d / "ref.b64").write_text(GOLDEN.read_text())
        s = make(str(d))
        group, preset = s.import_preset_file("ref.b64").split("/")
        s.load_preset(group, preset)
        ds = s.device_sets[0]
        ds.update_source({"run_blocks": 3})
        sets[name] = ds
    port, jax_ds = sets["port"], sets["jax"]
    assert [c.uri for c in port.channels] == [c.uri for c in jax_ds.channels]
    assert port.channels[-1].uri == UDPSRC and port.channels[-1].settings["fmt"] == "usb"
    _run(port)
    assert port.blocks_processed == 3
    assert np.all(np.isfinite(port.channels[-1].latest_data["iq_real"]))
    jax_ds.remove_channel(len(jax_ds.channels) - 1)  # see the module docstring
    _run(jax_ds)
    assert jax_ds.blocks_processed == 3
    for i, jc in enumerate(jax_ds.channels):
        if pregistry.REGISTRY[jc.uri].output == "data":  # DSD: the last block's arrays
            want, got = jc.latest_data, port.channels[i].latest_data
            assert sorted(got) == sorted(want) and port.channels[i].data_blocks == 3
            for k in want:
                np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=3e-5, rtol=1e-5,
                                           err_msg=f"{jc.uri} {k}")
            continue
        ja, pa = jax_ds.drain_audio(i), port.drain_audio(i)
        assert ja.shape == pa.shape and ja.size, jc.uri
        if jc.uri == "sdrangel.channel.bfm":
            # the 32 kHz channel holds no 19 kHz pilot, and neither BFM gates
            # its stereo decode on a pilot lock (ROADMAP.md §3): L−R is then
            # the signal times a 38 kHz reference whose phase is the
            # rounding noise of a pilot filter fed nothing. L+R is held.
            ja, pa = ja.sum(axis=-1), pa.sum(axis=-1)
        if np.any(ja):
            assert agreement_db(ja, pa) >= 80.0, (jc.uri, agreement_db(ja, pa))
        else:
            assert not np.any(pa), jc.uri
        assert port.channels[i].audio_samples == jc.audio_samples
