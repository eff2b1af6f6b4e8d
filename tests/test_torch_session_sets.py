"""Several Rx device sets of one `Session` (`runtime/session.py`), each a
file source over a .sdriq of its own stream, and the benchmark driver
that paces them (`portbench/drivers/sessionsets.py`, cell sets4-paced).

On the CPU, at the tiny shape of portbench's product cell (1.25 MS/s ÷2,
four NFM channels of the nfm16 raster, the session's block of 160,000):
- two and three sets in one Session each publish, block for block, what
  the same set publishes alone, bit for bit (audio, power, squelch,
  spectrum, scope), and agree with the float64 reference
  (`portbench/reference/chains.product`) within product-nfm16's limits;
- the driver's cell, cut to that shape: its rounds are correct, each set's
  outputs equal a one-set run of the test's own slice of the ring, and
  its per-set reference agrees with that run within the limits; the
  control (the reference in TF32) is not correct;
- on the CPU the sets' steps do not take the enqueue lock; the worker
  counts its blocks under a profiler, none on a stream of its own (the
  CPU has none);
- the four readers of the cell's per-layer metrics.

On the card (`cuda`; `python -m pytest tests/test_torch_session_sets.py -q
-o addopts="" -m cuda` with SDRANGEL_TPU_TEST_ON_TPU=1, which keeps
conftest.py from importing jax): two sets, each on a stream of its own,
equal the same sets run one at a time; the step runs on the set's own
stream, never the default one, under the enqueue lock; stop
waits for work still queued on the worker's stream; a device cache is
whole when its fill returns.
"""

import functools
import json
import math
import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from portbench import capture, control, harness, judge, trace
from portbench.drivers import sessionsets
from portbench.reference import chains, dsp
from sdrangel_tpu_torch.io import sdriq
from sdrangel_tpu_torch.runtime import engine as peng
from sdrangel_tpu_torch.runtime import session as psession
from sdrangel_tpu_torch.runtime import tracing
from torch_port_util import CPU

SEED = 2**31 + 4099
BLOCKS = 3
LIMITS = json.load(open(os.path.join(harness.HERE, "limits", "product-nfm16.json")))


def _tiny_cell(sets: int) -> harness.Cell:
    """sets4-paced at the tiny shape of portbench/tests/tiny.py's product
    cell: the 625 kHz baseband from a 1.25 MS/s capture ÷2, four of the
    channels, the noise as strong in each as the cell's."""
    c = harness.load_cell("sets4-paced")
    rate = 1_250_000
    c.traffic["noise_dbfs"] += 10 * math.log10(rate / c.config["sample_rate"])
    c.config.update(sample_rate=rate, log2_decim=1, set_block=160_000, sets=sets)
    c.traffic["channels_hz"] = c.traffic["channels_hz"][6:10]
    c.traffic["carriers"]["count"] = 2
    c.traffic.update(ring_blocks=3, warm_blocks=2, compare_blocks=2, profile_blocks=2)
    return c


@functools.lru_cache(maxsize=None)
def _ring(sets: int) -> np.ndarray:
    """The tiny cell's ring of rounds, as the harness makes it."""
    c = _tiny_cell(sets)
    return capture.ring(c.traffic, c.traffic["channels_hz"], c.config["sample_rate"],
                        sessionsets.block_samples(c.config), SEED, CPU).numpy()


def _slice(ring: np.ndarray, cfg: dict, s: int) -> np.ndarray:
    """Set s's stream: its part of every round, in order."""
    d = cfg["set_block"]
    return np.ascontiguousarray(ring[:, s * d:(s + 1) * d]).reshape(-1, 2)


def _add_set(session, cell, stream: np.ndarray, path: str, blocks: int, got: list):
    cfg, ch = cell.config, cell.config["channel"]
    sdriq.write(path, stream, sample_rate=cfg["sample_rate"], sample_size=16, timestamp=0)
    ds = session.add_device_set("rx")
    ds.update_source({"kind": "filesource", "file_path": path, "log2_decim": cfg["log2_decim"],
                      "fc_pos": cfg["fc_pos"], "publish_every": 1, "run_blocks": blocks})
    settings = {k: ch[k] for k in ("audio_rate", "rf_bandwidth", "af_bandwidth",
                                   "fm_deviation", "squelch_db", "squelch_gate_ms", "volume")}
    for f in cell.traffic["channels_hz"]:
        ds.add_channel(ch["uri"], {"inputFrequencyOffset": float(f), **settings})
    publish = ds._publish_block

    def taken(outs, chans, egress):
        got.append(outs)
        publish(outs, chans, egress)
    ds._publish_block = taken
    return ds


def _run_sets(sets, deadline_s: float = 120.0) -> None:
    for ds in sets:
        ds.start()
    t0 = time.time()
    while any(ds.running for ds in sets) and time.time() - t0 < deadline_s:
        time.sleep(0.01)
    for ds in sets:
        ds.stop()
    assert not any(ds.running for ds in sets), "a set outlived its deadline"
    assert not [ds.error for ds in sets if ds.error]


def _session_run(cell, ring, which, device=CPU, blocks=BLOCKS, session=None) -> dict:
    """The sets `which` of the ring's layout in one Session, each played for
    `blocks` blocks: {set: [each published block's outputs]}."""
    got = {s: [] for s in which}
    with tempfile.TemporaryDirectory() as tmp:
        session = session or psession.Session(device=device)
        sets = [_add_set(session, cell, _slice(ring, cell.config, s),
                         os.path.join(tmp, f"set{s}.sdriq"), blocks, got[s]) for s in which]
        _run_sets(sets)
    return got


@functools.lru_cache(maxsize=None)
def _together(n: int) -> dict:
    return _session_run(_tiny_cell(n), _ring(n), tuple(range(n)))


def _assert_equal_outs(a: dict, b: dict) -> None:
    assert len(a["channels"]) == len(b["channels"])
    for ca, cb in zip(a["channels"], b["channels"]):
        for k in ("audio", "power", "squelch"):
            np.testing.assert_array_equal(ca[k], cb[k])
    np.testing.assert_array_equal(a["spectrum"], b["spectrum"])
    np.testing.assert_array_equal(a["scope"], b["scope"])


@pytest.mark.parametrize("n", [2, 3])
def test_sets_equal_each_set_alone(n):
    together = _together(n)
    for s in range(n):
        alone = _session_run(_tiny_cell(n), _ring(n), (s,))[s]
        assert len(together[s]) == len(alone) == BLOCKS
        for a, b in zip(together[s], alone):
            _assert_equal_outs(a, b)


@pytest.mark.parametrize("n", [2, 3])
def test_sets_agree_with_the_reference(n):
    cell, ring = _tiny_cell(n), _ring(n)
    together = _together(n)
    for s in range(n):
        for b in range(1, BLOCKS):  # the first block's audio starts one sample apart
            raws = [torch.from_numpy(ring[i]) for i in (b - 1, b)]
            ref = chains.product(sessionsets.set_slices(raws, cell.config, s), cell.config,
                                 cell.traffic["channels_hz"], dsp.F64)
            ok, check = judge.verdict(judge.product_numbers(together[s][b], ref), LIMITS)
            assert ok, (s, b, check)


def test_driver_layout_and_reference_agree_with_a_one_set_run():
    n = 3
    cell, ring = _tiny_cell(n), _ring(n)
    seen = {}
    out = harness.run_cell(cell, SEED, 0.5, False, CPU,
                           inspect=lambda b, ours, ref: seen.setdefault(b, (ours, ref)))
    assert out.correct, out.check
    assert out.attempted >= 3 and out.failed == 0 and seen
    last = max(seen) + 1
    for s in range(n):
        alone = _session_run(cell, ring, (s,), blocks=last)[s]
        for b, (ours, ref) in seen.items():
            _assert_equal_outs(ours[s], alone[b])
            ok, check = judge.verdict(judge.product_numbers(alone[b], ref[s]), LIMITS)
            assert ok, (s, b, check)


def test_control_of_the_tiny_cell_is_not_correct():
    out = harness.run_cell(_tiny_cell(2), SEED, 0.5, False, CPU,
                           patch=control.in_place_of_program)
    assert not out.correct, out.check


def test_the_driver_refuses_a_block_other_than_the_sessions():
    cell = _tiny_cell(2)
    cell.config.update(set_block=2 * cell.config["set_block"])
    with pytest.raises(RuntimeError, match="the session's block is 160000"):
        harness.run_cell(cell, SEED, 0.5, False, CPU)


def test_cpu_sets_do_not_take_the_enqueue_lock():
    """The enqueue lock serializes the workers' launches on a card only: on
    the CPU a step computes inside torch's ops, and the sets' steps overlap."""
    with psession._ENQUEUE:
        got = _session_run(_tiny_cell(2), _ring(2), (0, 1), blocks=2)
    assert [len(v) for v in got.values()] == [2, 2]


def test_worker_counts_its_blocks_none_on_an_own_stream_on_the_cpu():
    cell = _tiny_cell(2)
    before = tracing.totals()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _session_run(cell, _ring(2), (0, 1), blocks=2)
    spans, counters = tracing.since(before)
    assert counters.get(psession.BLOCKS) == 4
    assert psession.OWN_STREAM_BLOCKS not in counters
    # the workers' own spans reach the tallies the cell's metrics read
    for name in (psession.READ, psession.PUBLISH, "rx demod"):
        assert spans[name][0] == 4, name


# -- the cell's per-layer metrics ----------------------------------------------

ROUNDS = 4
SPANS = {"session read": (16, 0.008), "session publish": (16, 0.040),
         "rx fetch wait": (16, 0.004)}
EXPECTED = {
    "sets_read_host_ms": 8.0 / ROUNDS,
    "sets_publish_host_ms": 40.0 / ROUNDS,
    "sets_fetch_wait_ms": 4.0 / ROUNDS,
    "sets_own_stream_share": 0.75,
}
COUNTERS = {psession.BLOCKS: 16, psession.OWN_STREAM_BLOCKS: 12}


def _view(stretch=True):
    # a stretch of more rounds released than the sets took: a span reads
    # by its calls, a set's call a round
    s = trace.Stretch(ROUNDS + 3, 4000.0, [], {}, 100.0, []) if stretch else None
    return harness.View({"sets": 4}, s, {})


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_metric_reads_the_planted_tallies(metric, monkeypatch):
    monkeypatch.setattr(tracing, "totals", lambda: (dict(SPANS), dict(COUNTERS)))
    assert harness.read_metric(metric, _view()) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_metric_none_without_a_stretch(metric, monkeypatch):
    monkeypatch.setattr(tracing, "totals", lambda: (dict(SPANS), dict(COUNTERS)))
    assert harness.read_metric(metric, _view(stretch=False)) is None


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_metric_none_where_the_program_tallied_nothing(metric, monkeypatch):
    # a program whose sets share the default stream counts no session blocks
    monkeypatch.setattr(tracing, "totals", lambda: ({}, {}))
    assert harness.read_metric(metric, _view()) is None


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device sets' streams exist only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_sets_on_their_own_streams_equal_one_at_a_time(cuda_device):
    cell, ring = _tiny_cell(2), _ring(2)
    together = _session_run(cell, ring, (0, 1), device=cuda_device)
    for s in (0, 1):
        alone = _session_run(cell, ring, (s,), device=cuda_device)[s]
        assert len(together[s]) == len(alone) == BLOCKS
        for a, b in zip(together[s], alone):
            _assert_equal_outs(a, b)


@pytest.mark.cuda
def test_the_step_runs_on_the_sets_own_stream(cuda_device, monkeypatch):
    seen = []
    step_packed = peng.RxPipeline.step_packed

    session = psession.Session(device=cuda_device)

    def recorded(pipe, *a, **k):
        assert psession._ENQUEUE.locked()  # one worker enqueues at a time
        seen.append((threading.get_ident(), torch.cuda.current_stream(cuda_device)))
        return step_packed(pipe, *a, **k)

    monkeypatch.setattr(peng.RxPipeline, "step_packed", recorded)
    before = tracing.totals()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _session_run(_tiny_cell(2), _ring(2), (0, 1), session=session)
    default = torch.cuda.default_stream(cuda_device)
    by_thread = {}
    for ident, stream in seen:
        by_thread.setdefault(ident, set()).add(stream)
    assert len(by_thread) == 2 and all(len(v) == 1 for v in by_thread.values())
    streams = [next(iter(v)) for v in by_thread.values()]
    assert streams[0] != streams[1] and default not in streams
    counters = tracing.since(before)[1]
    assert counters[psession.OWN_STREAM_BLOCKS] == counters[psession.BLOCKS] == 2 * BLOCKS


@pytest.mark.cuda
def test_stop_waits_for_work_queued_on_the_workers_stream(cuda_device, monkeypatch):
    """A publish that fails right after ~0.5 s of device sleep was queued on
    the worker's stream: the worker waits for its stream before the
    generation's tensors drop, so once stop returns the stream is idle."""
    streams = []

    def failing(self, outs, chans, egress):
        streams.append(torch.cuda.current_stream(cuda_device))
        torch.cuda._sleep(1_000_000_000)  # ~0.5 s at the H100's clocks
        raise OSError("the sink went away")

    monkeypatch.setattr(psession.DeviceSet, "_publish_block", failing)
    cell = _tiny_cell(1)
    with tempfile.TemporaryDirectory() as tmp:
        session = psession.Session(device=cuda_device)
        ds = _add_set(session, cell, _slice(_ring(1), cell.config, 0),
                      os.path.join(tmp, "set0.sdriq"), BLOCKS, [])
        ds.start()
        t0 = time.time()
        while ds.running and time.time() - t0 < 60.0:
            time.sleep(0.001)
        ds.stop()
    assert "the sink went away" in ds.error
    assert len(streams) == 1 and streams[0] != torch.cuda.default_stream(cuda_device)
    assert streams[0].query()


@pytest.mark.cuda
def test_a_device_cache_is_whole_when_its_fill_returns(cuda_device):
    """The sets share the device caches (`spectrum._device_window`,
    `demod_nfm._device_taps`, `decimators`' tap and leg caches), filled by
    whichever set's stream asks first with a blocking `.to(device)`: that
    copy waits for its stream, so another set's stream never reads a cache
    entry before its upload has finished."""
    from sdrangel_tpu_torch.dsp import spectrum

    stream = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(stream):
        torch.cuda._sleep(1_000_000_000)  # ~0.5 s queued ahead of the fill
        window = spectrum._device_window(spectrum.SpectrumConfig(fft_size=1536), cuda_device)
        assert stream.query()
    np.testing.assert_array_equal(window.cpu().numpy(),
                                  spectrum.SpectrumConfig(fft_size=1536).win)
