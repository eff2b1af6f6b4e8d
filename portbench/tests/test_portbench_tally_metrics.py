"""The readers of the program's spans and counters
(`sdrangel_tpu_torch.runtime.tracing`) on a synthetic stretch with planted
tallies: each divides by the stretch's blocks, returns None without a
stretch, and None where the program tallied nothing of its name."""

import pytest

from portbench import harness, trace
from sdrangel_tpu_torch.runtime import tracing

BLOCKS = 4
SPANS = {"rx channelizer": (64, 0.080), "rx demod": (64, 0.320), "rx taps": (4, 0.012),
         "rx pack": (4, 0.004), "rx fetch wait": (4, 0.002), "hostfeed copy": (4, 0.160)}
COUNTERS = {"pinned bytes": 4 * 44_100_000, "fed bytes": 4 * 40_960_000}
# (metric, what it reads off the planted tallies, per block)
EXPECTED = {
    "rx_chan_host_ms": 80.0 / BLOCKS,
    "rx_demod_host_ms": 320.0 / BLOCKS,
    "rx_taps_host_ms": (12.0 + 4.0) / BLOCKS,
    "fetch_wait_ms": 2.0 / BLOCKS,
    "hostfeed_copy_host_ms": 160.0 / BLOCKS,
    "pinned_alloc_mb": 44.1,
    # 40.96 MB a block over 2 × 0.5 ms of HtoD inside the feed span
    "feed_h2d_gbps": 40.96e6 / 1e-3 / 1e9,
}


def _stretch():
    ops = []
    for b in range(BLOCKS):
        t = 1000.0 * b
        ops += [trace.DeviceOp("Memcpy HtoD (Pinned -> Device)", t, t + 500, "portbench feed"),
                trace.DeviceOp("Memcpy HtoD (Pinned -> Device)", t + 500, t + 1000,
                               "portbench feed"),
                # neither an HtoD of the feed nor a copy at all
                trace.DeviceOp("Memcpy HtoD (Pinned -> Device)", t, t + 700, "portbench step"),
                trace.DeviceOp("flat_decimate_kernel", t, t + 100, "portbench feed")]
    return trace.Stretch(BLOCKS, 4000.0, ops, {}, 3000.0, [])


def _plant(monkeypatch, spans, counters):
    monkeypatch.setattr(tracing, "totals", lambda: (dict(spans), dict(counters)))


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reads_the_planted_tallies(metric, monkeypatch):
    _plant(monkeypatch, SPANS, COUNTERS)
    value = harness.read_metric(metric, harness.View({}, _stretch(), {}))
    assert value == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_none_without_a_stretch(metric, monkeypatch):
    _plant(monkeypatch, SPANS, COUNTERS)
    assert harness.read_metric(metric, harness.View({}, None, {})) is None


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_none_where_nothing_was_tallied(metric, monkeypatch):
    _plant(monkeypatch, {}, {})
    assert harness.read_metric(metric, harness.View({}, _stretch(), {})) is None


def test_h2d_rate_none_without_a_feed_copy(monkeypatch):
    _plant(monkeypatch, SPANS, COUNTERS)
    s = _stretch()
    s.ops = [o for o in s.ops if o.owner != "portbench feed"]
    assert harness.read_metric("feed_h2d_gbps", harness.View({}, s, {})) is None
