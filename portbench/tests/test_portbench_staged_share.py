"""The reader of the host feed's staged share (`hostfeed_staged_share`) on
planted counters of `sdrangel_tpu_torch.runtime.tracing`: the `hostfeed
staged bytes` counter over the `fed bytes` counter, None without a
stretch, and None on a program that counted no fed bytes or no staged
ones (a program without the staging ring)."""

import pytest

from portbench import harness, trace
from sdrangel_tpu_torch.runtime import tracing

BLOCKS = 4


def _view(stretch=True):
    s = trace.Stretch(BLOCKS, 4000.0, [], {}, 3000.0, []) if stretch else None
    return harness.View({}, s, {})


def _plant(monkeypatch, counters):
    monkeypatch.setattr(tracing, "totals", lambda: ({}, dict(counters)))


@pytest.mark.parametrize("fed,staged,share", [(1 << 27, 1 << 27, 1.0), (1 << 27, 1 << 25, 0.25),
                                              (1 << 20, 0, 0.0)])
def test_reads_staged_over_fed_bytes(fed, staged, share, monkeypatch):
    _plant(monkeypatch, {"fed bytes": fed, "hostfeed staged bytes": staged})
    assert harness.read_metric("hostfeed_staged_share", _view()) == pytest.approx(share)


def test_none_without_a_stretch(monkeypatch):
    _plant(monkeypatch, {"fed bytes": 1 << 27, "hostfeed staged bytes": 1 << 27})
    assert harness.read_metric("hostfeed_staged_share", _view(stretch=False)) is None


def test_none_on_a_program_without_fed_bytes(monkeypatch):
    _plant(monkeypatch, {"pinned bytes": 1, "rx channels": 16})
    assert harness.read_metric("hostfeed_staged_share", _view()) is None


def test_none_on_a_program_without_the_staging_ring(monkeypatch):
    _plant(monkeypatch, {"fed bytes": 1 << 27, "pinned bytes": 1})
    assert harness.read_metric("hostfeed_staged_share", _view()) is None
