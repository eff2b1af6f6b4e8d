"""The reader of the product step's banked share (`rx_banked_share`) on
planted counters of `sdrangel_tpu_torch.runtime.tracing`: the `rx banked
channels` counter over the `rx channels` counter, None without a stretch,
and None on a program that counted no channels."""

import pytest

from portbench import harness, trace
from sdrangel_tpu_torch.runtime import tracing

BLOCKS = 4


def _view(stretch=True):
    s = trace.Stretch(BLOCKS, 4000.0, [], {}, 3000.0, []) if stretch else None
    return harness.View({}, s, {})


def _plant(monkeypatch, counters):
    monkeypatch.setattr(tracing, "totals", lambda: ({}, dict(counters)))


@pytest.mark.parametrize("channels,banked,share", [(64, 64, 1.0), (64, 48, 0.75), (4, 0, 0.0)])
def test_reads_banked_over_channels(channels, banked, share, monkeypatch):
    _plant(monkeypatch, {"rx channels": channels, "rx banked channels": banked})
    assert harness.read_metric("rx_banked_share", _view()) == pytest.approx(share)


def test_none_without_a_stretch(monkeypatch):
    _plant(monkeypatch, {"rx channels": 64, "rx banked channels": 64})
    assert harness.read_metric("rx_banked_share", _view(stretch=False)) is None


def test_none_on_a_program_without_the_counters(monkeypatch):
    _plant(monkeypatch, {"pinned bytes": 1, "fed bytes": 1})
    assert harness.read_metric("rx_banked_share", _view()) is None
