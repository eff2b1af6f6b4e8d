"""The reader of the product step's channelizer banked share
(`rx_chan_banked_share`) on planted counters of
`sdrangel_tpu_torch.runtime.tracing`: the `rx chan banked channels` counter
over the `rx channels` counter, None without a stretch, None on a program
that counted no channels, and None on a program that counts channels but
not the channelizer's banks (one that channelizes channel by channel)."""

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
def test_reads_chan_banked_over_channels(channels, banked, share, monkeypatch):
    _plant(monkeypatch, {"rx channels": channels, "rx banked channels": channels,
                         "rx chan banked channels": banked})
    assert harness.read_metric("rx_chan_banked_share", _view()) == pytest.approx(share)


def test_none_without_a_stretch(monkeypatch):
    _plant(monkeypatch, {"rx channels": 64, "rx chan banked channels": 64})
    assert harness.read_metric("rx_chan_banked_share", _view(stretch=False)) is None


def test_none_on_a_program_without_channels(monkeypatch):
    _plant(monkeypatch, {"pinned bytes": 1, "fed bytes": 1})
    assert harness.read_metric("rx_chan_banked_share", _view()) is None


def test_none_on_a_program_that_channelizes_channel_by_channel(monkeypatch):
    _plant(monkeypatch, {"rx channels": 64, "rx banked channels": 64})
    assert harness.read_metric("rx_chan_banked_share", _view()) is None


def test_reads_the_program_counter_of_a_profiled_step():
    """The reader on a real profiled nfm16 step: every channel banked."""
    import torch

    from sdrangel_tpu_torch.runtime import engine

    pipe = engine.RxPipeline(
        engine.DeviceConfig(1_250_000.0, log2_decim=1),
        [engine.ChannelSpec("sdrangel.channel.nfmdemod", -187_500.0 + 25_000.0 * k,
                            {"squelch_db": -60.0}) for k in range(16)], "cpu",
        block_size=32_768)
    raw = torch.zeros((pipe.device_block, 2), dtype=torch.int16)
    before = tracing.totals()[1]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pipe.step(pipe.init_state(), raw)
    counters = tracing.totals()[1]
    got = {k: counters[k] - before.get(k, 0) for k in (engine.RX_CHAN_BANKED, engine.RX_CHANNELS)}
    assert got == {engine.RX_CHAN_BANKED: 16, engine.RX_CHANNELS: 16}
