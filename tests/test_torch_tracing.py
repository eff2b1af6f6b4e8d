"""The port's spans and counters (`runtime/tracing.py`).

With no profiler running, no span enters a `record_function` and nothing is
tallied, in the Rx step, the bank gear's step and the host feed. Under
`torch.profiler` (CPU activity), a 2-channel NFM RxPipeline over 2 blocks
shows each of `engine.LAYERS` on the profiler's timeline and tallies one
channelizer span and one demod span a group (its two channels, at one plan
depth, run as one bank) and block; a 16-channel pipeline at the nfm16
traffic's offsets counts its 16 channels a block, all of them banked in
the channelizer and in the demod, and a one-channel pipeline 1 and none;
the gear's step
shows the `sharded.LAYERS` it runs; `shard_block` counts the bytes it hands each
shard. On the card (`cuda`), `fetch` tallies its wait and the pinned
buffers of the upload and the read-back.
"""

import numpy as np
import pytest
import torch

from sdrangel_tpu_torch.parallel import hostfeed, sharded
from sdrangel_tpu_torch.parallel.mesh import make_mesh
from sdrangel_tpu_torch.runtime import engine, tracing

NFM = "sdrangel.channel.nfmdemod"
RATE = 768_000.0
CHANNELS = (-100_000.0, 100_000.0)
BLOCKS = 2


def _pipe(device="cpu"):
    return engine.RxPipeline(
        engine.DeviceConfig(RATE, log2_decim=1),
        [engine.ChannelSpec(NFM, f, {"squelch_db": -60.0}) for f in CHANNELS],
        device, block_size=32_768)


def _raw(n, seed=0):
    return np.random.default_rng(seed).integers(-2048, 2048, size=(n, 2), dtype=np.int16)


def _run_pipe(pipe):
    list(pipe.run(lambda b, n: _raw(n, b), BLOCKS))


def _gear():
    cfg = sharded.ShardedPipelineConfig(n_time=1, n_channel=1, log2_decim=3,
                                        block=1 << 14, n_channels=2, pfb_m=4)
    step, init_fn = sharded.build_sharded_step(cfg, "cpu")

    def run():
        state, carry = init_fn()
        raw = torch.from_numpy(_raw(cfg.block))
        step(state, raw, carry, torch.zeros(2), torch.tensor([0, 1]))
    return run


def _feed(n_time=1, n_channel=1, block=1 << 12):
    mesh = make_mesh(n_time, n_channel, ["cpu"] * (n_time * n_channel))
    data = _raw(block)
    return lambda: hostfeed.shard_block(mesh, block, 0, lambda s, n: data[s:s + n])


def _profiled(fn):
    """fn() under torch.profiler (CPU): (the events' names, what was
    tallied)."""
    before = tracing.totals()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}, tracing.since(before)


@pytest.mark.parametrize("what", ["pipeline", "gear", "shard_block"])
def test_off_enters_no_range_and_tallies_nothing(what, monkeypatch):
    run = {"pipeline": lambda: _run_pipe(_pipe()), "gear": _gear(), "shard_block": _feed()}[what]

    def refuse(self):
        raise AssertionError(f"record_function({self.name!r}) entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", refuse)
    before = tracing.totals()
    run()
    assert tracing.totals() == before


@pytest.fixture(scope="module")
def profiled_pipe():
    pipe = _pipe()
    _run_pipe(pipe)  # warm: the first block's plans outside the profile
    return pipe, _profiled(lambda: _run_pipe(pipe))


@pytest.mark.parametrize("layer", engine.LAYERS)
def test_profiled_step_shows_each_layer(layer, profiled_pipe):
    pipe, (names, (spans, _)) = profiled_pipe
    assert layer in names
    # the channelizer and the demod run once a group: a bank is one cascade
    per_block = {engine.CHANNELIZE: len(pipe.groups), engine.DEMOD: len(pipe.groups)}.get(layer, 1)
    assert len(pipe.groups) == 1  # the two channels share a kind, a depth and settings
    calls, seconds = spans[layer]
    assert calls == per_block * BLOCKS and seconds > 0


#: the nfm16 traffic's raster, received at 625 kHz (1.25 MS/s ÷2): banks of
#: 12 channels at depth 3 and 4 at depth 2
NFM16 = tuple(-187_500.0 + 25_000.0 * k for k in range(16))


@pytest.mark.parametrize("offsets,banked", [(NFM16, 16), (NFM16[:1], 0)],
                         ids=["nfm16", "one"])
def test_profiled_step_counts_banked_channels(offsets, banked):
    pipe = engine.RxPipeline(
        engine.DeviceConfig(1_250_000.0, log2_decim=1),
        [engine.ChannelSpec(NFM, f, {"squelch_db": -60.0}) for f in offsets], "cpu",
        block_size=32_768)
    _run_pipe(pipe)
    _, (_, counters) = _profiled(lambda: _run_pipe(pipe))
    assert counters[engine.RX_CHANNELS] == len(offsets) * BLOCKS
    assert counters.get(engine.RX_BANKED, 0) == banked * BLOCKS
    assert counters.get(engine.RX_CHAN_BANKED, 0) == banked * BLOCKS


def test_profiled_upload_counts_fed_bytes(profiled_pipe):
    pipe, (_, (spans, counters)) = profiled_pipe
    assert counters[engine.FED_BYTES] == BLOCKS * pipe.device_block * 4
    assert engine.PINNED_BYTES not in counters  # nothing is pinned for the CPU
    assert engine.FETCH_WAIT not in spans  # the CPU's fetch waits for nothing


def test_gear_step_shows_the_layers_it_ran():
    assert sharded.LAYERS == ("gear ÷2^k decimator", "gear collectives", "gear spectrum tap",
                              "gear PFB analysis", "gear channel select", "gear demod bank")
    names, (spans, _) = _profiled(_gear())
    ran = names & set(sharded.LAYERS)
    assert {sharded.DECIMATE, sharded.ANALYSIS, sharded.SELECT, sharded.DEMOD} <= ran
    assert set(spans) & set(sharded.LAYERS) == ran


@pytest.mark.parametrize("n_time,n_channel", [(1, 1), (2, 1), (2, 2)])
def test_shard_block_counts_fed_bytes(n_time, n_channel):
    block = 1 << 12
    names, (spans, counters) = _profiled(_feed(n_time, n_channel, block))
    # each time row goes to each channel shard of its row
    assert counters == {engine.FED_BYTES: block * 4 * n_channel}
    assert hostfeed.COPY in names and spans[hostfeed.COPY][0] == 1


@pytest.mark.cuda
def test_fetch_tallies_its_wait_and_pinned_buffers():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: fetch's wait and pinned buffers exist only there")
    pipe = _pipe("cuda")
    _run_pipe(pipe)
    before = tracing.totals()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _run_pipe(pipe)
    spans, counters = tracing.since(before)
    assert engine.FETCH_WAIT in {e.name for e in prof.events()}
    assert spans[engine.FETCH_WAIT][0] == BLOCKS
    block_bytes = BLOCKS * pipe.device_block * 4
    assert counters[engine.FED_BYTES] == block_bytes
    assert counters[engine.PINNED_BYTES] == block_bytes + BLOCKS * pipe.out_layout.size * 4
