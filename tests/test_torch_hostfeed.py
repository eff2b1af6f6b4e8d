"""The bank gears' host feed (`parallel/hostfeed.py`).

On the CPU every block's shards are fresh arrays that share no storage
with the capture or with another block's shards. On the card (`cuda`,
skipped without one): a staged row's shards equal its samples bit for bit
while the host fills the slot of block b + 2 with block b's upload still
queued behind a long kernel; the two pinned slots of a row are allocated
by its first two blocks and never again, and every byte fed is staged;
`ShardedSdriqFeeder` over the read-only memory map, a block wrapping at
EOF, gives the capture's rows. Run the card tests on a machine with one:

    python -m pytest tests/test_torch_hostfeed.py -q -o addopts=""

This file imports no jax, so it runs where only the port is installed.
"""

import warnings

import numpy as np
import pytest
import torch

from sdrangel_tpu_torch.io import sdriq
from sdrangel_tpu_torch.parallel import hostfeed
from sdrangel_tpu_torch.parallel.mesh import make_mesh
from sdrangel_tpu_torch.runtime import engine, tracing

MESHES = [(1, 1), (2, 1), (2, 2)]


def _capture(n, seed=0):
    """(n, 2) int16 samples, read-only as a memory map's are."""
    data = np.random.default_rng(seed).integers(-32768, 32768, size=(n, 2), dtype=np.int16)
    data.flags.writeable = False
    return data


def _rows(data, block, b, t, n_time):
    rows = block // n_time
    start = b * block + t * rows
    return data[np.arange(start, start + rows) % len(data)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned staging ring engages only there")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("n_time,n_channel", MESHES)
def test_shard_block_rows_are_fresh_each_block(n_time, n_channel):
    block = 1 << 12
    mesh = make_mesh(n_time, n_channel, ["cpu"] * (n_time * n_channel))
    data = _capture(3 * block)
    feed = {b: hostfeed.shard_block(mesh, block, b, lambda s, n: data[s:s + n]) for b in (0, 2)}
    for b, shards in feed.items():
        assert list(shards) == mesh.local
        for (t, _), x in shards.items():
            np.testing.assert_array_equal(x.numpy(), _rows(data, block, b, t, n_time))
            assert not np.shares_memory(x.numpy(), data)
    for x in feed[0].values():
        for y in feed[2].values():
            assert not np.shares_memory(x.numpy(), y.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n_time", [1, 2])
def test_staged_shards_equal_their_rows_behind_a_queued_kernel(n_time, cuda_device):
    block, blocks = 1 << 20, 5
    mesh = make_mesh(n_time, 1, [cuda_device] * n_time)
    data = _capture(blocks * block)
    fed = []
    for b in range(blocks):
        torch.cuda._sleep(20_000_000)  # ~10 ms: the upload waits behind it
        fed.append(hostfeed.shard_block(mesh, block, b, lambda s, n: data[s:s + n]))
    torch.cuda.synchronize()
    for b, shards in enumerate(fed):
        for (t, _), x in shards.items():
            assert x.device == cuda_device and x.dtype == torch.int16
            np.testing.assert_array_equal(x.cpu().numpy(), _rows(data, block, b, t, n_time))


@pytest.mark.cuda
@pytest.mark.parametrize("n_time,n_channel", MESHES)
def test_staging_pins_two_slots_a_row_and_stages_every_byte(n_time, n_channel, cuda_device):
    block = 1 << 16
    mesh = make_mesh(n_time, n_channel, [cuda_device] * (n_time * n_channel))
    data = _capture(5 * block)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for b in range(5):
            before = tracing.totals()
            hostfeed.shard_block(mesh, block, b, lambda s, n: data[s:s + n])
            counters = tracing.since(before)[1]
            assert counters.get(engine.PINNED_BYTES, 0) == (block * 4 if b < 2 else 0)
            assert counters[hostfeed.STAGED_BYTES] == counters[engine.FED_BYTES] \
                == block * 4 * n_channel
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_feeder_reads_the_read_only_map_and_wraps_at_eof(tmp_path, cuda_device):
    block, n_time = 1 << 14, 2
    data = _capture(block * 5 // 2)  # block 2 wraps past the end
    path = str(tmp_path / "cap.sdriq")
    sdriq.write(path, data, 1_000_000)
    mesh = make_mesh(n_time, 1, [cuda_device] * n_time)
    feeder = hostfeed.ShardedSdriqFeeder(path, mesh, block)
    assert not feeder._mm.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no warning of the read-only map reaches the caller
        fed = [feeder.block(b) for b in range(4)]
    torch.cuda.synchronize()
    for b, shards in enumerate(fed):
        for (t, _), x in shards.items():
            np.testing.assert_array_equal(x.cpu().numpy(), _rows(data, block, b, t, n_time))
