"""Host feeding of the time-sharded gears from a `.sdriq` capture.

Each process memory-maps the capture and reads only the time rows of the
shards it holds (the `jax.make_array_from_callback` role of the JAX
package's hostfeed.py): a block reaches the gear as `{(t, c): shard}`,
time row t being global samples [b·B + t·B/n_time, b·B + (t+1)·B/n_time),
read once and uploaded to each shard of the row. The same code
feeds one process with every shard and each process of a mesh across
processes with its own.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..io import sdriq
from ..runtime import tracing
from ..runtime.engine import FED_BYTES
from .mesh import Mesh

#: the span of the host copy of a block's rows
COPY = "hostfeed copy"


def shard_block(mesh: Mesh, block_size: int, b: int,
                read: Callable[[int, int], np.ndarray]) -> dict:
    """Block b as this process's shards: `read(start, count)` gives a
    (count, 2) int16 row, read once per local time row."""
    rows = block_size // mesh.n_time
    # a copy: the row may be a view of the read-only memory map
    with tracing.span(COPY):
        host = {t: torch.from_numpy(np.array(read(b * block_size + t * rows, rows),
                                             dtype=np.int16))
                for t in sorted({k[0] for k in mesh.local})}
    for k in mesh.local:
        tracing.count(FED_BYTES, host[k[0]].nbytes)
    return {k: host[k[0]].to(mesh.device(k)) for k in mesh.local}


class ShardedSdriqFeeder:
    """Per-block time shards of a 16-bit `.sdriq`, looping at EOF like the
    reference file source (filesourcethread.cpp:188-195) unless wrap=False,
    where a block past the end raises EOFError."""

    def __init__(self, path: str, mesh: Mesh, block_size: int, wrap: bool = True):
        self.info, self._mm = sdriq.open_mmap(path)
        if self.info.sample_size != 16:
            raise ValueError("sharded feeder currently expects 16-bit captures")
        self.mesh = mesh
        self.block_size = int(block_size)
        self.wrap = wrap
        if self.block_size % mesh.n_time:
            raise ValueError(f"block_size {block_size} not divisible by time axis "
                             f"{mesh.n_time}")

    @property
    def n_samples(self) -> int:
        return self._mm.shape[0]

    def n_blocks(self) -> int:
        return self._mm.shape[0] // self.block_size

    def block(self, b: int) -> dict:
        if not self.wrap and (b + 1) * self.block_size > self.n_samples:
            raise EOFError
        return shard_block(self.mesh, self.block_size, b,
                           lambda start, count: sdriq.read_block(self._mm, start, count,
                                                                 wrap=self.wrap))
