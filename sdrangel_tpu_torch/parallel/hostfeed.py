"""Host feeding of the time-sharded gears from a `.sdriq` capture.

Each process memory-maps the capture and reads only the time rows of the
shards it holds (the `jax.make_array_from_callback` role of the JAX
package's hostfeed.py): a block reaches the gear as `{(t, c): shard}`,
time row t being global samples [b·B + t·B/n_time, b·B + (t+1)·B/n_time),
read once and uploaded to each shard of the row. The same code
feeds one process with every shard and each process of a mesh across
processes with its own.

A row whose shards lie on cards is staged: it is copied once into the
next of a ring of two pinned buffers that the mesh keeps for the row
(`Mesh.staging`), and uploaded from there to each shard without blocking
the host. An event per card, recorded after the slot's uploads, is waited
on before the host writes into the slot again. A row on the CPU is copied
into a fresh array each block: there the host tensor is the shard the step
holds, so a reused buffer would alias one block's shard with the next's.
"""

from __future__ import annotations

import warnings
from typing import Callable

import numpy as np
import torch

from ..io import sdriq
from ..runtime import tracing
from ..runtime.engine import FED_BYTES, PINNED_BYTES
from .mesh import Mesh

#: the span of the host copy of a block's rows
COPY = "hostfeed copy"
#: the bytes uploaded to shards from a pinned staging slot (as `fed bytes`:
#: a row's bytes once per shard of the row)
STAGED_BYTES = "hostfeed staged bytes"
#: the pinned buffers a staged time row cycles through
SLOTS = 2


class _Slot:
    """A pinned (rows, 2) int16 buffer and the events recorded after its
    last uploads, one per card."""

    def __init__(self, rows: int):
        self.host = torch.empty((rows, 2), dtype=torch.int16, pin_memory=True)
        tracing.count(PINNED_BYTES, self.host.nbytes)
        self.done: list[torch.cuda.Event] = []

    def uploaded(self, devices) -> None:
        self.done = []
        for dev in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            self.done.append(ev)


class _Ring:
    """A time row's staging slots, each allocated on first use."""

    def __init__(self, rows: int):
        self.rows = rows
        self.slots: list[_Slot | None] = [None] * SLOTS
        self.turn = 0

    def take(self) -> _Slot:
        """The next slot, once its last uploads have run."""
        i, self.turn = self.turn, (self.turn + 1) % SLOTS
        if self.slots[i] is None:
            self.slots[i] = _Slot(self.rows)
        for ev in self.slots[i].done:
            ev.synchronize()
        return self.slots[i]


def _slot(mesh: Mesh, t: int, rows: int) -> _Slot:
    ring = mesh.staging.get(t)
    if ring is None or ring.rows != rows:
        ring = mesh.staging[t] = _Ring(rows)
    return ring.take()


def _copy(row: np.ndarray, slot: _Slot | None) -> torch.Tensor:
    """The row as an int16 host tensor: into the slot (torch's copy, which
    runs on the intra-op threads), else a fresh array. Either copy also
    lifts a view of the read-only memory map."""
    if slot is None:
        return torch.from_numpy(np.array(row, dtype=np.int16))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # a read-only view, only read here
        src = torch.from_numpy(row)
    return slot.host.copy_(src)


def shard_block(mesh: Mesh, block_size: int, b: int,
                read: Callable[[int, int], np.ndarray]) -> dict:
    """Block b as this process's shards: `read(start, count)` gives a
    (count, 2) int16 row, read once per local time row."""
    rows = block_size // mesh.n_time
    held: dict[int, list] = {}
    for k in mesh.local:
        held.setdefault(k[0], []).append(k)
    slots = {t: _slot(mesh, t, rows) for t, keys in held.items()
             if all(mesh.device(k).type == "cuda" for k in keys)}
    with tracing.span(COPY):
        host = {t: _copy(read(b * block_size + t * rows, rows), slots.get(t)) for t in held}
    shards = {}
    for k in mesh.local:
        staged = k[0] in slots
        tracing.count(FED_BYTES, host[k[0]].nbytes)
        if staged:
            tracing.count(STAGED_BYTES, host[k[0]].nbytes)
        shards[k] = host[k[0]].to(mesh.device(k), non_blocking=staged)
    for t, slot in slots.items():
        slot.uploaded({mesh.device(k) for k in held[t]})
    return shards


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
