"""The (time × channel) device mesh of the channel-bank gears and the four
collectives they call: the port's counterpart of `jax.sharding.Mesh` with
`lax.ppermute`, `all_gather` and `all_to_all` inside `shard_map`.

A mesh is a grid of shard places, each a (process rank, torch device). A
device may repeat: four shards may sit on one card, or on the CPU, as the
JAX tests' virtual host devices do. A collective takes the parts of the
shards this process holds, `{(t, c): tensor}`, and returns each of them
its result:

  ring_shift      shard (t, c) receives shard ((t−1) mod n_time, c)'s part
                  (lax.ppermute over "time", perm [(i, (i+1) % n_time)])
  all_gather_time the parts of column c tiled along axis 0, in time order
  all_gather      every part tiled along axis 0 in (time, channel) order
  all_to_all      part s split along axis 1 into one chunk per shard; shard
                  d receives chunk d of every part, tiled along axis 0 in
                  (time, channel) order (split_axis=1, concat_axis=0)

Between shards of one process a part moves by a device copy on the current
streams (a peer copy between two cards; none between shards of one device).
Every shard computes its own result, as each of JAX's devices does.
Between processes (`init_distributed`) the parts go through one byte buffer
per collective: `batch_isend_irecv` for the ring, `all_gather` for the
gathers and `all_to_all_single` for the swap, over gloo when the shards are
on the CPU and over NCCL, one card per rank, when they are on cards.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..runtime.engine import resolve_device

@dataclasses.dataclass(frozen=True)
class Place:
    """Where one shard lives: a process of the group and a device of it."""

    rank: int
    device: torch.device


#: the group's places, process-major, once `init_distributed` has run
_GROUP_PLACES: list[Place] = []


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def init_distributed(rank: int | None = None, world_size: int | None = None,
                     init_method: str | None = None, local_devices=None,
                     timeout_s: float = 300.0) -> list[Place]:
    """Join this process to the group (the jax.distributed.initialize
    analog) and return every process's places, process-major. Rank, world
    size and address default to torchrun's RANK, WORLD_SIZE and
    MASTER_ADDR/MASTER_PORT (`env://`). The local devices default to the
    card LOCAL_RANK names, which raises without a card: CPU shards are
    asked for by name (`["cpu", "cpu"]`). Shards on cards take NCCL with
    one card per rank, shards on the CPU gloo, never both."""
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
    if local_devices is None:
        local_devices = [f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"]
    devices = [_indexed(resolve_device(d)) for d in local_devices]
    kinds = {d.type for d in devices}
    if len(kinds) != 1:
        raise ValueError(f"a process's shards lie all on cards or all on the CPU, not {devices}")
    backend = "nccl" if kinds == {"cuda"} else "gloo"
    if backend == "nccl":
        if len(devices) != 1:
            raise ValueError(f"NCCL takes one card per rank, got {devices}")
        torch.cuda.set_device(devices[0])
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    everyone: list = [None] * world_size
    dist.all_gather_object(everyone, [str(d) for d in devices])
    places = [Place(r, torch.device(d)) for r, names in enumerate(everyone) for d in names]
    if len({p.device.type for p in places}) != 1:
        dist.destroy_process_group()
        raise ValueError("the group mixes card and CPU shards; NCCL and gloo do not mix")
    _GROUP_PLACES[:] = places
    return list(places)


def shutdown_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUP_PLACES.clear()


def group_places() -> list[Place]:
    """Every process's places after `init_distributed`, else none."""
    return list(_GROUP_PLACES)


def default_places() -> list[Place]:
    """The group's places after `init_distributed`, else this process's
    visible cards (none without a card)."""
    return group_places() or [Place(0, torch.device("cuda", i))
                              for i in range(torch.cuda.device_count())]


def make_mesh(n_time: int, n_channel: int, devices=None) -> "Mesh":
    """The first n_time·n_channel places as an (n_time, n_channel) grid.
    `devices` are places or devices of this process (repeats allowed);
    the default is `default_places()`."""
    if devices is None:
        places = default_places()
    else:
        places = [d if isinstance(d, Place) else Place(_rank(), _indexed(resolve_device(d)))
                  for d in devices]
    n = n_time * n_channel
    if len(places) < n:
        raise ValueError(f"need {n} devices, have {len(places)}")
    return Mesh(places[:n], n_time, n_channel)


def _indexed(dev: torch.device) -> torch.device:
    """"cuda" as the card it names (the current one), as tensors report it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An (n_time, n_channel) grid of places; `local` lists this process's
    shards in (time, channel) order, `home` is the first one's device."""

    def __init__(self, places: list[Place], n_time: int, n_channel: int):
        if len(places) != n_time * n_channel:
            raise ValueError(f"{len(places)} places for a {n_time}x{n_channel} mesh")
        self.n_time, self.n_channel = int(n_time), int(n_channel)
        self.size = self.n_time * self.n_channel
        self.coords = [(t, c) for t in range(self.n_time) for c in range(self.n_channel)]
        self.places = dict(zip(self.coords, places))
        self.rank = _rank()
        self.local = [k for k in self.coords if self.places[k].rank == self.rank]
        if not self.local:
            raise ValueError(f"process {self.rank} holds no shard of the mesh")
        ranks = {p.rank for p in places}
        self.distributed = ranks != {self.rank}
        if self.distributed:
            if ranks != set(range(dist.get_world_size())):
                raise ValueError(f"the mesh spans ranks {sorted(ranks)}; the collectives "
                                 f"need every rank of the group")
            if len({p.device.type for p in places}) != 1:
                raise ValueError("a mesh across processes lies all on cards or all on the CPU")
        self.home = self.device(self.local[0])
        # the exchange buffers: on the card for NCCL, on the host for gloo
        self._wire = self.home if self.home.type == "cuda" else torch.device("cpu")
        self._held = {r: [k for k in self.coords if self.places[k].rank == r] for r in ranks}

    @property
    def shape(self) -> dict:
        return {"time": self.n_time, "channel": self.n_channel}

    def device(self, coord) -> torch.device:
        return self.places[coord].device

    def index(self, coord) -> int:
        """The shard's position in (time, channel) order."""
        return coord[0] * self.n_channel + coord[1]

    # -- the collectives ---------------------------------------------------

    def ring_shift(self, parts: dict) -> dict:
        """Shard (t, c) receives shard ((t−1) mod n_time, c)'s part."""
        src_of = {k: ((k[0] - 1) % self.n_time, k[1]) for k in self.coords}
        remote = self._p2p(parts, src_of) if self.distributed else {}
        return {k: (parts[src_of[k]] if src_of[k] in parts else remote[k])
                .to(self.device(k), non_blocking=True) for k in self.local}

    def all_gather_time(self, parts: dict) -> dict:
        """Shard (t, c) receives column c's parts tiled along axis 0."""
        every = self._everyone(parts)
        return self._tiled({k: [(t, k[1]) for t in range(self.n_time)] for k in self.local},
                           every)

    def all_gather(self, parts: dict) -> dict:
        """Every shard receives all parts tiled along axis 0."""
        every = self._everyone(parts)
        return self._tiled({k: self.coords for k in self.local}, every)

    def all_to_all(self, parts: dict) -> dict:
        """Part s (F, M) splits along axis 1 into `size` chunks of M/size;
        shard d receives chunk d of every part, tiled along axis 0 in
        (time, channel) order: (size·F, M/size)."""
        template = parts[self.local[0]]
        width = template.shape[1]
        if width % self.size:
            raise ValueError(f"all_to_all: axis 1 of {width} does not split over {self.size} shards")
        sz = width // self.size

        def chunk(k, d):
            i = self.index(d)
            return parts[k][:, i * sz:(i + 1) * sz]

        remote = self._swap(parts, chunk) if self.distributed else {}
        return {d: torch.cat([(chunk(s, d) if s in parts else remote[d, s])
                              .to(self.device(d), non_blocking=True) for s in self.coords], dim=0)
                for d in self.local}

    def from_shard(self, coord, part: torch.Tensor | None, shape, dtype) -> torch.Tensor:
        """Shard `coord`'s part, on this process's home device (a broadcast
        from the process that holds it)."""
        if not self.distributed:
            return part.to(self.home, non_blocking=True)
        owner = self.places[coord].rank
        buf = (_pack([part], self._wire) if owner == self.rank
               else torch.empty(_nbytes(shape, dtype), dtype=torch.uint8, device=self._wire))
        dist.broadcast(buf, src=owner)
        return _unpack(buf, shape, dtype, 1)[0].to(self.home, non_blocking=True)

    # -- across processes --------------------------------------------------

    def _everyone(self, parts: dict) -> dict:
        """Every shard's part: this process's as given, the others' from one
        all_gather of a byte buffer per process (padded to the largest)."""
        if not self.distributed:
            return parts
        template = parts[self.local[0]]
        kmax = max(len(v) for v in self._held.values())
        mine = _pack([parts[k] for k in self.local], self._wire)
        buf = torch.zeros(kmax * _nbytes(template.shape, template.dtype), dtype=torch.uint8,
                          device=self._wire)
        buf[:mine.numel()] = mine
        bufs = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
        dist.all_gather(bufs, buf)
        every = dict(parts)
        for r, held in self._held.items():
            if r != self.rank:
                every.update(zip(held, _unpack(bufs[r], template.shape, template.dtype,
                                               len(held))))
        return every

    def _p2p(self, parts: dict, src_of: dict) -> dict:
        """The ring's remote parts: one send and one receive per peer."""
        template = parts[self.local[0]]
        ops, inbound = [], {}
        peers = sorted(set(self._held) - {self.rank})
        for peer in peers:
            out = [parts[src_of[d]] for d in self._held[peer] if src_of[d] in parts]
            if out:
                ops.append(dist.P2POp(dist.isend, _pack(out, self._wire), peer))
            want = [d for d in self.local if self.places[src_of[d]].rank == peer]
            if want:
                buf = torch.empty(len(want) * _nbytes(template.shape, template.dtype),
                                  dtype=torch.uint8, device=self._wire)
                ops.append(dist.P2POp(dist.irecv, buf, peer))
                inbound[peer] = (want, buf)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        got = {}
        for want, buf in inbound.values():
            got.update(zip(want, _unpack(buf, template.shape, template.dtype, len(want))))
        return got

    def _swap(self, parts: dict, chunk) -> dict:
        """The swap's remote chunks by one all_to_all_single: to each peer,
        for each of its shards d and each of ours s, chunk d of part s."""
        template = chunk(self.local[0], self.local[0])
        each = _nbytes(template.shape, template.dtype)
        world = dist.get_world_size()
        send, in_splits, out_splits = [], [], []
        for r in range(world):
            dests = self._held.get(r, []) if r != self.rank else []
            send += [chunk(s, d) for d in dests for s in self.local]
            in_splits.append(len(dests) * len(self.local) * each)
            srcs = self._held.get(r, []) if r != self.rank else []
            out_splits.append(len(self.local) * len(srcs) * each)
        inp = (_pack(send, self._wire) if send
               else torch.empty(0, dtype=torch.uint8, device=self._wire))
        out = torch.empty(sum(out_splits), dtype=torch.uint8, device=self._wire)
        dist.all_to_all_single(out, inp, out_splits, in_splits)
        got, pos = {}, 0
        for r in range(world):
            if r == self.rank:
                continue
            pairs = [(d, s) for d in self.local for s in self._held.get(r, [])]
            for pair, t in zip(pairs, _unpack(out[pos:pos + len(pairs) * each],
                                              template.shape, template.dtype, len(pairs))):
                got[pair] = t
            pos += len(pairs) * each
        return got

    def _tiled(self, sources: dict, every: dict) -> dict:
        """Each shard's listed parts concatenated on its device along axis 0."""
        return {k: torch.cat([every[s].to(self.device(k), non_blocking=True) for s in srcs],
                             dim=0)
                for k, srcs in sources.items()}


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()


def _pack(parts: list, wire: torch.device) -> torch.Tensor:
    return torch.cat([p.contiguous().view(torch.uint8).reshape(-1).to(wire, non_blocking=True)
                      for p in parts])


def _unpack(buf: torch.Tensor, shape, dtype, count: int) -> list:
    """`count` tensors of (shape, dtype) from the front of a byte buffer."""
    n = _nbytes(shape, dtype)
    return [buf[i * n:(i + 1) * n].clone().view(dtype).reshape(shape) for i in range(count)]
