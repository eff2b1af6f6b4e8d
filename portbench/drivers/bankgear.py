"""The channel-bank gear: the step `parallel.sharded.build_sharded_step`
returns, on the configuration's mesh, with the audio fetched one block
behind, as the sharded session drives it, each block fed from host
memory through `parallel.hostfeed.shard_block` (a numpy copy of the
block, then its upload)."""

from __future__ import annotations

import numpy as np
import torch

from .. import judge
from . import kernel_launches
from ..reference import chains

HARNESS_SPANS = ("feed", "step", "fetch")


def block_samples(config: dict) -> int:
    return config["block"]


def frequencies(config: dict, traffic: dict):
    """The demods' frequencies, each inside the baseband."""
    half = config["sample_rate"] / (1 << config["log2_decim"]) / 2
    offsets = config["offsets_hz"]
    if any(not -half <= f < half for f in offsets):
        raise ValueError(f"an offset lies outside the baseband of ±{half} Hz")
    return offsets


def reference(config: dict, traffic: dict, raws, arith):
    return chains.bank(raws, config, arith)


def numbers(ours, ref) -> dict:
    return judge.bank_numbers(ours, ref)


class System:
    def __init__(self, config: dict, traffic: dict, ring, device):
        from sdrangel_tpu_torch.parallel import hostfeed, mesh, sharded

        b = config["bank"]
        cfg = sharded.ShardedPipelineConfig(
            n_time=config["mesh_time"], n_channel=config["mesh_channel"],
            device_rate=float(config["sample_rate"]), log2_decim=config["log2_decim"],
            fc_pos=config["fc_pos"], block=config["block"], pfb_m=config["pfb_m"],
            pfb_taps=config["pfb_taps"],
            bank=(sharded.BankGroup(b["uri"], b["count"], dict(b["settings"])),))
        self.mesh = mesh.make_mesh(cfg.n_time, cfg.n_channel, [device] * (cfg.n_time * cfg.n_channel))
        self.step, self.init = sharded.build_sharded_step(cfg, self.mesh)
        idx, res = sharded.grid_split(cfg, np.asarray(config["offsets_hz"]))
        self.res = torch.from_numpy(res).to(device)
        self.idx = torch.from_numpy(idx).to(torch.int64).to(device)
        self.block = config["block"]
        self.ring = ring
        self.shard_block = hostfeed.shard_block
        self.ranges = (*sharded.LAYERS, *("portbench " + s for s in HARNESS_SPANS))

    def _read(self, start: int, count: int) -> np.ndarray:
        blk = self.ring[(start // self.block) % len(self.ring)]
        off = start % self.block
        return blk[off:off + count]

    def feed(self, b: int):
        return self.shard_block(self.mesh, self.block, b, self._read)

    def loop(self, hooks):
        state, carry = self.init()
        pending = None
        b = 0
        while True:
            hooks.feed(b)
            with hooks.span("feed"):
                x = self.feed(b)
            with hooks.span("step"):
                state, audio, carry = self.step(state, x, carry, self.res, self.idx)
            if pending is not None:
                with hooks.span("fetch"):
                    out = pending[1].cpu().numpy()
                yield pending[0], out
            pending = (b, audio)
            b += 1

    @staticmethod
    def copy(outputs):
        return np.array(outputs)

    launches = staticmethod(kernel_launches)

    def close(self) -> None:
        del self.step, self.init
