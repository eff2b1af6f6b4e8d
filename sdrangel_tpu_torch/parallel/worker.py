"""One process of a mesh that spans processes: the channel-bank gear's raw
step, or a session whose device set runs sharded, on this process's shards.

    torchrun --nproc-per-node 2 -m sdrangel_tpu_torch.parallel.worker \\
        --capture cap.sdriq --out outdir [--mode step|session] [--blocks 2]
    python -m sdrangel_tpu_torch.parallel.worker --rank R --world-size W \\
        --init-method tcp://127.0.0.1:PORT --local-devices cpu,cpu ...

Rank, world size and address come from torchrun's environment unless
given. Each process holds --local-devices (default: the card LOCAL_RANK
names, NCCL, one card per rank; `cpu,cpu` for CPU shards over gloo; no
card and no --local-devices raises), the global mesh is laid
out process-major, each process reads only its own time rows of the
capture, and writes outdir/audio_pR.npy with the audio rows it holds and
outdir/rows_pR.npy with their channel indices.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from . import mesh as meshmod
from . import sharded
from .hostfeed import ShardedSdriqFeeder

NFM_SETTINGS = {"squelch_db": -100.0, "squelch_gate_ms": 1.0}


def run_step(args, local: list) -> tuple[list, np.ndarray]:
    """The raw step over --blocks blocks: (rows held, (rows, samples) audio)."""
    cfg = sharded.ShardedPipelineConfig(
        n_time=args.n_time, n_channel=args.n_channel, log2_decim=args.log2_decim,
        block=args.block, n_channels=args.n_channels)
    mesh = meshmod.make_mesh(args.n_time, args.n_channel)
    step, init_fn = sharded.build_sharded_step(cfg, mesh)
    state, carry = init_fn()
    feeder = ShardedSdriqFeeder(args.capture, mesh, cfg.block)
    offsets = torch.full((cfg.n_channels,), args.offset_hz, dtype=torch.float32)
    blocks = []
    for b in range(args.blocks):
        state, audio, carry = step(state, feeder.block(b), carry, offsets)
        blocks.append(audio.cpu().numpy())
    return [int(r) for r in step.rows[0]], np.concatenate(blocks, axis=-1)


def run_session(args, local: list) -> tuple[list, np.ndarray]:
    """A session's sharded filesource set, stopped by run_blocks in step with
    the other processes: (channels published, their drained audio)."""
    from ..runtime.session import Session

    sess = Session(device=local[0])
    ds = sess.add_device_set()
    ds.update_source({
        "kind": "filesource", "file_path": args.capture, "log2_decim": args.log2_decim,
        "sharded": True, "mesh_time": args.n_time, "mesh_channel": args.n_channel,
        "sharded_block": args.block, "run_blocks": args.blocks,
    })
    for _ in range(args.n_channels):
        ds.add_channel(sharded.NFM_URI, {"inputFrequencyOffset": args.offset_hz,
                                         **NFM_SETTINGS})
    ds.start()
    t0 = time.time()
    while ds.running and not ds.error:
        if time.time() - t0 > args.timeout:
            raise TimeoutError(f"{ds.blocks_processed}/{args.blocks} blocks in {args.timeout} s")
        time.sleep(0.02)
    ds.stop()
    if ds.error:
        raise RuntimeError(f"device set error: {ds.error}")
    if ds.blocks_processed != args.blocks:
        raise RuntimeError(f"{ds.blocks_processed} blocks published, {args.blocks} asked")
    rows, audio = [], []
    for c in range(args.n_channels):
        a = ds.drain_audio(c)
        if a.size:
            rows.append(c)
            audio.append(a)
    return rows, np.stack(audio)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sdrangel_tpu_torch.parallel.worker")
    p.add_argument("--capture", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--mode", choices=("step", "session"), default="step")
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--world-size", type=int, default=None)
    p.add_argument("--init-method", default=None, help="default env:// (torchrun)")
    p.add_argument("--local-devices", default=None,
                   help="comma-separated, e.g. cpu,cpu for gloo on the CPU (default: "
                        "the card LOCAL_RANK names)")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds a collective or the session may wait")
    p.add_argument("--blocks", type=int, default=2)
    p.add_argument("--n-time", type=int, default=2)
    p.add_argument("--n-channel", type=int, default=2)
    p.add_argument("--log2-decim", type=int, default=3)
    p.add_argument("--block", type=int, default=1 << 15)
    p.add_argument("--n-channels", type=int, default=8)
    p.add_argument("--offset-hz", type=float, default=20_000.0)
    args = p.parse_args(argv)
    local = args.local_devices.split(",") if args.local_devices else None
    meshmod.init_distributed(args.rank, args.world_size, args.init_method, local,
                             timeout_s=args.timeout)
    try:
        rank = torch.distributed.get_rank()
        local = [pl.device for pl in meshmod.group_places() if pl.rank == rank]
        rows, audio = (run_session if args.mode == "session" else run_step)(args, local)
        os.makedirs(args.out, exist_ok=True)
        np.save(os.path.join(args.out, f"audio_p{rank}.npy"), audio)
        np.save(os.path.join(args.out, f"rows_p{rank}.npy"), np.asarray(rows, np.int32))
        print(f"process {rank}: rows {rows} ok", flush=True)
    finally:
        meshmod.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
