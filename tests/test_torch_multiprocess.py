"""A mesh across processes: two gloo processes of
`python -m sdrangel_tpu_torch.parallel.worker`, each holding two CPU shards
of one 2×2 mesh (process-major, so each holds one time row), each reading
its own rows of the capture. Their combined rows equal the same mesh in one
process: the raw step's audio, and a session's published audio. Each
process has its own time limits (the process group's and the test's), so a
collective that deadlocks fails the test instead of the suite's clock.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

from sdrangel_tpu_torch.io import sdriq, testsource
from sdrangel_tpu_torch.parallel import mesh as pmesh
from sdrangel_tpu_torch.parallel import sharded
from sdrangel_tpu_torch.parallel.hostfeed import ShardedSdriqFeeder
from sdrangel_tpu_torch.runtime.session import Session
from torch_port_util import CPU, n

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK, N_BLOCKS, RATE = 1 << 15, 2, 768_000.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _capture(tmp_path) -> str:
    src = testsource.TestSourceConfig(sample_rate=RATE, carrier_freq=20_000.0,
                                      modulation="fm", tone_freq=900.0, fm_deviation=5000.0,
                                      amplitude=0.4)
    path = str(tmp_path / "cap.sdriq")
    sdriq.write(path, testsource.to_iq_int16(testsource.generate(src, BLOCK * N_BLOCKS)),
                sample_rate=int(RATE))
    return path


def _two_processes(cap: str, out: str, mode: str) -> dict:
    """Both workers' rows, {channel: audio}."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sdrangel_tpu_torch.parallel.worker", "--mode", mode,
         "--rank", str(r), "--world-size", "2", "--init-method", f"tcp://127.0.0.1:{port}",
         "--local-devices", "cpu,cpu", "--timeout", "60", "--capture", cap, "--out", out,
         "--blocks", str(N_BLOCKS)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"process {r}:\n{outs[r][-3000:]}"
    audio = {}
    for r in range(2):
        rows = np.load(os.path.join(out, f"rows_p{r}.npy"))
        data = np.load(os.path.join(out, f"audio_p{r}.npy"))
        assert len(rows) == 4, rows  # half the bank: the channel chunks of its time row
        audio.update(zip(rows.tolist(), data))
    assert sorted(audio) == list(range(8))
    return audio


def test_two_process_mesh_matches_one_process(tmp_path):
    cap = _capture(tmp_path)
    audio = _two_processes(cap, str(tmp_path / "step"), "step")
    cfg = sharded.ShardedPipelineConfig(n_time=2, n_channel=2, log2_decim=3, block=BLOCK,
                                        n_channels=8)
    mesh = pmesh.make_mesh(2, 2, [CPU] * 4)
    step, init_fn = sharded.build_sharded_step(cfg, mesh)
    state, carry = init_fn()
    feeder = ShardedSdriqFeeder(cap, mesh, BLOCK)
    ref = []
    for b in range(N_BLOCKS):
        state, a, carry = step(state, feeder.block(b), carry, torch.full((8,), 20_000.0))
        ref.append(n(a))
    ref = np.concatenate(ref, axis=-1)
    assert np.abs(ref).max() > 0.01
    for c in range(8):
        np.testing.assert_array_equal(audio[c], ref[c])


def test_two_process_session_matches_one_process(tmp_path):
    cap = _capture(tmp_path)
    audio = _two_processes(cap, str(tmp_path / "session"), "session")
    sess = Session(device=CPU)
    ds = sess.add_device_set()
    ds.update_source({"kind": "filesource", "file_path": cap, "log2_decim": 3,
                      "sharded": True, "mesh_time": 2, "mesh_channel": 2,
                      "sharded_block": BLOCK, "run_blocks": N_BLOCKS})
    for _ in range(8):
        ds.add_channel(sharded.NFM_URI, {"inputFrequencyOffset": 20_000.0,
                                         "squelch_db": -100.0, "squelch_gate_ms": 1.0})
    ds.start()
    ds._thread.join(timeout=120)
    assert not ds.running and not ds.error, ds.error
    assert ds.blocks_processed == N_BLOCKS
    for c in range(8):
        ref = ds.drain_audio(c)
        assert ref.size and np.abs(ref).max() > 0.01
        np.testing.assert_array_equal(audio[c], ref)
