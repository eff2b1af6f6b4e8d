"""Several receivers in one server: the Rx device sets of one `Session`
(the `server` CLI's MainCore), each a file source over a .sdriq of its own
stream, paced by one absolute clock as live receivers would be.

Layout. The harness's ring block is one round of every set's block: with
D the session's block, set s plays samples s·D to (s+1)·D of each ring
block, so round b's reference is, set by set, the product path's over
ring blocks b − 1 and b. Set-up writes set s's .sdriq of its slices of
the ring under `.portbench_cache/`.

Clock. Round k is released to every set at t0 + k·D/rate, on the
harness's thread, which calls `hooks.feed(k)` at the release. A set's
worker waits for round k before it starts its block k: the wait sits in
the first call of the worker's block loop (`_live_dyn`, wrapped on the
instance), ahead of the `session read` span, so that span times the read
alone. A set that is behind finds its round released and does not wait,
so a backlog shows as block times that grow through the window. No worker
thread calls the hooks: the per-layer metrics read the program's tallies.

Outputs. `_publish_block` is wrapped on each instance to take the block's
outputs (one block behind the newest queued, as the session publishes);
the loop yields round k once every set has published its block k, and the
channels' audio buffers are drained as it goes. Each `loop()` starts the
sets anew from position 0 with fresh state and stops them when it closes.
"""

from __future__ import annotations

import math
import os
import shutil
import statistics
import threading
import time
import weakref

import numpy as np

from .. import judge
from ..reference import chains
from . import kernel_launches
from .rxpipeline import _copy

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(os.path.dirname(os.path.dirname(HERE)), ".portbench_cache")
#: the product numbers a set that published nothing reads
_MISSING = {"audio_err": math.inf, "audio_off_share": math.inf, "audio_head_err": math.inf}


def block_samples(config: dict) -> int:
    return config["sets"] * config["set_block"]


def frequencies(config: dict, traffic: dict):
    return traffic["channels_hz"]


def set_slices(raws, config: dict, s: int) -> list:
    """Set s's blocks of the ring blocks `raws`, in stream order."""
    d = config["set_block"]
    return [r[s * d:(s + 1) * d] for r in raws]


def reference(config: dict, traffic: dict, raws, arith):
    return [chains.product(set_slices(raws, config, s), config, traffic["channels_hz"], arith)
            for s in range(config["sets"])]


def numbers(ours, ref) -> dict:
    """The worst set's product numbers, number by number."""
    if len(ours) != len(ref):
        return dict(_MISSING)
    return judge.combine([judge.product_numbers(o, r) for o, r in zip(ours, ref)])


class System:
    """`config["sets"]` Rx device sets of one Session on `device`, each
    with the configuration's NFM channels at the traffic's offsets."""

    def __init__(self, config: dict, traffic: dict, ring, device):
        from sdrangel_tpu_torch.io import sdriq
        from sdrangel_tpu_torch.runtime import engine
        from sdrangel_tpu_torch.runtime import session as sessionmod

        self.n, self.d = config["sets"], config["set_block"]
        self.period = self.d / config["sample_rate"]
        self.dir = os.path.join(CACHE, f"sessionsets-{os.getpid()}-{id(self):x}")
        os.makedirs(self.dir, exist_ok=True)
        # removed on close, or once the system is gone where a run raised
        # before the harness could close it
        self._remove_dir = weakref.finalize(self, shutil.rmtree, self.dir, ignore_errors=True)
        ch = config["channel"]
        settings = {k: ch[k] for k in ("audio_rate", "rf_bandwidth", "af_bandwidth",
                                       "fm_deviation", "squelch_db", "squelch_gate_ms", "volume")}
        sp = config["spectrum"]
        if sp["window"] != "hanning":
            raise ValueError("the configuration's spectrum window must be hanning")
        self.session = sessionmod.Session(device=device)
        self.sets = []
        for s in range(self.n):
            path = os.path.join(self.dir, f"set{s}.sdriq")
            sdriq.write(path, np.ascontiguousarray(ring[:, s * self.d:(s + 1) * self.d]
                                                   ).reshape(-1, 2),
                        sample_rate=int(config["sample_rate"]), sample_size=16, timestamp=0)
            ds = self.session.add_device_set("rx")
            ds.update_source({
                "kind": "filesource", "file_path": path, "log2_decim": config["log2_decim"],
                "fc_pos": config["fc_pos"], "dc_correction": False, "iq_correction": False,
                "file_preload": config["file_preload"], "throttle": config["throttle"],
                "publish_every": config["publish_every"], "spectrum_fft_size": sp["fft_size"],
                "spectrum_averaging": sp["averaging"], "spectrum_averaging_n": sp["averaging_n"]})
            for f in traffic["channels_hz"]:
                ds.add_channel(ch["uri"], {"inputFrequencyOffset": float(f), **settings})
            self._wrap(ds, s)
            self.sets.append(ds)
        self.ranges = (sessionmod.READ, sessionmod.PUBLISH, *engine.LAYERS, engine.FETCH_WAIT)
        self._clock = threading.Condition()
        self._loops = 0
        self._profiler_ready = False
        self._reset()

    def _reset(self) -> None:
        self._released = -1  # the newest round released
        self._closing = False
        self._asked = [0] * self.n  # blocks each set's worker has begun
        self._published = [0] * self.n  # blocks each set has published
        self._rounds: dict[int, list] = {}  # round -> each set's outputs

    def _wrap(self, ds, s: int) -> None:
        """The clock, the block check and the outputs, on this instance."""
        file_reader, live_dyn, publish = ds._file_reader, ds._live_dyn, ds._publish_block

        def checked_file_reader(mm):
            open_reader = file_reader(mm)

            def opened(block):
                if block != self.d:
                    raise ValueError(f"the session's block is {block}, the "
                                     f"configuration's {self.d}")
                return open_reader(block)
            return opened

        def paced_live_dyn(pipe):
            k = self._asked[s]
            self._asked[s] += 1
            with self._clock:
                self._clock.wait_for(lambda: self._released >= k or self._closing)
            return live_dyn(pipe)

        def taken_publish(outs, chans, egress):
            publish(outs, chans, egress)
            with ds._lock:
                for c in ds.channels:
                    c.audio.clear()
            with self._clock:
                k = self._published[s]
                self._published[s] = k + 1
                self._rounds.setdefault(k, [None] * self.n)[s] = outs
                self._clock.notify_all()

        ds._file_reader, ds._live_dyn, ds._publish_block = (
            checked_file_reader, paced_live_dyn, taken_publish)

    def _check(self) -> None:
        for s, ds in enumerate(self.sets):
            if ds.error or not ds.running:
                raise RuntimeError(f"device set {s} stopped: {ds.error or 'no error given'}")

    def loop(self, hooks):
        if hooks.trace_on and not self._profiler_ready:
            # a process's first profiler takes seconds to start (CUPTI's
            # set-up): inside the window the clock would then release the
            # rounds due meanwhile in one burst, and the profiled stretch
            # would end within it. So one starts and stops here, first.
            import torch

            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]):
                pass
            self._profiler_ready = True
        self._reset()
        for ds in self.sets:
            ds.start()
        late: list[float] = []
        release, out = 0, 0  # the next round to release, to yield
        t0 = time.perf_counter()
        try:
            while True:
                with self._clock:
                    while True:
                        self._check()
                        now = time.perf_counter()
                        due = t0 + release * self.period
                        ready = min(self._published) > out
                        if now >= due or ready:
                            break
                        self._clock.wait(due - now)
                if now >= due:  # the clock first: a round is due
                    hooks.feed(release)
                    with self._clock:
                        late.append(time.perf_counter() - due)
                        self._released = release
                        self._clock.notify_all()
                    release += 1
                    continue
                with self._clock:
                    outs = self._rounds.pop(out)
                yield out, outs
                out += 1
        finally:
            behind = [release - p for p in self._published]
            self._stop()
            if late:
                print(f"sessionsets loop {self._loops}: {release} rounds released; clock late "
                      f"ms median {statistics.median(late) * 1e3:.4f} largest "
                      f"{max(late) * 1e3:.4f}; blocks behind by set at the end: "
                      + ", ".join(str(b) for b in behind), flush=True)
            self._loops += 1

    def _stop(self) -> None:
        """Stop every set at once: each finishes its block and publishes
        what it has queued."""
        stops = [threading.Thread(target=ds.stop) for ds in self.sets]
        for t in stops:
            t.start()
        with self._clock:
            self._closing = True
            self._clock.notify_all()
        for t in stops:
            t.join()
        with self._clock:
            self._rounds.clear()

    copy = staticmethod(_copy)

    launches = staticmethod(kernel_launches)

    def close(self) -> None:
        self._stop()
        self.session.shutdown()
        del self.sets, self.session
        self._remove_dir()
