"""The port's daemon transport (`io/daemon.py`, its native GF(256) codec in
`io/fec.py`) and the daemon source and sink of its sessions, against the
JAX package: the superframe datagrams byte for byte, the assembler's
frames and statistics under loss, the auto-FEC trajectory, each side's
sender into the other's receiver over localhost UDP, where the native codec
is built, and tests/test_tx.py's lossy-relay loopback on the port's Tx and
Rx sessions.
"""

import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from sdrangel_tpu.io import daemon as jdaemon
from sdrangel_tpu_torch.io import daemon as pdaemon
from sdrangel_tpu_torch.io import fec as pfec
from sdrangel_tpu_torch.runtime import session as psession
from torch_port_util import CPU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_wire_constants_equal_jax():
    for name in ("BLOCK_BYTES", "DATA_BLOCKS", "_FEEDBACK_MAGIC"):
        assert getattr(pdaemon, name) == getattr(jdaemon, name)
    for name in ("_HDR", "_META", "_FEEDBACK"):
        assert getattr(pdaemon, name).format == getattr(jdaemon, name).format


@pytest.mark.parametrize("n_fec", [0, 4, 8, 16])
def test_superframe_datagrams_byte_equal_jax(n_fec):
    rng = np.random.default_rng(3 + n_fec)
    for n_samples in (8000, (pdaemon.DATA_BLOCKS - 1) * pdaemon.BLOCK_BYTES // 4, 1):
        payload = rng.integers(-2000, 2000, size=(n_samples, 2), dtype=np.int16).tobytes()
        kw = dict(center_frequency=100_000_000, sample_rate=250_000)
        p = pdaemon.make_superframe(7, payload, n_fec, **kw)
        assert p == jdaemon.make_superframe(7, payload, n_fec, **kw)
        assert len(p) == pdaemon.DATA_BLOCKS + n_fec


def _lossy_grams(seed: int) -> list[bytes]:
    """20 superframes of 8 parity blocks: most lose a few datagrams within
    the budget; frames 4, 7 and 10-17 lose 20 or 36, never complete, and are
    evicted as failed once more than 8 wait in the slots; frame 9 arrives
    twice."""
    rng = np.random.default_rng(seed)
    grams = []
    for fi in range(20):
        payload = rng.integers(-3000, 3000, size=(16_000, 2), dtype=np.int16).tobytes()
        frame = pdaemon.make_superframe(fi, payload, 8, sample_rate=48_000)
        n_drop = 36 if fi == 7 else 20 if fi == 4 or 10 <= fi < 18 else int(rng.integers(0, 9))
        keep = sorted(set(range(len(frame))) - set(rng.choice(len(frame), n_drop,
                                                              replace=False).tolist()))
        grams += [frame[i] for i in keep]
        if fi == 9:
            grams += [frame[i] for i in keep[:20]]  # late duplicates
    return grams


def test_assembler_under_loss_equals_jax():
    p, j = pdaemon.SuperframeAssembler(), jdaemon.SuperframeAssembler()
    decided = 0
    for k, g in enumerate(_lossy_grams(5)):
        po, jo = p.feed(g), j.feed(g)
        assert (po is None) == (jo is None), k
        if po is not None:
            assert po == jo
            decided += 1
        assert p.stats == pdaemon.FrameStats(**vars(j.stats)), k
        if k % 97 == 0:
            assert p.take_interval() == j.take_interval()
    assert decided == p.stats.frames_ok == 10
    assert p.stats.frames_failed >= 2 and p.stats.blocks_recovered > 0
    assert p.stats.frames_failed + len(p.slots) == 10
    # a short datagram is ignored
    assert p.feed(b"\x00" * 10) is None and j.feed(b"\x00" * 10) is None


def _bound_sender(mod, **kw):
    tx = mod.DaemonSender("127.0.0.1", 9, **kw)
    tx._sock.bind(("127.0.0.1", 0))
    return tx


def test_auto_fec_trajectory_equals_jax():
    """The same receiver feedback — a link that loses every 10th datagram,
    then a clean one, then a burst of failed frames — drives both senders'
    n_fec along the same path (the link is simulated with the JAX sender's
    n_fec, so the port's must follow it step for step)."""
    p_tx = _bound_sender(pdaemon, n_fec=1, auto_fec=True)
    j_tx = _bound_sender(jdaemon, n_fec=1, auto_fec=True)
    fb = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    asm = jdaemon.SuperframeAssembler()
    payload = np.random.default_rng(0).integers(-2048, 2048, (16_000, 2), np.int16).tobytes()
    path, count = [], 0
    try:
        for fi, drop_every in enumerate([10] * 26 + [0] * 12 + [3] * 6):
            for g in jdaemon.make_superframe(fi, payload, j_tx.n_fec):
                count += 1
                if not (drop_every and count % drop_every == 0):
                    asm.feed(g)
            decided = asm.stats.frames_ok + asm.stats.frames_failed
            if fi % 2 == 1 and decided:
                exp, rec, failed, ok = asm.take_interval()
                raw = jdaemon._FEEDBACK_MAGIC + jdaemon._FEEDBACK.pack(exp, rec, failed, ok)
                for tx in (p_tx, j_tx):
                    fb.sendto(raw, tx._sock.getsockname())
                fb.sendto(b"noise", p_tx._sock.getsockname())
                time.sleep(0.01)
                p_tx.poll_feedback()
                j_tx.poll_feedback()
            assert p_tx.n_fec == j_tx.n_fec, (fi, path)
            path.append(p_tx.n_fec)
    finally:
        for s in (p_tx, j_tx, fb):
            s.close()
    assert max(path[:26]) >= 14 and path[37] < max(path[:26]) and path[-1] > path[37], path


@pytest.mark.parametrize("sender,receiver", [(jdaemon, pdaemon), (pdaemon, jdaemon)])
def test_wire_interop_over_udp(sender, receiver):
    """One package's sender into the other's receiver over localhost UDP:
    three frames arrive whole, with their metadata, and the receiver's
    feedback datagram reaches the sender."""
    rx = receiver.DaemonReceiver("127.0.0.1", 0, timeout=5.0, feedback_every=2)
    tx = sender.DaemonSender("127.0.0.1", rx.port, n_fec=4, center_frequency=7_000_000,
                             sample_rate=48_000)
    try:
        rng = np.random.default_rng(4)
        for _ in range(3):
            iq = rng.integers(-5000, 5000, size=(4096, 2), dtype=np.int16)
            tx.send_iq(iq)
            got, meta = rx.recv_frame()
            np.testing.assert_array_equal(got[:len(iq)], iq)
            assert meta["sample_rate"] == 48_000 and meta["center_frequency"] == 7_000_000
        assert tx.frame_index == 3 and rx.assembler.stats.frames_ok == 3
        tx._sock.settimeout(5.0)
        raw, _ = tx._sock.recvfrom(256)
        assert raw.startswith(sender._FEEDBACK_MAGIC)
        assert sender._FEEDBACK.unpack_from(raw, 4)[3] == 2  # two frames decoded
    finally:
        tx.close()
        rx.close()


_BUILD_CHECK = """
import os, sys

class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sdrangel_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, NoJax())
jax_so = os.path.join("native", "libfecgf256.so")
before = os.stat(jax_so).st_mtime_ns if os.path.exists(jax_so) else None
from sdrangel_tpu_torch.io import fec
assert fec.native_available()
maps = open("/proc/self/maps").read()
assert fec.library_path() in maps, fec.library_path()
assert os.path.realpath(jax_so) not in maps
after = os.stat(jax_so).st_mtime_ns if os.path.exists(jax_so) else None
assert before == after, (before, after)
print(fec.library_path())
"""


def test_native_codec_builds_into_the_ports_build_dir():
    """The port builds native/fec_gf256.cc into its own kernels/_build/
    and never writes or loads the JAX package's native/libfecgf256.so (in
    a fresh process, with jax and the JAX package blocked)."""
    proc = subprocess.run([sys.executable, "-c", _BUILD_CHECK], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    path = proc.stdout.strip()
    assert os.path.dirname(path) == os.path.join(REPO, "sdrangel_tpu_torch", "kernels", "_build")
    assert os.path.basename(path).startswith("libfecgf256_") and os.path.exists(path)


def test_numpy_path_when_native_is_switched_off(monkeypatch):
    monkeypatch.setenv("SDRANGEL_TPU_NO_NATIVE_FEC", "1")
    assert not pfec.native_available()
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, size=(12, 40), dtype=np.uint8)
    parity = pfec.fec_encode(data, 3)
    received = {i: data[i] for i in range(3, 12)}
    received.update({12 + r: parity[r] for r in range(3)})
    np.testing.assert_array_equal(pfec.fec_decode(received, 12, 40), data)


# -- the session's daemon source and sink --------------------------------------------------------


def test_daemon_sink_sends_whole_superframes_and_carries_the_rest():
    """Uneven int16 blocks leave as whole superframes of payload_room // 4
    samples, in order; complex blocks are rounded and clipped as the JAX
    session does. Each write's frames (at most 2, 260 datagrams) are read
    before the next write, so the receive buffer never has to hold more."""
    rx = pdaemon.DaemonReceiver("127.0.0.1", 0, timeout=5.0)
    rx._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 23)
    sink = psession.SinkSettings(kind="daemonsink", daemon_port=rx.port, daemon_fec=2,
                                 sample_rate=96_000.0)
    out = psession.DaemonSink(sink)
    room = out.room
    assert room == (pdaemon.DATA_BLOCKS - 1) * pdaemon.BLOCK_BYTES // 4
    rng = np.random.default_rng(6)
    z = ((rng.standard_normal(room) + 1j * rng.standard_normal(room)) * 0.6).astype(np.complex64)
    blocks = [rng.integers(-30000, 30000, size=(size, 2), dtype=np.int16)
              for size in (room // 3, room, 2 * room + 7)] + [z]
    sent, frames = [], []
    try:
        for blk in blocks:
            before = out.sender.frame_index
            out.write(blk)
            frames += [rx.recv_frame()[0] for _ in range(out.sender.frame_index - before)]
            sent.append(blk if blk.dtype == np.int16 else np.stack(
                [np.clip(np.round(z.real * 32768.0), -32768, 32767),
                 np.clip(np.round(z.imag * 32768.0), -32768, 32767)], -1).astype(np.int16))
        stream = np.concatenate(sent)
        assert len(frames) == len(stream) // room == 4
        assert len(out.carry) == len(stream) % room
        np.testing.assert_array_equal(np.concatenate(frames), stream[:4 * room])
    finally:
        out.close()
        rx.close()


def test_daemon_source_reads_frames_and_emits_silence_in_a_gap():
    src = psession.DaemonSource("127.0.0.1", 0, gap_s=0.3)
    tx = pdaemon.DaemonSender("127.0.0.1", src.rx.port, n_fec=2)
    try:
        iq = np.random.default_rng(2).integers(-900, 900, size=(10_000, 2), dtype=np.int16)
        tx.send_iq(iq)
        np.testing.assert_array_equal(src.read(6000), iq[:6000])
        t0 = time.perf_counter()
        got = src.read(6000)  # 4000 samples left, then a gap
        assert time.perf_counter() - t0 >= 0.25
        np.testing.assert_array_equal(got[:4000], iq[6000:])
        assert not got[4000:].any()
        assert src.stats.frames_ok == 1
    finally:
        tx.close()
        src.close()
    assert not src._thread.is_alive()


def _tone_snr_longest_run(audio: np.ndarray) -> tuple[int, float]:
    """tests/test_tx.py's measure: the longest active run (the network
    source emits silence in a stream gap), its first quarter dropped."""
    active = np.abs(audio) > 1e-4
    edges = np.flatnonzero(np.diff(np.concatenate([[0], active.view(np.int8), [0]])))
    start, end = max(zip(edges[0::2], edges[1::2]), key=lambda r: r[1] - r[0])
    a = audio[start:end]
    size = a.size
    a = a[a.size // 4:]
    a = a - a.mean()
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a)))) ** 2
    freqs = np.fft.rfftfreq(len(a), 1.0 / 48000.0)
    tone = np.abs(freqs - 1000.0) < 10 * 48000.0 / len(a)
    return size, 10 * np.log10(spec[tone].sum() / max(spec[~tone & (freqs > 100)].sum(), 1e-30))


def _daemonsink_lossy_relay_roundtrip():
    relay = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    relay.bind(("127.0.0.1", 0))
    relay.settimeout(0.2)
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    rx_port = probe.getsockname()[1]
    probe.close()
    stop = threading.Event()

    def pump():
        k = 0
        while not stop.is_set():
            try:
                raw, _ = relay.recvfrom(4096)
                k += 1
                if k % 16 == 0:
                    continue  # drop every 16th datagram
                relay.sendto(raw, ("127.0.0.1", rx_port))
            except (TimeoutError, OSError):
                continue

    pump_t = threading.Thread(target=pump, daemon=True)
    pump_t.start()
    ds_tx = psession.Session(device=CPU).add_device_set("tx")
    ds_tx.update_source({"kind": "daemonsink", "sample_rate": 96_000.0, "log2_interp": 1,
                         "daemon_address": "127.0.0.1", "daemon_port": relay.getsockname()[1],
                         "daemon_fec": 24, "throttle": True})
    ds_tx.add_channel("sdrangel.channeltx.modnfm", {"inputFrequencyOffset": 20_000.0,
                                                    "toneFrequency": 1000.0,
                                                    "fm_deviation": 5000.0})
    ds_rx = psession.Session(device=CPU).add_device_set("rx")
    ds_rx.update_source({"kind": "daemonsource", "daemon_port": rx_port,
                         "sample_rate": 96_000.0})
    ds_rx.add_channel("sdrangel.channel.nfmdemod", {"inputFrequencyOffset": 20_000.0,
                                                    "squelch_db": -60.0, "squelch_gate_ms": 1.0})
    audio = np.zeros(0, np.float32)
    try:
        ds_tx.start()
        deadline = time.time() + 120
        while time.time() < deadline and ds_tx.blocks_processed < 3 and not ds_tx.error:
            time.sleep(0.1)
        assert not ds_tx.error, ds_tx.error
        ds_rx.start()
        deadline = time.time() + 240
        while time.time() < deadline and not (ds_tx.error or ds_rx.error):
            time.sleep(0.2)
            audio = np.concatenate([audio, ds_rx.drain_audio(0).ravel()])
            if audio.size >= 48000:
                break
    finally:
        ds_tx.stop()
        ds_rx.stop()
        stop.set()
        pump_t.join(timeout=3)
        relay.close()
    assert not ds_tx.error and not ds_rx.error, (ds_tx.error, ds_rx.error)
    assert audio.size >= 24000, f"only {audio.size} audio samples"
    run, snr = _tone_snr_longest_run(audio)
    assert run >= 16000, f"longest active run only {run}"
    assert snr > 15.0, f"daemonsink->daemonsource audio SNR {snr:.1f} dB"
    stats = ds_rx.daemon_stats
    assert stats.frames_ok > 0 and stats.blocks_recovered > 0
    assert not ds_rx._daemon  # the worker closed its socket


def test_daemonsink_tx_to_daemonsource_rx_over_lossy_relay():
    """tests/test_tx.py's loopback on the port's sessions: a Tx set streams
    NFM at +20 kHz (96 kHz, FEC 24) through a relay that drops every 16th
    datagram into an Rx set's daemon source; the demodulated tone is above
    15 dB. The path runs in real time (a throttled Tx, a 5 s gap before
    silence), so a loaded machine may starve it: one retry, as in JAX's."""
    for attempt in range(2):
        try:
            _daemonsink_lossy_relay_roundtrip()
            return
        except (AssertionError, OSError):
            if attempt == 1:
                raise
