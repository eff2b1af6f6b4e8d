"""The port's network and audio host copies (`io/udp.py`, `io/rtp.py`,
`io/audio.py`) against the JAX package's, on the inputs of
tests/test_channels_extra.py and tests/test_audio_rtp_cw.py.

- The code: each copy's module body equals the JAX module's, docstrings
  aside (ASTs compared).
- UDP: every wire format encodes byte for byte as JAX's does and decodes
  alike; the port's sink feeds JAX's source and JAX's sink the port's.
- RTP: packets, RFC 2198 RED payloads, SR/SDES/RR compounds and their
  parsers byte-equal for a fixed SSRC, sequence, timestamp and NTP clock;
  the sender's datagrams byte-equal to JAX's sender's over localhost, plain
  and redundant; the receiver's RFC 3550 statistics and RR equal on the
  same packets, across a sequence wrap and with losses; the RR-driven RED
  adaptation run through both senders datagram for datagram.
- Audio: mix, AudioFifo and compress equal on JAX's inputs.
"""

from __future__ import annotations

import pathlib
import socket
import threading
import time

import numpy as np
import pytest

from sdrangel_tpu.io import audio as jaudio
from sdrangel_tpu.io import rtp as jrtp
from sdrangel_tpu.io import udp as judp
from sdrangel_tpu_torch.io import audio as paudio
from sdrangel_tpu_torch.io import rtp as prtp
from sdrangel_tpu_torch.io import udp as pudp
from torch_port_util import code_without_docstrings

REPO = pathlib.Path(__file__).resolve().parent.parent
NTP = (3_900_000_000, 0x12345678)


@pytest.mark.parametrize("module", ["io/udp.py", "io/rtp.py", "io/audio.py"])
def test_copy_code_equals_jax(module):
    assert (code_without_docstrings(REPO / "sdrangel_tpu_torch" / module)
            == code_without_docstrings(REPO / "sdrangel_tpu" / module))


def _udp_data(fmt: str) -> np.ndarray:
    """test_channels_extra.py's data for each wire format."""
    if fmt.startswith("iq"):
        return (np.exp(1j * np.linspace(0, 6, 500)) * 0.5).astype(np.complex64)
    if fmt == "stereo16":
        return np.random.default_rng(0).uniform(-0.5, 0.5, (500, 2)).astype(np.float32)
    return np.random.default_rng(0).uniform(-0.5, 0.5, 500).astype(np.float32)


@pytest.mark.parametrize("fmt", judp.FORMATS)
def test_udp_payloads_equal_jax(fmt):
    assert pudp.FORMATS == judp.FORMATS
    data = _udp_data(fmt)
    wire = judp.encode_payload(data, fmt)
    assert pudp.encode_payload(data, fmt) == wire
    np.testing.assert_array_equal(pudp.decode_payload(wire, fmt), judp.decode_payload(wire, fmt))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_udp_sink_feeds_the_other_source(direction):
    """test_udp_roundtrip_formats across the two packages, every format."""
    sink_mod, src_mod = (pudp, judp) if direction == "port_to_jax" else (judp, pudp)
    for fmt in judp.FORMATS:
        src = src_mod.UdpSource("127.0.0.1", 0, fmt=fmt, timeout=5.0)
        sink = sink_mod.UdpSink("127.0.0.1", src.port, fmt=fmt, payload_bytes=256)
        data = _udp_data(fmt)
        got = {}
        reader = threading.Thread(target=lambda: got.setdefault("d", src.read(500)))
        reader.start()
        sink.write(data)
        sink.flush()
        reader.join(timeout=5)
        sink.close()
        src.close()
        np.testing.assert_array_equal(
            got["d"], judp.decode_payload(judp.encode_payload(data, fmt), fmt))


def test_rtp_packet_and_red_builders_equal_jax():
    rng = np.random.default_rng(1)
    payload = rng.integers(0, 256, 320, dtype=np.uint8).tobytes()
    prev = rng.integers(0, 256, 320, dtype=np.uint8).tobytes()
    for args in ((payload, 0xFFFF, 0xFFFFFFF0, 0xDEADBEEF, prtp.PT_L16_MONO),
                 (b"", 1, 0, 1, prtp.PT_RED, True)):
        pkt = jrtp.build_packet(*args)
        assert prtp.build_packet(*args) == pkt
        assert prtp.parse_packet(pkt) == jrtp.parse_packet(pkt)
    for red_args in ((payload, prtp.PT_L16_MONO, prev, 160), (payload, 10, None, 0)):
        red = jrtp.build_red_payload(*red_args)
        assert prtp.build_red_payload(*red_args) == red
        assert prtp.parse_red_payload(red) == jrtp.parse_red_payload(red)
    with pytest.raises(ValueError, match="10-bit"):
        prtp.build_red_payload(b"x", prtp.PT_L16_MONO, b"y" * 1200, 160)
    for bad in (b"\xff" * 32, b""):
        with pytest.raises(ValueError):
            jrtp.parse_red_payload(bad)
        with pytest.raises(ValueError):
            prtp.parse_red_payload(bad)


def test_rtcp_builders_and_parser_equal_jax(monkeypatch):
    monkeypatch.setattr(jrtp, "_ntp_now", lambda: NTP)
    monkeypatch.setattr(prtp, "_ntp_now", lambda: NTP)
    sr = jrtp.build_sr(0xCAFEBABE, 123456, 3, 960)
    assert prtp.build_sr(0xCAFEBABE, 123456, 3, 960) == sr
    assert prtp.build_sr(7, 1, 2, 3, cname="x" * 300) == jrtp.build_sr(7, 1, 2, 3, cname="x" * 300)
    rr = jrtp.build_rr(1, 2, 77, 5, 70000, 12.7, 9, 10)
    assert prtp.build_rr(1, 2, 77, 5, 70000, 12.7, 9, 10) == rr
    bye = bytes([0x81, prtp.RTCP_BYE, 0, 1]) + b"\x00\x00\x00\x07"
    for raw in (sr, rr, sr + rr + bye, sr[:10]):
        assert prtp.parse_rtcp(raw) == jrtp.parse_rtcp(raw)
    kinds = [r["type"] for r in prtp.parse_rtcp(sr + rr + bye)]
    assert kinds == ["SR", "SDES", "RR", "BYE"]


def _receive_all(sock: socket.socket, n: int) -> list[bytes]:
    return [sock.recvfrom(65536)[0] for _ in range(n)]


def _sender(mod, port: int, **kw):
    tx = mod.RtpAudioSender("127.0.0.1", port, **kw)
    tx.seq, tx.timestamp, tx.ssrc = 0xFFFE, 0xFFFFFF00, 0x5EED5EED
    return tx


@pytest.mark.parametrize("stereo,redundant", [(False, False), (False, True), (True, True)])
def test_rtp_sender_datagrams_equal_jax(stereo, redundant):
    """The sender's datagrams for test_rtp_roundtrip's tone (and the stereo
    RED case of test_red_stereo_large_packets_shrink_to_fit) byte-equal."""
    t = np.arange(1024) / 48000.0
    tone = (0.5 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32)
    audio = np.stack([tone, np.cos(2 * np.pi * 440 * t).astype(np.float32)], -1) if stereo \
        else tone
    sent = {}
    for name, mod in (("jax", jrtp), ("port", prtp)):
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(5.0)
        tx = _sender(mod, rx.getsockname()[1], stereo=stereo,
                     samples_per_packet=480 if stereo else 160, rtcp=False)
        tx.redundant = redundant
        n = tx.write(audio[:500]) + tx.write(audio[500:])
        sent[name] = (_receive_all(rx, n), tx.seq, tx.timestamp, tx.packet_count,
                      tx.octet_count)
        tx.close()
        rx.close()
    assert sent["port"] == sent["jax"] and len(sent["jax"][0]) >= 4


def test_rtp_receiver_statistics_equal_jax():
    """The same packets (a sequence wrap, losses, RED blocks, a malformed
    RED payload) into both receivers: equal samples, RFC 3550 statistics
    and receiver reports."""
    tone = np.sin(2 * np.pi * 440 * np.arange(16 * 60) / 48000.0).astype(np.float32)
    pkts, seq = [], 0xFFFA
    prev = None
    for i in range(60):
        pcm = (tone[16 * i:16 * i + 16] * 32767).astype(">i2").tobytes()
        if i % 7 == 3:
            seq += 1  # a loss
        if i >= 40:
            wire = jrtp.build_red_payload(pcm, jrtp.PT_L16_MONO, prev, 16)
            pkts.append(jrtp.build_packet(wire, seq, 16 * i, 0xABCD, jrtp.PT_RED))
        else:
            pkts.append(jrtp.build_packet(pcm, seq, 16 * i, 0xABCD, jrtp.PT_L16_MONO))
        prev, seq = pcm, seq + 1
    pkts.append(jrtp.build_packet(b"\xff" * 32, seq, 0, 0xABCD, jrtp.PT_RED))
    results = {}
    for name, mod in (("jax", jrtp), ("port", prtp)):
        rx = mod.RtpAudioReceiver("127.0.0.1", 0, timeout=5.0)
        rx.ssrc = 0x1234
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        out, reports = [], []
        for k, pkt in enumerate(pkts):
            s.sendto(pkt, ("127.0.0.1", rx.port))
            info, pcm = rx.read_packet()
            out.append((info["seq"], info.get("malformed"), np.asarray(pcm).tobytes()))
            if k % 20 == 19:
                reports.append(rx.receiver_report())
        reports.append(rx.receiver_report())
        results[name] = (out, reports, rx.received, rx.expected, rx.lost, rx.cycles,
                         rx.recovered)
        s.close()
        rx.close()
    # jitter follows the arrival clock: compare the reports without it
    for name in results:
        parsed = [prtp.parse_rtcp(r)[0] for r in results[name][1]]
        results[name] = (results[name][0], [{k: v for k, v in p.items() if k != "jitter"}
                                            for p in parsed], *results[name][2:])
    assert results["port"] == results["jax"]
    assert results["jax"][4] > 0 and results["jax"][5] == 1 << 16 and results["jax"][6] > 0


def test_rr_driven_red_adaptation_equals_jax():
    """test_rtcp_rr_driven_red_adaptation through both senders: the same RR
    feedback flips each into RED and back, datagram for datagram."""
    tone = np.sin(2 * np.pi * 440 * np.arange(160 * 8) / 48000.0).astype(np.float32)
    runs = {}
    for name, mod in (("jax", jrtp), ("port", prtp)):
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(5.0)
        # the first write's SR binds the sender's RTCP socket
        tx = _sender(mod, rx.getsockname()[1], samples_per_packet=160, rtcp_interval=0.0)
        fb = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        log = []
        for fraction in (None, 64, None, 0):
            if fraction is not None:
                fb.sendto(jrtp.build_rr(1, tx.ssrc, fraction, 2, 0, 0), ("127.0.0.1", tx._rtcp.port))
                time.sleep(0.05)
            n = tx.write(tone)
            log.append((tx.redundant, tx.fraction_lost, _receive_all(rx, n)))
        runs[name] = log
        fb.close()
        tx.close()
        rx.close()
    assert runs["port"] == runs["jax"]
    assert [r for r, _, _ in runs["jax"]] == [False, True, True, False]


def test_rtcp_peer_sender_report_equals_jax(monkeypatch):
    """test_rtcp_sender_report_and_sdes: the compound SR+SDES on port + 1."""
    monkeypatch.setattr(jrtp, "_ntp_now", lambda: NTP)
    monkeypatch.setattr(prtp, "_ntp_now", lambda: NTP)
    got = {}
    for name, mod in (("jax", jrtp), ("port", prtp)):
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.bind(("127.0.0.1", 0))
        peer = mod.RtcpPeer("127.0.0.1", rx.getsockname()[1], bind=True, timeout=5.0)
        tx = _sender(mod, rx.getsockname()[1], samples_per_packet=160, rtcp_interval=0.0)
        tx.write(np.sin(2 * np.pi * 440 * np.arange(480) / 48000.0).astype(np.float32))
        got[name] = peer.recv()
        tx.close()
        peer.close()
        rx.close()
    assert got["port"] == got["jax"]
    assert {r["type"] for r in got["jax"]} == {"SR", "SDES"}
    assert got["jax"][0]["packet_count"] == 3 and got["jax"][1]["cname"] == "sdrangel_tpu"


def test_audio_mix_fifo_compress_equal_jax():
    a = np.full(100, 0.8, np.float32)
    b = np.linspace(-1.5, 1.5, 120).astype(np.float32)
    for chans in ([a, a], [a, b], []):
        np.testing.assert_array_equal(paudio.mix(chans), jaudio.mix(chans))
    fifos = [m.AudioFifo(capacity_samples=100) for m in (jaudio, paudio)]
    for f in fifos:
        f.write(np.ones(80, np.float32))
        f.write(np.ones(80, np.float32))
    outs = [(f.overruns, f.read(150), f.fill) for f in fifos]
    assert outs[0][0] == outs[1][0] == 1 and outs[0][2] == outs[1][2]
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    x = np.concatenate([np.full(10, 0.9), np.full(10, 0.01), np.linspace(-1, 1, 50)]
                       ).astype(np.float32)
    for kw in ({}, {"threshold_db": -20, "ratio": 4}, {"threshold_db": -6, "ratio": 2,
                                                       "makeup_db": 3.0}):
        np.testing.assert_array_equal(paudio.compress(x, **kw), jaudio.compress(x, **kw))
