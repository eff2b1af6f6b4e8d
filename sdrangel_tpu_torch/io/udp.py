"""UDP egress/ingest of demod audio and I/Q.

Reference: plugins/channelrx/udpsrc/udpsrc.{h,cpp} — forwards channelized
I/Q or demodulated audio as UDP datagrams in several formats (S16LE I/Q
16/24-bit, mono/stereo audio, AM/FM demod, udpsrc.h:200-313);
sdrbase/audio/audionetsink.{h,cpp} — raw UDP audio; plugins/channeltx/udpsink
ingests the same formats for Tx. RTP framing is layered in
io/rtp.py.

The port's own copy of the JAX package's module (sdrangel_tpu/io/udp.py),
held equal to it by tests/test_torch_net_io.py. It is host code and stays on the host.
"""

from __future__ import annotations

import socket

import numpy as np

FORMATS = (
    "iq16",  # interleaved int16 I/Q
    "iq24",  # interleaved int32 (24-bit range) I/Q
    "mono16",  # int16 mono audio
    "stereo16",  # int16 L/R audio
    "float32",  # float32 mono
)


def encode_payload(data: np.ndarray, fmt: str) -> bytes:
    if fmt == "iq16":
        if np.iscomplexobj(data):
            out = np.empty((len(data), 2), dtype=np.int16)
            out[:, 0] = np.clip(data.real * 32768.0, -32768, 32767)
            out[:, 1] = np.clip(data.imag * 32768.0, -32768, 32767)
            return out.tobytes()
        return data.astype(np.int16).tobytes()
    if fmt == "iq24":
        out = np.empty((len(data), 2), dtype=np.int32)
        out[:, 0] = np.clip(data.real * 8388608.0, -8388608, 8388607)
        out[:, 1] = np.clip(data.imag * 8388608.0, -8388608, 8388607)
        return out.tobytes()
    if fmt == "mono16":
        return np.clip(data * 32768.0, -32768, 32767).astype(np.int16).tobytes()
    if fmt == "stereo16":
        return np.clip(data * 32768.0, -32768, 32767).astype(np.int16).tobytes()
    if fmt == "float32":
        return data.astype(np.float32).tobytes()
    raise ValueError(fmt)


def decode_payload(raw: bytes, fmt: str) -> np.ndarray:
    if fmt == "iq16":
        a = np.frombuffer(raw, dtype=np.int16).reshape(-1, 2)
        return ((a[:, 0] + 1j * a[:, 1]) / 32768.0).astype(np.complex64)
    if fmt == "iq24":
        a = np.frombuffer(raw, dtype=np.int32).reshape(-1, 2)
        return ((a[:, 0] + 1j * a[:, 1]) / 8388608.0).astype(np.complex64)
    if fmt == "mono16":
        return np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    if fmt == "stereo16":
        return (
            np.frombuffer(raw, dtype=np.int16).reshape(-1, 2).astype(np.float32)
            / 32768.0
        )
    if fmt == "float32":
        return np.frombuffer(raw, dtype=np.float32)
    raise ValueError(fmt)


class UdpSink:
    """Datagram writer chunking blocks to a fixed payload size
    (UDPSink<T> semantics, sdrbase/util/udpsink.h)."""

    def __init__(self, address: str, port: int, fmt: str = "mono16",
                 payload_bytes: int = 1472):
        self.addr = (address, port)
        self.fmt = fmt
        self.payload_bytes = payload_bytes
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._pending = b""

    def write(self, data: np.ndarray) -> int:
        self._pending += encode_payload(data, self.fmt)
        sent = 0
        while len(self._pending) >= self.payload_bytes:
            self._sock.sendto(self._pending[: self.payload_bytes], self.addr)
            self._pending = self._pending[self.payload_bytes :]
            sent += 1
        return sent

    def flush(self) -> None:
        if self._pending:
            self._sock.sendto(self._pending, self.addr)
            self._pending = b""

    def close(self) -> None:
        self.flush()
        self._sock.close()


class UdpSource:
    """Blocking datagram reader with a bounded reassembly buffer
    (the channeltx/udpsink ingest role)."""

    def __init__(self, address: str, port: int, fmt: str = "mono16",
                 timeout: float = 1.0):
        self.fmt = fmt
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((address, port))
        self._sock.settimeout(timeout)
        self._buf = b""

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def read(self, n_samples: int) -> np.ndarray:
        """Read exactly n_samples (blocking until enough datagrams arrive)."""
        bps = {"iq16": 4, "iq24": 8, "mono16": 2, "stereo16": 4, "float32": 4}[self.fmt]
        need = n_samples * bps
        while len(self._buf) < need:
            raw, _ = self._sock.recvfrom(65536)
            self._buf += raw
        chunk, self._buf = self._buf[:need], self._buf[need:]
        return decode_payload(chunk, self.fmt)

    def close(self) -> None:
        self._sock.close()
