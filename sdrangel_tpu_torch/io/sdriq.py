""".sdriq capture reader and writer (sdrbase/dsp/filerecord.{h,cpp}:17-23,
129-150): a 24-byte little-endian header — int32 sampleRate, uint64
centerFrequency, int64 startTimeStamp, uint32 sampleSize (16 or 24; anything
else is 16) — then interleaved I/Q (int16, or int32 holding 24-bit values).
Also the headerless raw captures (cu8, cs8, cs16) the file source plays."""

from __future__ import annotations

import dataclasses
import time

import numpy as np

HEADER_DTYPE = np.dtype([
    ("sample_rate", "<i4"),
    ("center_frequency", "<u8"),
    ("start_timestamp", "<i8"),
    ("sample_size", "<u4"),
])
HEADER_BYTES = 24


@dataclasses.dataclass
class SdriqInfo:
    sample_rate: int
    center_frequency: int
    start_timestamp: int
    sample_size: int  # 16 or 24
    n_samples: int  # complex samples in the payload


def read_header(path: str) -> SdriqInfo:
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(HEADER_BYTES), dtype=HEADER_DTYPE)[0]
        f.seek(0, 2)
        payload = f.tell() - HEADER_BYTES
    size = int(raw["sample_size"])
    if size not in (16, 24):  # filerecord.cpp:145 assumes 16-bit for old files
        size = 16
    return SdriqInfo(
        sample_rate=int(raw["sample_rate"]),
        center_frequency=int(raw["center_frequency"]),
        start_timestamp=int(raw["start_timestamp"]),
        sample_size=size,
        n_samples=payload // (4 if size == 16 else 8),
    )


def open_mmap(path: str) -> tuple[SdriqInfo, np.ndarray]:
    """Memory-map the payload as an (N, 2) integer array."""
    info = read_header(path)
    dtype = np.int16 if info.sample_size == 16 else np.int32
    raw = np.memmap(path, dtype=dtype, mode="r", offset=HEADER_BYTES)
    n = (len(raw) // 2) * 2
    return info, raw[:n].reshape(-1, 2)


#: headerless capture formats (rtl_sdr / hackrf conventions): file extension
#: -> (numpy dtype, pipeline input_format). Rate and centre come from the
#: source settings: a raw capture has no header.
RAW_FORMATS = {
    "cu8": (np.uint8, "u8"),  # rtl_sdr
    "cs8": (np.int8, "i8"),  # hackrf_transfer
    "cs16": (np.int16, "i16"),
}


def open_raw(path: str, fmt: str) -> np.ndarray:
    """Memory-map a headerless interleaved-I/Q capture as (N, 2). fmt: a
    RAW_FORMATS key, or "auto" to take it from the file's extension."""
    if fmt == "auto":
        ext = path.rsplit(".", 1)[-1].lower()
        if ext not in RAW_FORMATS:
            raise ValueError(f"cannot infer raw format from extension {ext!r}; "
                             f"set file_format to one of {sorted(RAW_FORMATS)}")
        fmt = ext
    raw = np.memmap(path, dtype=RAW_FORMATS[fmt][0], mode="r")
    n = (len(raw) // 2) * 2
    return raw[:n].reshape(-1, 2)


def read_block(mm: np.ndarray, start: int, count: int, wrap: bool = True) -> np.ndarray:
    """`count` samples from `start`, looping at EOF like the reference file
    source (filesourcethread.cpp:188-195); with wrap=False a read past the
    end raises EOFError."""
    n = mm.shape[0]
    if not wrap and start + count > n:
        raise EOFError
    start %= n
    if start + count <= n:
        return np.asarray(mm[start : start + count])
    parts = []
    pos, left = start, count
    while left:
        take = min(left, n - pos)
        parts.append(mm[pos : pos + take])
        left -= take
        pos = (pos + take) % n
    return np.concatenate(parts, axis=0)


def to_complex64(block: np.ndarray, sample_size: int = 16) -> np.ndarray:
    scale = 32768.0 if sample_size == 16 else 8388608.0
    f = block.astype(np.float32) / np.float32(scale)
    return (f[..., 0] + 1j * f[..., 1]).astype(np.complex64)


def _header(sample_rate: int, center_frequency: int, sample_size: int,
            timestamp: int | None) -> bytes:
    header = np.zeros(1, dtype=HEADER_DTYPE)
    header["sample_rate"] = sample_rate
    header["center_frequency"] = center_frequency
    header["start_timestamp"] = int(time.time()) if timestamp is None else timestamp
    header["sample_size"] = sample_size
    return header.tobytes()


def _payload(iq: np.ndarray, sample_size: int) -> np.ndarray:
    """complex64 in [-1, 1) rounded and saturated to the sample width, or raw
    (N, 2) integers as they are."""
    if not np.iscomplexobj(iq):
        return np.ascontiguousarray(iq)
    scale = 32768.0 if sample_size == 16 else 8388608.0
    ints = np.empty((len(iq), 2), dtype=np.int16 if sample_size == 16 else np.int32)
    ints[:, 0] = np.clip(np.round(iq.real * scale), -scale, scale - 1)
    ints[:, 1] = np.clip(np.round(iq.imag * scale), -scale, scale - 1)
    return ints


def write(path: str, iq: np.ndarray, sample_rate: int, center_frequency: int = 0,
          sample_size: int = 16, timestamp: int | None = None) -> None:
    """Write complex64 in [-1, 1) (or raw int16/int32 (N, 2)) as .sdriq."""
    with open(path, "wb") as f:
        f.write(_header(sample_rate, center_frequency, sample_size, timestamp))
        f.write(_payload(iq, sample_size).tobytes())


class SdriqWriter:
    """Streaming .sdriq recorder: the header first, the payload appended per
    block (the FileRecord sink, filerecord.cpp:51-68)."""

    def __init__(self, path: str, sample_rate: int, center_frequency: int = 0,
                 sample_size: int = 16, timestamp: int | None = None):
        self.sample_size = sample_size
        self._f = open(path, "wb")
        self._f.write(_header(sample_rate, center_frequency, sample_size, timestamp))
        self.samples_written = 0

    def write(self, iq: np.ndarray) -> None:
        """iq: (N, 2) int16/int32 raw samples, or complex64 in [-1, 1)."""
        ints = _payload(iq, self.sample_size)
        self._f.write(ints.tobytes())
        self.samples_written += len(ints)

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()
