""".sdriq capture reader (sdrbase/dsp/filerecord.{h,cpp}:17-23,129-150): a
24-byte little-endian header — int32 sampleRate, uint64 centerFrequency,
int64 startTimeStamp, uint32 sampleSize (16 or 24; anything else is 16) —
then interleaved I/Q (int16, or int32 holding 24-bit values)."""

from __future__ import annotations

import dataclasses

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


def read_block(mm: np.ndarray, start: int, count: int) -> np.ndarray:
    """`count` samples from `start`, looping at EOF like the reference file
    source (filesourcethread.cpp:188-195)."""
    n = mm.shape[0]
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
