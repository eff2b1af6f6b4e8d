"""Audio mixing and dynamics — the AudioOutput/AudioCompressor roles.

Reference: sdrbase/audio/audiooutput.cpp:210-270 — the pull-mode device
callback mixes every registered channel FIFO with saturating int16 adds;
sdrbase/audio/audiocompressor.{h,cpp} — lookup-table compressor
(audiocompressor holds a 2^16-entry transfer curve). Headless equivalents:
block mixer + soft-knee compressor, WAV/UDP egress downstream.

The port's own copy of the JAX package's module (sdrangel_tpu/io/audio.py),
held equal to it by tests/test_torch_net_io.py. It is host code and stays on the host.
"""

from __future__ import annotations

import numpy as np


def mix(channels: list[np.ndarray]) -> np.ndarray:
    """Saturating mix of float blocks in [-1,1) (AudioOutput semantics:
    plain sum then clip, audiooutput.cpp:241-254)."""
    if not channels:
        return np.zeros(0, dtype=np.float32)
    n = min(c.shape[-1] for c in channels)
    acc = np.zeros(n, dtype=np.float64)
    for c in channels:
        acc += c[..., :n]
    return np.clip(acc, -1.0, 1.0).astype(np.float32)


class AudioFifo:
    """Bounded audio queue between the demod thread and the egress
    (sdrbase/audio/audiofifo.cpp:68,147 — blocking ring with drop-on-full)."""

    def __init__(self, capacity_samples: int = 48000):
        self.capacity = capacity_samples
        self._chunks: list[np.ndarray] = []
        self._fill = 0
        self.overruns = 0

    def write(self, block: np.ndarray) -> int:
        n = block.shape[-1]
        if self._fill + n > self.capacity:
            self.overruns += 1
            n_fit = max(0, self.capacity - self._fill)
            block = block[..., :n_fit]
            n = n_fit
        if n:
            self._chunks.append(np.asarray(block))
            self._fill += n
        return n

    def read(self, count: int) -> np.ndarray:
        """Returns exactly `count` samples, zero-padded on underrun
        (the audio callback never blocks)."""
        out = np.zeros(count, dtype=np.float32)
        pos = 0
        while pos < count and self._chunks:
            c = self._chunks[0]
            take = min(count - pos, c.shape[-1])
            out[pos : pos + take] = c[:take]
            if take == c.shape[-1]:
                self._chunks.pop(0)
            else:
                self._chunks[0] = c[take:]
            self._fill -= take
            pos += take
        return out

    @property
    def fill(self) -> int:
        return self._fill


def compress(
    audio: np.ndarray,
    threshold_db: float = -20.0,
    ratio: float = 4.0,
    makeup_db: float = 0.0,
) -> np.ndarray:
    """Soft-knee compressor on the instantaneous envelope
    (audiocompressor.cpp transfer-curve semantics, analytic form)."""
    eps = 1e-9
    level_db = 20.0 * np.log10(np.maximum(np.abs(audio), eps))
    over = level_db - threshold_db
    gain_db = np.where(over > 0.0, -over * (1.0 - 1.0 / ratio), 0.0) + makeup_db
    return (audio * 10.0 ** (gain_db / 20.0)).astype(np.float32)
