"""WAV audio writer/reader (stdlib) with saturating int16 egress
(audiooutput.cpp:210-270)."""

from __future__ import annotations

import wave

import numpy as np


def write_wav(path: str, audio: np.ndarray, sample_rate: int = 48000) -> None:
    """audio: (T,) or (T, channels) float in [-1,1) or int16."""
    if audio.ndim == 1:
        audio = audio[:, None]
    if audio.dtype != np.int16:
        audio = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(audio.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(audio.tobytes())


def read_wav(path: str) -> tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        data = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
        ch = w.getnchannels()
        rate = w.getframerate()
    return data.reshape(-1, ch), rate
