"""CW (Morse) keyer — keying-envelope generator for the Tx modulators.

Reference: sdrbase/dsp/cwkeyer.{h,cpp} — per-sample state machine producing
key-down/up with configurable WPM, iambic/straight modes, and a text player.
Block form: the text compiles to a key-down/up schedule on the host; the
envelope (with raised-cosine edges against key clicks) is generated per
block and multiplies the modulator's AF. Host-only numpy, the port's own
copy of the JAX package's keyer (sdrangel_tpu/channels/cwkeyer.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

MORSE = {
    "a": ".-", "b": "-...", "c": "-.-.", "d": "-..", "e": ".", "f": "..-.",
    "g": "--.", "h": "....", "i": "..", "j": ".---", "k": "-.-", "l": ".-..",
    "m": "--", "n": "-.", "o": "---", "p": ".--.", "q": "--.-", "r": ".-.",
    "s": "...", "t": "-", "u": "..-", "v": "...-", "w": ".--", "x": "-..-",
    "y": "-.--", "z": "--..",
    "0": "-----", "1": ".----", "2": "..---", "3": "...--", "4": "....-",
    "5": ".....", "6": "-....", "7": "--...", "8": "---..", "9": "----.",
    ".": ".-.-.-", ",": "--..--", "?": "..--..", "/": "-..-.", "=": "-...-",
}


@dataclasses.dataclass(frozen=True)
class CWConfig:
    wpm: float = 15.0
    sample_rate: float = 48000.0
    edge_ms: float = 5.0  # raised-cosine key edge

    @property
    def dot_samples(self) -> int:
        # PARIS standard: dot = 1.2 / wpm seconds
        return int(round(1.2 / self.wpm * self.sample_rate))


def text_to_schedule(text: str, cfg: CWConfig) -> list[tuple[bool, int]]:
    """Compile text to (key_down, duration_samples) segments.
    dot=1, dash=3, intra-element gap=1, letter gap=3, word gap=7 dots."""
    d = cfg.dot_samples
    sched: list[tuple[bool, int]] = []
    for word in text.lower().split():
        for li, letter in enumerate(word):
            code = MORSE.get(letter)
            if code is None:
                continue
            for ei, sym in enumerate(code):
                sched.append((True, d if sym == "." else 3 * d))
                if ei < len(code) - 1:
                    sched.append((False, d))
            if li < len(word) - 1:
                sched.append((False, 3 * d))
        sched.append((False, 7 * d))
    return sched


class CWKeyer:
    """Streaming envelope generator over a compiled schedule."""

    def __init__(self, text: str, cfg: CWConfig, loop: bool = False):
        self.cfg = cfg
        self.loop = loop
        self.schedule = text_to_schedule(text, cfg)
        self._seg = 0
        self._pos = 0
        edge = max(1, int(cfg.edge_ms * 1e-3 * cfg.sample_rate))
        self._edge = 0.5 - 0.5 * np.cos(np.pi * np.arange(edge) / edge)

    def done(self) -> bool:
        return not self.loop and self._seg >= len(self.schedule)

    def next_block(self, count: int) -> np.ndarray:
        """Key envelope in [0,1] with raised-cosine edges."""
        out = np.zeros(count, dtype=np.float32)
        pos = 0
        while pos < count and not self.done():
            if self._seg >= len(self.schedule):
                self._seg = 0
            down, dur = self.schedule[self._seg]
            take = min(count - pos, dur - self._pos)
            if down:
                seg = np.ones(take, dtype=np.float32)
                e = len(self._edge)
                # rising edge at segment start, falling at end
                r0 = self._pos
                for i in range(take):
                    p = r0 + i
                    if p < e:
                        seg[i] = self._edge[p]
                    elif p >= dur - e:
                        seg[i] = self._edge[dur - 1 - p] if dur - 1 - p < e else 1.0
                out[pos : pos + take] = seg
            pos += take
            self._pos += take
            if self._pos >= dur:
                self._pos = 0
                self._seg += 1
        return out
