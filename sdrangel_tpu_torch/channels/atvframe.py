"""ATV frame assembly — field/vsync semantics over the demod's line stream.

The port's own copy of the JAX package's numpy module
(sdrangel_tpu/channels/atvframe.py), held equal to it by
tests/test_torch_atv.py; it runs on the host, on the lines read back from
the card.

The device-side demod (demod_atv.process) emits hsync-aligned LINES; this
host module reproduces the reference's frame construction semantics
(atvdemod.h:446-541 processClassic/processHSkip + applyStandard,
atvdemod.cpp:681-733):

  * classic standards: vertical sync = a run of broad-pulse lines (most of
    the line at sync level); the lines after the run are the field's
    visible rows. Interleaved standards weave two consecutive fields into
    one frame — even rows from the first field, odd from the second; the
    field parity is read from the half-line offset of the broad pulses
    (field 2's vsync starts mid-line), exactly the distinction
    ATVStdShortInterleaved/ATVStd{PAL625,PAL525,405} carry vs ATVStdShort.
  * ATVStdHSkip: no vsync lines at all — the frame boundary is a SKIPPED
    horizontal sync (processHSkip renders when a sync pulse arrives after
    >= 1.5 line durations without one, atvdemod.h:517-533). In the line
    stream that is a line with no sync notch at column 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .demod_atv import ATVConfig


@dataclasses.dataclass
class FrameAssembler:
    """Streaming frame builder. feed(lines (N, spl)) -> list of frames
    ((visible_rows, spl) float arrays)."""

    cfg: ATVConfig
    frames: int = 0
    last_frame: np.ndarray | None = None
    field_order_detected: bool = False

    def __post_init__(self):
        self._field_a: list[np.ndarray] | None = None
        self._current: list[np.ndarray] = []
        self._in_vsync = False
        self._vsync_start_cols: list[float] = []
        self._parity_half: bool = False  # current field started mid-line

    # -- line classification -------------------------------------------------

    def _sync_frac(self, line: np.ndarray) -> float:
        return float(np.mean(line < self.cfg.sync_level))

    def _is_vsync(self, line: np.ndarray) -> bool:
        return self._sync_frac(line) > 0.5

    def _has_hsync(self, line: np.ndarray) -> bool:
        top = max(2, int(0.04 * self.cfg.samples_per_line))
        return float(np.min(line[:top])) < self.cfg.sync_level

    def _broad_pulse_start(self, line: np.ndarray) -> float:
        """Column (fraction of the line) where the sync region starts —
        ~0 for field 1, ~0.5 for field 2 of an interleaved frame."""
        below = line < self.cfg.sync_level
        idx = np.nonzero(below)[0]
        if idx.size == 0:
            return 0.0
        # ignore the normal hsync tip at column 0: find the longest run
        runs = np.split(idx, np.nonzero(np.diff(idx) > 1)[0] + 1)
        longest = max(runs, key=len)
        return float(longest[0]) / len(line)

    # -- assembly ------------------------------------------------------------

    def feed(self, lines: np.ndarray) -> list[np.ndarray]:
        out: list[np.ndarray] = []
        std = self.cfg.std
        if self.cfg.standard == "hskip":
            for line in np.asarray(lines):
                if not self._has_hsync(line):
                    if self._current:
                        out.append(self._emit([self._current]))
                    self._current = []
                else:
                    self._current.append(np.asarray(line))
            return out

        for line in np.asarray(lines):
            if self._is_vsync(line):
                if not self._in_vsync:
                    self._in_vsync = True
                    self._vsync_start_cols = []
                    if self._current:
                        out.extend(self._close_field())
                self._vsync_start_cols.append(self._broad_pulse_start(line))
            else:
                if self._in_vsync:
                    self._in_vsync = False
                    # parity: broad pulses starting mid-line = second field
                    med = float(np.median(self._vsync_start_cols or [0.0]))
                    self._parity_half = 0.25 < med < 0.75
                    self.field_order_detected = True
                self._current.append(np.asarray(line))
        return out

    def _close_field(self) -> list[np.ndarray]:
        field = self._current
        self._current = []
        std = self.cfg.std
        if not std.interleaved:
            return [self._emit([field])]
        if self._parity_half:
            # second field: weave with the stored first field
            if self._field_a is not None:
                frame = self._emit([self._field_a, field])
                self._field_a = None
                return [frame]
            self._field_a = None
            return []
        self._field_a = field
        return []

    def _emit(self, fields: list[list[np.ndarray]]) -> np.ndarray:
        spl = self.cfg.samples_per_line
        if len(fields) == 1:
            rows = [ln for ln in fields[0]]
            frame = np.stack(rows) if rows else np.zeros((0, spl))
        else:
            a, b = fields
            n = 2 * min(len(a), len(b))
            frame = np.zeros((n, spl), np.float32)
            frame[0::2] = np.stack(a[: n // 2])
            frame[1::2] = np.stack(b[: n // 2])
        self.frames += 1
        self.last_frame = frame
        return frame

    def report(self) -> dict:
        return {
            "frames": self.frames,
            "lastFrameLines": 0 if self.last_frame is None else int(
                self.last_frame.shape[0]),
            "interleaved": self.cfg.std.interleaved,
            "fieldOrderDetected": self.field_order_detected,
        }
