"""ATV (analog TV) demodulator: AM or FM video with line synchronization.

Reference: plugins/channelrx/demodatv/atvdemod.{h,cpp}: a per-sample video
demod (AM magnitude, the FM discriminator, or USB/LSB through fftfilt's
runAsym, atvdemod.cpp:246-330), then a horizontal-sync state machine that
cuts the stream into lines of `samplesPerLine`; the standards (PAL625,
525, ...) set the lines of a frame.

Block form: the video level of a whole block comes from the usual
vectorized demod; the line cut is geometric. The horizontal sync phase is
the argmin of the line-folded average (a reduction, not a scan), the block
becomes (lines, samples_per_line), and each line is rolled so the sync tip
sits at column 0. The phase is estimated again every block, which follows
the drift the reference's per-sample trigger follows.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from ..dsp import fftfilt, nco, phasediscri
from .demod_nfm import _device_taps


@dataclasses.dataclass(frozen=True)
class ATVStandard:
    """Line structure of one ATV standard (atvdemod.cpp applyStandard,
    :681-733)."""

    lines: int  # default total lines a frame
    fps: float  # default frame rate
    sync_lines: int  # m_intNumberOfSyncLines
    black_lines: int  # m_intNumberOfBlackLines (sync + border)
    eq_lines: int  # equalizing pulse lines
    interleaved: bool  # two fields a frame


#: the ATVStd* table (atvdemod.h:53-61 names; atvdemod.cpp:681-727 values)
ATV_STANDARDS = {
    "pal625": ATVStandard(625, 25.0, 44, 48, 3, True),  # PAL-B/G/H
    "pal525": ATVStandard(525, 30.0, 40, 44, 3, True),  # PAL-M
    "405": ATVStandard(405, 25.0, 24, 28, 3, True),
    "shortinterleaved": ATVStandard(90, 25.0, 4, 4, 0, True),
    "short": ATVStandard(90, 25.0, 4, 4, 0, False),
    "hskip": ATVStandard(90, 25.0, 0, 0, 0, False),
}


@dataclasses.dataclass(frozen=True, eq=False)
class ATVConfig:
    channel_rate: float  # e.g. 10 MS/s: 640 samples a PAL line
    input_offset: float = 0.0
    modulation: str = "am"  # am | fm | usb | lsb
    standard: str = "pal625"  # ATVStd* (atvdemod.h:53-61)
    lines: int = 0  # 0 -> the standard's lines a frame
    fps: float = 0.0  # 0 -> the standard's frame rate
    rf_bandwidth: float = 6_000_000.0
    fm_deviation: float = 2_500_000.0
    sync_level: float = 0.15  # the sync tip as a fraction of full video
    invert: bool = False
    fft_filtering: bool = False
    fft_len: int = 1024

    @functools.cached_property
    def std(self) -> ATVStandard:
        if self.standard not in ATV_STANDARDS:
            raise ValueError(f"unknown ATV standard {self.standard!r}; "
                             f"choose from {sorted(ATV_STANDARDS)}")
        return ATV_STANDARDS[self.standard]

    @property
    def n_lines(self) -> int:
        return self.lines or self.std.lines

    @property
    def frame_rate(self) -> float:
        return self.fps or self.std.fps

    @property
    def visible_lines(self) -> int:
        """Image lines a frame (all lines less the standard's black lines)."""
        return self.n_lines - self.std.black_lines

    @property
    def line_rate(self) -> float:
        return self.n_lines * self.frame_rate  # 15625 Hz for PAL625

    @functools.cached_property
    def samples_per_line(self) -> int:
        """Points a line at the channel rate (nbPointsPerLine of
        MsgReportEffectiveSampleRate, atvdemod.h:150-165)."""
        return int(round(self.channel_rate / self.line_rate))

    @functools.cached_property
    def rf_filter(self):
        fc = 0.5 * self.rf_bandwidth / self.channel_rate
        if self.modulation in ("usb", "lsb"):
            # vestigial: a narrow opposite band (runAsym)
            return fftfilt.create_asym_filter(0.05, fc, self.fft_len)
        return fftfilt.create_dsb_filter(fc, self.fft_len)


class ATVState(NamedTuple):
    nco: nco.NCOState
    fft: fftfilt.FftFiltState
    discri: phasediscri.DiscriminatorState
    sync_phase: torch.Tensor  # the horizontal sync phase of the last block


def make_state(cfg: ATVConfig, device: torch.device, batch_shape=()) -> ATVState:
    return ATVState(
        nco=nco.make_nco(device, batch_shape),
        fft=fftfilt.make_state(cfg.fft_len, device, batch_shape),
        discri=phasediscri.make_state(device, batch_shape),
        sync_phase=torch.zeros(batch_shape, dtype=torch.float32, device=device),
    )


class ATVOutputs(NamedTuple):
    lines: torch.Tensor  # (..., n_lines, samples_per_line) float32 video levels
    sync_phase: torch.Tensor  # (...,) the sync tip's sample within a line
    sync_quality: torch.Tensor  # (...,) depth of the folded sync notch (0..1)


def process(state: ATVState, x: torch.Tensor, cfg: ATVConfig) -> tuple[ATVState, ATVOutputs]:
    nco_state, xm = nco.mix_block(
        state.nco, x, nco.freq_to_increment(-cfg.input_offset, cfg.channel_rate))

    fft_state = state.fft
    if cfg.modulation in ("usb", "lsb"):
        h = _device_taps(cfg, "rf_filter", x.device)
        fft_state, xm = fftfilt.run_asym(state.fft, xm, h[0], h[1],
                                         usb=cfg.modulation != "lsb")
    elif cfg.fft_filtering:
        fft_state, xm = fftfilt.run_filt(state.fft, xm, _device_taps(cfg, "rf_filter", x.device))

    discri_state = state.discri
    if cfg.modulation == "fm":
        discri_state, video, _ = phasediscri.discriminator_delta(
            state.discri, xm, cfg.channel_rate / (2.0 * cfg.fm_deviation))
        video = video * 0.5 + 0.5
    else:  # am / usb / lsb: the envelope, normalized by the block's peak
        video = xm.abs()
        peak = torch.amax(video, dim=-1, keepdim=True)
        video = video / torch.clamp(peak, min=1e-9)
    if cfg.invert:
        video = 1.0 - video

    spl = cfg.samples_per_line
    n_lines = video.shape[-1] // spl
    grid = video[..., :n_lines * spl].reshape(*video.shape[:-1], n_lines, spl)
    # horizontal sync: the line-folded average has its notch at the sync tip
    folded = torch.mean(grid, dim=-2)
    sync_phase = torch.argmin(folded, dim=-1).to(torch.float32)
    mean = torch.mean(folded, dim=-1)
    notch = (mean - torch.amin(folded, dim=-1)) / torch.clamp(mean, min=1e-9)
    # roll each line so the sync tip sits at column 0
    shift = torch.round(sync_phase).to(torch.int64)
    cols = (torch.arange(spl, device=x.device) + shift[..., None]) % spl
    lines = torch.gather(grid, -1, cols[..., None, :].expand(grid.shape))
    return ATVState(nco_state, fft_state, discri_state, sync_phase), ATVOutputs(
        lines, sync_phase, notch)
