"""Plain DSP of SDRangel's NFM receive chain, written from the published
algorithms and independent of the program under test.

Every filter runs in direct form from a zero history: y[m] = sum_k
h[k]·ext[stride·m + k] with ext the input behind L − 1 zeros. `Arith`
chooses the arithmetic: float64 for the reference, or float32 with the
operands of every filter product rounded to TF32 (10 mantissa bits) for
the control, which stands for the program computed with TF32 switched on.

Sources (SDRangel, github.com/f4exb/sdrangel): half-band taps
sdrbase/dsp/hbfiltertraits.cpp; the ÷2^k cascade sdrbase/dsp/decimators.h;
the channel plan downchannelizer.cpp:250-287; the NCO nco.cpp; the rational
resampler interpolator.{h,cpp}; the phase discriminator phasediscri.h; the
NFM chain plugins/channelrx/demodnfm/nfmdemod.cpp:140-330 and its audio
bandpass bandpass.h; the spectrum spectrumvis.cpp; the polyphase DFT bank
is y_c[n] = (x ⊛ h·e^{+j2πc·/M})[nM + M − 1].
"""

from __future__ import annotations

import dataclasses
import functools
import math
from fractions import Fraction

import numpy as np
import torch

#: the unique side coefficients of SDRangel's half-band filters, outermost
#: first (hbfiltertraits.cpp); order 64 for the device decimators, order 48
#: for the down-channelizer's stages
HALFBAND_SIDE = {
    64: (
        -0.0004653050334792540, 0.0007120490624526884, -0.0012303473710125559,
        0.0019716520179919018, -0.0029947484165425580, 0.0043703902150498061,
        -0.0061858352927315653, 0.0085554408639278122, -0.0116397924445187356,
        0.0156852221106748395, -0.0211070832238078286, 0.0286850846890029897,
        -0.0400956173930921908, 0.0597215923200692667, -0.1036982054813635201,
        0.3175014394028848885,
    ),
    48: (
        -0.0011627994808655962, 0.0017451165792459335, -0.0029357205890606303,
        0.0048726090910227891, -0.0077313759655872928, 0.0117637971494846689,
        -0.0173810771817523163, 0.0253500636065296450, -0.0373266939135983855,
        0.0576685041500848358, -0.1024912545928038654, 0.3173768238826674692,
    ),
}


def halfband(order: int) -> np.ndarray:
    """The (order − 1)-tap symmetric half-band response: 0.5 at the centre,
    the side coefficients at odd offsets, zeros at the other even ones."""
    side = HALFBAND_SIDE[order]
    h = np.zeros(order - 1)
    centre = (order - 1) // 2
    h[centre] = 0.5
    for k, c in enumerate(side):
        off = 2 * (len(side) - k) - 1
        h[centre - off] = h[centre + off] = c
    return h


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 (or complex64) values rounded to TF32's 10 mantissa bits,
    to nearest, ties to even."""
    if x.is_complex():
        return torch.view_as_complex(round_tf32(torch.view_as_real(x)).contiguous())
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Arith:
    """float64 (`tf32=False`), or float32 with TF32 operands in every filter
    product (`tf32=True`)."""

    tf32: bool = False

    @property
    def real(self) -> torch.dtype:
        return torch.float32 if self.tf32 else torch.float64

    @property
    def cplx(self) -> torch.dtype:
        return torch.complex64 if self.tf32 else torch.complex128

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return round_tf32(x) if self.tf32 else x

    def taps(self, h: np.ndarray, device) -> torch.Tensor:
        return self.operand(torch.as_tensor(np.ascontiguousarray(h, np.float64), device=device)
                            .to(self.real))


F64 = Arith(False)
TF32 = Arith(True)


def correlate(x: torch.Tensor, h: np.ndarray, stride: int, arith: Arith) -> torch.Tensor:
    """y[m] = Σ_k h[k]·ext[stride·m + k], ext = [0 (L − 1 times) | x], for m
    in [0, T/stride): a FIR from a zero history, every stride-th output.
    x (..., T); h (L,) real taps."""
    n_out = x.shape[-1] // stride
    ext = torch.nn.functional.pad(arith.operand(x), (len(h) - 1, 0))
    taps = arith.taps(h, x.device)
    y = torch.zeros((*x.shape[:-1], n_out), dtype=x.dtype, device=x.device)
    span = stride * (n_out - 1) + 1
    for k in np.flatnonzero(h):
        y += taps[k] * ext[..., k:k + span:stride]
    return y


# -- the device decimator and the channel plan -----------------------------

def placement_signs(log2_decim: int, fc_pos: str) -> tuple[int, ...]:
    """Quarter-rate rotation per ÷2 stage that brings the wanted band to
    DC (devicesamplesource.cpp:84-110): none for cen."""
    if fc_pos == "cen":
        return (0,) * log2_decim
    raise ValueError(f"fc_pos {fc_pos!r}: the reference implements cen only")


def halfband_cascade(x: torch.Tensor, signs, order: int, arith: Arith) -> torch.Tensor:
    """÷2 half-band stages in turn, each after its ±fs/4 rotation (0: none)."""
    h = halfband(order)
    for s in signs:
        if s:
            n = torch.arange(x.shape[-1], device=x.device)
            x = x * torch.polar(torch.ones(n.shape, dtype=arith.real, device=x.device),
                                (s * math.pi / 2) * (n % 4).to(arith.real))
        x = correlate(x, h, 2, arith)
    return x


def i16_to_complex(raw: torch.Tensor, arith: Arith) -> torch.Tensor:
    """(T, 2) int16 I/Q as complex samples in [−1, 1)."""
    f = raw.to(arith.real) / 32768.0
    return torch.complex(f[..., 0], f[..., 1])


@dataclasses.dataclass(frozen=True)
class ChannelPlan:
    signs: tuple[int, ...]
    channel_rate: float
    residual_hz: float


def plan_channel(in_rate: float, requested_rate: float, offset: float) -> ChannelPlan:
    """createFilterChain (downchannelizer.cpp:250-287): halve the band —
    lower, upper or centre half — while the channel fits in it."""
    lo, hi = offset - requested_rate / 2, offset + requested_rate / 2
    start, end = -in_rate / 2, in_rate / 2
    signs = []

    def fits(s, e):
        return e > s and s <= lo and e >= hi

    while True:
        bw = end - start
        if fits(start, start + bw / 2):
            signs.append(1)
            end = start + bw / 2
        elif fits(end - bw / 2, end):
            signs.append(-1)
            start = end - bw / 2
        elif fits(start + bw / 4, end - bw / 4):
            signs.append(0)
            start, end = start + bw / 4, end - bw / 4
        else:
            break
    return ChannelPlan(tuple(signs), in_rate / (1 << len(signs)),
                       (lo + hi) / 2 - (start + end) / 2)


# -- the NFM demodulator ---------------------------------------------------

def mix(x: torch.Tensor, freq_hz, rate: float, arith: Arith) -> torch.Tensor:
    """x·e^{−j2π·f·(n + 1)/rate}: the channel moved down by f (the NCO
    steps before it reads). freq_hz: a number or one per row of x."""
    f = torch.as_tensor(freq_hz, dtype=torch.float64, device=x.device).reshape(-1, 1)
    n = torch.arange(1, x.shape[-1] + 1, dtype=torch.float64, device=x.device)
    turns = torch.remainder(-f * n / rate, 1.0)
    return x * torch.polar(torch.ones_like(turns), 2 * math.pi * turns).to(arith.cplx)


def polyphase_lowpass(phases: int, rate: float, cutoff: float, per_phase: float = 4.5
                      ) -> np.ndarray:
    """createPolyphaseLowPass (interpolator.cpp:20-55): a Hamming-windowed
    sinc at `phases`·rate, unit DC gain, split into `phases` legs each
    normalised to unit sum: (phases, taps per leg)."""
    ntaps = int(per_phase * phases)
    ntaps += ntaps % 2
    total = ntaps * phases
    n = np.arange(total, dtype=np.float64)
    window = 0.54 - 0.46 * np.cos(2 * np.pi * n / (total - 1))
    mid = (total - 1) // 2
    w = 2 * np.pi * cutoff / rate
    k = n - mid
    with np.errstate(invalid="ignore", divide="ignore"):
        taps = np.where(k == 0, w / np.pi, np.sin(k * w) / (k * np.pi)) * window
    taps /= taps[mid] + 2 * taps[mid + 1:].sum()
    legs = taps.reshape(-1, phases).T
    return legs / legs.sum(axis=1, keepdims=True)


@functools.lru_cache(maxsize=8)
def resample_schedule(p: int, q: int, n_inputs: int, phases: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Interpolator::decimate (interpolator.h:23-35) for in/out = p/q, in
    units of 1/q: per input the distance falls by one; when it is below one
    an output is due, on leg floor(distance·phases) (not below 0), and the
    distance grows by p/q. Returns each output's newest input and leg."""
    if p < q:
        raise ValueError(f"{p}/{q}: the NFM resampler decimates")
    newest, leg = [], []
    d = 0
    for n in range(n_inputs):
        d -= q
        if d < q:
            newest.append(n)
            leg.append(max(phases * d // q, 0))
            d += p
    return np.asarray(newest), np.asarray(leg)


def resample(x: torch.Tensor, in_rate: float, out_rate: float, cutoff: float, arith: Arith
             ) -> torch.Tensor:
    """The NFM audio-rate resampler: output j = Σ_u legs[leg_j][u]·x[n_j − u]."""
    frac = Fraction(in_rate / out_rate).limit_denominator(1 << 20)
    cutoff = min(cutoff, 0.45 * min(in_rate, out_rate))
    phases = 16
    legs = polyphase_lowpass(phases, phases * in_rate, cutoff)
    newest, leg = resample_schedule(frac.numerator, frac.denominator, x.shape[-1], phases)
    ntaps = legs.shape[1]
    ext = torch.nn.functional.pad(arith.operand(x), (ntaps - 1, 0))
    sel = arith.taps(legs, x.device)[torch.as_tensor(leg, device=x.device)]  # (n_out, ntaps)
    pos = torch.as_tensor(newest + ntaps - 1, device=x.device)
    y = torch.zeros((*x.shape[:-1], len(newest)), dtype=x.dtype, device=x.device)
    for u in range(ntaps):
        y += sel[:, u] * ext[..., pos - u]
    return y


def discriminate(x: torch.Tensor, scale: float) -> torch.Tensor:
    """phaseDiscriminatorDelta (phasediscri.h:61-78): the phase step per
    sample over π, wrapped into [−1, 1], times the FM scaling; the sample
    before the first is 1 + 0j."""
    ext = torch.cat([torch.ones_like(x[..., :1]), x], dim=-1)
    d = torch.diff(torch.atan2(ext.imag, ext.real), dim=-1) / math.pi
    d = torch.where(d < -1, d + 2, d)
    d = torch.where(d > 1, d - 2, d)
    return d * scale


def moving_mean(x: torch.Tensor, n: int) -> torch.Tensor:
    """The mean of the n samples ending at each sample, zeros before the first."""
    c = torch.cumsum(torch.nn.functional.pad(x.to(torch.float64), (n, 0)), dim=-1)
    return (c[..., n:] - c[..., :-n]) / n


def squelch_counter(open_: np.ndarray, gate: int) -> np.ndarray:
    """count[t] = clamp(count[t − 1] ± 1, 0, 2·gate), +1 while open, from 0,
    one run of equal conditions at a time. open_ (T,) bool -> (T,) int."""
    count = np.empty(len(open_), np.int64)
    edges = np.flatnonzero(np.diff(open_.astype(np.int8))) + 1
    c = 0
    for s, e in zip(np.r_[0, edges], np.r_[edges, len(open_)]):
        step = np.arange(1, e - s + 1)
        count[s:e] = np.minimum(c + step, 2 * gate) if open_[s] else np.maximum(c - step, 0)
        c = int(count[e - 1])
    return count


def nfm_bandpass(ntaps: int, fs: float, f_lo: float, f_hi: float) -> np.ndarray:
    """The audio bandpass SDRangel's NFM applies: Bandpass<T>::create
    (bandpass.h:15-76) as its ring walk (bandpass.h:78-121) applies it —
    the newest two samples share tap 0, so the centre tap sits one sample
    late — scaled to unit gain at the passband's geometric centre. Ordered
    oldest sample first, for `correlate`."""
    n2 = ntaps // 2 + 1
    d = np.arange(n2) - (ntaps - 1) / 2.0
    wl, wh = 2 * np.pi * f_lo / fs, 2 * np.pi * f_hi / fs
    with np.errstate(divide="ignore", invalid="ignore"):
        lp = np.sin(d * wh) / (d * np.pi)
        hp = -np.sin(d * wl) / (d * np.pi)
    lp[-1] = wh / np.pi
    hp[-1] = 1.0 - wl / np.pi
    win = 0.54 + 0.46 * np.cos(2 * np.pi * d / ntaps)
    t = -(lp + hp) * win
    t[-1] += 1.0
    t /= 2 * t[:-1].sum() + t[-1]
    by_age = np.zeros(ntaps)
    by_age[0] = by_age[1] = t[0]
    by_age[2:n2] = t[1:n2 - 1]
    by_age[n2] = t[n2 - 1]
    ages = np.arange(n2 + 1, ntaps)
    by_age[ages] = t[ntaps - ages]
    k = by_age[::-1]
    w = 2 * np.pi * np.sqrt(f_lo * f_hi) / fs
    return k / abs(np.sum(k * np.exp(-1j * w * np.arange(ntaps))))


@dataclasses.dataclass(frozen=True)
class Nfm:
    """NFMDemod's settings (nfmdemod.cpp) at one channel rate."""

    channel_rate: float
    audio_rate: float = 48000.0
    rf_bandwidth: float = 12500.0
    af_bandwidth: float = 3000.0
    fm_deviation: float = 5000.0
    squelch_db: float = -40.0
    squelch_gate_ms: float = 50.0
    volume: float = 1.0

    @property
    def gate(self) -> int:
        return max(1, int(self.audio_rate * self.squelch_gate_ms / 1000.0))


def nfm(y: torch.Tensor, offset_hz, cfg: Nfm, arith: Arith):
    """NFM of channel streams y (C, T) from a zero state: mixed down by
    their offsets, resampled to audio (cutoff rf/2.2), discriminated; the
    power squelch (the 32-sample mean of |·|² against the level) drives
    the gate counter, and the demod, zeroed where the squelch is shut, is
    read `gate` samples late while the gate is open; then the 301-tap
    bandpass and the volume. Returns (audio (C, A), squelch open at the
    stream's end (C,) bool)."""
    x = resample(mix(y, offset_hz, cfg.channel_rate, arith), cfg.channel_rate,
                 cfg.audio_rate, cfg.rf_bandwidth / 2.2, arith)
    demod = discriminate(x, cfg.audio_rate / (2.0 * cfg.fm_deviation))
    open_ = (moving_mean(x.real ** 2 + x.imag ** 2, 32)
             >= 10.0 ** (cfg.squelch_db / 10.0)).cpu().numpy()
    gate = cfg.gate
    counts = np.stack([squelch_counter(o, gate) for o in open_])
    written = torch.where(torch.as_tensor(open_, device=y.device), demod, 0.0)
    delayed = torch.nn.functional.pad(written, (gate, 0))[..., :written.shape[-1]]
    gated = torch.where(torch.as_tensor(counts > gate, device=y.device), delayed, 0.0)
    audio = correlate(gated, nfm_bandpass(301, cfg.audio_rate, 300.0, cfg.af_bandwidth),
                      1, arith)
    return audio * cfg.volume, counts[:, -1] > gate


# -- taps and the polyphase DFT bank ---------------------------------------

def spectrum_db(x: torch.Tensor, fft_size: int, averaging_n: int, blocks: int) -> torch.Tensor:
    """SpectrumVis with a Hanning window and the moving average over
    `averaging_n` frames: the display of the last of `blocks` equal parts
    of x, each cut into whole frames. dB, 0 for a full-scale tone,
    negative frequencies first."""
    n = fft_size
    i = torch.arange(n, dtype=torch.float64, device=x.device)
    win = 0.5 - 0.5 * torch.cos(2 * math.pi * i / (n - 1))
    alpha = 1.0 / averaging_n
    acc = torch.zeros(n, dtype=torch.float64, device=x.device)
    for part in x.to(torch.complex128).chunk(blocks, dim=-1):
        frames = part[: part.shape[-1] // n * n].reshape(-1, n)
        p = torch.fft.fft(frames * win, dim=-1).abs() ** 2
        w = (1 - alpha) ** torch.arange(p.shape[0] - 1, -1, -1, dtype=torch.float64,
                                        device=x.device)
        acc = (1 - alpha) ** p.shape[0] * acc + alpha * (w[:, None] * p).sum(0)
    db = 10 * torch.log10(acc.clamp(min=1e-30)) - 20 * math.log10(n)
    return torch.cat([db[n // 2:], db[: n // 2]])


def pfb_prototype(m: int, taps_per_branch: int, beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed sinc of length M·P cut at fs/(2M), unit DC gain."""
    n = m * taps_per_branch
    t = np.arange(n) - (n - 1) / 2.0
    fc = 0.5 / m
    h = 2 * fc * np.sinc(2 * fc * t) * np.kaiser(n, beta)
    return h / h.sum()


def pfb_channels(x: torch.Tensor, m: int, taps_per_branch: int, channels, arith: Arith
                 ) -> torch.Tensor:
    """Grid channels c of x (T,): y_c[n] = Σ_i g_c[i]·x[nM + M − 1 − i] with
    g_c[i] = h[i]·e^{+j2πci/M} — a bandpass at c·fs/M, then ÷M at each
    frame's end — for each c in `channels`: (C, T/M)."""
    h = pfb_prototype(m, taps_per_branch)
    n_taps, n_out = len(h), x.shape[-1] // m
    # ext[M − 1 + nM + k] = x[nM + M − 1 − (L − 1 − k)]: the flipped taps
    ext = torch.nn.functional.pad(arith.operand(x), (n_taps - 1, 0))[..., m - 1:]
    span = m * (n_out - 1) + 1
    c = np.asarray(channels, np.float64)[:, None]
    g = (h * np.exp(2j * np.pi * c * np.arange(n_taps) / m))[:, ::-1]
    taps = torch.complex(arith.taps(g.real, x.device), arith.taps(g.imag, x.device))
    y = torch.zeros((len(c), n_out), dtype=x.dtype, device=x.device)
    for k in range(n_taps):
        y += taps[:, k:k + 1] * ext[k:k + span:m]
    return y
