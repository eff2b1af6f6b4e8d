"""The two receive chains the benchmark's configurations run, from the
raw capture to what the program hands its user, in plain arithmetic
(`dsp`). Each call starts from a zero state: the caller passes the block
before the one judged, which flushes every finite memory of the chain
(the longest, the device filter's 931 or 63 input samples and the
squelch gate's 2·gate audio samples, lie far inside one block; the
spectrum's moving average forgets a block's weight to (7/8)^625 ≈ 5e-37)."""

from __future__ import annotations

import numpy as np
import torch

from . import dsp


def _baseband(raws, config: dict, arith: dsp.Arith) -> torch.Tensor:
    """The device decimator's output for the concatenated raw blocks."""
    if config["input_format"] != "i16":
        raise ValueError("the reference reads i16 captures")
    x = torch.cat([dsp.i16_to_complex(r, arith) for r in raws])
    return dsp.halfband_cascade(x, dsp.placement_signs(config["log2_decim"], config["fc_pos"]),
                                64, arith)


def product(raws, config: dict, channels_hz, arith: dsp.Arith = dsp.F64) -> dict:
    """The Rx product path's outputs of the last of `raws` ((T, 2) int16
    blocks in stream order): per channel the audio, the channel power and
    the squelch meter; the spectrum and the scope's head of the baseband."""
    bb = _baseband(raws, config, arith)
    n = len(raws)
    rate = config["sample_rate"] / (1 << config["log2_decim"])
    ch = config["channel"]
    out = []
    for f in channels_hz:
        plan = dsp.plan_channel(rate, ch["requested_rate"], f)
        y = dsp.halfband_cascade(bb, plan.signs, 48, arith)[None]
        cfg = dsp.Nfm(channel_rate=plan.channel_rate, audio_rate=ch["audio_rate"],
                      rf_bandwidth=ch["rf_bandwidth"], af_bandwidth=ch["af_bandwidth"],
                      fm_deviation=ch["fm_deviation"], squelch_db=ch["squelch_db"],
                      squelch_gate_ms=ch["squelch_gate_ms"], volume=ch["volume"])
        audio, open_ = dsp.nfm(y, plan.residual_hz, cfg, arith)
        last = y[0, -(y.shape[-1] // n):]
        out.append({"audio": audio[0, -(audio.shape[-1] // n):].double().cpu().numpy(),
                    "power": float((last.real ** 2 + last.imag ** 2).double().mean()),
                    "squelch": bool(open_[0])})
    sp = config["spectrum"]
    if sp["window"] != "hanning" or sp["averaging"] != "moving":
        raise ValueError("the reference's spectrum is the Hanning window, moving average")
    head = bb[-(bb.shape[-1] // n):][: config["scope_samples"]].to(torch.complex128)
    magsq = head.real ** 2 + head.imag ** 2
    scope = torch.stack([head.real, head.imag, 10 * torch.log10(magsq.clamp(min=1e-30))])
    return {"channels": out,
            "spectrum": dsp.spectrum_db(bb, sp["fft_size"], sp["averaging_n"], n).cpu().numpy(),
            "scope": scope.cpu().numpy()}


def grid_split(offsets_hz, grid_hz: float, m: int) -> tuple[np.ndarray, np.ndarray]:
    """Each demod's grid channel (mod M) and the residual its NCO absorbs."""
    off = np.asarray(offsets_hz, np.float64)
    idx = np.rint(off / grid_hz)
    return (idx % m).astype(np.int64), off - idx * grid_hz


def bank(raws, config: dict, arith: dsp.Arith = dsp.F64) -> np.ndarray:
    """The bank gear's audio of the last of `raws`: (demods, samples)."""
    bb = _baseband(raws, config, arith)
    n = len(raws)
    m = config["pfb_m"]
    grid = config["sample_rate"] / (1 << config["log2_decim"]) / m
    idx, residual = grid_split(config["offsets_hz"], grid, m)
    used = sorted(set(idx.tolist()))
    chans = dsp.pfb_channels(bb, m, config["pfb_taps"], used, arith)
    y = chans[torch.as_tensor([used.index(c) for c in idx], device=bb.device)]
    cfg = dsp.Nfm(channel_rate=grid, **config["bank"]["settings"])
    audio, _ = dsp.nfm(y, residual, cfg, arith)
    return audio[:, -(audio.shape[-1] // n):].double().cpu().numpy()
