"""DATV front end — QPSK symbol recovery feeding the DVB-S FEC chain.

Reference: plugins/channelrx/demoddatv/datvdemod.cpp configures the leansdr
pipeline: sampler → RRC matched filter → timing/carrier recovery → QPSK
soft symbols → deconvol (Viterbi) → deinterleave → RS → derandomize →
TS output. The device part here is the MS/s section (NCO mix, RRC via the
overlap-add filter, Gardner timing), in the JAX package's order; the
bit/byte layers come from channels/dvbs.py on the host, as in the JAX
package (the session's host decode, runtime/session.py).

Carrier phase: DVB-S QPSK has a 4-fold phase ambiguity; this front end
resolves it by trying all four rotations on the first block and locking the
one whose Viterbi+RS chain yields sync bytes (the leansdr "phase search"
role) — exposed as `resolve_rotation`. The host glue below is the JAX
package's numpy code (sdrangel_tpu/channels/demod_datv.py), held equal to it
by tests/test_torch_datv.py, but for recover_ts's ranking of its candidates
(`_sync_score`; ROADMAP.md §3).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..dsp import fftfilt, nco, symsync
from . import dvbs
from .demod_nfm import _device_taps


@dataclasses.dataclass(frozen=True, eq=False)
class DATVConfig:
    channel_rate: float
    input_offset: float = 0.0
    symbol_rate: float = 250_000.0
    rrc_rolloff: float = 0.35
    fec_rate: str = "1/2"
    fft_len: int = 1024

    @property
    def sps(self) -> int:
        sps = int(round(self.channel_rate / self.symbol_rate))
        if abs(self.channel_rate / self.symbol_rate - sps) >= 1e-9:
            raise ValueError("channel rate must be an integer number of samples per symbol: "
                             f"{self.channel_rate} / {self.symbol_rate}")
        return sps

    @functools.cached_property
    def rrc_filter(self) -> np.ndarray:
        fb = self.symbol_rate / self.channel_rate
        return fftfilt.create_rrc_filter(fb, self.rrc_rolloff, self.fft_len)


class DATVState(NamedTuple):
    nco: nco.NCOState
    fft: fftfilt.FftFiltState
    sym: symsync.SymSyncState


def make_state(cfg: DATVConfig, device: torch.device, batch_shape=()) -> DATVState:
    return DATVState(
        nco=nco.make_nco(device, batch_shape),
        fft=fftfilt.make_state(cfg.fft_len, device, batch_shape),
        sym=symsync.make_state(device, batch_shape, sps=cfg.sps),
    )


class DATVOutputs(NamedTuple):
    soft_i: torch.Tensor  # (..., n_sym) float32 in [-1, 1]
    soft_q: torch.Tensor


def process(state: DATVState, x: torch.Tensor, cfg: DATVConfig
            ) -> tuple[DATVState, DATVOutputs]:
    """(state, iq (..., T) complex64 at the channel rate) -> (state', QPSK
    soft symbols (..., T/sps)): NCO mix → RRC matched filter (fftfilt
    runFilt) → Gardner symbol sync → normalised to a unit mean |s| → clipped
    to ±1, as float32 planes."""
    nco_state, xm = nco.mix_block(
        state.nco, x, nco.freq_to_increment(-cfg.input_offset, cfg.channel_rate))
    fft_state, mf = fftfilt.run_filt(state.fft, xm, _device_taps(cfg, "rrc_filter", x.device))
    sym_state, symbols = symsync.synchronize_block(state.sym, mf, cfg.sps)
    scale = torch.clamp(torch.mean(symbols.abs(), dim=-1, keepdim=True), min=1e-9)
    s = symbols / scale
    return (DATVState(nco_state, fft_state, sym_state),
            DATVOutputs(torch.clamp(s.real, -1.0, 1.0).contiguous(),
                        torch.clamp(s.imag, -1.0, 1.0).contiguous()))


# ---------------------------------------------------------------------------
# host-side symbol<->bit glue
# ---------------------------------------------------------------------------

def bits_to_qpsk(channel_bits: np.ndarray) -> np.ndarray:
    """(2n,) bits -> (n,) unit QPSK symbols (Gray: I = b0, Q = b1)."""
    pairs = channel_bits.reshape(-1, 2).astype(np.float64) * 2.0 - 1.0
    return ((pairs[:, 0] + 1j * pairs[:, 1]) / np.sqrt(2.0)).astype(np.complex64)


def qpsk_to_soft_bits(soft_i: np.ndarray, soft_q: np.ndarray) -> np.ndarray:
    """Interleave I/Q soft values back into the (2n,) bit-likelihood stream."""
    out = np.empty(2 * len(soft_i), dtype=np.float64)
    out[0::2] = soft_i
    out[1::2] = soft_q
    return out


_ROTATIONS = [1.0, 1j, -1.0, -1j]


def resolve_rotation(soft_i: np.ndarray, soft_q: np.ndarray, n_probe_packets: int = 2):
    """Try the 4 QPSK phase ambiguities; return (rotation index, soft bits)
    for the one whose decoded stream carries TS sync bytes."""
    best = (0, None, -1)
    s = soft_i + 1j * soft_q
    for ri, rot in enumerate(_ROTATIONS):
        sr = s * rot
        soft = qpsk_to_soft_bits(np.real(sr), np.imag(sr))
        bits = dvbs.viterbi_decode(soft, hard=False)
        byts = np.packbits(bits)
        # score on 0x47 ONLY: the rate-1/2 code is transparent to a 180°
        # rotation (both generators have odd weight), so the inverted
        # stream decodes to INVERTED bytes whose syncs read 0xB8 — counting
        # 0xB8 too made the 180°-rotated candidate tie the correct one
        score = int((byts == dvbs.SYNC_BYTE).sum())
        if score > best[2]:
            best = (ri, soft, score)
    return best[0], best[1]


def _sync_score(bits: np.ndarray) -> int:
    """The 0x47 sync bytes of a decoded channel stream on its 204-byte grid
    (the Forney interleaver passes each codeword's first byte undelayed),
    at the best bit phase and grid offset; random bytes score 1-3, a
    stream of ~16 codewords ~14."""
    best = 0
    for phase in range(8):
        byts = np.packbits(bits[phase:])
        byts = byts[:len(byts) // dvbs.RS_PACKET * dvbs.RS_PACKET].reshape(-1, dvbs.RS_PACKET)
        best = max(best, int((byts == dvbs.SYNC_BYTE).sum(axis=0).max(initial=0)))
    return best


def recover_ts(
    soft_i: np.ndarray,
    soft_q: np.ndarray,
    fec_rate: str = "1/2",
    max_packets: int = 256,
) -> tuple[bytes, dict]:
    """Host FEC chain over accumulated soft symbols: resolve the QPSK phase
    ambiguity, search the bit alignment, run Viterbi → deinterleave →
    RS(204,188) → descramble (channels/dvbs.py), and return the recovered
    TS bytes plus decode stats. The reference does this inside the vendored
    leansdr graph (plugins/channelrx/demoddatv/datvdemod.cpp); here it is a
    one-shot NumPy pass the session applies to a channel's buffered symbols.
    """
    # probe must survive the Forney pipeline: the deinterleaver swallows
    # INTERLEAVER_DELAY (= 2244) bytes before the first valid RS codeword
    probe = (dvbs.INTERLEAVER_DELAY + 4 * dvbs.RS_PACKET) * 8 * 2

    def _chain(bits_soft, n_cw):
        bits = dvbs.viterbi_decode(bits_soft, hard=False)
        de = dvbs.deinterleave(np.packbits(bits))[dvbs.INTERLEAVER_DELAY:]
        n_cw = min(len(de) // dvbs.RS_PACKET, n_cw)
        data, ok, corrected = [], 0, 0
        for i in range(n_cw):
            d, n = dvbs.rs_decode(de[i * dvbs.RS_PACKET : (i + 1) * dvbs.RS_PACKET])
            data.append(d)
            if n >= 0:
                ok += 1
                corrected += n
        return data, ok, corrected

    # Joint ambiguity search: QPSK rotation (4) × puncture-pattern phase
    # (kept-bits-per-period offsets). Viterbi-level sync counting alone
    # aliases — punctured streams admit rotations whose decode shows sync
    # bytes but fails RS (and the code is transparent to 180°, so 0xB8
    # inverted syncs must not count) — so candidates are pre-ranked by
    # 0x47 count and then VERIFIED by RS decode over the probe prefix.
    # The port ranks by the syncs on the stream's 204-byte grid at the best
    # of the 8 bit phases (`_sync_score`), where JAX counts every 0x47 byte
    # at bit phase 0: a receiver delay that is no whole byte of the decoded
    # stream left JAX's right candidate out of the 6 checked at FEC 3/4.
    px, py = dvbs.PUNCTURE[fec_rate]
    kpp = sum(px) + sum(py)
    sc = soft_i + 1j * soft_q
    candidates = []
    for ri, rotv in enumerate(_ROTATIONS):
        sr = sc[: probe] * rotv
        sb_raw = qpsk_to_soft_bits(np.real(sr), np.imag(sr))
        for pre in range(kpp if fec_rate != "1/2" else 1):
            sb = sb_raw[pre:]
            if fec_rate != "1/2":
                sb = dvbs.depuncture(sb, fec_rate, hard=False)
            sync47 = _sync_score(dvbs.viterbi_decode(sb[: probe], hard=False))
            candidates.append((sync47, ri, pre))
    candidates.sort(reverse=True)

    best = None  # (rs_ok, bit_off, rot, pre, soft_full)
    for sync47, ri, pre in candidates[:6]:
        if sync47 < 2:
            break
        s_full = sc * _ROTATIONS[ri]
        soft_full = qpsk_to_soft_bits(np.real(s_full), np.imag(s_full))[pre:]
        if fec_rate != "1/2":
            soft_full = dvbs.depuncture(soft_full, fec_rate, hard=False)
        for bit_off in range(0, 64, 2):
            _, ok, _ = _chain(soft_full[bit_off : bit_off + probe], 3)
            if best is None or ok > best[0]:
                best = (ok, bit_off, ri, pre, soft_full)
            if ok == 3:
                break
        if best and best[0] == 3:
            break
    if best is None:
        return b"", {"rotation": 0, "packets": 0, "rsCorrected": 0, "rsFailed": 0}
    _, best_off, rot, _pre, soft = best

    # the Forney deinterleaver's pipeline swallows ~11 packets at the tail
    # (INTERLEAVER_DELAY bytes) — don't count them as decodable
    n_packets = min(max_packets, len(soft) // (dvbs.RS_PACKET * 8 * 2) - 12)
    if n_packets <= 0:
        return b"", {"rotation": rot, "packets": 0, "rsCorrected": 0, "rsFailed": 0}
    data, ok, corrected = _chain(soft[best_off:], n_packets)
    if not data:
        return b"", {"rotation": rot, "packets": 0, "rsCorrected": 0, "rsFailed": 0}
    pk = np.concatenate(data).reshape(-1, dvbs.TS_PACKET)
    # scrambler-group realignment: the energy-dispersal PRBS resets every 8
    # packets with the group head's sync byte inverted to 0xB8 — locate it
    # so windows that do not start at the stream head still descramble
    # correctly (decodes of buffered segments / future mid-stream joins)
    heads = np.nonzero(pk[:8, 0] == 0xB8)[0] if len(pk) >= 8 else []
    i0 = int(heads[0]) if len(heads) else 0
    dropped = i0
    recovered = dvbs.fix_sync(dvbs.descramble(pk[i0:].reshape(-1)))
    stats = {"rotation": rot, "packets": len(pk) - dropped,
             "rsCorrected": corrected, "rsFailed": len(data) - ok,
             "headDropped": dropped}
    return recovered.tobytes(), stats
