"""DVB-S FEC chain — the DATV (demoddatv/leansdr) decode layers.

Reference: plugins/channelrx/demoddatv vendors the leansdr DVB-S stack:
QPSK at the symbol layer (covered here by dsp/symsync + the RRC builder in
dsp/fftfilt), then convolutional (K=7, G1=0o171/G2=0o133) Viterbi decoding,
Forney deinterleaving (I=12, M=17), RS(204,188) over GF(256) (prim poly
0x11D — shared with io/fec.py), and the energy-dispersal descrambler
(PRBS x^15+x^14+1) recovering MPEG transport-stream packets.

These bit/byte layers run on the host at transport rates (like the RDS
layer); the MS/s front end (mix, RRC matched filter, symbol timing) runs on
the card (channels/demod_datv.py). The encoder halves exist so tests close
the loop without recorded captures.

The port's own copy of the JAX package's numpy module
(sdrangel_tpu/channels/dvbs.py), held equal to it by
tests/test_torch_dvbs_copies.py.
"""

from __future__ import annotations

import numpy as np

from ..io.fec import _EXP, _LOG, gf_inv, gf_mul

TS_PACKET = 188
RS_PACKET = 204
SYNC_BYTE = 0x47

# ---------------------------------------------------------------------------
# Convolutional code K=7 (DVB-S standard polynomials)
# ---------------------------------------------------------------------------

_G1, _G2 = 0o171, 0o133
_NSTATES = 64


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """Rate-1/2 encoder: bit stream -> interleaved (c1, c2) stream."""
    state = 0
    out = np.empty(2 * len(bits), dtype=np.uint8)
    for i, b in enumerate(bits):
        reg = (int(b) << 6) | state
        out[2 * i] = bin(reg & _G1).count("1") & 1
        out[2 * i + 1] = bin(reg & _G2).count("1") & 1
        state = reg >> 1
    return out


def _branch_tables():
    """For each (state, input bit): next state and the two output bits."""
    nxt = np.zeros((_NSTATES, 2), dtype=np.int32)
    outs = np.zeros((_NSTATES, 2, 2), dtype=np.int8)
    for s in range(_NSTATES):
        for b in range(2):
            reg = (b << 6) | s
            nxt[s, b] = reg >> 1
            outs[s, b, 0] = bin(reg & _G1).count("1") & 1
            outs[s, b, 1] = bin(reg & _G2).count("1") & 1
    return nxt, outs


_NXT, _OUTS = _branch_tables()


def viterbi_decode(soft: np.ndarray, hard: bool | None = None) -> np.ndarray:
    """Rate-1/2 Viterbi with full traceback.

    soft: (2T,) float in [-1, 1] (soft bit likelihoods, +1 = bit 1) or
    hard 0/1. `hard` says which explicitly; None falls back to a heuristic
    that can misread an all-non-negative soft block as hard bits — pass it
    when you know. Returns (T,) decoded bits. Vectorized over the 64
    states; the time loop is host NumPy (transport-layer rates)."""
    soft = np.asarray(soft, dtype=np.float64)
    if hard is None:
        hard = bool(soft.max() > 1.0 or soft.min() >= 0.0)
    if hard:  # hard bits -> bipolar
        soft = soft * 2.0 - 1.0
    t = len(soft) // 2
    pairs = soft[: 2 * t].reshape(t, 2)

    # branch metric of emitting (o0, o1): correlation with the soft pair
    out_bipolar = _OUTS.astype(np.float64) * 2.0 - 1.0  # (S, 2, 2)

    metrics = np.full(_NSTATES, -1e18)
    metrics[0] = 0.0
    backptr = np.zeros((t, _NSTATES), dtype=np.int8)  # input bit chosen
    prevstate = np.zeros((t, _NSTATES), dtype=np.int32)

    # precompute predecessor lists: state s' reached from (s, b)
    preds = [[] for _ in range(_NSTATES)]
    for s in range(_NSTATES):
        for b in range(2):
            preds[_NXT[s, b]].append((s, b))
    pred_s = np.array([[p[0][0], p[1][0]] for p in preds])  # (S, 2)
    pred_b = np.array([[p[0][1], p[1][1]] for p in preds])
    pred_out = out_bipolar[pred_s, pred_b]  # (S, 2, 2)

    for i in range(t):
        bm = pred_out @ pairs[i]  # (S, 2)
        cand = metrics[pred_s] + bm  # (S, 2)
        choice = np.argmax(cand, axis=1)
        metrics = cand[np.arange(_NSTATES), choice]
        backptr[i] = pred_b[np.arange(_NSTATES), choice]
        prevstate[i] = pred_s[np.arange(_NSTATES), choice]

    bits = np.empty(t, dtype=np.uint8)
    s = int(np.argmax(metrics))
    for i in range(t - 1, -1, -1):
        bits[i] = backptr[i, s]
        s = prevstate[i, s]
    return bits


#: DVB-S puncturing patterns (X, Y kept-bit masks per rate)
PUNCTURE = {
    "1/2": ([1], [1]),
    "2/3": ([1, 0], [1, 1]),
    "3/4": ([1, 0, 1], [1, 1, 0]),
    "5/6": ([1, 0, 1, 0, 1], [1, 1, 0, 1, 0]),
    "7/8": ([1, 0, 0, 0, 1, 0, 1], [1, 1, 1, 1, 0, 1, 0]),
}


def puncture(coded: np.ndarray, rate: str) -> np.ndarray:
    """Drop bits of the rate-1/2 stream per the DVB pattern."""
    px, py = PUNCTURE[rate]
    period = len(px)
    pairs = coded.reshape(-1, 2)
    n = (len(pairs) // period) * period
    pairs = pairs[:n]
    keep = []
    for i in range(n):
        if px[i % period]:
            keep.append(pairs[i, 0])
        if py[i % period]:
            keep.append(pairs[i, 1])
    return np.asarray(keep, dtype=coded.dtype)


def depuncture(received: np.ndarray, rate: str,
               hard: bool | None = None) -> np.ndarray:
    """Re-insert erasures (soft 0) at the punctured positions so the plain
    rate-1/2 Viterbi decodes any DVB rate. `hard` as in viterbi_decode."""
    px, py = PUNCTURE[rate]
    period = len(px)
    kept_per_period = sum(px) + sum(py)
    n_periods = len(received) // kept_per_period
    out = np.zeros(2 * period * n_periods, dtype=np.float64)
    r = np.asarray(received, dtype=np.float64)
    if hard is None:
        hard = bool(r.min() >= 0.0 and r.max() <= 1.0)
    if hard:
        r = r * 2.0 - 1.0
    src = 0
    for p_i in range(n_periods):
        for i in range(period):
            if px[i]:
                out[2 * (p_i * period + i)] = r[src]
                src += 1
            if py[i]:
                out[2 * (p_i * period + i) + 1] = r[src]
                src += 1
    return out


# ---------------------------------------------------------------------------
# Forney convolutional interleaver I=12, M=17
# ---------------------------------------------------------------------------

_I, _M = 12, 17


def interleave(data: np.ndarray) -> np.ndarray:
    """Byte interleaver over a whole message (batch form: the delay lines
    are realized as index arithmetic; output aligned so packet sync bytes
    land on branch 0 as in DVB)."""
    n = len(data)
    out = np.zeros(n, dtype=np.uint8)
    for idx in range(n):
        branch = idx % _I
        delay = branch * _M
        src = idx - delay * _I
        out[idx] = data[src] if src >= 0 else 0
    return out


def deinterleave(data: np.ndarray) -> np.ndarray:
    """Inverse (branch j delayed by (I-1-j)*M); total pipeline delay
    I*(I-1)*M bytes — callers discard the head."""
    n = len(data)
    out = np.zeros(n, dtype=np.uint8)
    for idx in range(n):
        branch = idx % _I
        delay = (_I - 1 - branch) * _M
        src = idx - delay * _I
        out[idx] = data[src] if src >= 0 else 0
    return out


INTERLEAVER_DELAY = _I * (_I - 1) * _M  # bytes of pipeline latency


# ---------------------------------------------------------------------------
# RS(204,188): shortened RS(255,239), roots alpha^0..alpha^15, poly 0x11D
# ---------------------------------------------------------------------------

_NROOTS = 16


def _gf_poly_mul(a, b):
    out = np.zeros(len(a) + len(b) - 1, dtype=np.uint8)
    for i, ai in enumerate(a):
        if ai:
            out[i : i + len(b)] ^= gf_mul(np.full(len(b), ai, np.uint8), b)
    return out


def _rs_generator():
    g = np.array([1], dtype=np.uint8)
    for i in range(_NROOTS):
        g = _gf_poly_mul(g, np.array([1, _EXP[i]], dtype=np.uint8))
    return g


_RS_G = _rs_generator()


def rs_encode(msg: np.ndarray) -> np.ndarray:
    """188 data bytes -> 204-byte codeword (systematic)."""
    assert len(msg) == TS_PACKET
    padded = np.concatenate([msg.astype(np.uint8), np.zeros(_NROOTS, np.uint8)])
    rem = padded.copy()
    for i in range(TS_PACKET):
        coef = rem[i]
        if coef:
            rem[i : i + len(_RS_G)] ^= gf_mul(np.full(len(_RS_G), coef, np.uint8), _RS_G)
    return np.concatenate([msg.astype(np.uint8), rem[TS_PACKET:]])


def _m(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[(int(_LOG[a]) + int(_LOG[b])) % 255])


def _poly_eval(poly, x: int) -> int:
    """Evaluate polynomial (highest-degree coefficient first) at x."""
    y = 0
    for c in poly:
        y = _m(y, x) ^ int(c)
    return y


def rs_decode(codeword: np.ndarray) -> tuple[np.ndarray, int]:
    """204-byte codeword -> (188 data bytes, n_corrected); n_corrected = -1
    when uncorrectable (>8 byte errors). Textbook BM + Chien + Forney with
    fcr=0 roots alpha^0..alpha^15 (the DVB RS(204,188) profile)."""
    cw = [int(v) for v in codeword]
    synd = [_poly_eval(cw, int(_EXP[i])) for i in range(_NROOTS)]
    if not any(synd):
        return np.asarray(cw[:TS_PACKET], np.uint8), 0

    # Berlekamp-Massey (coefficient lists lowest-degree first)
    c_poly = [1]
    b_poly = [1]
    l_len, m_shift, b_disc = 0, 1, 1
    for n in range(_NROOTS):
        d = synd[n]
        for i in range(1, l_len + 1):
            d ^= _m(c_poly[i] if i < len(c_poly) else 0, synd[n - i])
        if d == 0:
            m_shift += 1
        elif 2 * l_len <= n:
            t_poly = list(c_poly)
            coef = _m(d, gf_inv(b_disc))
            shifted = [0] * m_shift + [_m(coef, x) for x in b_poly]
            c_poly = [
                (c_poly[i] if i < len(c_poly) else 0) ^ (shifted[i] if i < len(shifted) else 0)
                for i in range(max(len(c_poly), len(shifted)))
            ]
            l_len = n + 1 - l_len
            b_poly = t_poly
            b_disc = d
            m_shift = 1
        else:
            coef = _m(d, gf_inv(b_disc))
            shifted = [0] * m_shift + [_m(coef, x) for x in b_poly]
            c_poly = [
                (c_poly[i] if i < len(c_poly) else 0) ^ (shifted[i] if i < len(shifted) else 0)
                for i in range(max(len(c_poly), len(shifted)))
            ]
            m_shift += 1
    n_errors = l_len
    if n_errors > _NROOTS // 2:
        return np.asarray(cw[:TS_PACKET], np.uint8), -1

    # Chien search: roots of C(x) are X_k^{-1} where X_k = alpha^{position
    # power}; byte at index i has power (RS_PACKET-1-i) in the shortened code
    positions = []
    for i in range(RS_PACKET):
        power = RS_PACKET - 1 - i
        x_inv = int(_EXP[(255 - power) % 255])
        if _poly_eval(c_poly[::-1], x_inv) == 0:
            positions.append(i)
    if len(positions) != n_errors:
        return np.asarray(cw[:TS_PACKET], np.uint8), -1

    # Forney: Omega(x) = [S(x) * C(x)] mod x^NROOTS  (lowest-first)
    omega = [0] * _NROOTS
    for i in range(_NROOTS):
        acc = 0
        for j in range(i + 1):
            acc ^= _m(synd[j] if j < len(synd) else 0,
                      c_poly[i - j] if i - j < len(c_poly) else 0)
        omega[i] = acc
    for i in positions:
        power = RS_PACKET - 1 - i
        x = int(_EXP[power % 255])
        x_inv = gf_inv(x)
        num = _poly_eval(omega[::-1], x_inv)
        # C'(x): formal derivative keeps odd-degree terms
        deriv = [c_poly[j] for j in range(1, len(c_poly), 2)]
        den = 0
        x_inv2 = _m(x_inv, x_inv)
        xpow = 1
        for c in deriv:
            den ^= _m(c, xpow)
            xpow = _m(xpow, x_inv2)
        if den == 0:
            return np.asarray(cw[:TS_PACKET], np.uint8), -1
        # Forney with fcr=0: e_k = X_k * Omega(X_k^-1) / C'(X_k^-1)
        magnitude = _m(x, _m(num, gf_inv(den)))
        cw[i] ^= magnitude

    if any(_poly_eval(cw, int(_EXP[i])) for i in range(_NROOTS)):
        return np.asarray([int(v) for v in codeword[:TS_PACKET]], np.uint8), -1
    return np.asarray(cw[:TS_PACKET], np.uint8), n_errors


# ---------------------------------------------------------------------------
# Energy dispersal (PRBS x^15 + x^14 + 1, init 0b100101010000000)
# ---------------------------------------------------------------------------

def _prbs_bytes(n: int) -> np.ndarray:
    """EN 300 421 §4.4 PRBS (1 + x^14 + x^15), init '100101010000000'
    loaded s1..s15: output bit = s14 ^ s15, shifted back into s1. The
    sequence starts 0000 0011 ... — first output byte 0x03 (the spec's
    published start)."""
    reg = 0b000000010101001  # s1 in bit 0 .. s15 in bit 14
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        byte = 0
        for _ in range(8):
            bit = ((reg >> 13) ^ (reg >> 14)) & 1
            reg = ((reg << 1) | bit) & 0x7FFF
            byte = (byte << 1) | bit
        out[i] = byte
    return out


#: XOR table over an 8-packet group: the FIRST PRBS byte applies to the
#: first byte AFTER the inverted sync (EN 300 421 §4.4: group offset g>=1
#: gets PRBS[g-1]); at subsequent sync positions the PRBS keeps running
#: but its output is disabled.
_PRBS_XOR = np.zeros(8 * TS_PACKET, np.uint8)
_PRBS_XOR[1:] = _prbs_bytes(8 * TS_PACKET - 1)
_PRBS_XOR[:: TS_PACKET] = 0


def scramble(packets: np.ndarray) -> np.ndarray:
    """Energy dispersal over groups of 8 TS packets: the first packet's sync
    byte is inverted (0xB8), PRBS XORs every byte except sync bytes."""
    pk = packets.reshape(-1, TS_PACKET).copy()
    for g in range(0, len(pk), 8):
        group = pk[g : g + 8]
        group ^= _PRBS_XOR[: group.size].reshape(group.shape)
        group[0, 0] = 0xB8 if group[0, 0] == SYNC_BYTE else group[0, 0]
    return pk.reshape(-1)


descramble = scramble  # XOR is an involution; sync inversion handled below


def fix_sync(packets: np.ndarray) -> np.ndarray:
    pk = packets.reshape(-1, TS_PACKET).copy()
    pk[:, 0] = SYNC_BYTE
    return pk.reshape(-1)


# ---------------------------------------------------------------------------
# The full pipe (unpunctured rate 1/2) for loopback tests
# ---------------------------------------------------------------------------

def encode_transport(packets: np.ndarray) -> np.ndarray:
    """TS packets -> channel bits (scramble -> RS -> interleave -> conv)."""
    scrambled = scramble(packets).reshape(-1, TS_PACKET)
    rs = np.concatenate([rs_encode(p) for p in scrambled])
    il = interleave(rs)
    bits = np.unpackbits(il)
    return conv_encode(bits)


def decode_transport(channel_bits: np.ndarray, n_packets: int) -> tuple[np.ndarray, int]:
    """Channel bits -> (TS packets, total RS corrections)."""
    bits = viterbi_decode(channel_bits)
    byts = np.packbits(bits)
    de = deinterleave(byts)
    de = de[INTERLEAVER_DELAY:]  # drop interleaver pipeline head
    n_cw = min(len(de) // RS_PACKET, n_packets)
    out, corrected = [], 0
    for i in range(n_cw):
        data, n = rs_decode(de[i * RS_PACKET : (i + 1) * RS_PACKET])
        out.append(data)
        if n > 0:
            corrected += n
    if not out:
        return np.zeros(0, dtype=np.uint8), 0
    recovered = descramble(np.concatenate(out))
    return fix_sync(recovered), corrected
