"""Peaks of the card and the least time of the work a kernel does.

The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) are written here once. A share of
a roofline divides the least time the work could take on the card by the
time measured, so no implementation can read over 100 %: the least time
is the larger of the bytes the work must move (its input read once, its
output written once) over the memory bandwidth, and its operations over
the card's highest dense rate, whatever unit carries them.
"""

from __future__ import annotations

H100 = {
    "hbm_bytes_per_s": 3.35e12,
    "dense_flops_per_s": 989e12,  # bf16/fp16 on the tensor cores, the highest dense rate
}

#: bytes of one complex sample of the decimator's output (complex64)
OUT_BYTES = 8


def decimator_work(n_in: int, in_bytes: int, log2_decim: int, order: int = 64
                   ) -> tuple[float, float]:
    """(bytes, FLOP) of one ÷2^k decimation of n_in I/Q pairs of in_bytes
    each: the composed filter of the k half-band stages of `order` − 1 taps
    has (order − 2)(2^k − 1) + 1 taps; each output of each plane (I, Q)
    is that many multiply-adds of 2 FLOP."""
    r = 1 << log2_decim
    n_out = n_in // r
    taps = (order - 2) * (r - 1) + 1
    return n_in * in_bytes + n_out * OUT_BYTES, n_out * 2 * taps * 2.0


def least_ms(nbytes: float, flop: float, peaks: dict = H100) -> float:
    return max(nbytes / peaks["hbm_bytes_per_s"], flop / peaks["dense_flops_per_s"]) * 1e3


def decimator_least_ms(n_in: int, log2_decim: int, in_bytes: int = 4) -> float:
    """The least time of one block's device decimation (i16 pairs: 4 bytes)."""
    return least_ms(*decimator_work(n_in, in_bytes, log2_decim))
