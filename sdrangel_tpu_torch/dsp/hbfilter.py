"""Half-band FIR taps of the orders the Rx and Tx paths use.

Reference: sdrbase/dsp/hbfiltertraits.cpp:25-173 — order N stores the N/4
unique side coefficients; the full response is the symmetric length N-1 FIR
whose even-offset taps are zero except the 0.5 centre tap. The values are the
JAX package's table (sdrangel_tpu/dsp/hbfilter.py) for orders 48 (the
DownChannelizer stages), 64 (the device decimators and interpolators) and
96 (the UpChannelizer stages); the tests hold `hb_taps` equal to the
original.
"""

from __future__ import annotations

import functools

import numpy as np

# Unique side coefficients, outermost first, innermost (next to the centre) last.
HB_COEFFS: dict[int, list[float]] = {
    48: [
        -0.0011627994808655962,
        0.0017451165792459335,
        -0.0029357205890606303,
        0.0048726090910227891,
        -0.0077313759655872928,
        0.0117637971494846689,
        -0.0173810771817523163,
        0.0253500636065296450,
        -0.0373266939135983855,
        0.0576685041500848358,
        -0.1024912545928038654,
        0.3173768238826674692,
    ],
    64: [
        -0.0004653050334792540,
        0.0007120490624526884,
        -0.0012303473710125559,
        0.0019716520179919018,
        -0.0029947484165425580,
        0.0043703902150498061,
        -0.0061858352927315653,
        0.0085554408639278122,
        -0.0116397924445187356,
        0.0156852221106748395,
        -0.0211070832238078286,
        0.0286850846890029897,
        -0.0400956173930921908,
        0.0597215923200692667,
        -0.1036982054813635201,
        0.3175014394028848885,
    ],
    96: [
        -0.0000243052463317894,
        0.0000503567741519848,
        -0.0001002354600628052,
        0.0001801275832684543,
        -0.0003014864432246497,
        0.0004783148860127732,
        -0.0007274200147704493,
        0.0010686503612886001,
        -0.0015251456116906108,
        0.0021238131085570462,
        -0.0028960654265650426,
        0.0038789688077727476,
        -0.0051173875903961540,
        0.0066675444490017317,
        -0.0086031967328669932,
        0.0110268456349653828,
        -0.0140900919878225728,
        0.0180336055419063578,
        -0.0232708957455770062,
        0.0305843805330435620,
        -0.0416576245224431485,
        0.0608846679850302969,
        -0.1044156487571061137,
        0.3177437550265513333,
    ],
}

DECIMATORS_ORDER = 64  # decimators.h:23
DOWNCHANNELIZER_ORDER = 48  # downchannelizer.h:28
UPCHANNELIZER_ORDER = 96  # upchannelizer.h:32
#: the reference's device interpolation cascade orders (interpolators.h:27-29);
#: the Tx path runs order 64 at every stage, as the JAX package does
INTERPOLATORS_ORDERS = (64, 32, 16)


@functools.lru_cache(maxsize=None)
def hb_taps(order: int) -> np.ndarray:
    """Full (order-1)-tap float32 impulse response; DC gain ≈ 1."""
    c = np.asarray(HB_COEFFS[order], dtype=np.float64)
    n_side = len(c)
    length = order - 1
    h = np.zeros(length, dtype=np.float64)
    centre = length // 2
    h[centre] = 0.5
    for k in range(n_side):
        off = 2 * (n_side - k) - 1  # innermost coefficient sits at offset 1
        h[centre - off] = c[k]
        h[centre + off] = c[k]
    return h.astype(np.float32)
