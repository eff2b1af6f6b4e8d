"""Half-band FIR taps of the two orders the Rx path uses.

Reference: sdrbase/dsp/hbfiltertraits.cpp:25-173 — order N stores the N/4
unique side coefficients; the full response is the symmetric length N-1 FIR
whose even-offset taps are zero except the 0.5 centre tap. The values are the
JAX package's table (sdrangel_tpu/dsp/hbfilter.py) for orders 48 (the
DownChannelizer stages) and 64 (the device decimators); the tests hold
`hb_taps` equal to the original.
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
}

DECIMATORS_ORDER = 64  # decimators.h:23
DOWNCHANNELIZER_ORDER = 48  # downchannelizer.h:28


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
