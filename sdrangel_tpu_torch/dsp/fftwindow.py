"""FFT window functions (sdrbase/dsp/fftwindow.{h,cpp}); a copy of the JAX
package's numpy designer, held equal to it by the tests."""

from __future__ import annotations

import enum
import functools

import numpy as np


class Function(enum.Enum):
    BARTLETT = "bartlett"
    BLACKMAN_HARRIS = "blackman_harris"
    FLATTOP = "flattop"
    HAMMING = "hamming"
    HANNING = "hanning"
    RECTANGLE = "rectangle"


@functools.lru_cache(maxsize=None)
def window(func: Function, n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    x = 2.0 * np.pi * i / (n - 1)
    if func is Function.BARTLETT:
        w = 2.0 / (n - 1) * ((n - 1) / 2.0 - np.abs(i - (n - 1) / 2.0))
    elif func is Function.BLACKMAN_HARRIS:
        w = 0.35875 - 0.48829 * np.cos(x) + 0.14128 * np.cos(2 * x) - 0.01168 * np.cos(3 * x)
    elif func is Function.FLATTOP:
        w = (1.0 - 1.93 * np.cos(x) + 1.29 * np.cos(2 * x) - 0.388 * np.cos(3 * x)
             + 0.03222 * np.cos(4 * x))
    elif func is Function.HAMMING:
        w = 0.54 - 0.46 * np.cos(x)
    elif func is Function.HANNING:
        w = 0.5 - 0.5 * np.cos(x)
    elif func is Function.RECTANGLE:
        w = np.ones(n)
    else:
        raise ValueError(func)
    return w.astype(np.float32)
