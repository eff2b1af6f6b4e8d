"""Raw I/Q ingest formats (dsptypes.h:25-97 scale policy).

Ingest normalizes any ADC width to complex64 in [-1, 1) once; every later
stage is float32/complex64.
"""

from __future__ import annotations

import torch

#: name -> (container dtype, zero offset, scale divisor): u8 = RTL-SDR
#: (DecimatorsU<..., quint8, 8, 127>), i8 = HackRF, i12 = Airspy/PlutoSDR
#: (12 bits in int16), i16 = file/test source, i24 = 24-bit (int32 container).
INPUT_FORMATS = {
    "i16": (torch.int16, 0.0, 32768.0),
    "u8": (torch.uint8, 127.4, 128.0),
    "i8": (torch.int8, 0.0, 128.0),
    "i12": (torch.int16, 0.0, 2048.0),
    "i24": (torch.int32, 0.0, 8388608.0),
}


def iq_raw_to_complex64(raw: torch.Tensor, fmt: str = "i16") -> torch.Tensor:
    """Interleaved raw I/Q (..., T, 2) or (..., 2T) -> complex64 (..., T)."""
    _, offset, scale = INPUT_FORMATS[fmt]
    if raw.shape[-1] != 2:
        raw = raw.reshape(*raw.shape[:-1], -1, 2)
    f = (raw.to(torch.float32) - offset) * (1.0 / scale)
    return torch.complex(f[..., 0], f[..., 1])
