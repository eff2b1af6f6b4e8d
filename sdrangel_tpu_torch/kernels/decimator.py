"""The counterpart of the JAX package's pallas/decimator.py, under its public
names: the fused ÷2^k decimator in its two kernel forms and its oracle.

Every function takes raw (T + HALO, 2) int16 — a block preceded by the
previous block's last HALO raw samples (zeros for the first block) — and
returns (2, T/2^k) float32 I/Q planes, the Pallas kernels' contract, so the
tests compare like with like against them in interpret mode. The kernels
need only the last r·(t_leg − 1) samples of the halo; the Pallas
`tile_out`/`interpret` options have no meaning on the card and are gone.

  decimate_cascade_fused      K1 (kernels/flat_decimate.py), for
                              pallas/decimator.py:94
  decimate_cascade_fused_mxu  K1-TC (kernels/flat_decimate_tc.py), for
                              pallas/decimator.py:165
  reference_equivalent        the staged streaming cascade, same convention
"""

from __future__ import annotations

import numpy as np
import torch

from ..dsp import decimators as dec
from .flat_decimate import flat_decimate
from .flat_decimate_tc import flat_decimate_tc

#: input-rate halo of the Pallas kernels (it covers the ÷64 history, 3906)
HALO = 8192


def _ext(raw: torch.Tensor, log2_decim: int) -> torch.Tensor:
    """The kernels' ext: the block plus the tail of the halo it needs."""
    r = 1 << log2_decim
    t = raw.shape[0] - HALO
    if raw.dim() != 2 or raw.shape[1] != 2 or raw.dtype != torch.int16:
        raise TypeError(f"raw must be (T + HALO, 2) int16, got {raw.dtype} {tuple(raw.shape)}")
    if t <= 0 or t % r:
        raise ValueError(f"raw holds {t} samples after the {HALO}-sample halo; "
                         f"need a positive multiple of {r}")
    return raw[HALO - dec.flat_tail_len(log2_decim):].contiguous()


def decimate_cascade_fused(raw: torch.Tensor, log2_decim: int = 6) -> torch.Tensor:
    """K1 (the VPU kernel's counterpart): (T + HALO, 2) int16 -> (2, T/2^k)."""
    legs, _, _ = dec._device_legs(log2_decim, "cen", raw.device)
    return flat_decimate(_ext(raw, log2_decim), legs).t().contiguous()


def decimate_cascade_fused_mxu(raw: torch.Tensor, log2_decim: int = 6) -> torch.Tensor:
    """K1-TC (the MXU kernel's counterpart): (T + HALO, 2) int16 -> (2, T/2^k)."""
    legs, _, _ = dec._device_legs(log2_decim, "cen", raw.device)
    return flat_decimate_tc(_ext(raw, log2_decim), legs).t().contiguous()


def reference_equivalent(raw, log2_decim: int = 6) -> torch.Tensor:
    """Oracle: the staged streaming cascade (`decimators.decimate_cascade`)
    over the whole raw block from zero state, the halo's outputs dropped."""
    raw = torch.as_tensor(np.asarray(raw)) if not isinstance(raw, torch.Tensor) else raw
    x = raw.to(torch.float32) * (1.0 / 32768.0)
    _, y = dec.decimate_cascade(
        dec.init_state(log2_decim, raw.device), torch.complex(x[:, 0], x[:, 1]), log2_decim)
    return torch.stack([y.real, y.imag])[:, HALO >> log2_decim:]
