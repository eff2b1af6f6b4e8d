"""K1: the flat ÷2^k polyphase decimator — wrapper and plain twin.

`flat_decimate` launches the CUDA kernel (`csrc/flat_decimate.cu`) for a
tensor on the card and runs the plain twin `flat_decimate_reference` for a
tensor on the CPU; any other device raises. There is no fallback: a failed
build or launch on the card raises.

Contract (the grid of the JAX `decimate_flat`, decimators.py:326-345; the
Pallas kernel's HALO convention is the same grid fed raw[HALO − r·(t_leg−1):]):
  x     (T, 2) int16 or float32 block, interleaved I/Q; int16 is scaled by
        1/32768 (i16 ingest)
  tail  (r·(t_leg − 1), 2), x's dtype: the carried tail, its own tensor;
        or tail=None and x is ext = [tail | block], (T + r·(t_leg − 1), 2)
  legs  (r, t_leg) float32 real legs, r = 2^k with 1 ≤ k ≤ 6; legs_im the
        imaginary part of complex legs (inf/sup placements) or None
  ->    (T/r, 2) float32, y[m] = Σ_j Σ_t legs[j, t] · ext[r·(m + t) + j]
        with ext = [tail | block]
The kernel reads the tail and the block through two pointers, so a caller
never copies the block to put the tail in front of it; the one-tensor form
is read as two views of ext.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

SCALE_I16 = 1.0 / 32768.0
RATIOS = (2, 4, 8, 16, 32, 64)


def _operands(x: torch.Tensor, legs_re: torch.Tensor, legs_im: torch.Tensor | None,
              tail: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Validates the operands; returns (tail, block, number of outputs T/r).
    With tail=None, x is ext = [tail | block] and both are views of it."""
    for name, legs in (("legs_re", legs_re), ("legs_im", legs_im)):
        if legs is None:
            continue
        if legs.dim() != 2 or legs.dtype != torch.float32:
            raise TypeError(f"{name} must be (r, t_leg) float32, got {legs.dtype} "
                            f"{tuple(legs.shape)}")
        if legs.shape != legs_re.shape or legs.device != x.device:
            raise ValueError(f"{name} must match legs_re's shape and x's device")
    r, t_leg = legs_re.shape
    if r not in RATIOS:
        raise ValueError(f"legs (r={r}, t_leg={t_leg}): r must be one of {RATIOS}")
    for name, v in (("x", x), ("tail", tail)):
        if v is None:
            continue
        if v.dim() != 2 or v.shape[1] != 2:
            raise ValueError(f"{name} must be (N, 2) interleaved I/Q, got {tuple(v.shape)}")
        if v.dtype not in (torch.int16, torch.float32) or v.dtype != x.dtype:
            raise TypeError(f"{name} must be int16 or float32 like x, got {v.dtype}")
        if v.device != x.device:
            raise ValueError(f"x on {x.device}, {name} on {v.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return split_ext(x, tail, r, t_leg)


def split_ext(x: torch.Tensor, tail: torch.Tensor | None, r: int, t_leg: int
              ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The [tail | block] contract that K1 and K1-TC share: returns (tail,
    block, number of outputs T/r). With tail=None, x is ext = [tail | block]
    and both are views of it; else the tail must be r·(t_leg − 1) pairs. The
    block must be a positive multiple of r pairs."""
    n_tail = r * (t_leg - 1)
    if tail is None:
        tail, block = x[:n_tail], x[n_tail:]
    elif tail.shape[0] != n_tail:
        raise ValueError(f"tail holds {tail.shape[0]} pairs, not r·(t_leg−1) = {n_tail}")
    else:
        block = x
    t = block.shape[0]
    if t <= 0 or t % r:
        raise ValueError(
            f"{t} block samples after the r·(t_leg−1) = {n_tail}-pair tail: not a positive "
            f"multiple of r (r={r}, t_leg={t_leg})")
    return tail, block, t // r


def flat_decimate_reference(
    x: torch.Tensor, legs_re: torch.Tensor, legs_im: torch.Tensor | None = None,
    tail: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch twin of K1: the polyphase planes as conv1d channels."""
    tail, block, _ = _operands(x, legs_re, legs_im, tail)
    r = legs_re.shape[0]
    x = torch.cat([tail, block]).to(torch.float32)
    if block.dtype == torch.int16:
        x = x * SCALE_I16
    # planes[c, j, w] = ext[r·w + j, c]: batch c = I/Q, channel j = leg
    planes = x.reshape(-1, r, 2).permute(2, 1, 0)
    if legs_im is None:
        y = F.conv1d(planes, legs_re[None])  # (2, 1, n_out)
        return y[:, 0].t().contiguous()
    y = F.conv1d(planes, torch.stack([legs_re, legs_im]))  # (2 [xr, xi], 2 [Lr, Li], n)
    y_re = y[0, 0] - y[1, 1]
    y_im = y[0, 1] + y[1, 0]
    return torch.stack([y_re, y_im], dim=-1)


def flat_decimate(
    x: torch.Tensor, legs_re: torch.Tensor, legs_im: torch.Tensor | None = None,
    tail: torch.Tensor | None = None,
) -> torch.Tensor:
    """K1 on a CUDA tensor, the plain twin on a CPU tensor (see module doc)."""
    if x.device.type == "cpu":
        return flat_decimate_reference(x, legs_re, legs_im, tail)
    if x.device.type != "cuda":
        raise ValueError(f"flat_decimate runs on cuda or cpu tensors, not {x.device}")
    tail, block, n_out = _operands(x, legs_re, legs_im, tail)
    pair = x.element_size() * 2
    if tail.data_ptr() % pair or block.data_ptr() % pair:
        raise ValueError("tail and block must start on an I/Q pair boundary")
    legs_re = legs_re.contiguous()
    legs_im = None if legs_im is None else legs_im.contiguous()
    r, t_leg = legs_re.shape
    i16 = int(x.dtype == torch.int16)
    lib = build.library()
    out = torch.empty((n_out, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.sdr_flat_decimate(
            i16, tail.data_ptr(), tail.shape[0], block.data_ptr(), block.shape[0],
            legs_re.data_ptr(), None if legs_im is None else legs_im.data_ptr(),
            r, t_leg, SCALE_I16 if i16 else 1.0,
            out.data_ptr(), n_out, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"flat_decimate launch failed: CUDA error {err} "
            f"({lib.sdr_cuda_error_string(err).decode()}) at r={r}, t_leg={t_leg}, "
            f"{smem_bytes(r, t_leg, bool(i16), legs_im is not None)} B of shared memory")
    flat_decimate.launches += 1
    return out


def blocks_per_sm(r: int, t_leg: int, i16: bool = True, complex_legs: bool = False) -> int:
    """K1's blocks resident on one SM of the current card for one variant
    (the CUDA occupancy query, after the kernel's shared-memory opt-in)."""
    n = build.library().sdr_flat_decimate_blocks_per_sm(int(i16), r, t_leg, int(complex_legs))
    if n < 0:
        raise RuntimeError(f"occupancy query failed at r={r}, t_leg={t_leg}: CUDA error {-n}")
    return n


def smem_bytes(r: int, t_leg: int, i16: bool = True, complex_legs: bool = False) -> int:
    """Dynamic shared memory of one K1 block of that variant, in bytes."""
    return build.library().sdr_flat_decimate_smem_bytes(int(i16), r, t_leg, int(complex_legs))


flat_decimate.launches = 0  # kernel launches since the last reset
