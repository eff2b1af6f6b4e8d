"""K1: the flat ÷2^k polyphase decimator — wrapper and plain twin.

`flat_decimate` launches the CUDA kernel (`csrc/flat_decimate.cu`) for a
tensor on the card and runs the plain twin `flat_decimate_reference` for a
tensor on the CPU; any other device raises. There is no fallback: a failed
build or launch on the card raises.

Contract (the grid of the JAX `decimate_flat`, decimators.py:326-345; the
Pallas kernel's HALO convention is the same grid fed raw[HALO − r·(t_leg−1):]):
  ext   (N, 2) int16 or float32 — [carried tail | block], interleaved I/Q,
        N = T + r·(t_leg − 1); int16 is scaled by 1/32768 (i16 ingest)
  legs  (r, t_leg) float32 real legs; legs_im the imaginary part of
        complex legs (inf/sup placements) or None
  ->    (T/r, 2) float32, y[m] = Σ_j Σ_t legs[j, t] · ext[r·(m + t) + j]
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

SCALE_I16 = 1.0 / 32768.0


def _n_out(ext: torch.Tensor, legs_re: torch.Tensor) -> int:
    r, t_leg = legs_re.shape
    t = ext.shape[0] - r * (t_leg - 1)
    if t <= 0 or t % r:
        raise ValueError(
            f"ext length {ext.shape[0]} is not r·(t_leg−1) + a positive multiple "
            f"of r (r={r}, t_leg={t_leg})")
    return t // r


def _check(ext: torch.Tensor, legs_re: torch.Tensor, legs_im: torch.Tensor | None) -> None:
    if ext.dim() != 2 or ext.shape[1] != 2:
        raise ValueError(f"ext must be (N, 2) interleaved I/Q, got {tuple(ext.shape)}")
    if ext.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"ext must be int16 or float32, got {ext.dtype}")
    for name, legs in (("legs_re", legs_re), ("legs_im", legs_im)):
        if legs is None:
            continue
        if legs.dim() != 2 or legs.dtype != torch.float32:
            raise TypeError(f"{name} must be (r, t_leg) float32, got {legs.dtype} "
                            f"{tuple(legs.shape)}")
        if legs.shape != legs_re.shape or legs.device != ext.device:
            raise ValueError(f"{name} must match legs_re's shape and ext's device")
    if not ext.is_contiguous():
        raise ValueError("ext must be contiguous")


def flat_decimate_reference(
    ext: torch.Tensor, legs_re: torch.Tensor, legs_im: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain PyTorch twin of K1: the polyphase planes as conv1d channels."""
    _check(ext, legs_re, legs_im)
    r = legs_re.shape[0]
    _n_out(ext, legs_re)
    x = ext.to(torch.float32)
    if ext.dtype == torch.int16:
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
    ext: torch.Tensor, legs_re: torch.Tensor, legs_im: torch.Tensor | None = None
) -> torch.Tensor:
    """K1 on a CUDA tensor, the plain twin on a CPU tensor (see module doc)."""
    if ext.device.type == "cpu":
        return flat_decimate_reference(ext, legs_re, legs_im)
    if ext.device.type != "cuda":
        raise ValueError(f"flat_decimate runs on cuda or cpu tensors, not {ext.device}")
    _check(ext, legs_re, legs_im)
    if ext.data_ptr() % (ext.element_size() * 2):
        raise ValueError("ext must start on an I/Q pair boundary (short2/float2 loads)")
    legs_re = legs_re.contiguous()
    legs_im = None if legs_im is None else legs_im.contiguous()
    r, t_leg = legs_re.shape
    n_out = _n_out(ext, legs_re)
    lib = build.library()
    out = torch.empty((n_out, 2), dtype=torch.float32, device=ext.device)
    with torch.cuda.device(ext.device):
        err = lib.sdr_flat_decimate(
            int(ext.dtype == torch.int16), ext.data_ptr(), ext.shape[0],
            legs_re.data_ptr(), None if legs_im is None else legs_im.data_ptr(),
            r, t_leg, SCALE_I16 if ext.dtype == torch.int16 else 1.0,
            out.data_ptr(), n_out, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"flat_decimate launch failed: CUDA error {err} "
            f"({lib.sdr_cuda_error_string(err).decode()}) at r={r}, t_leg={t_leg}, "
            f"{lib.sdr_flat_decimate_smem_bytes(r, t_leg, int(legs_im is not None))} B "
            f"of shared memory")
    flat_decimate.launches += 1
    return out


flat_decimate.launches = 0  # kernel launches since the last reset
