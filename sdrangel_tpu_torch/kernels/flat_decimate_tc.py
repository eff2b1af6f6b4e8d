"""K1-TC: the flat ÷2^k decimator on the tensor cores — wrapper and plain
version.

`flat_decimate_tc` launches the CUDA kernel (`csrc/flat_decimate_tc.cu`, the
counterpart of the Pallas MXU kernel sdrangel_tpu/pallas/decimator.py:165)
for a tensor on the card and runs the plain version
`flat_decimate_tc_reference` for a tensor on the CPU; any other device
raises. There is no fallback: a failed build or launch on the card raises.

Contract (K1's i16 cen path, kernels/flat_decimate.py):
  ext   (N, 2) int16 — [carried raw tail | block], interleaved I/Q,
        N = T + r·(t_leg − 1), scaled by 1/32768 as it is read
  legs  (r, t_leg) float32 real legs, r = 2^k with 1 ≤ k ≤ 6, t_leg ≤ 64
  ->    (T/r, 2) float32, y[m] = Σ_j Σ_t legs[j, t] · ext[r·(m + t) + j]

Both forms compute Z = planes @ legs with planes[w, j] = ext[r·w + j], then
the skewed diagonal sum y[m] = Σ_t Z[m + t, t]. The kernel splits the
product into three TF32 passes with f32 fidelity (see the source note).
"""

from __future__ import annotations

import torch

from . import build

SCALE_I16 = 1.0 / 32768.0
MAX_TAPS = 64  # the kernel zero-pads t_leg to 64 taps (8 warps × 8)
RATIOS = (2, 4, 8, 16, 32, 64)


def _check(ext: torch.Tensor, legs: torch.Tensor) -> int:
    """Validates the operands; returns the number of outputs T/r."""
    if ext.dim() != 2 or ext.shape[1] != 2:
        raise ValueError(f"ext must be (N, 2) interleaved I/Q, got {tuple(ext.shape)}")
    if ext.dtype != torch.int16:
        raise TypeError(f"ext must be int16 (the i16 cen path), got {ext.dtype}")
    if legs.dim() != 2 or legs.dtype != torch.float32:
        raise TypeError(f"legs must be (r, t_leg) float32, got {legs.dtype} {tuple(legs.shape)}")
    r, t_leg = legs.shape
    if r not in RATIOS or not 1 <= t_leg <= MAX_TAPS:
        raise ValueError(f"legs (r={r}, t_leg={t_leg}): r must be one of {RATIOS} "
                         f"and t_leg at most {MAX_TAPS}")
    if legs.device != ext.device:
        raise ValueError(f"legs on {legs.device}, ext on {ext.device}")
    if not ext.is_contiguous():
        raise ValueError("ext must be contiguous")
    t = ext.shape[0] - r * (t_leg - 1)
    if t <= 0 or t % r:
        raise ValueError(
            f"ext length {ext.shape[0]} is not r·(t_leg−1) + a positive multiple "
            f"of r (r={r}, t_leg={t_leg})")
    return t // r


def flat_decimate_tc_reference(ext: torch.Tensor, legs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version in the kernel's Z-form: planes @ legs, then the
    diagonal sum, in float32."""
    n_out = _check(ext, legs)
    r, t_leg = legs.shape
    w = ext.shape[0] // r
    planes = (ext.to(torch.float32) * SCALE_I16).reshape(w, r, 2).permute(2, 0, 1)
    z = torch.matmul(planes, legs).contiguous()  # (2, W, t_leg)
    # diag[c, m, t] = z[c, m + t, t]
    diag = z.as_strided((2, n_out, t_leg), (w * t_leg, t_leg, t_leg + 1))
    return diag.sum(-1).t().contiguous()


def flat_decimate_tc(ext: torch.Tensor, legs: torch.Tensor) -> torch.Tensor:
    """K1-TC on a CUDA tensor, the plain version on a CPU tensor."""
    if ext.device.type == "cpu":
        return flat_decimate_tc_reference(ext, legs)
    if ext.device.type != "cuda":
        raise ValueError(f"flat_decimate_tc runs on cuda or cpu tensors, not {ext.device}")
    n_out = _check(ext, legs)
    if ext.data_ptr() % 4:
        raise ValueError("ext must start on an I/Q pair boundary (short2 loads)")
    legs = legs.contiguous()
    r, t_leg = legs.shape
    lib = build.library()
    out = torch.empty((n_out, 2), dtype=torch.float32, device=ext.device)
    with torch.cuda.device(ext.device):
        err = lib.sdr_flat_decimate_tc(
            ext.data_ptr(), ext.shape[0], legs.data_ptr(), r, t_leg, out.data_ptr(), n_out,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"flat_decimate_tc launch failed: CUDA error {err} "
            f"({lib.sdr_cuda_error_string(err).decode()}) at r={r}, t_leg={t_leg}, "
            f"{lib.sdr_flat_decimate_tc_smem_bytes(r)} B of shared memory")
    flat_decimate_tc.launches += 1
    return out


flat_decimate_tc.launches = 0  # kernel launches since the last reset
