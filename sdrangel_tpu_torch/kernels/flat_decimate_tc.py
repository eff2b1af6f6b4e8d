"""K1-TC: the flat ÷2^k decimator on the tensor cores — wrapper and plain
version.

`flat_decimate_tc` launches the CUDA kernel (`csrc/flat_decimate_tc.cu`, the
counterpart of the Pallas MXU kernel sdrangel_tpu/pallas/decimator.py:165)
for a tensor on the card and runs the plain version
`flat_decimate_tc_reference` for a tensor on the CPU; any other device
raises. There is no fallback: a failed build or launch on the card raises.

Contract (K1's i16 cen path, kernels/flat_decimate.py):
  x     (T, 2) int16 block, interleaved I/Q, scaled by 1/32768 as it is read
  tail  (r·(t_leg − 1), 2) int16, the carried raw tail; or tail=None and x
        is ext = [tail | block], (T + r·(t_leg − 1), 2)
  legs  (r, t_leg) float32 real legs, r = 2^k with 1 ≤ k ≤ 6, t_leg ≤ 64
  ->    (T/r, 2) float32, y[m] = Σ_j Σ_t legs[j, t] · ext[r·(m + t) + j]
        with ext = [tail | block]

Both forms compute Z = planes @ legs with planes[w, j] = ext[r·w + j], then
the skewed diagonal sum y[m] = Σ_t Z[m + t, t]. The kernel splits the
product into three TF32 passes with f32 fidelity (see the source note).
"""

from __future__ import annotations

import torch

from . import build

SCALE_I16 = 1.0 / 32768.0
MAX_TAPS = 64  # the kernel zero-pads t_leg to 64 taps (4 warps × 16)
RATIOS = (2, 4, 8, 16, 32, 64)


def _operands(x: torch.Tensor, legs: torch.Tensor, tail: torch.Tensor | None
              ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Validates the operands; returns (tail, block, number of outputs T/r).
    With tail=None, x is ext = [tail | block] and both are views of it."""
    if legs.dim() != 2 or legs.dtype != torch.float32:
        raise TypeError(f"legs must be (r, t_leg) float32, got {legs.dtype} {tuple(legs.shape)}")
    r, t_leg = legs.shape
    if r not in RATIOS or not 1 <= t_leg <= MAX_TAPS:
        raise ValueError(f"legs (r={r}, t_leg={t_leg}): r must be one of {RATIOS} "
                         f"and t_leg at most {MAX_TAPS}")
    n_tail = r * (t_leg - 1)
    for name, v in (("x", x), ("tail", tail)):
        if v is None:
            continue
        if v.dim() != 2 or v.shape[1] != 2:
            raise ValueError(f"{name} must be (N, 2) interleaved I/Q, got {tuple(v.shape)}")
        if v.dtype != torch.int16:
            raise TypeError(f"{name} must be int16 (the i16 cen path), got {v.dtype}")
        if v.device != legs.device:
            raise ValueError(f"legs on {legs.device}, {name} on {v.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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


def flat_decimate_tc_reference(x: torch.Tensor, legs: torch.Tensor,
                               tail: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version in the kernel's Z-form: planes @ legs, then the
    diagonal sum, in float32."""
    tail, block, n_out = _operands(x, legs, tail)
    ext = torch.cat([tail, block])
    r, t_leg = legs.shape
    w = ext.shape[0] // r
    planes = (ext.to(torch.float32) * SCALE_I16).reshape(w, r, 2).permute(2, 0, 1)
    z = torch.matmul(planes, legs).contiguous()  # (2, W, t_leg)
    # diag[c, m, t] = z[c, m + t, t]
    diag = z.as_strided((2, n_out, t_leg), (w * t_leg, t_leg, t_leg + 1))
    return diag.sum(-1).t().contiguous()


def flat_decimate_tc(x: torch.Tensor, legs: torch.Tensor,
                     tail: torch.Tensor | None = None) -> torch.Tensor:
    """K1-TC on a CUDA tensor, the plain version on a CPU tensor. x is the
    block with its carried tail in `tail`, or with tail=None ext = [tail |
    block] (read as two views, with no copy)."""
    if x.device.type == "cpu":
        return flat_decimate_tc_reference(x, legs, tail)
    if x.device.type != "cuda":
        raise ValueError(f"flat_decimate_tc runs on cuda or cpu tensors, not {x.device}")
    tail, block, n_out = _operands(x, legs, tail)
    if tail.data_ptr() % 4 or block.data_ptr() % 4:
        raise ValueError("tail and block must start on an I/Q pair boundary")
    legs = legs.contiguous()
    r, t_leg = legs.shape
    lib = build.library()
    out = torch.empty((n_out, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.sdr_flat_decimate_tc(
            tail.data_ptr(), tail.shape[0], block.data_ptr(), block.shape[0], legs.data_ptr(),
            r, t_leg, out.data_ptr(), n_out, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"flat_decimate_tc launch failed: CUDA error {err} "
            f"({lib.sdr_cuda_error_string(err).decode()}) at r={r}, t_leg={t_leg}, "
            f"{lib.sdr_flat_decimate_tc_smem_bytes(r)} B of shared memory")
    flat_decimate_tc.launches += 1
    return out


def blocks_per_sm(r: int) -> int:
    """K1-TC's blocks resident on one SM of the current card at ratio r
    (the CUDA occupancy query, after the kernel's shared-memory opt-in)."""
    n = build.library().sdr_flat_decimate_tc_blocks_per_sm(r)
    if n < 0:
        raise RuntimeError(f"occupancy query failed at r={r}: {n}")
    return n


flat_decimate_tc.launches = 0  # kernel launches since the last reset
