"""Plain PyTorch versions of the matmul and fused Schur-update kernels.

Upcast to f32, multiply, combine, then cast to ``out_dtype``: the
semantics the CUDA kernels must match, and what their wrappers run for a
tensor that lies on the CPU.

`tf32_split_ref` and `matmul_split_ref` spell out the arithmetic of the
tensor-core body's f32 route (csrc/matmul.cu): each operand split into
TF32 hi and lo parts, and three products of the parts.
"""

from __future__ import annotations

import torch

__all__ = ["matmul_ref", "schur_update_ref", "tf32_split_ref", "matmul_split_ref"]


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """f32-accumulating GEMM; the result in ``out_dtype`` (default a's)."""
    out = a.float() @ b.float()
    return out.to(out_dtype or a.dtype)


def schur_update_ref(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     alpha: float = 1.0, beta: float = -1.0,
                     out_dtype=None) -> torch.Tensor:
    """β·C + α·(A@B) in f32; the result in ``out_dtype`` (default C's)."""
    prod = a.float() @ b.float()
    out = beta * c.float() + alpha * prod
    return out.to(out_dtype or c.dtype)


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    # Round to 10 explicit mantissa bits, to nearest with ties away from
    # zero, on the f32 bit pattern (as `cvt.rna.tf32.f32`): add half a TF32
    # ulp to the magnitude bits and clear the 13 low bits. A carry into the
    # exponent is the right rounding; past the f32 range it gives inf. NaN
    # stays NaN.
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(x), x, rounded)


def tf32_split_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of an f32 tensor: hi = x rounded to TF32, lo = (x − hi)
    rounded to TF32. x − hi is exact in f32, so hi + lo is x within
    2⁻²²·|x| (and within 2⁻¹³⁷ below the normal range, where TF32 keeps
    fewer bits)."""
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_split_ref takes float32, got {x.dtype}")
    hi = _rna_tf32(x)
    return hi, _rna_tf32(x - hi)


def matmul_split_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B as the tensor-core body computes f32: lo·hi + hi·lo + hi·hi of
    the TF32 parts, the two small products first; f32 out."""
    a_hi, a_lo = tf32_split_ref(a.float())
    b_hi, b_lo = tf32_split_ref(b.float())
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
