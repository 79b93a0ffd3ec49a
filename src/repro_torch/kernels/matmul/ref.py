"""Plain PyTorch versions of the tiled matmul and fused Schur-update kernels.

Upcast to f32, multiply, combine, then cast to ``out_dtype``: the
semantics the CUDA kernels must match, and what their wrappers run for a
tensor that lies on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["matmul_ref", "schur_update_ref"]


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
