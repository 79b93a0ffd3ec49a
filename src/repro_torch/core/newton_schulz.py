"""Newton–Schulz refinement of an approximate inverse.

    X_{k+1} = X_k (2I − A X_k)

converges quadratically whenever ‖I − A X_0‖ < 1. Each sweep is two
BlockMatrix multiplies through the ambient multiply engine, so under
``cuda`` a sweep is two launches of the GEMM kernel over the whole grid.
The precision policies run it in f32 after a low-precision recursion.
"""

from __future__ import annotations

import torch

from .blockmatrix import BlockMatrix
from .multiply import multiply

__all__ = ["newton_schulz_polish", "residual_norm"]


def newton_schulz_polish(a: BlockMatrix, x0: BlockMatrix, *, sweeps: int = 2
                         ) -> BlockMatrix:
    """Refine x0 ≈ a⁻¹ with `sweeps` Newton–Schulz iterations."""
    two_i = BlockMatrix.identity(a.grid, a.block_size, a.dtype,
                                 a.device).scalar_mul(2.0)
    x = x0
    for _ in range(sweeps):
        ax = multiply(a, x)
        x = multiply(x, two_i.subtract(ax))
    return x


def residual_norm(a: BlockMatrix, x: BlockMatrix) -> torch.Tensor:
    """‖I − A·X‖_F / ‖I‖_F, a 0-d tensor on a's device."""
    ax = multiply(a, x)
    eye = BlockMatrix.identity(a.grid, a.block_size, a.dtype, a.device)
    r = eye.subtract(ax)
    return torch.linalg.norm(r.to_dense()) / torch.sqrt(
        torch.tensor(a.n, dtype=r.dtype, device=r.device))
