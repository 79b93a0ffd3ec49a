"""Classical leaves of the Strassen recursion (`core/strassen.py`).

The recursion bottoms out in classical multiplies at or below its cutoff.
Every leaf is one launch of the hand-written GEMM (`kernels/matmul`): a
block-grid leaf is flattened to its dense (n, n) product and runs as B2
(`matmul_cuda`), and a fused Schur leaf folds the subtract into B1
(`schur_update_cuda`). On a CPU tensor the kernels' plain versions run,
as every wrapper of the port does. There is no other route: a leaf on a
CUDA tensor never falls back to `torch.matmul`.
"""

from __future__ import annotations

import torch

from ..matmul import ops as mm_ops

__all__ = ["base_matmul_blocks", "base_schur_update", "base_matmul"]


def base_matmul_blocks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One classical leaf multiply on (g, g, bs, bs) block grids: the grid
    flattened to ONE dense (n, n) GEMM, f32 accumulation, a's dtype out."""
    return mm_ops.grid_matmul(a, b)


def base_schur_update(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                      negate_c: bool) -> torch.Tensor:
    """One classical leaf Schur update, A·B − C (negate_c) or C − A·B, as
    one fused GEMM launch. In f32 on the CPU the plain version rounds as
    `base_matmul_blocks` followed by the subtract does, bit for bit."""
    alpha, beta = (1.0, -1.0) if negate_c else (-1.0, 1.0)
    return mm_ops.grid_schur_update(c, a, b, alpha=alpha, beta=beta)


def base_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One classical leaf multiply on dense (n, n) operands."""
    return mm_ops.matmul(a, b)
