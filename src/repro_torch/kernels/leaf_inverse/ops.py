"""Public entry points of the leaf kernels: Gauss-Jordan inverses and the
blocked triangular solve."""

from __future__ import annotations

import torch

from .kernel import (blocked_leaf_inverse_cuda, leaf_inverse_cuda,
                     triangular_solve_cuda)

__all__ = ["leaf_inverse", "batched_leaf_inverse", "blocked_leaf_inverse",
           "batched_blocked_leaf_inverse", "triangular_solve"]


def leaf_inverse(block: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Invert one (bs, bs) block (SPIN's Algorithm-2 leaf, scalar GJ).

    out_dtype=torch.float32 keeps the f32 sweep un-rounded on the final
    write even for low-precision blocks.
    """
    return leaf_inverse_cuda(block.contiguous()[None], out_dtype=out_dtype)[0]


def batched_leaf_inverse(blocks: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Invert (batch, bs, bs) blocks, one kernel block per matrix."""
    return leaf_inverse_cuda(blocks.contiguous(), out_dtype=out_dtype)


def blocked_leaf_inverse(block: torch.Tensor, panel: int | None = None,
                         out_dtype=None) -> torch.Tensor:
    """Invert one (bs, bs) block with the blocked (rank-t update) GJ sweep."""
    return blocked_leaf_inverse_cuda(block.contiguous()[None], panel=panel,
                                     out_dtype=out_dtype)[0]


def batched_blocked_leaf_inverse(blocks: torch.Tensor, panel: int | None = None,
                                 out_dtype=None) -> torch.Tensor:
    """Blocked-GJ inverse of (batch, bs, bs) blocks."""
    return blocked_leaf_inverse_cuda(blocks.contiguous(), panel=panel,
                                     out_dtype=out_dtype)


def triangular_solve(t: torch.Tensor, b: torch.Tensor, *, lower: bool = True,
                     unit_diagonal: bool = False,
                     panel: int | None = None) -> torch.Tensor:
    """Solve T X = B for one (bs, bs) triangular T and (bs, k) B."""
    return triangular_solve_cuda(t[None], b.contiguous()[None], panel,
                                 lower=lower, unit_diagonal=unit_diagonal)[0]
