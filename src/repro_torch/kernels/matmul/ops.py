"""Public GEMM entry points over dense operands and block grids.

The `grid_*` functions are the multiply engine's mechanism: they flatten a
(bi, bk, bs, bs) block grid into its dense equivalent and contract it with
ONE kernel launch, so the whole k-sum stays in the kernel's f32
accumulator. The flattening copies a strided grid once, O(n²) beside the
O(n³) product. `block_gemm` is the per-block form: one launch a block
product, the k-sum added in f32 outside the kernel.
"""

from __future__ import annotations

import torch

from .kernel import matmul_cuda, schur_update_cuda

__all__ = ["matmul", "schur_update", "grid_matmul", "grid_schur_update",
           "blocks_to_dense", "dense_to_blocks", "block_gemm"]


def _unit_column_stride(t: torch.Tensor) -> torch.Tensor:
    # The kernel takes any row stride but needs unit column stride; a
    # column-major operand (as torch.linalg's solvers return) is copied.
    return t if t.stride(-1) == 1 else t.contiguous()


def matmul(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """C = A @ B through the GEMM kernel (plain version on the CPU).

    out_dtype=torch.float32 keeps the f32 accumulator un-rounded out of
    low-precision operands.
    """
    return matmul_cuda(_unit_column_stride(a), _unit_column_stride(b),
                       out_dtype=out_dtype)


def schur_update(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                 alpha: float = 1.0, beta: float = -1.0,
                 out_dtype=None) -> torch.Tensor:
    """Fused β·C + α·(A@B) (see kernel.schur_update_cuda)."""
    c, a, b = (_unit_column_stride(t) for t in (c, a, b))
    return schur_update_cuda(c, a, b, alpha=alpha, beta=beta,
                             out_dtype=out_dtype)


def blocks_to_dense(blocks: torch.Tensor) -> torch.Tensor:
    """(bi, bj, bs, bs) block grid -> dense (bi*bs, bj*bs); copies only
    when the grid is not laid out densely already."""
    bi, bj, bs, _ = blocks.shape
    return blocks.permute(0, 2, 1, 3).reshape(bi * bs, bj * bs)


def dense_to_blocks(dense: torch.Tensor, bs: int) -> torch.Tensor:
    """Dense (bi*bs, bj*bs) -> (bi, bj, bs, bs) block grid (a view)."""
    m, n = dense.shape
    return dense.reshape(m // bs, bs, n // bs, bs).permute(0, 2, 1, 3)


def grid_matmul(a_blocks: torch.Tensor, b_blocks: torch.Tensor) -> torch.Tensor:
    """C[i,j] = Σ_k A[i,k]·B[k,j] over block grids, as ONE kernel launch.

    The result has the operands' dtype, like `matmul` with out_dtype=None.
    """
    bs = a_blocks.shape[2]
    out = matmul(blocks_to_dense(a_blocks), blocks_to_dense(b_blocks))
    return dense_to_blocks(out, bs)


def grid_schur_update(c_blocks: torch.Tensor, a_blocks: torch.Tensor,
                      b_blocks: torch.Tensor, *, alpha: float = 1.0,
                      beta: float = -1.0, out_dtype=None) -> torch.Tensor:
    """Fused β·C + α·(A@B) on (b, b, bs, bs) block grids, one kernel."""
    bs = c_blocks.shape[2]
    out = schur_update(blocks_to_dense(c_blocks), blocks_to_dense(a_blocks),
                       blocks_to_dense(b_blocks), alpha=alpha, beta=beta,
                       out_dtype=out_dtype)
    return dense_to_blocks(out, bs)


def block_gemm(a_blocks: torch.Tensor, b_blocks: torch.Tensor) -> torch.Tensor:
    """C[i,j] = Σ_k A[i,k]·B[k,j] with one GEMM launch a block product.

    a_blocks: (bi, bk, bs, bs); b_blocks: (bk, bj, bs, bs). Each product
    leaves the kernel in f32 and the k-sum stays in f32, whatever the
    operands' dtype; the result has a's dtype. `grid_matmul` is the
    one-launch form the multiply engine uses.
    """
    bi, bk, bs, _ = a_blocks.shape
    bj = b_blocks.shape[1]
    out = torch.empty((bi, bj, bs, bs), dtype=a_blocks.dtype,
                      device=a_blocks.device)
    for i in range(bi):
        for j in range(bj):
            acc = torch.zeros((bs, bs), dtype=torch.float32,
                              device=a_blocks.device)
            for k in range(bk):
                acc += matmul(a_blocks[i, k], b_blocks[k, j],
                              out_dtype=torch.float32)
            out[i, j] = acc
    return out
