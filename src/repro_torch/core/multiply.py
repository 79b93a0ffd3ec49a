"""BlockMatrix multiply — the paper's dominant cost (§5.4) — and its engines.

Three engines:

  * ``einsum``   — one `torch.einsum` over the block grid, upcast to f32
                   and cast back: the plain baseline.
  * ``cuda``     — the kernel engine: a grid contraction runs as ONE launch
                   of the hand-written GEMM (`kernels/matmul`), and the
                   Schur updates of Algorithm 2 (`V = A21·III − A22`,
                   `C11 = I − III·C21`) fold the trailing subtract into the
                   same kernel's accumulator (`schur_update_blocks`). On a
                   CPU tensor the kernels' plain versions run instead.
  * ``strassen`` — Strassen's 7-multiply recursion over the grid
                   (`core/strassen.py`), whose classical leaves are GEMM
                   kernel launches; a Schur update that is one leaf fuses
                   its subtract into the leaf's launch.

The engine is chosen through a contextvar, as in the JAX package; PyTorch
runs eagerly, so there is no compiled program to key on it.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

import torch

from ..kernels.matmul import ops as mm_ops
from .blockmatrix import BlockMatrix, _bump
from .strassen import strassen_matmul_blocks, strassen_schur_update_blocks

__all__ = ["ENGINES", "multiply", "multiply_engine", "current_engine",
           "validate_engine", "multiply_blocks", "matmul_blocks_einsum",
           "matmul_blocks_cuda", "schur_update_blocks", "multiply_subtract",
           "subtract_multiply"]

ENGINES = ("einsum", "cuda", "strassen")

_ENGINE: contextvars.ContextVar[str] = contextvars.ContextVar(
    "repro_torch_multiply_engine", default="einsum")


def validate_engine(engine: str | None) -> str | None:
    """Raise a clear ValueError for an engine this package does not have.

    None (inherit the ambient engine) passes through.
    """
    if engine is not None and engine not in ENGINES:
        raise ValueError(f"unknown multiply engine {engine!r}; this package "
                         f"has {ENGINES}")
    return engine


@contextlib.contextmanager
def multiply_engine(name: str) -> Iterator[None]:
    """Select the multiply engine (one of `ENGINES`)."""
    validate_engine(name)
    token = _ENGINE.set(name)
    try:
        yield
    finally:
        _ENGINE.reset(token)


def current_engine() -> str:
    """The ambient multiply engine name ('einsum' unless overridden)."""
    return _ENGINE.get()


def matmul_blocks_einsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[i,j] = Σ_k A[i,k] @ B[k,j] over (bi,bk,bs,bs)×(bk,bj,bs,bs) grids,
    in f32, cast back to a's dtype."""
    out = torch.einsum("ikab,kjbc->ijac", a.float(), b.float())
    return out.to(a.dtype)


def matmul_blocks_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[i,j] = Σ_k A[i,k] @ B[k,j] as ONE launch of the GEMM kernel."""
    return mm_ops.grid_matmul(a, b)


def multiply_blocks(a: torch.Tensor, b: torch.Tensor,
                    engine: str | None = None) -> torch.Tensor:
    """Engine dispatch on raw block grids; engine=None reads the ambient
    `multiply_engine` context."""
    engine = validate_engine(engine) or _ENGINE.get()
    if engine == "cuda":
        return matmul_blocks_cuda(a, b)
    if engine == "strassen":
        return strassen_matmul_blocks(a, b)
    return matmul_blocks_einsum(a, b)


def schur_update_blocks(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                        negate_c: bool, engine: str | None = None
                        ) -> torch.Tensor:
    """Fused multiply+subtract on block grids: A·B − C (negate_c=True, the
    paper's `V = A21·III − A22`) or C − A·B (negate_c=False, `C11 = I − VII`).

    Under ``cuda`` the subtract folds into the GEMM kernel's f32
    accumulator: (α, β) = (1, −1) for V and (−1, 1) for C11. Under
    ``strassen`` the product runs the 7-multiply recursion, and the
    subtract folds into the leaf's launch when the whole product is one
    classical leaf. Under ``einsum`` it is multiply-then-subtract in the
    unfused order.
    """
    engine = validate_engine(engine) or _ENGINE.get()
    if engine == "strassen":
        return strassen_schur_update_blocks(c, a, b, negate_c=negate_c)
    if engine == "cuda":
        alpha, beta = (1.0, -1.0) if negate_c else (-1.0, 1.0)
        return mm_ops.grid_schur_update(c, a, b, alpha=alpha, beta=beta)
    prod = multiply_blocks(a, b, engine)
    return prod - c if negate_c else c - prod


def multiply(a: BlockMatrix, b: BlockMatrix) -> BlockMatrix:
    """The paper's `multiply` (§3.3): C = A · B on the block grid."""
    if a.grid != b.grid or a.block_size != b.block_size:
        raise ValueError(f"grid mismatch: {tuple(a.blocks.shape)} vs "
                         f"{tuple(b.blocks.shape)}")
    _bump("multiplies")
    _bump("block_gemms", a.grid ** 3)
    return BlockMatrix(multiply_blocks(a.blocks, b.blocks))


def _fused_op_counts(grid: int) -> None:
    # A fused Schur update is one multiply + one subtract of Algorithm 2:
    # the op-count oracle (6/2/1 per level) does not see the fusion.
    _bump("multiplies")
    _bump("block_gemms", grid ** 3)
    _bump("subtracts")


def _check_grids(*ms: BlockMatrix) -> None:
    if len({m.grid for m in ms}) != 1:
        raise ValueError("grid mismatch: "
                         + " vs ".join(str(tuple(m.blocks.shape)) for m in ms))


def multiply_subtract(a: BlockMatrix, b: BlockMatrix,
                      c: BlockMatrix) -> BlockMatrix:
    """A·B − C (the paper's `V = IV − A22` with IV = A21·III, fused)."""
    _check_grids(a, b, c)
    _fused_op_counts(a.grid)
    return BlockMatrix(schur_update_blocks(c.blocks, a.blocks, b.blocks,
                                           negate_c=True))


def subtract_multiply(c: BlockMatrix, a: BlockMatrix,
                      b: BlockMatrix) -> BlockMatrix:
    """C − A·B (the paper's `C11 = I − VII` with VII = III·C21, fused)."""
    _check_grids(a, b, c)
    _fused_op_counts(a.grid)
    return BlockMatrix(schur_update_blocks(c.blocks, a.blocks, b.blocks,
                                           negate_c=False))
