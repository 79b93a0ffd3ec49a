"""The comparison baseline: block-recursive LU inversion (Liu et al. [10]).

The same algorithm as the JAX package's `core/lu_inverse.py`, on the same
BlockMatrix primitives as SPIN, so the two share every multiply (and so
the GEMM kernel under engine="cuda"):

    leaf: L, U = lu(A);  Linv = tri_inv(L);  Uinv = tri_inv(U)
    else: L11,U11,L11i,U11i = rec(A11)
          U12 = L11i · A12;  L21 = A21 · U11i;  S = A22 − L21 · U12
          L22,U22,L22i,U22i = rec(S)
          Linv21 = −L22i · (L21 · L11i);  Uinv12 = −U11i · (U12 · U22i)
    top:  A^{-1} = Uinv · Linv, five half-size multiplies.

The leaf LU is unpivoted (valid for SPD and diagonally dominant blocks),
one `torch.linalg.lu_factor_ex(pivot=False)` call on the card and a plain
loop on the CPU: the JAX package has no kernel there, and runs its leaf as
one `fori_loop` inside its jitted program.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .blockmatrix import BlockMatrix, _bump
from .multiply import multiply, multiply_engine, validate_engine

__all__ = ["lu_inverse", "lu_inverse_dense", "block_lu"]


class _LU(NamedTuple):
    l: BlockMatrix
    u: BlockMatrix
    linv: BlockMatrix
    uinv: BlockMatrix


def _local_lu_plain(block: torch.Tensor) -> torch.Tensor:
    """Unpivoted dense LU of one block, swept in f32 one column a step:
    the compact factor, multipliers below the diagonal. The plain version
    of the leaf, and its CPU path."""
    n = block.shape[0]
    a = block.float().clone()
    for k in range(n - 1):
        a[k + 1:, k] /= a[k, k]
        a[k + 1:, k + 1:].addr_(a[k + 1:, k], a[k, k + 1:], alpha=-1.0)
    return a


def _local_lu(block: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Unpivoted dense LU of one block in f32, as (L, U) in the block's
    dtype. On the card one `torch.linalg.lu_factor_ex(pivot=False)` call
    (unpivoted LU exists on CUDA only); on the CPU the plain loop."""
    if block.device.type == "cuda":
        a = torch.linalg.lu_factor_ex(block.float(), pivot=False)[0]
    else:
        a = _local_lu_plain(block)
    eye = torch.eye(block.shape[0], dtype=a.dtype, device=a.device)
    return (torch.tril(a, -1) + eye).to(block.dtype), torch.triu(a).to(block.dtype)


def _local_tri_inv(block: torch.Tensor, lower: bool) -> torch.Tensor:
    eye = torch.eye(block.shape[0], dtype=torch.float32, device=block.device)
    inv = torch.linalg.solve_triangular(block.float(), eye, upper=not lower)
    return inv.to(block.dtype)


def _leaf(a: BlockMatrix) -> _LU:
    # 2 LU-class + 4 tri-inv + 3 multiply-class local O(bs³) ops: the "9x"
    # leaf work the paper books for the LU baseline (Table 1 row 1).
    _bump("leaf_lu")
    l, u = _local_lu(a.blocks[0, 0])
    one = lambda x: BlockMatrix(x[None, None])  # noqa: E731
    return _LU(one(l), one(u), one(_local_tri_inv(l, lower=True)),
               one(_local_tri_inv(u, lower=False)))


def block_lu(a: BlockMatrix) -> _LU:
    b = a.grid
    if b & (b - 1):
        raise ValueError(f"grid must be a power of two, got {b}")
    if b == 1:
        return _leaf(a)

    a11, a12, a21, a22 = a.split()
    f11 = block_lu(a11)
    u12 = multiply(f11.linv, a12)
    l21 = multiply(a21, f11.uinv)
    s = a22.subtract(multiply(l21, u12))
    f22 = block_lu(s)

    h = b // 2
    zero = BlockMatrix.zeros(h, a.block_size, a.dtype, a.device)
    l = BlockMatrix.arrange(f11.l, zero, l21, f22.l)
    u = BlockMatrix.arrange(f11.u, u12, zero, f22.u)
    linv21 = multiply(f22.linv, multiply(l21, f11.linv)).neg()
    uinv12 = multiply(f11.uinv, multiply(u12, f22.uinv)).neg()
    linv = BlockMatrix.arrange(f11.linv, zero, linv21, f22.linv)
    uinv = BlockMatrix.arrange(f11.uinv, uinv12, zero, f22.uinv)
    return _LU(l, u, linv, uinv)


def _triangular_product(uinv: BlockMatrix, linv: BlockMatrix) -> BlockMatrix:
    """A^{-1} = U^{-1} L^{-1} via 5 half-size multiplies (vs 8 naive)."""
    if uinv.grid == 1:
        return multiply(uinv, linv)
    u11, u12, _, u22 = uinv.split()
    l11, _, l21, l22 = linv.split()
    c11 = multiply(u11, l11).add(multiply(u12, l21))
    c12 = multiply(u12, l22)
    c21 = multiply(u22, l21)
    c22 = multiply(u22, l22)
    return BlockMatrix.arrange(c11, c12, c21, c22)


def lu_inverse(a: BlockMatrix) -> BlockMatrix:
    """Block LU-based inversion (the paper's comparison baseline)."""
    f = block_lu(a)
    return _triangular_product(f.uinv, f.linv)


def lu_inverse_dense(dense, block_size: int, *, engine: str | None = None,
                     device: str | torch.device = DEFAULT_DEVICE
                     ) -> torch.Tensor:
    """Dense (n, n) -> dense (n, n) inverse via block LU, on `device`."""
    validate_engine(engine)
    dev = resolve_device(device)
    dense = torch.as_tensor(dense).to(dev)
    ctx = multiply_engine(engine) if engine else contextlib.nullcontext()
    with ctx:
        return lu_inverse(BlockMatrix.from_dense(dense, block_size)).to_dense()
