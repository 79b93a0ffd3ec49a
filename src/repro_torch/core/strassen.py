"""Strassen's 7-multiply block multiply: the ``strassen`` engine.

Split both operands into quadrants, form 7 sub-products from quadrant sums
and differences, and combine them: 7 multiplies and 18 add/sub passes a
level instead of 8 multiplies.

    m1 = (A11 + A22)(B11 + B22)     C11 = m1 + m4 − m5 + m7
    m2 = (A21 + A22) B11            C12 = m3 + m5
    m3 = A11 (B12 − B22)            C21 = m2 + m4
    m4 = A22 (B21 − B11)            C22 = m1 − m2 + m3 + m6
    m5 = (A11 + A12) B22
    m6 = (A21 − A11)(B11 + B12)
    m7 = (A12 − A22)(B21 + B22)

Two variants share the recursion:

  * grid  — `strassen_matmul_blocks` on (g, g, bs, bs) block grids, the
            engine under `multiply_blocks`; an odd grid pads to g + 1 block
            rows and columns of zeros.
  * dense — `strassen_matmul` on (n, n) operands; odd n pads to n + 1.

The recursion goes classical when the operand dimension drops to
`strassen_cutoff()`, and hands the leaf to `kernels.strassen.ops`: one
launch of the GEMM kernel a leaf on the card. The add passes are plain
elementwise torch ops.

Op accounting: each split level adds 18 to `strassen_adds` and each
classical leaf 1 to `strassen_base_multiplies`, the counts that
`verify.expected_strassen_counts` predicts; the Algorithm-2 counters
(multiplies, subtracts, ...) do not see the engine. Under $SPIN_TRACE
the grid variant emits a "strassen.split" event a split and a
"strassen.base" event a classical leaf (kind "strassen_level").
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from ..obs.trace import TRACER as _TRACER
from .blockmatrix import _bump
from .costmodel import STRASSEN_CUTOFF

__all__ = ["STRASSEN_CUTOFF_ENV", "strassen_cutoff", "strassen_matmul",
           "strassen_matmul_blocks", "strassen_schur_update_blocks"]

STRASSEN_CUTOFF_ENV = "SPIN_STRASSEN_CUTOFF"

_Base = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def strassen_cutoff() -> int:
    """Operand dimension at/below which the recursion goes classical:
    `costmodel.STRASSEN_CUTOFF` (the constant the cost model prices with),
    or ``SPIN_STRASSEN_CUTOFF``, read on every call."""
    from .. import envconfig

    raw = envconfig.env_int(STRASSEN_CUTOFF_ENV)
    return STRASSEN_CUTOFF if raw is None else max(raw, 0)


def _pad_grid(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad an odd (g, g, ...) grid to (g+1, g+1, ...). The zero row and
    column meet the other operand's zero column and row, so slicing the
    product back to g×g is exact."""
    g = x.shape[0]
    out = x.new_zeros((g + 1, g + 1) + tuple(x.shape[2:]))
    out[:g, :g] = x
    return out


def _quads(x: torch.Tensor):
    h = x.shape[0] // 2
    return x[:h, :h], x[:h, h:], x[h:, :h], x[h:, h:]


def _assemble(c11, c12, c21, c22) -> torch.Tensor:
    h = c11.shape[0]
    out = c11.new_empty((2 * h, 2 * h) + tuple(c11.shape[2:]))
    out[:h, :h] = c11
    out[:h, h:] = c12
    out[h:, :h] = c21
    out[h:, h:] = c22
    return out


def _seven(a, b, rec):
    """The 7 products and the combine of one split, on quadrant views."""
    a11, a12, a21, a22 = _quads(a)
    b11, b12, b21, b22 = _quads(b)
    m1 = rec(a11 + a22, b11 + b22)
    m2 = rec(a21 + a22, b11)
    m3 = rec(a11, b12 - b22)
    m4 = rec(a22, b21 - b11)
    m5 = rec(a11 + a12, b22)
    m6 = rec(a21 - a11, b11 + b12)
    m7 = rec(a12 - a22, b21 + b22)
    # 10 operand-side + 8 output-side elementwise passes a split level.
    _bump("strassen_adds", 18)
    return _assemble(m1 + m4 - m5 + m7, m3 + m5, m2 + m4, m1 - m2 + m3 + m6)


# ---------------------------------------------------------------------------
# Grid variant (the engine under multiply_blocks)
# ---------------------------------------------------------------------------


def _default_base_blocks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    from ..kernels.strassen import ops as st_ops

    return st_ops.base_matmul_blocks(a, b)


def strassen_matmul_blocks(a: torch.Tensor, b: torch.Tensor, *,
                           cutoff: int | None = None,
                           base: _Base | None = None) -> torch.Tensor:
    """C = A·B over (g, g, bs, bs) block grids by Strassen's recursion.

    cutoff=None reads `strassen_cutoff()`; base=None sends each leaf to
    `kernels.strassen.ops.base_matmul_blocks`.
    """
    if a.ndim != 4 or a.shape != b.shape or a.shape[0] != a.shape[1]:
        raise ValueError(
            f"expected matching square (g, g, bs, bs) grids, got "
            f"{tuple(a.shape)} vs {tuple(b.shape)}")
    if cutoff is None:
        cutoff = strassen_cutoff()
    g, bs = a.shape[0], a.shape[2]
    if g == 1 or g * bs <= cutoff:
        _bump("strassen_base_multiplies")
        if _TRACER.enabled:
            _TRACER.event("strassen.base", "strassen_level", grid=g,
                          block_size=bs, n=g * bs, op="classical_leaf")
        return (base or _default_base_blocks)(a, b)
    if _TRACER.enabled:
        _TRACER.event("strassen.split", "strassen_level", grid=g,
                      block_size=bs, n=g * bs, cutoff=cutoff,
                      op="seven_multiply_split")
    if g % 2:
        out = strassen_matmul_blocks(_pad_grid(a), _pad_grid(b),
                                     cutoff=cutoff, base=base)
        return out[:g, :g]
    return _seven(a, b, functools.partial(strassen_matmul_blocks,
                                          cutoff=cutoff, base=base))


def strassen_schur_update_blocks(c: torch.Tensor, a: torch.Tensor,
                                 b: torch.Tensor, *, negate_c: bool,
                                 cutoff: int | None = None) -> torch.Tensor:
    """The Strassen route of the fused Schur updates: A·B − C or C − A·B.

    When the whole product is one classical leaf, the subtract folds into
    the leaf's GEMM launch (`base_schur_update`). Above the cutoff the
    product runs the recursion and the subtract follows it, in the order
    of the unfused path.
    """
    if cutoff is None:
        cutoff = strassen_cutoff()
    g, bs = a.shape[0], a.shape[2]
    if g == 1 or g * bs <= cutoff:
        from ..kernels.strassen import ops as st_ops

        _bump("strassen_base_multiplies")
        return st_ops.base_schur_update(c, a, b, negate_c=negate_c)
    prod = strassen_matmul_blocks(a, b, cutoff=cutoff)
    return prod - c if negate_c else c - prod


# ---------------------------------------------------------------------------
# Dense variant (raw (n, n) operands: the crossover measurement)
# ---------------------------------------------------------------------------


def _default_base_dense(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    from ..kernels.strassen import ops as st_ops

    return st_ops.base_matmul(a, b)


def strassen_matmul(a: torch.Tensor, b: torch.Tensor, *,
                    cutoff: int | None = None,
                    base: _Base | None = None) -> torch.Tensor:
    """C = A @ B on dense square (n, n) operands by Strassen's recursion.

    Odd n pads both operands to n + 1 with zeros and slices the product
    back: exact, since the padded row and column multiply to zero.
    """
    if a.ndim != 2 or a.shape != b.shape or a.shape[0] != a.shape[1]:
        raise ValueError(
            f"expected matching square (n, n) operands, got "
            f"{tuple(a.shape)} vs {tuple(b.shape)}")
    if cutoff is None:
        cutoff = strassen_cutoff()
    n = a.shape[0]
    if n <= max(cutoff, 1):
        _bump("strassen_base_multiplies")
        return (base or _default_base_dense)(a, b)
    rec = functools.partial(strassen_matmul, cutoff=cutoff, base=base)
    if n % 2:
        pad = (0, 1, 0, 1)
        return rec(torch.nn.functional.pad(a, pad),
                   torch.nn.functional.pad(b, pad))[:n, :n]
    return _seven(a, b, rec)
