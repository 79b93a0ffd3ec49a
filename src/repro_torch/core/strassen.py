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
           "strassen_matmul_blocks", "strassen_schur_update_blocks",
           "strassen_matmul_dist", "strassen_schur_update_dist"]

STRASSEN_CUTOFF_ENV = "SPIN_STRASSEN_CUTOFF"

_Base = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def strassen_cutoff() -> int:
    """Operand dimension at/below which the recursion goes classical:
    `costmodel.STRASSEN_CUTOFF` (the constant the cost model prices with),
    or ``SPIN_STRASSEN_CUTOFF``, read on every call."""
    from .. import envconfig

    raw = envconfig.env_int(STRASSEN_CUTOFF_ENV)
    return STRASSEN_CUTOFF if raw is None else max(raw, 0)


# ---------------------------------------------------------------------------
# Mesh anchoring: every intermediate recorded in the spec ledger
# ---------------------------------------------------------------------------


@functools.cache
def _ledger():
    # Late: the parallel layer imports core.multiply, which imports this
    # module. Cached, since the host-bound recursion anchors every pass.
    from ..parallel import sharded_blockmatrix

    return sharded_blockmatrix


def _anchor(x, op: str):
    """Record a Strassen intermediate's layout in the spec ledger
    (`parallel.sharded_blockmatrix.record_specs`), where the JAX package
    constrains and records one. A plain tensor is off the mesh (spec
    None); a mesh-laid-out grid (`parallel.collectives.DistArray`) is laid
    out by `grid_spec` first, with the axis names resolved as the SUMMA
    engines resolve them. Outside a ledger a plain tensor costs one read."""
    sbm = _ledger()
    if isinstance(x, torch.Tensor):
        if sbm._LEDGER.get() is not None:
            sbm._record(op, "grid", x.shape, None, ("data", "model"), None)
        return x
    from ..parallel import collectives as col
    from .multiply import _mesh_names

    axes = _mesh_names(x.mesh)
    spec = col.grid_spec(x.shape[0], x.shape[1], x.mesh, axes)
    x = col.relayout(x, spec)
    sbm._record(op, "grid", x.shape, spec, axes, x.mesh)
    return x


class _TensorOps:
    """The recursion's data movement on plain tensors; `mark` records the
    grid variant's intermediates in the spec ledger."""

    mark = staticmethod(_anchor)

    @classmethod
    def pad(cls, x):
        g = x.shape[0]
        out = cls.mark(x.new_zeros((g + 1, g + 1) + tuple(x.shape[2:])),
                       "strassen_pad")
        out[:g, :g] = x
        return cls.mark(out, "strassen_pad")

    @classmethod
    def unpad(cls, x, g):
        return cls.mark(x[:g, :g], "strassen_unpad")

    @staticmethod
    def quads(x):
        h = x.shape[0] // 2
        return x[:h, :h], x[:h, h:], x[h:, :h], x[h:, h:]

    @classmethod
    def add(cls, x, y):
        return cls.mark(x + y, "strassen_add")

    @classmethod
    def sub(cls, x, y):
        return cls.mark(x - y, "strassen_add")

    @classmethod
    def assemble(cls, c11, c12, c21, c22):
        h = c11.shape[0]
        out = cls.mark(c11.new_empty((2 * h, 2 * h) + tuple(c11.shape[2:])),
                       "strassen_combine")
        out[:h, :h] = c11
        out[:h, h:] = c12
        out[h:, :h] = c21
        out[h:, h:] = c22
        return cls.mark(out, "strassen_combine")


class _DenseOps(_TensorOps):
    """The dense variant's movement: nothing recorded, as in the JAX
    package."""

    mark = staticmethod(lambda x, op: x)


class _MeshOps:
    """The same movement on grids laid out over a mesh: quadrants, sums
    and the combined output are laid out by `grid_spec` and recorded."""

    @staticmethod
    def _spec(x, rows):
        from ..parallel import collectives as col
        from .multiply import _mesh_names

        return col.grid_spec(rows, rows, x.mesh, _mesh_names(x.mesh))

    @classmethod
    def _mark_layout(cls, like, shape, op: str) -> None:
        # A buffer the JAX package anchors before filling it: the layout
        # is recorded; here the buffer is the output's own shards.
        from ..parallel import sharded_blockmatrix as sbm
        from .multiply import _mesh_names

        sbm._record(op, "grid", shape, cls._spec(like, shape[0]),
                    _mesh_names(like.mesh), like.mesh)

    @classmethod
    def pad(cls, x):
        from ..parallel import collectives as col

        g, bs = x.shape[0], x.shape[2]
        shape = (g + 1, g + 1, bs, bs)
        cls._mark_layout(x, shape, "strassen_pad")
        out = col.assemble([((0, 0, 0, 0), x)], shape, cls._spec(x, g + 1),
                           x.mesh, zero_fill=True)
        return _anchor(out, "strassen_pad")

    @classmethod
    def unpad(cls, x, g):
        from ..parallel import collectives as col

        bs = x.shape[2]
        out = col.take(x, ((0, g), (0, g), (0, bs), (0, bs)),
                       cls._spec(x, g))
        return _anchor(out, "strassen_unpad")

    @classmethod
    def quads(cls, x):
        from ..parallel import collectives as col

        h, bs = x.shape[0] // 2, x.shape[2]
        spec = cls._spec(x, h)
        return tuple(col.take(x, ((r, r + h), (c, c + h), (0, bs), (0, bs)),
                              spec)
                     for r, c in ((0, 0), (0, h), (h, 0), (h, h)))

    @staticmethod
    def add(x, y):
        from ..parallel import collectives as col

        return _anchor(col.zip_map(torch.add, x, col.relayout(y, x.spec)),
                       "strassen_add")

    @staticmethod
    def sub(x, y):
        from ..parallel import collectives as col

        return _anchor(col.zip_map(torch.sub, x, col.relayout(y, x.spec)),
                       "strassen_add")

    @classmethod
    def assemble(cls, c11, c12, c21, c22):
        from ..parallel import collectives as col

        h, bs = c11.shape[0], c11.shape[2]
        shape = (2 * h, 2 * h, bs, bs)
        cls._mark_layout(c11, shape, "strassen_combine")
        out = col.assemble([((0, 0, 0, 0), c11), ((0, h, 0, 0), c12),
                            ((h, 0, 0, 0), c21), ((h, h, 0, 0), c22)],
                           shape, cls._spec(c11, 2 * h), c11.mesh)
        return _anchor(out, "strassen_combine")


def _seven(a, b, rec, ops=_TensorOps):
    """The 7 products and the combine of one split, on quadrant views."""
    a11, a12, a21, a22 = ops.quads(a)
    b11, b12, b21, b22 = ops.quads(b)
    add, sub = ops.add, ops.sub
    m1 = rec(add(a11, a22), add(b11, b22))
    m2 = rec(add(a21, a22), b11)
    m3 = rec(a11, sub(b12, b22))
    m4 = rec(a22, sub(b21, b11))
    m5 = rec(add(a11, a12), b22)
    m6 = rec(sub(a21, a11), add(b11, b12))
    m7 = rec(sub(a12, a22), add(b21, b22))
    # 10 operand-side + 8 output-side elementwise passes a split level.
    _bump("strassen_adds", 18)
    return ops.assemble(add(sub(add(m1, m4), m5), m7), add(m3, m5),
                        add(m2, m4), add(add(sub(m1, m2), m3), m6))


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
    return _strassen_grid(a, b, cutoff, base or _default_base_blocks,
                          _TensorOps)


def _strassen_grid(a, b, cutoff, base, ops):
    if cutoff is None:
        cutoff = strassen_cutoff()
    g, bs = a.shape[0], a.shape[2]
    if g == 1 or g * bs <= cutoff:
        _bump("strassen_base_multiplies")
        if _TRACER.enabled:
            _TRACER.event("strassen.base", "strassen_level", grid=g,
                          block_size=bs, n=g * bs, op="classical_leaf")
        return base(a, b)
    if _TRACER.enabled:
        _TRACER.event("strassen.split", "strassen_level", grid=g,
                      block_size=bs, n=g * bs, cutoff=cutoff,
                      op="seven_multiply_split")
    rec = functools.partial(_strassen_grid, cutoff=cutoff, base=base,
                            ops=ops)
    if g % 2:
        return ops.unpad(rec(ops.pad(a), ops.pad(b)), g)
    return _seven(a, b, rec, ops)


def _base_dist(a, b):
    # A classical leaf on the mesh: the GEMM kernel through SUMMA (one
    # launch a shard), or whole once a device when the grid does not
    # divide the mesh.
    from .multiply import multiply_dist

    return multiply_dist(a, b, "cuda")


def strassen_matmul_dist(a, b, *, cutoff: int | None = None):
    """Strassen's recursion over grids laid out on a mesh
    (`parallel.collectives.DistArray`): quadrants, sums and the combine
    stay laid out by `grid_spec` and are recorded in the spec ledger, and
    each classical leaf is the `cuda` engine's SUMMA product."""
    if a.shape != b.shape or a.shape[0] != a.shape[1]:
        raise ValueError(f"expected matching square grids, got {a.shape} "
                         f"vs {b.shape}")
    return _strassen_grid(a, b, cutoff, _base_dist, _MeshOps)


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
    return _anchor(prod - c if negate_c else c - prod, "strassen_schur")


def strassen_schur_update_dist(c, a, b, *, negate_c: bool,
                               cutoff: int | None = None):
    """`strassen_schur_update_blocks` on grids laid out over a mesh: a
    one-leaf product is the `cuda` engine's fused update on C's shards."""
    from ..parallel import collectives as col
    from .multiply import schur_update_dist

    if cutoff is None:
        cutoff = strassen_cutoff()
    g, bs = a.shape[0], a.shape[2]
    if g == 1 or g * bs <= cutoff:
        _bump("strassen_base_multiplies")
        return schur_update_dist(c, a, b, negate_c=negate_c, engine="cuda")
    prod = strassen_matmul_dist(a, b, cutoff=cutoff)
    c = col.relayout(c, prod.spec)
    out = (col.zip_map(torch.sub, prod, c) if negate_c
           else col.zip_map(lambda p, c_: c_ - p, prod, c))
    return _anchor(out, "strassen_schur")


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
    return _seven(a, b, rec, _DenseOps)
