"""BlockMatrix multiply — the paper's dominant cost (§5.4) — and its engines.

Five engines:

  * ``einsum``    — one `torch.einsum` over the block grid, upcast to f32
                    and cast back: the plain baseline.
  * ``allgather`` — SUMMA over the ambient mesh (`launch.mesh`): gather
                    A's row panel along `model` and B's column panel along
                    `data`, then one local einsum a shard.
  * ``ring``      — SUMMA with the B-panel gather unrolled into a ring
                    along `data`: each panel copy is issued on a side
                    stream before the local einsum it overlaps.
  * ``cuda``      — the kernel engine: a grid contraction runs as ONE launch
                    of the hand-written GEMM (`kernels/matmul`), and the
                    Schur updates of Algorithm 2 (`V = A21·III − A22`,
                    `C11 = I − III·C21`) fold the trailing subtract into the
                    same kernel's accumulator (`schur_update_blocks`). On a
                    mesh the SUMMA gathers stay and each shard's product is
                    one launch. On a CPU tensor the kernels' plain versions
                    run instead.
  * ``strassen``  — Strassen's 7-multiply recursion over the grid
                    (`core/strassen.py`), whose classical leaves are GEMM
                    kernel launches; a Schur update that is one leaf fuses
                    its subtract into the leaf's launch.

The engine is chosen through a contextvar, as in the JAX package; PyTorch
runs eagerly, so there is no compiled program to key on it.

Grid-to-mesh contract of the mesh engines (`multiply_dist`):
    A grid (i, k): i over 'data', k over 'model'
    B grid (k, j): k over 'data', j over 'model'
    C grid (i, j): i over 'data', j over 'model'
A product whose grids do not divide the mesh runs whole, once per distinct
device (`_mesh_axes_for`). Off the mesh `allgather` and `ring` are the
einsum product. A plain tensor multiplied under an ambient mesh by
`allgather`, `ring` or `cuda` is laid out on the mesh, multiplied there
and gathered back.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

import torch

from ..kernels.matmul import ops as mm_ops
from ..launch.mesh import current_mesh
from .blockmatrix import BlockMatrix, _bump
from .strassen import strassen_matmul_blocks, strassen_schur_update_blocks

__all__ = ["ENGINES", "MESH_ENGINES", "multiply", "multiply_engine",
           "current_engine", "validate_engine", "multiply_blocks",
           "matmul_blocks_einsum", "matmul_blocks_cuda", "schur_update_blocks",
           "multiply_dist", "schur_update_dist", "multiply_subtract",
           "subtract_multiply"]

ENGINES = ("einsum", "cuda", "strassen", "allgather", "ring")

# The engines whose products move data over an ambient mesh (SUMMA
# gathers, the ring, or Strassen's re-laid-out intermediates); off the
# mesh allgather and ring are the einsum product.
MESH_ENGINES = ("allgather", "ring", "cuda", "strassen")

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


def _local_product(engine: str):
    return matmul_blocks_cuda if engine == "cuda" else matmul_blocks_einsum


def _mesh_names(mesh) -> tuple[str, str]:
    """The (data, model) axis names of a mesh: "data" / "model" where it
    has them, else its first / last axis."""
    names = list(mesh.shape)
    return ("data" if "data" in names else names[0],
            "model" if "model" in names else names[-1])


def _mesh_axes_for(mesh, *grids) -> tuple[str, str] | None:
    """(data_axis, model_axis) when every (rows, cols) grid divides the mesh.

    Deep recursion levels shrink the grid below the mesh; those products
    run whole (once per distinct device) instead of through SUMMA. Axis
    names prefer "data" / "model", else the mesh's first / last axis.
    """
    if mesh is None or not mesh.axes:
        return None
    data_axis, model_axis = _mesh_names(mesh)
    for rows, cols in grids:
        if rows % mesh.shape[data_axis] or cols % mesh.shape[model_axis]:
            return None
    return data_axis, model_axis


def multiply_dist(a, b, engine: str | None = None,
                  axes: tuple[str, str] = ("data", "model")):
    """Engine dispatch on block grids laid out over a mesh
    (`parallel.collectives.DistArray`); the result is a DistArray.

    ``allgather`` and ``einsum`` run SUMMA with a local einsum, ``cuda``
    SUMMA with one GEMM-kernel launch a shard, ``ring`` the ring. A product
    whose grids do not divide the mesh runs whole once per distinct device
    and is laid out by `grid_spec` for `axes`.
    """
    from ..parallel import collectives as col

    engine = validate_engine(engine) or _ENGINE.get()
    mesh = a.mesh
    if not mesh.axes:                     # one shard: the plain product
        plain = (strassen_matmul_blocks if engine == "strassen"
                 else _local_product(engine))
        return col.once_per_device(plain, [a, b], (None,) * 4, mesh)
    if engine == "strassen":
        from .strassen import strassen_matmul_dist

        return strassen_matmul_dist(a, b)
    mesh_axes = _mesh_axes_for(mesh, a.shape[:2], b.shape[:2])
    local = _local_product(engine)
    if mesh_axes is None:
        spec = col.grid_spec(a.shape[0], b.shape[1], mesh, axes)
        return col.once_per_device(local, [a, b], spec, mesh,
                                   shape=(a.shape[0], b.shape[1]) + a.shape[2:])
    if engine == "ring":
        return col.ring(a, b, mesh_axes, matmul_blocks_einsum)
    return col.summa(a, b, mesh_axes, local)


def schur_update_dist(c, a, b, *, negate_c: bool, engine: str | None = None,
                      axes: tuple[str, str] = ("data", "model")):
    """`schur_update_blocks` on mesh-laid-out grids. Under ``cuda`` each
    shard runs the fused GEMM kernel on C's own shard after the SUMMA
    gathers; the other engines multiply, then subtract shard by shard in
    the unfused order."""
    from ..parallel import collectives as col

    engine = validate_engine(engine) or _ENGINE.get()
    mesh = a.mesh
    if not mesh.axes:                     # one shard: the plain update
        return col.once_per_device(
            lambda c_, a_, b_: _plain_schur_update(c_, a_, b_, negate_c,
                                                   engine),
            [c, a, b], (None,) * 4, mesh)
    if engine == "strassen":
        from .strassen import strassen_schur_update_dist

        return strassen_schur_update_dist(c, a, b, negate_c=negate_c)
    if engine == "cuda":
        alpha, beta = (1.0, -1.0) if negate_c else (-1.0, 1.0)

        def fused(c_, a_, b_):
            return mm_ops.grid_schur_update(c_, a_, b_, alpha=alpha,
                                            beta=beta)

        mesh_axes = _mesh_axes_for(mesh, a.shape[:2], b.shape[:2],
                                   c.shape[:2])
        if mesh_axes is None:
            return col.once_per_device(fused, [c, a, b], c.spec, mesh, shape=c.shape)
        return col.summa(a, b, mesh_axes, fused, c=c)
    prod = multiply_dist(a, b, engine, axes)
    c = col.relayout(c, prod.spec)
    if negate_c:
        return col.zip_map(torch.sub, prod, c)
    return col.zip_map(lambda p, c_: c_ - p, prod, c)


def _plain_schur_update(c, a, b, negate_c: bool, engine: str):
    # `schur_update_blocks` without an ambient mesh: one shard's update.
    if engine == "strassen":
        return strassen_schur_update_blocks(c, a, b, negate_c=negate_c)
    if engine == "cuda":
        alpha, beta = (1.0, -1.0) if negate_c else (-1.0, 1.0)
        return mm_ops.grid_schur_update(c, a, b, alpha=alpha, beta=beta)
    prod = matmul_blocks_einsum(a, b)
    return prod - c if negate_c else c - prod


def _on_mesh(engine: str, *grids: torch.Tensor):
    """(mesh, axis names) when a plain-tensor product under `engine` runs
    on the ambient mesh, else None: the SUMMA engines when the grids
    divide the mesh, Strassen on any mesh (its intermediates are laid out
    by the divisibility rule)."""
    if engine not in MESH_ENGINES:
        return None
    mesh = current_mesh()
    if engine == "strassen":
        return None if mesh is None or not mesh.axes else (mesh,
                                                           _mesh_names(mesh))
    axes = _mesh_axes_for(mesh, *(tuple(g.shape[:2]) for g in grids))
    return None if axes is None else (mesh, axes)


def _place(t: torch.Tensor, mesh, axes):
    from ..parallel import collectives as col

    return col.distribute(t, col.grid_spec(t.shape[0], t.shape[1], mesh,
                                           axes), mesh)


def multiply_blocks(a: torch.Tensor, b: torch.Tensor,
                    engine: str | None = None) -> torch.Tensor:
    """Engine dispatch on raw block grids; engine=None reads the ambient
    `multiply_engine` context. Under an ambient mesh the mesh engines lay
    the operands out on it, multiply there and gather the product back."""
    engine = validate_engine(engine) or _ENGINE.get()
    if engine == "einsum":
        return matmul_blocks_einsum(a, b)
    placed = _on_mesh(engine, a, b)
    if placed is None:
        return (strassen_matmul_blocks(a, b) if engine == "strassen"
                else _local_product(engine)(a, b))
    from ..parallel import collectives as col

    mesh, axes = placed
    out = multiply_dist(_place(a, mesh, axes), _place(b, mesh, axes),
                        engine, axes)
    return col.gather(out, a.device)


def schur_update_blocks(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                        negate_c: bool, engine: str | None = None
                        ) -> torch.Tensor:
    """Fused multiply+subtract on block grids: A·B − C (negate_c=True, the
    paper's `V = A21·III − A22`) or C − A·B (negate_c=False, `C11 = I − VII`).

    Under ``cuda`` the subtract folds into the GEMM kernel's f32
    accumulator: (α, β) = (1, −1) for V and (−1, 1) for C11, on each
    shard after the SUMMA gathers under an ambient mesh. Under
    ``strassen`` the product runs the 7-multiply recursion, and the
    subtract folds into the leaf's launch when the whole product is one
    classical leaf. Under ``einsum``, ``allgather`` and ``ring`` it is
    multiply-then-subtract in the unfused order.
    """
    engine = validate_engine(engine) or _ENGINE.get()
    if engine in ("cuda", "strassen"):
        placed = _on_mesh(engine, a, b, c)
        if placed is None:
            return _plain_schur_update(c, a, b, negate_c, engine)
        from ..parallel import collectives as col

        mesh, axes = placed
        out = schur_update_dist(*(_place(t, mesh, axes) for t in (c, a, b)),
                                negate_c=negate_c, engine=engine, axes=axes)
        return col.gather(out, c.device)
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
