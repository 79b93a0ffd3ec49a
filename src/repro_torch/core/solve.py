"""Multi-RHS solve on the SPIN recursion, without forming A⁻¹.

`spin_solve` answers what users of ridge regression and the normal
equations call: given SPD `A` and a block of right-hand sides `B`, produce
`X = A⁻¹B` without materializing `A⁻¹`. It reuses the recursion's quadrant
products (paper Algorithm 2's I/III/V names) in their inverse-free Schur
form:

    [A11 A12] [X1]   [B1]      III = A11⁻¹ A12   (recursive solve)
    [A21 A22] [X2] = [B2]      Y1  = A11⁻¹ B1    (same recursive call:
                                                  the B1 columns ride along)
    V  = A21·III − A22         (= −Schur complement, the paper's V)
    X2 = V⁻¹ (A21·Y1 − B2)     (recursive solve on V)
    X1 = Y1 − III·X2

Per level: 2 recursive solves and 3 block-times-panel products, no
multiply of two block matrices and no arrange. Under the ``cuda`` engine
the A21 products run in the GEMM kernel; under ``leaf_solver="cuda"`` each
leaf factorizes with LU and runs both substitution sweeps in the
triangular-solve kernel.

`spin_inverse_batched` inverts a (batch, n, n) stack, one
`spin_inverse_dense` call a matrix.

Under a low-precision policy (``precision="bf16"``) the solve runs at the
policy's compute dtype and returns X at b's dtype; the batched inverse
runs at the compute dtype and returns the policy's store dtype. Neither
polishes, as in the JAX package.

`sketched_approx_inverse` is the degraded-mode answer: a servable
approximate inverse with a reported residual, from a power-iteration seed
and Newton–Schulz sweeps, before (or without) the full recursion.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels.leaf_inverse import ops as tri_ops
from ..kernels.matmul import ops as mm_ops
from .blockmatrix import BlockMatrix, _bump
from .multiply import current_engine, multiply_engine, validate_engine
from .newton_schulz import newton_schulz_polish
from .precision import (resolve_precision, resolve_with_legacy_kwarg,
                        torch_dtype)
from .spin import LEAF_SOLVERS, _explicit, _policy_active, spin_inverse_dense

__all__ = ["spin_solve", "spin_solve_dense", "spin_solve_sharded",
           "spin_inverse_batched",
           "solve_grid_for", "SketchedInverse", "sketched_approx_inverse"]


def solve_grid_for(n: int, max_grid: int = 8, min_block: int = 64) -> int:
    """Largest power-of-two grid ≤ max_grid dividing n with blocks ≥ min_block."""
    g = 1
    while (g * 2 <= max_grid and n % (g * 2) == 0
           and n // (g * 2) >= min_block):
        g *= 2
    return g


def _apply_blocks(a: BlockMatrix, x: torch.Tensor) -> torch.Tensor:
    """A·X for a BlockMatrix A and a dense (n, k) panel X, summed in f32 and
    returned in x's dtype. Under the ``cuda`` engine it is one launch of
    the GEMM kernel over A's dense view."""
    _bump("solve_applies")
    return _apply_blocks_raw(a.blocks, x)


def _apply_blocks_raw(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`_apply_blocks` on a (b_r, b_c, bs, bs) grid, booking nothing: the
    sharded solve runs it on each row shard's block rows."""
    if current_engine() == "cuda":
        dense = mm_ops.blocks_to_dense(blocks)
        common = torch.promote_types(dense.dtype, x.dtype)
        out = mm_ops.matmul(dense.to(common), x.to(common),
                            out_dtype=torch.float32)
        return out.to(x.dtype)
    br, bc, bs, _ = blocks.shape
    xb = x.reshape(bc, bs, x.shape[-1])
    out = torch.einsum("ijab,jbk->iak", blocks.float(), xb.float())
    return out.reshape(br * bs, x.shape[-1]).to(x.dtype)


def _lu_permutation(lu: torch.Tensor, pivots: torch.Tensor) -> torch.Tensor:
    # LAPACK's pivots are sequential 1-based row swaps; P from lu_unpack has
    # one 1 a column, in the row that row i of L·U came from. Computed on
    # the device: no host loop over the pivots.
    p = torch.lu_unpack(lu, pivots, unpack_data=False)[0]
    return p.argmax(dim=0)


def _leaf_solve(block: torch.Tensor, rhs: torch.Tensor, solver: str) -> torch.Tensor:
    """Solve the grid == 1 system. The leaf solvers are those of the
    inversion, by name: `linalg` and `cuda` (LU, then the triangular-solve
    kernel twice) solve without an inverse; the others apply their leaf
    inverse to the right-hand side."""
    _bump("leaf_solves")
    f32 = block.float()
    r32 = rhs.float()
    if solver == "linalg":
        return torch.linalg.solve(f32, r32).to(rhs.dtype)
    if solver == "cuda":
        lu, pivots, _ = torch.linalg.lu_factor_ex(f32)
        y = tri_ops.triangular_solve(lu, r32[_lu_permutation(lu, pivots)],
                                     lower=True, unit_diagonal=True)
        return tri_ops.triangular_solve(lu, y, lower=False).to(rhs.dtype)
    inv = LEAF_SOLVERS[solver](block)
    return (inv.float() @ r32).to(rhs.dtype)


def _solve(a: BlockMatrix, b: torch.Tensor, leaf_solver: str) -> torch.Tensor:
    if a.grid == 1:
        return _leaf_solve(a.blocks[0, 0], b, leaf_solver)

    bs = a.block_size
    a11, a12, a21, a22 = a.split()
    half = a11.n
    b1, b2 = b[:half], b[half:]

    # One recursive solve covers both III (= A11⁻¹A12) and Y1 (= A11⁻¹B1):
    # the B1 columns ride along as extra right-hand sides.
    z = _solve(a11, torch.cat([a12.to_dense(), b1], dim=1), leaf_solver)
    iii, y1 = z[:, :half], z[:, half:]

    v = _apply_blocks(a21, iii) - a22.to_dense()          # −Schur complement
    _bump("subtracts")
    rhs2 = _apply_blocks(a21, y1) - b2
    _bump("subtracts")
    x2 = _solve(BlockMatrix.from_dense(v, bs), rhs2, leaf_solver)

    _bump("solve_applies")                                # III·X2 panel GEMM
    x1 = y1 - torch.matmul(iii.float(), x2.float()).to(y1.dtype)
    _bump("subtracts")
    return torch.cat([x1, x2], dim=0)


def spin_solve(a: BlockMatrix, b: torch.Tensor, *,
               leaf_solver: str = "linalg", auto: bool = False,
               precision=None) -> torch.Tensor:
    """Solve A X = B via the inverse-free SPIN recursion, on the device A's
    blocks lie on, with the ambient multiply engine.

    a: BlockMatrix with a power-of-two grid (SPD or with invertible
    leading blocks, the paper's class). b: (n, k) or (n,). Returns X with
    b's shape and dtype. auto=True asks the planner for the leaf solver
    (the grid is fixed by `a`). precision (PrecisionPolicy | preset string
    | None) runs the recursion at the policy's compute dtype (f32
    accumulation as always); None and "exact" are bitwise the plain call.
    """
    if auto:
        from ..planner import planned_leaf_solver

        leaf_solver = planned_leaf_solver(a.n, a.block_size, a.dtype,
                                          kind="solve", backend=a.device.type)
    if precision is not None:
        policy = resolve_precision(precision)
        if not policy.is_exact and _policy_active(policy, a.blocks.dtype):
            cd = torch_dtype(policy.resolve_compute(a.blocks.dtype))
            x = spin_solve(BlockMatrix(a.blocks.to(cd)), b.to(cd),
                           leaf_solver=leaf_solver)
            return x.to(b.dtype)
    grid = a.grid
    if grid & (grid - 1):
        raise ValueError(f"grid must be a power of two, got {grid}")
    if b.shape[0] != a.n:
        raise ValueError(f"rhs rows {b.shape[0]} != matrix dim {a.n}")
    if b.device != a.device:
        raise ValueError(f"rhs lies on {b.device}, the matrix on {a.device}")
    if leaf_solver not in LEAF_SOLVERS:
        raise ValueError(f"unknown leaf solver {leaf_solver!r}; this package "
                         f"has {tuple(LEAF_SOLVERS)}")
    vector = b.ndim == 1
    x = _solve(a, b[:, None] if vector else b, leaf_solver)
    return x[:, 0] if vector else x


def spin_solve_dense(a, b, block_size: int | None = None,
                     leaf_solver: str | None = None, *,
                     engine: str | None = None, auto: bool = False,
                     device: str | torch.device = DEFAULT_DEVICE,
                     precision=None, compute_dtype=None) -> torch.Tensor:
    """Dense (n, n) A and (n, k) or (n,) B -> X, computed on `device`.

    `a` and `b` are tensors or anything `torch.as_tensor` takes; both are
    moved to `device` first. engine=None inherits the ambient
    `multiply_engine`; leaf_solver=None is "linalg". With block_size=None
    (or auto=True) the planner picks block size, leaf solver and engine;
    explicit ones override its choice, and the planned call is bitwise the
    explicit call with the chosen plan. precision (PrecisionPolicy | preset
    string | None -> $SPIN_PRECISION or exact) runs the solve at the
    policy's compute dtype and returns X at b's dtype; `compute_dtype=` is
    the deprecated spelling.
    """
    validate_engine(engine)
    policy = resolve_with_legacy_kwarg("spin_solve_dense", precision, compute_dtype)
    dev = resolve_device(device)
    a = torch.as_tensor(a).to(dev)
    b = torch.as_tensor(b).to(dev)
    if auto or block_size is None:
        from ..planner import plan_solve

        kw = _explicit(block_size, leaf_solver, engine)
        if not policy.is_exact and _policy_active(policy, a.dtype):
            cd = torch_dtype(policy.resolve_compute(a.dtype))
            return plan_solve(a.to(cd), b.to(cd), precision=policy,
                              **kw).to(b.dtype)
        return plan_solve(a, b, **kw)
    ctx = multiply_engine(engine) if engine else contextlib.nullcontext()
    with ctx:
        return spin_solve(BlockMatrix.from_dense(a, block_size), b,
                          leaf_solver=leaf_solver or "linalg", precision=policy)


def spin_solve_sharded(a, b, block_size: int | None = None, *,
                       leaf_solver: str | None = None,
                       engine: str | None = None, auto: bool = False,
                       precision=None,
                       device: str | torch.device | None = None
                       ) -> torch.Tensor:
    """Mesh-resident multi-RHS solve: panels split by rows over `data`.

    The inverse-free Schur recursion with every dense panel laid out over
    the ambient mesh between levels (`parallel.sharded_blockmatrix`).
    `a`: dense (n, n) tensor (block_size required unless auto or the
    planner picks it), BlockMatrix, or ShardedBlockMatrix; `b`: (n, k) or
    (n,). Returns X with b's shape, on the mesh's first device; never
    forms A⁻¹. auto=True consults the planner under the sharded placement;
    explicit block_size / leaf_solver / engine override it. A low-precision
    `precision` runs a dense operand at the policy's compute dtype and
    returns X at b's dtype; a block operand with one raises.
    """
    from ..parallel.sharded_blockmatrix import ShardedBlockMatrix, solve_program
    from .spin import _resolve_sharded_config

    validate_engine(engine)
    if precision is not None:
        policy = resolve_precision(precision)
        dense_in = not isinstance(a, (BlockMatrix, ShardedBlockMatrix))
        if dense_in:
            a = torch.as_tensor(a)
        if not policy.is_exact and _policy_active(policy, a.dtype):
            if not dense_in:
                raise ValueError(
                    "low-precision policies on the sharded solve path need "
                    f"a dense operand; got {type(a).__name__}")
            b = torch.as_tensor(b)
            cd = torch_dtype(policy.resolve_compute(a.dtype))
            return spin_solve_sharded(a.to(cd), b.to(cd), block_size,
                                      leaf_solver=leaf_solver, engine=engine,
                                      auto=auto, device=device).to(b.dtype)
    a, leaf_solver, engine, _, dev = _resolve_sharded_config(
        "solve", a, block_size, leaf_solver, engine, auto, device)
    b = torch.as_tensor(b).to(dev)
    return solve_program(a, b, leaf_solver=leaf_solver, engine=engine)


def spin_inverse_batched(batch, block_size: int | None = None,
                         leaf_solver: str = "linalg",
                         *, engine: str | None = None,
                         device: str | torch.device = DEFAULT_DEVICE,
                         precision=None, compute_dtype=None) -> torch.Tensor:
    """SPIN-invert a (batch, n, n) stack of SPD matrices on `device`.

    Each slice goes through `spin_inverse_dense` with the same arguments,
    so it is bitwise equal to the per-matrix call. block_size=None asks the
    planner (cost model only) for the per-matrix block size on `device`'s
    backend. precision runs every slice at the policy's compute dtype, with
    no polish, and returns the stack at the policy's store dtype;
    `compute_dtype=` is the deprecated spelling.
    """
    batch = torch.as_tensor(batch)
    if batch.ndim != 3:
        raise ValueError(f"expected (batch, n, n), got {tuple(batch.shape)}")
    validate_engine(engine)
    policy = resolve_with_legacy_kwarg("spin_inverse_batched", precision, compute_dtype)
    if block_size is None:
        from ..planner import planned_block_size

        block_size = planned_block_size(batch.shape[-1], batch.dtype,
                                        backend=resolve_device(device).type)
    store = batch.dtype
    if not policy.is_exact and _policy_active(policy, batch.dtype):
        store = torch_dtype(policy.resolve_store(batch.dtype))
        batch = batch.to(torch_dtype(policy.resolve_compute(batch.dtype)))
    return torch.stack([spin_inverse_dense(m, block_size, leaf_solver,
                                           engine=engine, device=device,
                                           precision="exact")
                        for m in batch]).to(store)


# ---------------------------------------------------------------------------
# Degraded-mode (sketched) approximate inverse
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SketchedInverse:
    """A servable approximate inverse with its reported residual bound."""

    inverse: torch.Tensor     # dense (n, n), the operand's dtype
    residual_est: float       # probe estimate of ‖A X − I‖∞ at return
    sweeps: int               # Newton–Schulz sweeps spent
    converged: bool           # residual_est ≤ tol when it stopped


def sketched_approx_inverse(a: torch.Tensor,
                            generator: torch.Generator | None = None, *,
                            block_size: int | None = None,
                            tol: float | None = None, max_sweeps: int = 60,
                            probes: int = 2) -> SketchedInverse:
    """Approximate A⁻¹, servable before (or without) the full recursion.

    A randomized sketch (8 power steps on AᵀA from a random probe)
    estimates σ_max² and seeds X₀ = Aᵀ/(1.1·σ̂²), for which ‖I − AX₀‖₂ < 1
    for any nonsingular A (the 1.1 keeps α·σ_max² < 2 under a slightly low
    estimate). Newton–Schulz sweeps (`newton_schulz_polish`, two
    BlockMatrix multiplies each under the ambient multiply engine) then
    converge quadratically, and `update.estimate_inverse_residual`
    measures the residual after every sweep, stopping at `tol`.

    `a` lies on the device the work runs on; `generator` (a
    `torch.Generator` on that device, or None for the default one) draws
    the sketch and the probes. tol=None uses `verify.residual_tolerance`
    of a's dtype; block_size=None uses n // solve_grid_for(n).
    """
    from .update import estimate_inverse_residual  # late: both import this module
    from .verify import residual_tolerance

    n = a.shape[0]
    if tol is None:
        tol = residual_tolerance(a.dtype)
    f32 = a.float()

    v = torch.randn((n,), generator=generator, dtype=torch.float32,
                    device=a.device)
    for _ in range(8):
        v = f32.T @ (f32 @ v)
        v = v / torch.linalg.norm(v)
    sigma2 = float(torch.linalg.norm(f32.T @ (f32 @ v)))
    x0 = f32.T / (1.1 * sigma2)

    bs = block_size or n // solve_grid_for(n)
    a_bm = BlockMatrix.from_dense(f32, bs)
    x = BlockMatrix.from_dense(x0, bs)

    def probe_residual(x_bm: BlockMatrix) -> float:
        return estimate_inverse_residual(lambda p: f32 @ p, x_bm.to_dense(),
                                         generator, n, probes=max(1, probes))

    residual = probe_residual(x)
    sweeps = 0
    while residual > tol and sweeps < max_sweeps:
        x = newton_schulz_polish(a_bm, x, sweeps=1)
        sweeps += 1
        residual = probe_residual(x)
    return SketchedInverse(inverse=x.to_dense().to(a.dtype),
                           residual_est=residual, sweeps=sweeps,
                           converged=residual <= tol)
