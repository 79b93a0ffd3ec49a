"""SPIN conformance: residuals and the paper's op-count oracle.

  * `inverse_residual` computes ‖AX − I‖∞ and `solve_residual`
    ‖AX − B‖∞ / ‖B‖∞, in f32; `residual_tolerance` maps a storage dtype
    to the bound a correct implementation meets.
  * `expected_spin_counts(grid)` is the closed form of Algorithm 2's costs
    (6 multiplies, 2 subtract-class ops, 1 scalarMul per internal node; one
    leaf inversion per leaf), checked by `assert_paper_op_counts`.
  * `expected_spin_strassen_counts` is the 7/18 recurrence of the
    ``strassen`` engine's base multiplies and add passes, checked by
    `assert_strassen_op_counts`.
  * `run_conformance` sweeps `spin_inverse` and `spin_solve` over the
    matrix zoo × grids.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .blockmatrix import BlockMatrix, OpCounts, count_ops
from .precision import torch_dtype
from .solve import spin_solve
from .spin import spin_inverse
from .testing import MATRIX_FAMILIES

__all__ = ["residual_tolerance", "inverse_residual", "solve_residual",
           "expected_spin_counts", "assert_paper_op_counts",
           "expected_strassen_counts", "expected_spin_strassen_counts",
           "assert_strassen_op_counts", "ConformanceReport", "run_conformance"]

# Storage dtype -> max allowed ∞-norm residual on the zoo's well-posed
# families.
_RESIDUAL_TOL = {
    torch.float64: 1e-9,
    torch.float32: 1e-3,
    torch.bfloat16: 2e-2,
    torch.float16: 1e-2,
}


def residual_tolerance(dtype) -> float:
    """The residual bound a conformant implementation meets for `dtype`, a
    torch dtype or its name ("bfloat16")."""
    try:
        return _RESIDUAL_TOL[torch_dtype(dtype)]
    except KeyError:
        raise ValueError(f"no conformance tolerance for dtype {dtype}") from None


def _f32_product(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A·X in full f32: TF32 off for the call."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a.float() @ x.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def inverse_residual(a: torch.Tensor, x: torch.Tensor) -> float:
    """‖AX − I‖∞ (max-abs) for a claimed inverse X, in full f32 (no TF32)."""
    prod = _f32_product(a, x)
    prod.diagonal().sub_(1.0)
    return float(prod.abs().max())


def solve_residual(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> float:
    """‖AX − B‖∞ / ‖B‖∞ (max-abs) for a claimed solution X of AX = B, in
    full f32 (no TF32)."""
    b32 = b.float()
    resid = (_f32_product(a, x) - b32).abs().max()
    return float(resid / (b32.abs().max() + 1e-30))


# ---------------------------------------------------------------------------
# Op-count oracle (paper Algorithm 2)
# ---------------------------------------------------------------------------


def expected_spin_counts(grid: int) -> OpCounts:
    """Closed-form op counts for SPIN on a b×b grid (b a power of two).

    The tree has b − 1 internal nodes and b leaves. Each internal node does
    6 multiplies, 2 subtract-class ops, 1 scalarMul, 1 split and 1 arrange;
    each multiply at a node of half-grid h is h³ block GEMMs.
    """
    if grid < 1 or grid & (grid - 1):
        raise ValueError(f"grid must be a power of two ≥ 1, got {grid}")
    internal = grid - 1
    gemms = 0
    level_nodes, h = 1, grid // 2
    while h >= 1:
        gemms += level_nodes * 6 * h ** 3
        level_nodes, h = level_nodes * 2, h // 2
    return OpCounts(multiplies=6 * internal, block_gemms=gemms,
                    subtracts=2 * internal, scalar_muls=internal,
                    leaf_inversions=grid, splits=internal, arranges=internal)


def assert_paper_op_counts(grid: int, counts: OpCounts) -> None:
    """Assert `counts` (from count_ops over spin_inverse) match the paper.

    The solve path's counters (`leaf_lu`, `leaf_solves`, `solve_applies`)
    are not the oracle's, so a record that counted a solve beside the
    inversion still passes. Engine-blind: a Strassen product is still ONE
    Algorithm-2 multiply, and its own counters are checked by
    `assert_strassen_op_counts`.
    """
    want = expected_spin_counts(grid).as_dict()
    got = counts.as_dict()
    mismatches = {k: (got[k], v) for k, v in want.items() if got[k] != v
                  and k not in ("leaf_lu", "leaf_solves", "solve_applies",
                                "strassen_base_multiplies", "strassen_adds")}
    if mismatches:
        raise AssertionError(
            f"op counts diverge from paper Algorithm 2 at grid {grid} "
            f"(got, want): {mismatches}")


def expected_strassen_counts(grid: int, block_size: int,
                             cutoff: int | None = None) -> tuple[int, int]:
    """(base_multiplies, adds) of ONE Strassen multiply on a grid×grid grid.

    Each split level does 7 recursive multiplies and 18 quadrant add/sub
    passes; an odd grid pads to grid+1 before splitting. The recursion is
    classical (1 base multiply, 0 adds) at grid == 1 or when grid·block_size
    is at/below the cutoff (None reads the live `strassen_cutoff()`), as in
    `core.strassen.strassen_matmul_blocks`.
    """
    if cutoff is None:
        from .strassen import strassen_cutoff

        cutoff = strassen_cutoff()
    if grid == 1 or grid * block_size <= cutoff:
        return 1, 0
    padded = grid + (grid % 2)
    base, adds = expected_strassen_counts(padded // 2, block_size, cutoff)
    return 7 * base, 18 + 7 * adds


def expected_spin_strassen_counts(grid: int, block_size: int,
                                  cutoff: int | None = None
                                  ) -> tuple[int, int]:
    """Strassen totals of one spin_inverse under engine="strassen": each
    internal node at half-grid h runs its 6 Algorithm-2 multiplies (4 plain
    and 2 fused Schur updates, which book alike) as Strassen multiplies on
    an h-grid."""
    if grid < 1 or grid & (grid - 1):
        raise ValueError(f"grid must be a power of two ≥ 1, got {grid}")
    total_base = total_adds = 0
    level_nodes, h = 1, grid // 2
    while h >= 1:
        base, adds = expected_strassen_counts(h, block_size, cutoff)
        total_base += level_nodes * 6 * base
        total_adds += level_nodes * 6 * adds
        level_nodes, h = level_nodes * 2, h // 2
    return total_base, total_adds


def assert_strassen_op_counts(grid: int, block_size: int, counts: OpCounts,
                              cutoff: int | None = None) -> None:
    """Assert the Strassen counters match the 7/18 recurrence."""
    want = expected_spin_strassen_counts(grid, block_size, cutoff)
    got = (counts.strassen_base_multiplies, counts.strassen_adds)
    if got != want:
        raise AssertionError(
            f"Strassen op counts diverge at grid {grid} bs {block_size}: "
            f"(base_multiplies, adds) got {got}, want {want}")


# ---------------------------------------------------------------------------
# Conformance sweep
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ConformanceReport:
    family: str
    grid: int
    block_size: int
    dtype: str
    inverse_residual: float
    solve_residual: float
    tolerance: float
    op_counts_ok: bool
    path: str = "dense"                      # "dense" | "sharded"
    parity_vs_dense: float | None = None     # sharded only: rel. max |Δ|

    @property
    def ok(self) -> bool:
        return (self.op_counts_ok and self.inverse_residual < self.tolerance
                and self.solve_residual < self.tolerance
                and (self.parity_vs_dense is None
                     or self.parity_vs_dense < self.tolerance))

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


def run_conformance(grids: Sequence[int] = (2, 4, 8), block_size: int = 32,
                    n_rhs: int = 4, dtype: torch.dtype = torch.float32,
                    families: Sequence[str] = ("spd", "diag_dominant",
                                               "ill_conditioned_spd",
                                               "block_banded_spd"),
                    seed: int = 0, leaf_solver: str = "linalg",
                    device: str | torch.device | None = None,
                    sharded: bool = False) -> list[ConformanceReport]:
    """Sweep SPIN inversion and the `n_rhs`-column solve over the zoo with
    the ambient engine and `leaf_solver`; a conformant build has every
    report's `.ok`.

    sharded=True runs the mesh-resident recursion
    (`parallel.sharded_blockmatrix`) over the ambient mesh instead: the
    same op-count oracle, plus `parity_vs_dense`, the relative max
    deviation from the dense path's inverse, held to the same tolerance
    (0 off the mesh). `device` defaults to the mesh's devices under a
    mesh, else the card.
    """
    if sharded:
        from ..parallel.sharded_blockmatrix import (
            ShardedBlockMatrix, sharded_spin_inverse, sharded_spin_solve)
        from .spin import _sharded_device

        dev = _sharded_device(device)
    else:
        dev = resolve_device(DEFAULT_DEVICE if device is None else device)
    rng = np.random.default_rng(seed)
    reports = []
    for family in families:
        gen = MATRIX_FAMILIES[family]
        for grid in grids:
            n = grid * block_size
            kwargs = {}
            if family == "ill_conditioned_spd":
                kwargs["cond"] = 1e4      # stress, but within f32 reach
            if family == "block_banded_spd":
                kwargs["band"] = block_size
            a = gen(n, rng, dtype=dtype, device=dev, **kwargs)
            rhs = torch.from_numpy(rng.standard_normal(
                (n, n_rhs), dtype=np.float32)).to(dev, dtype)
            bm = BlockMatrix.from_dense(a, block_size)
            parity = None
            if sharded:
                sbm = ShardedBlockMatrix.from_blockmatrix(bm)
                with count_ops() as counts:
                    inv = sharded_spin_inverse(sbm, leaf_solver).to_dense()
                x = sharded_spin_solve(sbm, rhs, leaf_solver=leaf_solver)
                ref = spin_inverse(bm, leaf_solver=leaf_solver).to_dense()
                parity = float((inv - ref).float().abs().max()
                               / (ref.float().abs().max() + 1e-30))
            else:
                with count_ops() as counts:
                    inv = spin_inverse(bm, leaf_solver=leaf_solver).to_dense()
                x = spin_solve(bm, rhs, leaf_solver=leaf_solver)
            try:
                assert_paper_op_counts(grid, counts)
                counts_ok = True
            except AssertionError:
                counts_ok = False
            tol = residual_tolerance(dtype)
            if family == "ill_conditioned_spd":
                tol = tol * 1e2   # residual scales with κ·ε
            reports.append(ConformanceReport(
                family=family, grid=grid, block_size=block_size,
                dtype=str(dtype).removeprefix("torch."),
                inverse_residual=inverse_residual(a, inv),
                solve_residual=solve_residual(a, x, rhs), tolerance=tol,
                op_counts_ok=counts_ok,
                path="sharded" if sharded else "dense",
                parity_vs_dense=parity))
    return reports
