"""The inverse-free solve: the PyTorch port against the JAX package.

Each matrix of the zoo and each block of right-hand sides is made once,
with the port's generators on the CPU and numpy from a seed, and handed
bit for bit to both packages. The JAX side runs the Pallas kernels in
interpret mode, as its own tests do; the port runs its kernels' plain
versions on the CPU. Each case checks the port's solve residual against
`residual_tolerance`, its closeness to the reference's X, and its op
counts against the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlockMatrix as JBlockMatrix
from repro.core import count_ops as j_count_ops
from repro.core import multiply_engine as j_multiply_engine
from repro.core import verify as j_verify
from repro.core.solve import spin_solve as j_spin_solve
from repro.core.solve import solve_grid_for as j_solve_grid_for
from repro.core.solve import spin_inverse_batched as j_spin_inverse_batched
from repro.core.solve import spin_solve_dense as j_spin_solve_dense
from repro_torch import bridge, kernels
from repro_torch.core import (BlockMatrix, OpCounts, count_ops,
                              multiply_engine, solve_grid_for, solve_residual,
                              spin_inverse_batched, spin_inverse_dense,
                              spin_solve, spin_solve_dense, testing, verify)

BS = 16
GRIDS = [1, 2, 4, 8]
FAMILIES = ["spd", "diag_dominant", "ill_conditioned_spd", "block_banded_spd"]
# (port, reference) names of the same engine and leaf solver.
ENGINE_PAIRS = [("einsum", "einsum"), ("cuda", "pallas")]
LEAF_PAIRS = [("linalg", "linalg"), ("gauss_jordan", "gauss_jordan"),
              ("cuda", "pallas")]


def _matrix(family: str, n: int, dtype=torch.float32) -> torch.Tensor:
    rng = np.random.default_rng([FAMILIES.index(family), n, 1])
    kwargs = {"cond": 1e4} if family == "ill_conditioned_spd" else {}
    if family == "block_banded_spd":
        kwargs["band"] = BS
    return testing.MATRIX_FAMILIES[family](n, rng, dtype=dtype, device="cpu",
                                           **kwargs)


def _rhs(n: int, k: int, seed: int = 0, dtype=torch.float32) -> torch.Tensor:
    rng = np.random.default_rng([n, k, seed])
    return torch.from_numpy(rng.standard_normal((n, k), dtype=np.float32)).to(dtype)


def _tolerances(family: str, dtype=torch.float32) -> tuple[float, float]:
    """(residual bound, closeness bound relative to max |X_ref|).

    The residual bound is the conformance table's, widened 100× for the
    κ = 1e4 family as `run_conformance` widens it (the residual scales with
    κ·ε). The two packages round in different orders, and those differences
    grow with κ too: 1e-4 of the largest entry at κ ≈ 10, 1e-2 at κ = 1e4.
    """
    tol = verify.residual_tolerance(dtype)
    if family == "ill_conditioned_spd":
        return tol * 1e2, 1e-2
    return tol, 1e-4


def _solve_counts(grid: int) -> dict:
    """The inverse-free profile: per internal node one split, three panel
    applies (A21·III, A21·Y1, III·X2) and three subtracts (V, rhs2, X1);
    one leaf solve a leaf; no multiply, arrange or leaf inversion."""
    return OpCounts(leaf_solves=grid, splits=grid - 1,
                    solve_applies=3 * (grid - 1),
                    subtracts=3 * (grid - 1)).as_dict()


def _to_jax(t: torch.Tensor):
    return jnp.asarray(bridge.to_numpy(t))


def _rel_diff(x: torch.Tensor, ref) -> float:
    ref = torch.from_numpy(np.array(jnp.asarray(ref, jnp.float32)))
    return float((x.float() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("n_rhs", [1, 4])
@pytest.mark.parametrize("leaf", LEAF_PAIRS, ids=lambda p: p[0])
@pytest.mark.parametrize("engine", ENGINE_PAIRS, ids=lambda p: p[0])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_spin_solve_dense_matches_reference(family, grid, engine, leaf, n_rhs):
    (eng, j_eng), (lf, j_lf) = engine, leaf
    n = grid * BS
    a, b = _matrix(family, n), _rhs(n, n_rhs)
    with count_ops() as counts:
        x = spin_solve_dense(a, b, BS, lf, engine=eng, device="cpu")
    want = j_spin_solve_dense(_to_jax(a), _to_jax(b), BS, j_lf, engine=j_eng)
    res_tol, close_tol = _tolerances(family)
    assert x.dtype == b.dtype and tuple(x.shape) == tuple(b.shape)
    assert solve_residual(a, x, b) < res_tol
    assert _rel_diff(x, want) < close_tol
    assert counts.as_dict() == _solve_counts(grid)


@pytest.mark.parametrize("leaf", LEAF_PAIRS, ids=lambda p: p[0])
@pytest.mark.parametrize("engine", ENGINE_PAIRS, ids=lambda p: p[0])
@pytest.mark.parametrize("grid", GRIDS)
def test_solve_op_counts_equal_reference(grid, engine, leaf):
    # The reference books its counts while it traces, so it runs eagerly
    # here: a cached jit program would count nothing.
    (eng, j_eng), (lf, j_lf) = engine, leaf
    n = grid * BS
    a, b = _matrix("spd", n), _rhs(n, 3)
    with count_ops() as counts, multiply_engine(eng):
        spin_solve(BlockMatrix.from_dense(a, BS), b, leaf_solver=lf)
    with j_count_ops() as j_counts, j_multiply_engine(j_eng):
        j_spin_solve(JBlockMatrix.from_dense(_to_jax(a), BS), _to_jax(b),
                     leaf_solver=j_lf)
    assert counts.as_dict() == bridge.op_counts_from_dict(j_counts.as_dict()).as_dict()
    assert counts.as_dict() == _solve_counts(grid)


@pytest.mark.parametrize("leaf", LEAF_PAIRS, ids=lambda p: p[0])
def test_vector_rhs_is_the_one_column_solve(leaf):
    lf, j_lf = leaf
    a, b = _matrix("spd", 64), _rhs(64, 1)[:, 0]
    x = spin_solve_dense(a, b, BS, lf, engine="cuda", device="cpu")
    assert tuple(x.shape) == (64,)
    assert torch.equal(x, spin_solve_dense(a, b[:, None], BS, lf, engine="cuda",
                                           device="cpu")[:, 0])
    want = j_spin_solve_dense(_to_jax(a), _to_jax(b), BS, j_lf, engine="pallas")
    assert _rel_diff(x, want) < 1e-4


def test_spin_solve_validates_inputs():
    a3 = BlockMatrix.from_dense(_matrix("spd", 96), 32)        # grid 3
    with pytest.raises(ValueError, match="power of two"):
        spin_solve(a3, torch.ones(96, 2))
    a2 = BlockMatrix.from_dense(_matrix("spd", 64), 32)
    with pytest.raises(ValueError, match="rows"):
        spin_solve(a2, torch.ones(96, 2))
    with pytest.raises(ValueError, match="lies on"):
        spin_solve(a2, torch.ones(64, 2, device="meta"))
    with pytest.raises(ValueError, match="leaf solver"):
        spin_solve(a2, torch.ones(64, 2), leaf_solver="pallas")
    with pytest.raises(ValueError, match="einsum"):
        spin_solve_dense(_matrix("spd", 64), torch.ones(64, 2), 32,
                         engine="pallas", device="cpu")


@pytest.mark.parametrize("engine", ["einsum", "cuda"])
@pytest.mark.parametrize("leaf", ["linalg", "gauss_jordan", "cuda", "qr"])
def test_spin_solve_never_materializes_inverse_op_profile(leaf, engine):
    """No BlockMatrix multiply, arrange or leaf inversion: only panel
    applies and recursive leaf solves (the inverse-free claim)."""
    n, bs = 256, 32
    kernels.reset_launch_counts()
    with count_ops() as c:
        spin_solve_dense(_matrix("spd", n), _rhs(n, 2), bs, leaf,
                         engine=engine, device="cpu")
    grid = n // bs
    assert c.multiplies == 0 and c.arranges == 0 and c.leaf_inversions == 0
    assert c.leaf_solves == grid                 # one per leaf system
    assert c.splits == grid - 1                  # one per internal node
    assert c.solve_applies == 3 * (grid - 1)     # A21·III, A21·Y1, III·X2
    assert c.subtracts == 3 * (grid - 1)         # V, rhs2, X1
    # On the CPU the wrappers run the plain versions and launch nothing.
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}


@pytest.mark.parametrize("leaf", ["linalg", "cuda"])
def test_solve_agrees_with_inverse_then_multiply(leaf):
    a, b = _matrix("spd", 128), _rhs(128, 6)
    x = spin_solve_dense(a, b, 32, leaf, engine="cuda", device="cpu")
    inv = spin_inverse_dense(a, 32, leaf, engine="cuda", device="cpu")
    want = inv @ b
    assert float((x - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("engine", ENGINE_PAIRS, ids=lambda p: p[0])
def test_bf16_solve_matches_reference(engine):
    eng, j_eng = engine
    a = _matrix("spd", 128, torch.bfloat16)
    b = _rhs(128, 4, dtype=torch.bfloat16)
    x = spin_solve_dense(a, b, 32, "cuda", engine=eng, device="cpu")
    want = j_spin_solve_dense(_to_jax(a), _to_jax(b), 32, "pallas", engine=j_eng)
    assert x.dtype == torch.bfloat16
    tol = verify.residual_tolerance(torch.bfloat16)
    assert solve_residual(a, x, b) < tol
    assert j_verify.solve_residual(_to_jax(a), want, _to_jax(b)) < tol
    # Both round every panel and leaf result to bf16, at different places.
    assert _rel_diff(x, want) < 2e-2


@pytest.mark.parametrize("engine", ENGINE_PAIRS, ids=lambda p: p[0])
def test_bf16_matrix_f32_rhs_matches_reference(engine):
    # The A12 columns and the f32 right-hand sides ride along together, so
    # the panels are f32 while A's blocks stay bf16: the panel products
    # take the promoted type, as the reference's do.
    eng, j_eng = engine
    a, b = _matrix("spd", 128, torch.bfloat16), _rhs(128, 4)
    x = spin_solve_dense(a, b, 32, "cuda", engine=eng, device="cpu")
    want = j_spin_solve_dense(_to_jax(a), _to_jax(b), 32, "pallas", engine=j_eng)
    assert x.dtype == torch.float32
    assert solve_residual(a, x, b) < verify.residual_tolerance(torch.bfloat16)
    assert _rel_diff(x, want) < 1e-4


@pytest.mark.parametrize("leaf", LEAF_PAIRS, ids=lambda p: p[0])
def test_spin_inverse_batched_is_per_matrix_and_matches_reference(leaf):
    lf, j_lf = leaf
    stack = torch.stack([_matrix(f, 64) for f in ("spd", "diag_dominant",
                                                  "block_banded_spd")])
    got = spin_inverse_batched(stack, BS, lf, engine="cuda", device="cpu")
    assert tuple(got.shape) == (3, 64, 64)
    for i in range(3):
        assert torch.equal(got[i], spin_inverse_dense(stack[i], BS, lf,
                                                      engine="cuda", device="cpu"))
    want = j_spin_inverse_batched(_to_jax(stack), BS, j_lf, engine="pallas")
    assert _rel_diff(got, want) < 1e-4
    with pytest.raises(ValueError, match="batch"):
        spin_inverse_batched(stack[0], BS, lf, device="cpu")


@pytest.mark.parametrize("n_rhs", [1, 7])
@pytest.mark.parametrize("leaf", ["linalg", "qr", "gauss_jordan", "cuda"])
def test_run_conformance_solves_within_tolerance(leaf, n_rhs):
    reports = verify.run_conformance(grids=(1, 2, 4), block_size=16,
                                     n_rhs=n_rhs, leaf_solver=leaf, device="cpu")
    assert len(reports) == 12
    assert all(r.ok for r in reports), [r.as_dict() for r in reports if not r.ok]
    assert all(0.0 < r.solve_residual < r.tolerance for r in reports)
    assert all("solve_residual" in r.as_dict() for r in reports)


@pytest.mark.parametrize("n", [64, 96, 128, 192, 256, 512, 1000, 1024, 4096])
def test_solve_grid_for_matches_reference(n):
    assert solve_grid_for(n) == j_solve_grid_for(n)
    assert solve_grid_for(n, max_grid=16, min_block=16) == j_solve_grid_for(
        n, max_grid=16, min_block=16)


def test_solve_residual_matches_reference():
    a, b = _matrix("spd", 64), _rhs(64, 3)
    x = torch.linalg.solve(a, b) * 1.1                  # a claimed, inexact X
    got = solve_residual(a, x, b)
    want = j_verify.solve_residual(_to_jax(a), _to_jax(x), _to_jax(b))
    # AX is summed in another order by each package: ε-level differences
    # in AX, of a residual ≈ 0.1.
    assert got == pytest.approx(want, rel=1e-5)
    assert solve_residual(a, torch.linalg.solve(a, b), b) < 1e-5


def test_op_count_oracle_ignores_the_solve_counters():
    counts = verify.expected_spin_counts(4)
    counts.leaf_solves, counts.solve_applies, counts.leaf_lu = 4, 9, 4
    verify.assert_paper_op_counts(4, counts)
    counts.leaf_inversions += 1
    with pytest.raises(AssertionError):
        verify.assert_paper_op_counts(4, counts)


def test_solve_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b = torch.eye(32), torch.ones(32, 2)
    for call in (lambda: spin_solve_dense(a, b, 16),
                 lambda: spin_inverse_batched(a[None], 16)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert spin_solve_dense(a, b, 16, device="cpu").device.type == "cpu"
