"""The Strassen engine: the port against the JAX package.

The same numpy inputs go through both packages' Strassen recursions: the
dense and grid variants (odd sizes and grids included), SPIN inversion
under ``engine="strassen"`` over the matrix zoo in f32 and bf16, and the
entry points that ride on it. The op counters must equal the reference's
exactly and the 7/18 oracle. The JAX side runs eagerly (its BlockMatrix
recursion), so the cutoff each test sets reaches it; its leaves are XLA
products, nothing runs in Pallas interpret mode. The port runs its GEMM
kernel's plain version on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlockMatrix as JBlockMatrix
from repro.core import count_ops as j_count_ops
from repro.core import spin_inverse as j_spin_inverse
from repro.core import strassen_matmul as j_strassen_matmul
from repro.core import strassen_matmul_blocks as j_strassen_matmul_blocks
from repro.core import verify as j_verify
from repro.core.multiply import multiply_engine as j_multiply_engine
from repro.core.strassen import strassen_cutoff as j_strassen_cutoff
from repro_torch import bridge
from repro_torch.core import (BlockMatrix, costmodel, count_ops, lu_inverse_dense,
                              multiply_engine, spin_inverse, spin_inverse_batched,
                              spin_inverse_dense, spin_solve_dense,
                              strassen_cutoff, strassen_matmul,
                              strassen_matmul_blocks, testing, verify)
from repro_torch.core.multiply import (ENGINES, multiply_blocks,
                                       multiply_subtract, schur_update_blocks,
                                       subtract_multiply)
from repro_torch.core.strassen import STRASSEN_CUTOFF_ENV
from repro_torch.kernels.matmul import ops as mm_ops

BS = 16
CUTOFF = 16          # every grid > 1 splits
FAMILIES = ["spd", "diag_dominant", "ill_conditioned_spd", "block_banded_spd"]


@pytest.fixture
def cutoff16(monkeypatch):
    monkeypatch.setenv(STRASSEN_CUTOFF_ENV, str(CUTOFF))


def _normal(seed, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _matrix(family: str, n: int, dtype=torch.float32) -> torch.Tensor:
    rng = np.random.default_rng([FAMILIES.index(family), n, 17])
    kwargs = {"band": BS} if family == "block_banded_spd" else {}
    return testing.MATRIX_FAMILIES[family](n, rng, dtype=dtype, device="cpu",
                                           **kwargs)


def _to_jax(t: torch.Tensor):
    return jnp.asarray(bridge.to_numpy(t))


def _from_jax(x) -> torch.Tensor:
    return bridge.to_torch(np.asarray(x), "cpu")


def _relerr(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double(), want.double()
    return float(torch.linalg.norm(g - w) / (torch.linalg.norm(w) + 1e-30))


# ---------------------------------------------------------------- variants


@pytest.mark.parametrize("n", [7, 16, 33, 48])
def test_dense_matmul_matches_reference(n):
    a, b = _normal([n, 1], n, n), _normal([n, 2], n, n)
    with count_ops() as counts:
        got = strassen_matmul(torch.from_numpy(a), torch.from_numpy(b), cutoff=8)
    with j_count_ops() as j_counts:
        want = j_strassen_matmul(jnp.asarray(a), jnp.asarray(b), cutoff=8)
    assert got.shape == (n, n) and got.dtype == torch.float32
    assert _relerr(got, _from_jax(want)) <= 2e-4
    assert _relerr(got, torch.from_numpy(a @ b)) <= 2e-5
    assert counts.as_dict() == j_counts.as_dict()


def test_dense_at_cutoff_is_the_classical_leaf():
    a, b = (torch.from_numpy(_normal(s, 16, 16)) for s in (3, 4))
    with count_ops() as counts:
        got = strassen_matmul(a, b, cutoff=16)
    assert torch.equal(got, mm_ops.matmul(a, b))
    assert (counts.strassen_base_multiplies, counts.strassen_adds) == (1, 0)


@pytest.mark.parametrize("grid", [2, 3, 4])
def test_grid_matmul_matches_reference(grid):
    n = grid * BS
    a, b = _normal([grid, 1], n, n), _normal([grid, 2], n, n)
    ab = BlockMatrix.from_dense(torch.from_numpy(a), BS).blocks
    bb = BlockMatrix.from_dense(torch.from_numpy(b), BS).blocks
    with count_ops() as counts:
        got = strassen_matmul_blocks(ab, bb, cutoff=8)
    with j_count_ops() as j_counts:
        want = j_strassen_matmul_blocks(
            JBlockMatrix.from_dense(jnp.asarray(a), BS).blocks,
            JBlockMatrix.from_dense(jnp.asarray(b), BS).blocks, cutoff=8)
    assert got.shape == ab.shape
    assert _relerr(BlockMatrix(got).to_dense(),
                   _from_jax(JBlockMatrix(want).to_dense())) <= 2e-4
    assert _relerr(BlockMatrix(got).to_dense(), multiply_blocks(ab, bb, "einsum")
                   .permute(0, 2, 1, 3).reshape(n, n)) <= 2e-5
    assert counts.as_dict() == j_counts.as_dict()
    assert ((counts.strassen_base_multiplies, counts.strassen_adds)
            == verify.expected_strassen_counts(grid, BS, cutoff=8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["dense", "grid"])
def test_custom_base_runs_every_leaf(variant, dtype):
    a, b = (torch.from_numpy(_normal(s, 64, 64)).to(dtype) for s in (5, 6))
    calls = []
    if variant == "dense":
        def base(x, y):
            calls.append(tuple(x.shape))
            return mm_ops.matmul(x, y)

        got = strassen_matmul(a, b, cutoff=32, base=base)
        want = strassen_matmul(a, b, cutoff=32)
    else:
        def base(x, y):
            calls.append(tuple(x.shape))
            return mm_ops.grid_matmul(x, y)

        ab, bb = (BlockMatrix.from_dense(t, BS).blocks for t in (a, b))
        got = strassen_matmul_blocks(ab, bb, cutoff=32, base=base)
        want = strassen_matmul_blocks(ab, bb, cutoff=32)
    assert len(calls) == 7 and got.dtype == dtype
    assert torch.equal(got, want)


def test_variants_reject_mismatched_operands():
    with pytest.raises(ValueError):
        strassen_matmul(torch.zeros(4, 4), torch.zeros(4, 5))
    with pytest.raises(ValueError):
        strassen_matmul_blocks(torch.zeros(2, 2, 4, 4), torch.zeros(2, 3, 4, 4))


# ------------------------------------------------------------- inversion


def _zoo_cases():
    for family in FAMILIES:
        for dtype in (torch.float32, torch.bfloat16):
            # κ ≈ 1e6 is beyond bf16's 8-bit mantissa; f32 covers that family.
            if family == "ill_conditioned_spd" and dtype == torch.bfloat16:
                continue
            yield pytest.param(family, dtype,
                               id=f"{family}-{str(dtype)[6:]}")


@pytest.mark.parametrize("family,dtype", list(_zoo_cases()))
def test_inverse_matches_reference_across_zoo(cutoff16, family, dtype):
    grid = 4
    a = _matrix(family, grid * BS, dtype)
    with count_ops() as counts:
        x = spin_inverse_dense(a, BS, engine="strassen", device="cpu")
    with j_count_ops() as j_counts, j_multiply_engine("strassen"):
        want = j_spin_inverse(JBlockMatrix.from_dense(_to_jax(a), BS)).to_dense()
    assert x.dtype == dtype
    assert counts.as_dict() == j_counts.as_dict()
    verify.assert_paper_op_counts(grid, counts)
    verify.assert_strassen_op_counts(grid, BS, counts)
    if family == "ill_conditioned_spd":
        # κ ≈ 1e6 turns last-ulp rounding into O(1) differences between two
        # correct inverses: compare residual quality instead.
        x_einsum = spin_inverse_dense(a, BS, engine="einsum", device="cpu")
        eye = torch.eye(a.shape[0])
        r_str = float(torch.linalg.norm(a.double() @ x.double() - eye))
        r_ein = float(torch.linalg.norm(a.double() @ x_einsum.double() - eye))
        r_ref = float(torch.linalg.norm(a.double() @ _from_jax(want).double() - eye))
        assert r_str < 10 * max(r_ein, r_ref, 1e-6), (r_str, r_ein, r_ref)
    else:
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
        assert _relerr(x.float(), _from_jax(want).float()) <= tol
        assert verify.inverse_residual(a, x) <= verify.residual_tolerance(dtype)


@pytest.mark.parametrize("cutoff", [16, 32, 64])
@pytest.mark.parametrize("grid", [2, 4, 8])
def test_counts_equal_reference_and_oracle(monkeypatch, grid, cutoff):
    monkeypatch.setenv(STRASSEN_CUTOFF_ENV, str(cutoff))
    a = _matrix("spd", grid * BS)
    with count_ops() as counts, multiply_engine("strassen"):
        spin_inverse(BlockMatrix.from_dense(a, BS))
    with j_count_ops() as j_counts, j_multiply_engine("strassen"):
        j_spin_inverse(JBlockMatrix.from_dense(_to_jax(a), BS))
    assert counts.as_dict() == j_counts.as_dict()
    want = verify.expected_spin_strassen_counts(grid, BS)
    assert want == j_verify.expected_spin_strassen_counts(grid, BS)
    assert (counts.strassen_base_multiplies, counts.strassen_adds) == want
    with count_ops() as classical:
        spin_inverse(BlockMatrix.from_dense(a, BS))
    # The Algorithm-2 counters do not see the engine.
    counts.strassen_base_multiplies = counts.strassen_adds = 0
    assert counts.as_dict() == classical.as_dict()


@pytest.mark.parametrize("cutoff", [None, 8, 16, 64, 128, 512, 1024])
@pytest.mark.parametrize("grid", [1, 2, 4, 8, 16])
def test_strassen_oracle_equals_reference(grid, cutoff):
    for bs in (16, 1024):
        assert (verify.expected_spin_strassen_counts(grid, bs, cutoff)
                == j_verify.expected_spin_strassen_counts(grid, bs, cutoff))
        assert (verify.expected_strassen_counts(grid + 1, bs, cutoff)
                == j_verify.expected_strassen_counts(grid + 1, bs, cutoff))


def test_main_path_oracle_value():
    # n = 16384, bs = 1024 at the default cutoff: the chip run's counts.
    assert verify.expected_spin_strassen_counts(16, 1024, 512) == (2862, 8316)
    assert verify.expected_strassen_counts(2, 16, cutoff=16) == (7, 18)


def test_strassen_oracle_rejects_divergence():
    with count_ops() as c:
        pass
    c.strassen_base_multiplies = 7     # the oracle says (6, 0) at grid 2
    with pytest.raises(AssertionError):
        verify.assert_strassen_op_counts(2, BS, c, cutoff=CUTOFF)
    with pytest.raises(ValueError):
        verify.expected_spin_strassen_counts(3, BS, CUTOFF)


# -------------------------------------------------- fused Schur update route


@pytest.mark.parametrize("grid", [1, 2, 4])
def test_fused_schur_route_is_bitwise_the_unfused_one(cutoff16, grid):
    n = grid * BS
    a, b, c = (BlockMatrix.from_dense(torch.from_numpy(_normal([7, s], n, n)), BS)
               for s in range(3))
    with multiply_engine("strassen"):
        fused_v = multiply_subtract(a, b, c)
        fused_c11 = subtract_multiply(c, a, b)
        prod = multiply_blocks(a.blocks, b.blocks)
    assert torch.equal(fused_v.blocks, prod - c.blocks)
    assert torch.equal(fused_c11.blocks, c.blocks - prod)


def test_schur_update_blocks_negate_conventions(cutoff16):
    n = 2 * BS
    a, b, c = (BlockMatrix.from_dense(torch.from_numpy(_normal([8, s], n, n)), BS).blocks
               for s in range(3))
    prod = multiply_blocks(a, b, "strassen")
    assert torch.equal(schur_update_blocks(c, a, b, negate_c=True, engine="strassen"),
                       prod - c)
    assert torch.equal(schur_update_blocks(c, a, b, negate_c=False, engine="strassen"),
                       c - prod)


# ------------------------------------------------------ entry points and knob


def test_solve_batched_and_lu_under_strassen(cutoff16):
    n = 4 * BS
    a = _matrix("spd", n)
    rhs = torch.from_numpy(_normal(9, n, 4))
    xs = spin_solve_dense(a, rhs, BS, engine="strassen", device="cpu")
    xe = spin_solve_dense(a, rhs, BS, engine="einsum", device="cpu")
    # The solve's panel products take the einsum route under strassen, as
    # in the reference: only the kernel engine sends them to the kernel.
    assert torch.equal(xs, xe)
    batch = torch.stack([a, _matrix("diag_dominant", n)])
    got = spin_inverse_batched(batch, BS, engine="strassen", device="cpu")
    want = spin_inverse_batched(batch, BS, engine="einsum", device="cpu")
    assert _relerr(got, want) <= 2e-4
    d = _matrix("diag_dominant", n)
    assert _relerr(lu_inverse_dense(d, BS, engine="strassen", device="cpu"),
                   lu_inverse_dense(d, BS, engine="einsum", device="cpu")) <= 2e-4


def test_strassen_takes_a_precision_policy(cutoff16):
    a = _matrix("spd", 4 * BS)
    x = spin_inverse_dense(a, BS, engine="strassen", device="cpu", precision="bf16")
    assert x.dtype == torch.bfloat16
    assert verify.inverse_residual(a, x) <= verify.residual_tolerance("bfloat16")


def test_cutoff_env_override_as_reference(monkeypatch):
    monkeypatch.delenv(STRASSEN_CUTOFF_ENV, raising=False)
    assert strassen_cutoff() == j_strassen_cutoff() == costmodel.STRASSEN_CUTOFF == 512
    for raw, want in (("96", 96), ("-4", 0), (" 16 ", 16)):
        monkeypatch.setenv(STRASSEN_CUTOFF_ENV, raw)
        assert strassen_cutoff() == j_strassen_cutoff() == want
    monkeypatch.setenv(STRASSEN_CUTOFF_ENV, "many")
    for fn in (strassen_cutoff, j_strassen_cutoff):
        with pytest.raises(ValueError):
            fn()


def test_cutoff_env_changes_the_recursion(monkeypatch):
    a = _matrix("spd", 4 * BS)
    counts = {}
    for cutoff in ("16", "64"):
        monkeypatch.setenv(STRASSEN_CUTOFF_ENV, cutoff)
        with count_ops() as c, multiply_engine("strassen"):
            spin_inverse(BlockMatrix.from_dense(a, BS))
        counts[cutoff] = (c.strassen_base_multiplies, c.strassen_adds)
    assert counts["16"] == verify.expected_spin_strassen_counts(4, BS, 16)
    assert counts["64"] == verify.expected_spin_strassen_counts(4, BS, 64) == (18, 0)


def test_engine_registry_has_strassen():
    assert ENGINES == ("einsum", "cuda", "strassen", "allgather", "ring")
    with multiply_engine("strassen"):
        pass
