"""The PyTorch port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper of the port runs its kernel's plain PyTorch
version; the JAX side runs the Pallas kernels in interpret mode, as the
JAX package's own tests do. Inputs are drawn with numpy from a seed and
handed to both packages bit for bit through `repro_torch.bridge`. The
CUDA kernels themselves are tested on the card by `test_torch_cuda.py`.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlockMatrix as JBlockMatrix, count_ops as j_count_ops
from repro.core import spin_inverse as j_spin_inverse
from repro.core.testing import make_spd as j_make_spd
from repro.kernels.flash_attention import ops as jfa_ops, ref as jfa_ref
from repro.kernels.leaf_inverse import ops as jgj_ops, ref as jgj_ref
from repro.kernels.leaf_inverse.kernel import (blocked_leaf_inverse_pallas,
                                               leaf_inverse_pallas)
from repro.kernels.matmul import ops as jmm_ops
from repro.kernels.matmul.kernel import matmul_pallas, schur_update_pallas
from repro_torch import bridge, kernels
from repro_torch.core import BlockMatrix
from repro_torch.kernels.flash_attention import kernel as fa, ops as fa_ops
from repro_torch.kernels.leaf_inverse import kernel as gj, ops as gj_ops, ref as gj_ref
from repro_torch.kernels.matmul import kernel as mm, ops as mm_ops, ref as mm_ref

ROOT = Path(__file__).resolve().parents[1]

# One bf16 ulp is at most 2^-7 of the value; near zero the two packages'
# f32 sums may straddle a rounding boundary, hence a small floor.
BF16_ULP = 2.0 ** -7


def _pair(x: np.ndarray, dtype: str):
    """The same bits as a JAX array and a torch tensor."""
    j = jnp.asarray(x, jnp.float32).astype(dtype)
    return j, bridge.to_torch(np.asarray(j), device="cpu")


def _close(got: torch.Tensor, want, dtype: str, f32_rel: float) -> None:
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    got = got.float()
    scale = float(want.abs().max())
    if dtype == "float32":
        err = float((got - want).abs().max())
        assert err <= f32_rel * scale, (err, scale)
    else:
        excess = (got - want).abs() - (BF16_ULP * want.abs() + 1e-3 * scale)
        assert float(excess.max()) <= 0.0, float(excess.max())


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(list(key))


# ---------------------------------------------------------------------------
# B2 matmul and B1 Schur update: plain versions vs the Pallas kernels
# ---------------------------------------------------------------------------

# (m, k, n) with 64-tiles: several k steps in the Pallas kernel.
GEMM_SHAPES = [(128, 256, 192), (64, 192, 128), (192, 128, 64)]


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_matches_pallas(m, k, n, dtype):
    rng = _rng(m, k, n)
    aj, at = _pair(rng.standard_normal((m, k)), dtype)
    bj, bt = _pair(rng.standard_normal((k, n)), dtype)
    want = matmul_pallas(aj, bj, tiles=(64, 64, 64), interpret=True)
    got = mm.matmul_cuda(at, bt)
    assert got.dtype == at.dtype and tuple(got.shape) == (m, n)
    # f32: the two sum the k products in another order (≈ √k·ε).
    _close(got, want, dtype, f32_rel=1e-5)


@pytest.mark.parametrize("alpha,beta", [(1.0, -1.0), (-1.0, 1.0)])
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_schur_update_plain_matches_pallas(alpha, beta, m, k, n, dtype):
    rng = _rng(m, k, n, int(alpha) + 1)
    aj, at = _pair(rng.standard_normal((m, k)), dtype)
    bj, bt = _pair(rng.standard_normal((k, n)), dtype)
    cj, ct = _pair(rng.standard_normal((m, n)), dtype)
    want = schur_update_pallas(cj, aj, bj, alpha=alpha, beta=beta,
                               tiles=(64, 64, 64), interpret=True)
    got = mm.schur_update_cuda(ct, at, bt, alpha=alpha, beta=beta)
    assert got.dtype == ct.dtype
    _close(got, want, dtype, f32_rel=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_out_dtype_f32_keeps_the_accumulator(dtype):
    rng = _rng(7)
    aj, at = _pair(rng.standard_normal((64, 128)), dtype)
    bj, bt = _pair(rng.standard_normal((128, 64)), dtype)
    cj, ct = _pair(rng.standard_normal((64, 64)), dtype)
    want = matmul_pallas(aj, bj, tiles=(64, 64, 64), interpret=True,
                         out_dtype=jnp.float32)
    got = mm.matmul_cuda(at, bt, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _close(got, want, "float32", f32_rel=1e-5)
    want = schur_update_pallas(cj, aj, bj, tiles=(64, 64, 64), interpret=True,
                               out_dtype=jnp.float32)
    got = mm.schur_update_cuda(ct, at, bt, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _close(got, want, "float32", f32_rel=1e-5)


@pytest.mark.parametrize("grid", [1, 2, 4])
def test_grid_ops_match_reference(grid):
    bs = 32
    rng = _rng(grid)
    blocks = [rng.standard_normal((grid, grid, bs, bs)).astype(np.float32)
              for _ in range(3)]
    (aj, at), (bj, bt), (cj, ct) = [_pair(x, "float32") for x in blocks]
    got = mm_ops.grid_matmul(at, bt)
    want = jmm_ops.grid_matmul(aj, bj)
    assert tuple(got.shape) == (grid, grid, bs, bs)
    _close(got, want, "float32", f32_rel=1e-5)
    got = mm_ops.grid_schur_update(ct, at, bt, alpha=-1.0, beta=1.0)
    want = jmm_ops.grid_schur_update(cj, aj, bj, alpha=-1.0, beta=1.0)
    _close(got, want, "float32", f32_rel=1e-5)
    dense = mm_ops.blocks_to_dense(at)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jmm_ops.blocks_to_dense(aj)))
    assert torch.equal(mm_ops.dense_to_blocks(dense, bs), at)


def test_gemm_wrappers_reject_what_the_kernel_does_not_take():
    a, b = torch.zeros(8, 4), torch.zeros(4, 8)
    with pytest.raises(ValueError):
        mm.matmul_cuda(a, torch.zeros(5, 8))                    # contraction
    with pytest.raises(ValueError):
        mm.matmul_cuda(a, b.to(torch.bfloat16))                 # mixed dtypes
    with pytest.raises(ValueError):
        mm.matmul_cuda(a.to(torch.int32), b.to(torch.int32))    # int operands
    with pytest.raises(ValueError):
        mm.matmul_cuda(a[None], b)                              # rank 3
    with pytest.raises(ValueError):
        mm.matmul_cuda(a.half(), b.half(), out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        mm.schur_update_cuda(torch.zeros(8, 7), a, b)           # C shape


# ---------------------------------------------------------------------------
# The tensor-core body's f32 arithmetic: the 3xTF32 split, in plain PyTorch
# ---------------------------------------------------------------------------

_SPLIT_VALUES = {
    "normal": lambda rng: rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096),
    "zero": lambda rng: np.array([0.0, -0.0]),
    # f32 subnormals, down to the smallest, 2^-149
    "subnormal": lambda rng: np.concatenate([rng.uniform(-1, 1, 512) * 2.0 ** -126,
                                             [2.0 ** -149, -(2.0 ** -140)]]),
    # large, short of (2 - 2^-11)·2^127, where hi would round to inf
    "large": lambda rng: np.concatenate([rng.uniform(-3.4, 3.4, 512) * 1e38,
                                         [3.4e38, -3.4e38, 1e38]]),
}


@pytest.mark.parametrize("kind", sorted(_SPLIT_VALUES))
def test_tf32_split_keeps_ten_bits_and_recovers_x(kind):
    x = torch.from_numpy(_SPLIT_VALUES[kind](_rng(len(kind))).astype(np.float32))
    hi, lo = mm_ref.tf32_split_ref(x)
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())   # 10 explicit bits
        assert bool(torch.isfinite(part).all())
    # hi is the nearest TF32 value: within half a TF32 ulp, 2^-11 of |x|.
    # Below the normal range the TF32 step is fixed at 2^-136, so there
    # the bounds below hold with a floor of half of it, 2^-137.
    floor = 2.0 ** -137 if kind == "subnormal" else 0.0
    x64 = x.double()
    assert bool(((x64 - hi.double()).abs() <= (2.0 ** -11 * x64.abs()).clamp(min=floor)).all())
    # x - hi is exact, so hi + lo misses x only by lo's rounding: 2^-22 of |x|.
    err = (x64 - hi.double() - lo.double()).abs()
    assert bool((err <= (2.0 ** -22 * x64.abs()).clamp(min=floor)).all())
    # ties round away from zero, as cvt.rna does
    ties = torch.tensor([1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 3 * 2 ** -11])
    assert mm_ref.tf32_split_ref(ties)[0].tolist() == [1.0 + 2 ** -10, -(1.0 + 2 ** -10),
                                                      1.0 + 2 ** -9]


def _split_tolerance(a: np.ndarray, b: np.ndarray) -> torch.Tensor:
    # Entrywise bound of |split − exact| plus both sides' f32 summation:
    # each product of the parts misses a·b by at most 3·2^-22·|a||b| (lo's
    # rounding on either side and the dropped lo·lo), and a k-term f32 sum
    # is off by at most k·2^-24 of Σ|a||b| (twice: both sides sum in f32).
    k = a.shape[1]
    return torch.from_numpy((3 * 2.0 ** -22 + 2 * k * 2.0 ** -24) * (np.abs(a) @ np.abs(b)))


SPLIT_SHAPES = GEMM_SHAPES + [(100, 37, 129), (1, 300, 1), (65, 1, 63)]


@pytest.mark.parametrize("m,k,n", SPLIT_SHAPES)
def test_matmul_split_matches_pallas(m, k, n):
    rng = _rng(m, k, n, 5)
    a, b = (rng.standard_normal(s).astype(np.float32) for s in ((m, k), (k, n)))
    tiles = (64, 64, 64) if (m, k, n) in GEMM_SHAPES else (m, n, k)   # ragged: one block
    want = matmul_pallas(jnp.asarray(a), jnp.asarray(b), tiles=tiles, interpret=True)
    got = mm_ref.matmul_split_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    err = (got.double() - torch.from_numpy(np.asarray(want, np.float64))).abs()
    assert bool((err <= _split_tolerance(a, b)).all()), float(err.max())


@pytest.mark.parametrize("alpha,beta", [(1.0, -1.0), (-1.0, 1.0)])
@pytest.mark.parametrize("m,k,n", SPLIT_SHAPES)
def test_schur_update_split_matches_pallas(alpha, beta, m, k, n):
    rng = _rng(m, k, n, 6)
    a, b, c = (rng.standard_normal(s).astype(np.float32) for s in ((m, k), (k, n), (m, n)))
    tiles = (64, 64, 64) if (m, k, n) in GEMM_SHAPES else (m, n, k)   # ragged: one block
    want = schur_update_pallas(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b),
                               alpha=alpha, beta=beta, tiles=tiles, interpret=True)
    # the tensor-core body's epilogue: alpha·acc + beta·C in f32
    got = alpha * mm_ref.matmul_split_ref(torch.from_numpy(a), torch.from_numpy(b)) \
        + beta * torch.from_numpy(c)
    err = (got.double() - torch.from_numpy(np.asarray(want, np.float64))).abs()
    # plus one rounding of the f32 combination on each side
    tol = _split_tolerance(a, b) + 2.0 ** -23 * torch.from_numpy(
        np.abs(np.asarray(want, np.float64)))
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.parametrize("m,n,k,dtype,sms,want", [
    (8192, 8192, 8192, torch.float32, 132, ("tensor_core", 128)),   # top level
    (2048, 2048, 2048, torch.float32, 132, ("tensor_core", 128)),   # 256 tiles
    (1024, 1024, 1024, torch.float32, 132, ("tensor_core", 64)),    # 64 tiles
    (1408, 1536, 64, torch.float32, 132, ("tensor_core", 128)),     # 132 tiles
    (1408, 1408, 64, torch.float32, 132, ("tensor_core", 64)),      # 121 tiles
    (1024, 1024, 1024, torch.float32, 16, ("tensor_core", 128)),    # a small card
    (15360, 1280, 1024, torch.float32, 132, ("tensor_core", 128)),  # a solve panel
    (1, 1, 1, torch.float32, 132, ("tensor_core", 64)),
    (100, 129, 37, torch.bfloat16, 132, ("tensor_core", 64)),
    (4096, 4096, 4096, torch.float16, 132, ("tensor_core", 128)),
    (64, 80, 0, torch.float32, 132, ("ffma", None)),                # beta·C only
    (64, 80, 0, torch.bfloat16, 132, ("ffma", None)),
    (0, 80, 16, torch.float32, 132, ("empty", None)),
    (80, 0, 16, torch.float16, 132, ("empty", None)),
])
def test_gemm_route(m, n, k, dtype, sms, want):
    assert mm.gemm_route(m, n, k, dtype, sms) == want


def test_gemm_route_rejects_other_dtypes():
    with pytest.raises(ValueError):
        mm.gemm_route(8, 8, 8, torch.float64, 132)


# ---------------------------------------------------------------------------
# B4 scalar and B3 blocked Gauss–Jordan
# ---------------------------------------------------------------------------


def _spd_blocks(batch: int, bs: int, seed: int) -> np.ndarray:
    rng = _rng(seed, bs)
    out = []
    for _ in range(batch):
        b = rng.standard_normal((bs, bs))
        out.append(b @ b.T / bs + np.eye(bs))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("batch,bs", [(1, 16), (3, 32), (1, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gauss_jordan_plain_matches_pallas(batch, bs, dtype):
    xj, xt = _pair(_spd_blocks(batch, bs, 1), dtype)
    want = leaf_inverse_pallas(xj, interpret=True)
    got = gj.leaf_inverse_cuda(xt)
    assert got.dtype == xt.dtype
    # Same pivot-free steps in the same order: equal up to the rounding of
    # fused versus separate multiply-subtract, ≈ 1e-5 after bs steps.
    _close(got, want, dtype, f32_rel=1e-5)


@pytest.mark.parametrize("batch,bs,panel", [(1, 32, 8), (2, 64, 16), (1, 64, None),
                                            (1, 48, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_gauss_jordan_plain_matches_pallas(batch, bs, panel, dtype):
    xj, xt = _pair(_spd_blocks(batch, bs, 2), dtype)
    want = blocked_leaf_inverse_pallas(xj, panel=panel, interpret=True)
    got = gj.blocked_leaf_inverse_cuda(xt, panel=panel)
    assert got.dtype == xt.dtype
    # The rank-t updates sum t products in another order than the MXU
    # emulation: 1e-5 of the largest entry at condition ≈ 10.
    _close(got, want, dtype, f32_rel=1e-5)


@pytest.mark.parametrize("bs,panel", [(32, 8), (64, 16), (64, 64)])
def test_plain_versions_step_exact_against_jax_refs(bs, panel):
    xj, xt = _pair(_spd_blocks(2, bs, 3), "float32")
    _close(gj_ref.gauss_jordan_ref(xt), jgj_ref.gauss_jordan_ref(xj),
           "float32", f32_rel=1e-5)
    _close(gj_ref.blocked_gauss_jordan_ref(xt, panel),
           jgj_ref.blocked_gauss_jordan_ref(xj, panel), "float32", f32_rel=1e-5)
    # Pivot-free Gauss–Jordan against LAPACK's pivoted inverse: the
    # algorithm's own error at condition ≈ 10.
    _close(gj_ref.gauss_jordan_ref(xt), jgj_ref.leaf_inverse_ref(xj),
           "float32", f32_rel=1e-4)


@pytest.mark.parametrize("bs,panel", [(32, 8), (64, 16), (48, 16), (64, 64), (96, 48)])
def test_blocked_gauss_jordan_kernel_model_matches_pallas(bs, panel):
    """The CUDA kernel's step order (in place, D⁻¹ as 2 x 2 blocks of 32
    above t = 32, one W·R product a panel, the panel's rows and columns
    zeroed) against the Pallas kernel's [A | I] sweep."""
    xj, xt = _pair(_spd_blocks(2, bs, 14), "float32")
    want = blocked_leaf_inverse_pallas(xj, panel=panel, interpret=True)
    got = gj_ref.blocked_gauss_jordan_inplace_model(xt, panel)
    assert got.dtype == torch.float32
    # Another order of the same pivot-free elimination: the pivot blocks
    # inverted apart, then one product a panel. 1e-5 of the largest entry
    # at condition ≈ 10, as for the plain version.
    _close(got, want, "float32", f32_rel=1e-5)
    assert gj_ref.blocked_gauss_jordan_inplace_model(
        xt.to(torch.bfloat16), panel, out_dtype=torch.float32).dtype == torch.float32


def _full_sweep_gauss_jordan(blocks: torch.Tensor) -> torch.Tensor:
    """The scalar sweep on the whole [A | I], as the kernel ran it before it
    went in place: every step over all 2·bs columns."""
    batch, bs, _ = blocks.shape
    eye = torch.eye(bs, dtype=torch.float32).expand(batch, bs, bs)
    m = torch.cat([blocks.float(), eye], dim=2)
    for k in range(bs):
        row = m[:, k, :] / m[:, k, k:k + 1]
        fac = m[:, :, k].clone()
        fac[:, k] = 0.0
        m = m - fac[:, :, None] * row[:, None, :]
        m[:, k, :] = row
    return m[:, :, bs:]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [1, 2, 7, 32, 64, 128])
def test_in_place_gauss_jordan_equals_full_sweep_bitwise(bs, dtype, seed):
    _, xt = _pair(_spd_blocks(2, bs, 10 + seed), dtype)
    got = gj_ref.gauss_jordan_ref(xt, out_dtype=torch.float32)
    assert torch.equal(got, _full_sweep_gauss_jordan(xt))


def test_leaf_ops_single_and_batched():
    x = torch.from_numpy(_spd_blocks(3, 32, 4))
    assert torch.equal(gj_ops.batched_leaf_inverse(x), gj_ref.gauss_jordan_ref(x))
    assert torch.equal(gj_ops.leaf_inverse(x[1]), gj_ref.gauss_jordan_ref(x[1:2])[0])
    assert torch.equal(gj_ops.blocked_leaf_inverse(x[0], panel=8),
                       gj_ref.blocked_gauss_jordan_ref(x[:1], 8)[0])
    assert torch.equal(gj_ops.batched_blocked_leaf_inverse(x),
                       gj_ref.blocked_gauss_jordan_ref(x, gj.default_panel(32)))
    out = gj_ops.leaf_inverse(x[0].to(torch.bfloat16), out_dtype=torch.float32)
    assert out.dtype == torch.float32


@pytest.mark.parametrize("bs", [16, 48, 64, 96, 1024])
def test_default_panel_matches_reference(bs):
    from repro.kernels.leaf_inverse.kernel import default_panel as j_default_panel

    assert gj.default_panel(bs) == j_default_panel(bs)


def test_leaf_wrappers_reject_what_the_kernel_does_not_take():
    x = torch.eye(16)[None]
    with pytest.raises(ValueError):
        gj.leaf_inverse_cuda(torch.zeros(1, 16, 8))              # not square
    with pytest.raises(ValueError):
        gj.leaf_inverse_cuda(torch.eye(16))                      # rank 2
    with pytest.raises(ValueError):
        gj.blocked_leaf_inverse_cuda(x, panel=5)                 # 5 ∤ 16
    with pytest.raises(ValueError):
        gj.leaf_inverse_cuda(x.double())                         # f64
    with pytest.raises(ValueError):
        gj.leaf_inverse_cuda(x, out_dtype=torch.int32)


# ---------------------------------------------------------------------------
# B5 blocked triangular solve
# ---------------------------------------------------------------------------


def _triangular_system(bs: int, k: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """A FULL matrix (the solve must ignore its untargeted triangle) and
    right-hand sides. Off-diagonals are scaled down: a unit-diagonal
    substitution amplifies N(0, 1) off-diagonals exponentially, which
    tests overflow, not the solve."""
    rng = _rng(seed, bs, k)
    full = rng.standard_normal((bs, bs)) / 8 + 5 * np.eye(bs)
    return full.astype(np.float32), rng.standard_normal((bs, k)).astype(np.float32)


@pytest.mark.parametrize("k", [1, 5, 33])
@pytest.mark.parametrize("bs,panel", [(16, 8), (16, None), (64, 8), (64, None)])
@pytest.mark.parametrize("unit", [True, False], ids=["unit", "diag"])
@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
def test_blocked_triangular_solve_plain_matches_pallas(lower, unit, bs, panel, k):
    full, rhs = _triangular_system(bs, k, int(lower) + 2 * int(unit))
    (tj, tt), (bj, bt) = _pair(full, "float32"), _pair(rhs, "float32")
    want = jgj_ops.triangular_solve(tj, bj, lower=lower, unit_diagonal=unit,
                                    panel=panel)
    got = gj_ops.triangular_solve(tt, bt, lower=lower, unit_diagonal=unit,
                                  panel=panel)
    assert got.dtype == bt.dtype and tuple(got.shape) == (bs, k)
    # The same steps in the same order; the rank-t updates sum their t
    # products in another order than the MXU emulation.
    _close(got, want, "float32", f32_rel=1e-5)
    oracle = gj_ref.triangular_solve_ref(tt[None], bt[None], lower=lower,
                                         unit_diagonal=unit)[0]
    _close(got, jgj_ref.triangular_solve_ref(tj[None], bj[None], lower=lower,
                                              unit_diagonal=unit)[0],
           "float32", f32_rel=1e-5)
    assert float((got - oracle).abs().max()) <= 1e-5 * float(oracle.abs().max())


@pytest.mark.parametrize("k", [1, 5, 33])
@pytest.mark.parametrize("bs,panel", [(64, 16), (48, 16), (64, 64)])
@pytest.mark.parametrize("unit", [True, False], ids=["unit", "diag"])
@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
def test_triangular_solve_kernel_model_matches_pallas(lower, unit, bs, panel, k):
    """The CUDA kernel's step order (every D_p⁻¹ first, P = [−D_p⁻¹·T[p, <p]
    | D_p⁻¹], then one product a panel over [X; B_p], the upper sweep
    flipped) against the Pallas kernel, on a full matrix whose untargeted
    triangle the solve must ignore."""
    full, rhs = _triangular_system(bs, k, 5 + int(lower) + 2 * int(unit))
    (tj, tt), (bj, bt) = _pair(full, "float32"), _pair(rhs, "float32")
    want = jgj_ops.triangular_solve(tj, bj, lower=lower, unit_diagonal=unit, panel=panel)
    got = gj_ref.triangular_solve_dinv_model(tt[None], bt[None], panel, lower=lower,
                                             unit_diagonal=unit)[0]
    assert got.dtype == bt.dtype and tuple(got.shape) == (bs, k)
    # The same solution: D_p⁻¹ applied as a product instead of a sweep on
    # [D_p | rhs_p], and the panel updates summed in another order.
    _close(got, want, "float32", f32_rel=1e-5)


@pytest.mark.parametrize("k,batch,sms,want", [
    (15616, 1, 132, 64), (4352, 1, 132, 64), (2304, 1, 132, 32), (1280, 1, 132, 16),
    (256, 1, 132, 8), (1, 1, 132, 8), (1024, 4, 132, 32), (300, 2, 8, 64)])
def test_tri_strip_rule(k, batch, sms, want):
    strip = gj.tri_strip(k, batch, sms)
    assert strip == want and strip in gj.TRI_STRIPS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_triangular_solve_lu_round_trip(dtype):
    """Packed LU: the unit-lower sweep, then the upper sweep, solve the
    original system, as the reference's round trip does."""
    a = _spd_blocks(1, 64, 12)[0]
    rhs = _rng(13).standard_normal((64, 4)).astype(np.float32)
    lu, pivots = torch.linalg.lu_factor(torch.from_numpy(a))
    perm = torch.lu_unpack(lu, pivots, unpack_data=False)[0].argmax(dim=0)
    bt = torch.from_numpy(rhs)[perm].to(getattr(torch, dtype))
    y = gj_ops.triangular_solve(lu, bt, lower=True, unit_diagonal=True)
    x = gj_ops.triangular_solve(lu, y, lower=False)
    assert x.dtype == bt.dtype
    want = np.linalg.solve(a.astype(np.float64), rhs)
    atol = 1e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(x.float().numpy(), want, atol=atol)
    jlu, _, jperm = jax.lax.linalg.lu(jnp.asarray(a))
    jy = jgj_ops.triangular_solve(jlu, jnp.asarray(rhs)[jperm], lower=True,
                                  unit_diagonal=True)
    jx = jgj_ops.triangular_solve(jlu, jy, lower=False)
    if dtype == "float32":
        _close(x, jx, "float32", f32_rel=1e-5)


def test_triangular_solve_wrapper_rejects_what_the_kernel_does_not_take():
    t, b = torch.eye(16)[None], torch.ones(1, 16, 3)
    with pytest.raises(ValueError):
        gj.triangular_solve_cuda(torch.zeros(1, 16, 8), b)           # not square
    with pytest.raises(ValueError):
        gj.triangular_solve_cuda(t, torch.ones(1, 8, 3))             # rows
    with pytest.raises(ValueError):
        gj.triangular_solve_cuda(t, torch.ones(2, 16, 3))            # batch
    with pytest.raises(ValueError):
        gj.triangular_solve_cuda(t, b, panel=5)                      # 5 ∤ 16
    with pytest.raises(ValueError):
        gj.triangular_solve_cuda(t.double(), b)                      # f64
    with pytest.raises(ValueError):
        gj.triangular_solve_cuda(t[0], b[0])                         # rank 2
    assert torch.equal(gj.triangular_solve_cuda(t, b), b)


@pytest.mark.parametrize("bs", [1, 8, 32])
def test_lu_leaf_plain_matches_reference(bs):
    """The LU baseline's leaf: the port's plain loop (its CPU path, and the
    card path's plain version) against the reference's `fori_loop`."""
    import importlib

    from repro.core.lu_inverse import _local_lu as j_local_lu

    lu_mod = importlib.import_module("repro_torch.core.lu_inverse")
    xj, xt = _pair(_spd_blocks(1, bs, 15)[0], "float32")
    packed = lu_mod._local_lu_plain(xt)
    l, u = lu_mod._local_lu(xt)
    assert torch.equal(l, torch.tril(packed, -1) + torch.eye(bs))
    assert torch.equal(u, torch.triu(packed))
    jl, ju = j_local_lu(xj)
    # The same unpivoted steps; the reference updates the whole trailing
    # block as one outer product, the port row by row.
    _close(l, jl, "float32", f32_rel=1e-5)
    _close(u, ju, "float32", f32_rel=1e-5)


def test_cpu_calls_launch_no_kernel():
    kernels.reset_launch_counts()
    mm.matmul_cuda(torch.ones(4, 4), torch.ones(4, 4))
    mm.schur_update_cuda(torch.ones(4, 4), torch.ones(4, 4), torch.ones(4, 4))
    gj.leaf_inverse_cuda(torch.eye(4)[None])
    gj.blocked_leaf_inverse_cuda(torch.eye(4)[None])
    gj.triangular_solve_cuda(torch.eye(4)[None], torch.ones(1, 4, 2))
    fa.flash_attention_cuda(torch.ones(1, 2, 4, 16), torch.ones(1, 1, 4, 16),
                            torch.ones(1, 1, 4, 16))
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}


# ---------------------------------------------------------------------------
# B6 flash attention
# ---------------------------------------------------------------------------

# The reference's own bounds (tests/test_flash_attention.py): bf16 keeps 8
# mantissa bits; in f32 the versions differ in summation order only.
FLASH_TOL = {"float32": 2e-3, "bfloat16": 2e-2}


def _qkv(b, h, kv, sq, skv, hd, dtype, *key):
    rng = _rng(*key)
    return (_pair(rng.standard_normal((b, h, sq, hd)), dtype),
            _pair(rng.standard_normal((b, kv, skv, hd)), dtype),
            _pair(rng.standard_normal((b, kv, skv, hd)), dtype))


def _flash_err(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    return float((got.float() - want).abs().max())


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 1), (8, 2)], ids=["mha", "mqa", "gqa"])
def test_flash_attention_plain_matches_pallas(h, kv, causal, dtype, hd):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, h, kv, 64, 64, hd, dtype, h, kv, hd)
    got = fa_ops.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    pallas = jfa_ops.flash_attention(qj, kj, vj, causal=causal, bq=32, bk=32)
    oracle = jfa_ref.attention_ref(qj, kj, vj, causal=causal)
    assert _flash_err(got, pallas) < FLASH_TOL[dtype]
    assert _flash_err(got, oracle) < FLASH_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sq,skv", [(50, 50), (37, 50), (50, 37)])
def test_flash_attention_plain_takes_a_ragged_sequence(sq, skv, causal, dtype):
    """The Pallas kernel wants S divisible by its blocks; the port's kernel
    masks the last tile. Ragged shapes are held to the JAX oracle, and the
    square one to the model's chunked scan as well."""
    from repro.models.attention import _attend_chunked

    (qj, qt), (kj, kt), (vj, vt) = _qkv(1, 8, 2, sq, skv, 32, dtype, sq, skv)
    got = fa_ops.flash_attention(qt, kt, vt, causal=causal)
    assert _flash_err(got, jfa_ref.attention_ref(qj, kj, vj, causal=causal)) \
        < FLASH_TOL[dtype]
    if sq == skv:
        scan = _attend_chunked(*(x.transpose(0, 2, 1, 3) for x in (qj, kj, vj)),
                               causal=causal, window=0, q_chunk=sq, kv_chunk=skv)
        assert _flash_err(got, scan.transpose(0, 2, 1, 3)) < FLASH_TOL[dtype]


def test_flash_attention_plain_takes_strided_views():
    (_, qt), (_, kt), (_, vt) = _qkv(2, 4, 2, 40, 40, 16, "float32", 3)
    want = fa.flash_attention_cuda(qt, kt, vt)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (qt, kt, vt)]
    assert torch.equal(fa.flash_attention_cuda(*views), want)


def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take():
    q, k = torch.zeros(1, 3, 8, 16), torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_cuda(q, k, k)                                    # 3 % 2
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, k, k.bfloat16())                        # dtypes
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, k, torch.zeros(1, 2, 9, 16))            # v shape
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, torch.zeros(1, 2, 8, 8), torch.zeros(1, 2, 8, 8))
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q.double(), k.double(), k.double())        # f64
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q[0], k[0], k[0])                          # rank 3
    with pytest.raises(ValueError, match="empty"):
        fa.flash_attention_cuda(q, k[:, :, :0], k[:, :, :0])


# ---------------------------------------------------------------------------
# Bridge, device rule, package isolation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_bridge_round_trip_keeps_bits(dtype):
    j = jnp.asarray(_rng(5).standard_normal((8, 8)), jnp.float32).astype(dtype)
    t = bridge.to_torch(np.asarray(j), device="cpu")
    assert t.dtype == getattr(torch, dtype)
    back = bridge.to_numpy(t)
    assert back.dtype == np.asarray(j).dtype
    np.testing.assert_array_equal(back.view(np.uint8), np.asarray(j).view(np.uint8))


def test_bridge_blocks_and_op_counts():
    a = j_make_spd(64, jax.random.PRNGKey(0))
    jbm = JBlockMatrix.from_dense(a, 16)
    with j_count_ops() as counts:
        j_spin_inverse(jbm)
    bm = bridge.blockmatrix_from_numpy(np.asarray(jbm.blocks), device="cpu")
    assert isinstance(bm, BlockMatrix) and bm.grid == 4 and bm.block_size == 16
    np.testing.assert_array_equal(bm.to_dense().numpy(), np.asarray(a))
    oc = bridge.op_counts_from_dict(counts.as_dict())
    assert oc.as_dict() == counts.as_dict()
    with pytest.raises(ValueError):
        bridge.blockmatrix_from_numpy(np.zeros((2, 3, 4, 4), np.float32), device="cpu")


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.core import lu_inverse_dense, spin_inverse_dense, testing, verify

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = torch.eye(32)
    for call in (lambda: spin_inverse_dense(a, 16),
                 lambda: lu_inverse_dense(a, 16),
                 lambda: testing.make_spd(32, np.random.default_rng(0)),
                 lambda: verify.run_conformance(grids=(2,)),
                 lambda: BlockMatrix.zeros(2, 16),
                 lambda: bridge.to_torch(np.eye(4, dtype=np.float32)),
                 lambda: bridge.blockmatrix_from_numpy(np.zeros((2, 2, 4, 4), np.float32))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert spin_inverse_dense(a, 16, device="cpu").device.type == "cpu"


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys, numpy as np\n"
        "import repro_torch\n"
        "from repro_torch.core import spin_inverse_dense, testing, verify\n"
        "a = testing.make_spd(64, np.random.default_rng(0), device='cpu')\n"
        "x = spin_inverse_dense(a, 16, 'cuda', engine='cuda', device='cpu')\n"
        "assert verify.inverse_residual(a, x) < 1e-3\n"
        "import torch\n"
        "from repro_torch.configs import get_arch\n"
        "from repro_torch.models import transformer as T\n"
        "from repro_torch.serving import Request, ServingEngine\n"
        "import repro_torch.launch.serve, repro_torch.profile_lm\n"
        "cfg = get_arch('granite-8b').reduced()\n"
        "p = T.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "T.prefill(p, {'tokens': torch.zeros(1, 8, dtype=torch.int64)}, cfg)\n"
        "eng = ServingEngine(cfg, p, slots=1, max_len=16)\n"
        "eng.submit(Request(uid=0, prompt=[1, 2], max_new_tokens=2))\n"
        "eng.run_until_done()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_port_sources_have_no_jax_reference_or_spin_names():
    # A SPIN_* name may appear only as a knob of the port's own envconfig
    # table, each the JAX package's registered knob of the same name.
    from repro import envconfig as j_envconfig
    from repro_torch import envconfig

    knobs = set(envconfig.ENV_VARS)
    assert knobs <= j_envconfig.registered_names()
    forbidden = [re.compile(r"^\s*(import|from)\s+jax\b", re.M),
                 re.compile(r"^\s*(import|from)\s+repro(\.|\s|$)", re.M)]
    spin_names = re.compile(r"SPIN_[A-Z0-9_]*")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        text = path.read_text()
        for pat in forbidden:
            assert not pat.search(text), f"{path}: {pat.pattern}"
        assert set(spin_names.findall(text)) <= knobs, path
