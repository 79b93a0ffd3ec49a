"""The SMW update of a maintained inverse: the PyTorch port against the JAX
package.

Each matrix of the zoo, each inverse and each rank-k factor is made once on
the CPU from a numpy seed and handed bit for bit to both packages; the
inverse is LAPACK's, so both update the same operand. Tolerances:

  * f32: max |X_port − X_ref| ≤ 1e-4 · max |X_ref|. Both packages sum the
    same f32 panel products in other orders, ≈ √n · 2⁻²⁴ of each sum;
    1e-4 leaves room for the capacitance solve's amplification at the
    zoo's worst conditioning.
  * the bf16 serve GEMM: 2⁻⁷ of the largest entry, one bf16 ulp of the
    operands' rounding, which both packages do before an f32 sum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlockMatrix as JBlockMatrix
from repro.core import DriftTracker as JDriftTracker
from repro.core import add_low_rank as j_add_low_rank
from repro.core import apply_inverse as j_apply_inverse
from repro.core import block_update_factors as j_block_update_factors
from repro.core import count_ops as j_count_ops
from repro.core import estimate_inverse_residual as j_estimate
from repro.core import smw_update_inverse as j_smw_update_inverse
from repro.core import smw_update_solve as j_smw_update_solve
from repro_torch import bridge
from repro_torch.core import (BlockMatrix, DriftTracker, add_low_rank,
                              apply_inverse, block_update_factors, count_ops,
                              estimate_inverse_residual, smw_update_inverse,
                              smw_update_solve, spin_inverse_dense, testing,
                              verify)

N, BS = 128, 32
FAMILIES = sorted(testing.MATRIX_FAMILIES)
REL = 1e-4
BF16_REL = 2.0 ** -7


def _matrix(family: str, seed: int = 7, dtype=torch.float32) -> torch.Tensor:
    rng = np.random.default_rng([seed, FAMILIES.index(family)])
    kwargs = {"cond": 1e4} if family == "ill_conditioned_spd" else {}
    if family == "block_banded_spd":
        kwargs["band"] = BS
    return testing.MATRIX_FAMILIES[family](N, rng, dtype=dtype, device="cpu",
                                           **kwargs)


def _rank_k(k: int, seed: int, dtype=torch.float32) -> torch.Tensor:
    # U Uᵀ keeps the operand SPD (the paper's class) after the update.
    u = np.random.default_rng([seed, k]).standard_normal((N, k), dtype=np.float32)
    return torch.from_numpy(u / np.float32(N ** 0.5)).to(dtype)


def _j(t: torch.Tensor):
    return jnp.asarray(bridge.to_numpy(t))


def _t(x) -> torch.Tensor:
    return bridge.to_torch(np.asarray(x), "cpu")


def _dense(x) -> torch.Tensor:
    if isinstance(x, BlockMatrix):
        return x.to_dense()
    if isinstance(x, JBlockMatrix):
        return _t(x.to_dense())
    return x if isinstance(x, torch.Tensor) else _t(x)


def _assert_close(got, want, rel: float = REL) -> None:
    got, want = _dense(got).float(), _dense(want).float()
    assert got.shape == want.shape
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale, (err, rel * scale)


def _wrap(inv: torch.Tensor, rep: str):
    """The same inverse in the port's and the reference's representation."""
    if rep == "block":
        return BlockMatrix.from_dense(inv, BS), JBlockMatrix.from_dense(_j(inv), BS)
    return inv, _j(inv)


@pytest.mark.parametrize("rep", ["dense", "block"])
@pytest.mark.parametrize("family", FAMILIES)
def test_smw_update_inverse_matches_reference_across_zoo(family, rep):
    a = _matrix(family)
    u = _rank_k(4, seed=11)
    inv = torch.linalg.inv(a)
    port_inv, ref_inv = _wrap(inv, rep)
    got = smw_update_inverse(port_inv, u, u)
    want = j_smw_update_inverse(ref_inv, _j(u), _j(u))
    assert type(got) is (BlockMatrix if rep == "block" else torch.Tensor)
    _assert_close(got, want)
    # and it is the inverse of the updated matrix, as a fresh SPIN inversion
    tol = verify.residual_tolerance(torch.float32)
    tol = tol * 1e2 if family == "ill_conditioned_spd" else tol
    a2 = add_low_rank(a, u, u)
    fresh = spin_inverse_dense(a2, BS, device="cpu")
    assert float((_dense(got) - fresh).abs().max() / fresh.abs().max()) < tol
    assert verify.inverse_residual(a2, _dense(got)) < tol


@pytest.mark.parametrize("rep", ["dense", "block"])
def test_smw_update_solve_matches_reference(rep):
    a = _matrix("spd", seed=5)
    u, v = _rank_k(4, seed=6), _rank_k(4, seed=9)
    rhs = _rank_k(3, seed=8)
    port_inv, ref_inv = _wrap(torch.linalg.inv(a), rep)
    x = smw_update_solve(port_inv, u, v, rhs)
    _assert_close(x, j_smw_update_solve(ref_inv, _j(u), _j(v), _j(rhs)))
    want = spin_inverse_dense(add_low_rank(a, u, v), BS, device="cpu") @ rhs
    assert float((x - want).abs().max()) < 1e-3
    # a vector rhs keeps its shape and is bitwise the 1-column panel solve
    xv = smw_update_solve(port_inv, u, v, rhs[:, 0])
    assert xv.shape == (N,)
    assert torch.equal(xv, smw_update_solve(port_inv, u, v, rhs[:, :1])[:, 0])


def test_sherman_morrison_vector_case():
    a = _matrix("spd", seed=3)
    u = _rank_k(1, seed=4)[:, 0]
    inv = torch.linalg.inv(a)
    smw = smw_update_inverse(inv, u, u)
    _assert_close(smw, j_smw_update_inverse(_j(inv), _j(u), _j(u)))
    assert verify.inverse_residual(a + torch.outer(u, u), smw) < 1e-3


def test_chained_updates_stay_conformant():
    a = _matrix("spd")
    inv = spin_inverse_dense(a, BS, device="cpu")
    for i in range(4):
        u = _rank_k(2, seed=20 + i)
        a = add_low_rank(a, u, u)
        inv = smw_update_inverse(inv, u, u)
    assert verify.inverse_residual(a, inv) < verify.residual_tolerance(torch.float32)


@pytest.mark.parametrize("rep", ["dense", "block"])
def test_apply_inverse_and_add_low_rank_match_reference(rep):
    a = _matrix("diag_dominant", seed=12)
    u, v = _rank_k(4, seed=13), _rank_k(4, seed=14)
    rhs = _rank_k(5, seed=15)
    port_inv, ref_inv = _wrap(torch.linalg.inv(a), rep)
    _assert_close(apply_inverse(port_inv, rhs), j_apply_inverse(ref_inv, _j(rhs)))
    port_a, ref_a = _wrap(a, rep)
    got = add_low_rank(port_a, u, v)
    assert type(got) is type(port_a)
    _assert_close(got, j_add_low_rank(ref_a, _j(u), _j(v)))


def test_representations_agree():
    a = _matrix("spd", seed=12)
    u = _rank_k(4, seed=13)
    inv = torch.linalg.inv(a)
    dense = smw_update_inverse(inv, u, u)
    bm = smw_update_inverse(BlockMatrix.from_dense(inv, BS), u, u)
    assert isinstance(bm, BlockMatrix)
    assert float((bm.to_dense() - dense).abs().max()) < 1e-5
    rhs = _rank_k(2, seed=14)
    assert float((apply_inverse(BlockMatrix.from_dense(inv, BS), rhs)
                  - apply_inverse(inv, rhs)).abs().max()) < 1e-5


def test_apply_inverse_bf16_serve_gemm_matches_reference():
    a = _matrix("spd", seed=16)
    inv16 = torch.linalg.inv(a).to(torch.bfloat16)
    rhs = _rank_k(3, seed=17)
    got = apply_inverse(inv16, rhs, precision="bf16")
    want = j_apply_inverse(_j(inv16), _j(rhs), precision="bf16")
    assert got.dtype == torch.float32
    _assert_close(got, want, BF16_REL)
    # the serve GEMM keeps bf16 operands: the same sum as an f32 product of
    # the bf16 values, not of the f32 upcast of a rounded product
    plain = (inv16.float() @ rhs.to(torch.bfloat16).float()).float()
    _assert_close(got, plain, 1e-6)


def test_bf16_storage_meets_bf16_tolerance():
    a = _matrix("spd", seed=15, dtype=torch.bfloat16)
    u = _rank_k(4, seed=16, dtype=torch.bfloat16)
    inv = spin_inverse_dense(a, BS, device="cpu")
    smw = smw_update_inverse(inv, u, u)
    assert smw.dtype == torch.bfloat16
    _assert_close(smw, j_smw_update_inverse(_j(inv), _j(u), _j(u)), BF16_REL)
    assert verify.inverse_residual(add_low_rank(a, u, u), smw) < \
        verify.residual_tolerance(torch.bfloat16)


def test_block_update_factors_match_reference_and_replace_the_block():
    a = _matrix("spd", seed=9)
    r = 2
    rng = np.random.default_rng(10)
    delta = torch.from_numpy(rng.standard_normal((BS, N), dtype=np.float32)) * 0.05
    d = delta[:, r * BS:(r + 1) * BS]
    delta[:, r * BS:(r + 1) * BS] = (d + d.T) / 2
    u, v = block_update_factors(delta, r, N)
    ju, jv = j_block_update_factors(_j(delta), r, N)
    assert u.shape == v.shape == (N, 2 * BS)
    _assert_close(u, ju)
    _assert_close(v, jv)
    # explicit replacement: delta on row r, deltaᵀ on column r, diagonal once
    a2 = a.clone()
    a2[r * BS:(r + 1) * BS, :] += delta
    a2[:, r * BS:(r + 1) * BS] += delta.T
    a2[r * BS:(r + 1) * BS, r * BS:(r + 1) * BS] -= delta[:, r * BS:(r + 1) * BS]
    assert float((add_low_rank(a, u, v) - a2).abs().max()) < 1e-5
    inv2 = smw_update_inverse(torch.linalg.inv(a), u, v)
    _assert_close(inv2, j_smw_update_inverse(_j(torch.linalg.inv(a)), ju, jv))
    assert verify.inverse_residual(a2, inv2) < 1e-3


def test_block_update_factors_validates():
    with pytest.raises(ValueError):
        block_update_factors(torch.zeros((BS, N)), N // BS, N)  # index out of range
    with pytest.raises(ValueError):
        block_update_factors(torch.zeros((BS, N + 1)), 0, N)
    with pytest.raises(ValueError):
        j_block_update_factors(jnp.zeros((BS, N)), N // BS, N)


def test_drift_tracker_equals_reference_field_for_field():
    tr = DriftTracker.for_dtype(torch.float32, scale=10.0)
    jtr = JDriftTracker.for_dtype(jnp.float32, scale=10.0)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jtr)
    for t in (tr, jtr):
        t.note(4)
        t.note(2)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jtr)
    assert (tr.update_rank, tr.updates) == (6, 2)
    assert not tr.exceeded
    tr.residual_est = jtr.residual_est = 2 * tr.tolerance
    assert tr.exceeded and jtr.exceeded
    tr.reset()
    jtr.reset()
    assert dataclasses.asdict(tr) == dataclasses.asdict(jtr)
    assert (DriftTracker.for_dtype(torch.bfloat16).tolerance
            == JDriftTracker.for_dtype(jnp.bfloat16).tolerance)


@pytest.mark.parametrize("scale", [1.0, 1.001, 1.5])
def test_estimate_inverse_residual_bounds_and_reference(scale):
    a = _matrix("spd", seed=17)
    inv = torch.linalg.inv(a) * scale
    # ‖AX − I‖∞, the largest row sum, in f64: the norm a probe bounds
    # from below, since |(R z)_i| ≤ Σ_j |R_ij| · max |z|.
    resid = a.double() @ inv.double() - torch.eye(N, dtype=torch.float64)
    true = float(resid.abs().sum(dim=1).max())
    gen = torch.Generator().manual_seed(18)
    est = estimate_inverse_residual(lambda p: a @ p, inv, gen, N)
    j_est = j_estimate(lambda p: _j(a) @ p, _j(inv), jax.random.PRNGKey(18), N)
    # at most the true norm, up to the f32 rounding of the probe's two
    # products (n · 2⁻²⁴ · ‖A‖ · ‖X‖ ≈ 1e-5 here), and within 10x of the
    # reference's estimate from its own probes
    assert est <= true + 1e-5
    assert j_est / 10 <= est <= j_est * 10
    if scale == 1.0:
        assert est < verify.residual_tolerance(torch.float32)
    if scale == 1.5:
        assert est > verify.residual_tolerance(torch.float32)
    # same generator state, same probes: the estimate is reproducible
    again = estimate_inverse_residual(lambda p: a @ p, inv,
                                      torch.Generator().manual_seed(18), N)
    assert again == est


def test_op_counters_match_reference():
    a = _matrix("spd", seed=19)
    u = _rank_k(2, seed=21)
    inv = torch.linalg.inv(a)
    rhs = _rank_k(3, seed=22)
    with count_ops() as counts:
        smw_update_inverse(inv, u, u)
        smw_update_inverse(BlockMatrix.from_dense(inv, BS), u, u)
        smw_update_solve(BlockMatrix.from_dense(inv, BS), u, u, rhs)
        apply_inverse(BlockMatrix.from_dense(inv, BS), rhs)
        apply_inverse(inv, rhs)
    with j_count_ops() as j_counts:
        j_smw_update_inverse(_j(inv), _j(u), _j(u))
        j_smw_update_inverse(JBlockMatrix.from_dense(_j(inv), BS), _j(u), _j(u))
        j_smw_update_solve(JBlockMatrix.from_dense(_j(inv), BS), _j(u), _j(u), _j(rhs))
        j_apply_inverse(JBlockMatrix.from_dense(_j(inv), BS), _j(rhs))
        j_apply_inverse(_j(inv), _j(rhs))
    assert counts.as_dict() == j_counts.as_dict()
    assert (counts.smw_updates, counts.solve_applies) == (2, 3)
