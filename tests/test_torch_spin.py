"""SPIN inversion and the LU baseline: the PyTorch port against the JAX package.

Each matrix of the zoo is built once (with the port's generators on the
CPU, from a numpy seed) and handed bit for bit to both packages. The JAX
side runs the Pallas kernels in interpret mode, as its own tests do; the
port runs its kernels' plain versions on the CPU. Each case checks the
port's residual against `residual_tolerance`, its elementwise closeness to
the reference's inverse, and its op counts against the paper's oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlockMatrix as JBlockMatrix
from repro.core import count_ops as j_count_ops
from repro.core import lu_inverse as j_lu_inverse
from repro.core import multiply_engine as j_multiply_engine
from repro.core import spin_inverse as j_spin_inverse
from repro.core import spin_inverse_dense as j_spin_inverse_dense
from repro.core import verify as j_verify
from repro_torch import bridge
from repro_torch.core import (BlockMatrix, count_ops, lu_inverse,
                              lu_inverse_dense, multiply_engine,
                              spin_inverse, spin_inverse_dense, testing, verify)
from repro_torch.core.multiply import ENGINES, multiply_blocks

BS = 16
GRIDS = [1, 2, 4, 8]
FAMILIES = ["spd", "diag_dominant", "ill_conditioned_spd", "block_banded_spd"]
# (port, reference) names of the same engine and leaf solver.
ENGINE_PAIRS = [("einsum", "einsum"), ("cuda", "pallas")]
LEAF_PAIRS = [("linalg", "linalg"), ("gauss_jordan", "gauss_jordan"),
              ("cuda", "pallas")]


def _matrix(family: str, n: int, dtype=torch.float32) -> torch.Tensor:
    rng = np.random.default_rng([FAMILIES.index(family), n])
    kwargs = {"cond": 1e4} if family == "ill_conditioned_spd" else {}
    if family == "block_banded_spd":
        kwargs["band"] = BS
    return testing.MATRIX_FAMILIES[family](n, rng, dtype=dtype, device="cpu",
                                           **kwargs)


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


def _to_jax(t: torch.Tensor):
    return jnp.asarray(bridge.to_numpy(t))


def _rel_diff(x: torch.Tensor, ref) -> float:
    ref = torch.from_numpy(np.array(jnp.asarray(ref, jnp.float32)))
    return float((x.float() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("leaf", LEAF_PAIRS, ids=lambda p: p[0])
@pytest.mark.parametrize("engine", ENGINE_PAIRS, ids=lambda p: p[0])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_spin_inverse_dense_matches_reference(family, grid, engine, leaf):
    (eng, j_eng), (lf, j_lf) = engine, leaf
    a = _matrix(family, grid * BS)
    with count_ops() as counts:
        x = spin_inverse_dense(a, BS, lf, engine=eng, device="cpu")
    want = j_spin_inverse_dense(_to_jax(a), BS, j_lf, engine=j_eng)
    res_tol, close_tol = _tolerances(family)
    assert x.dtype == a.dtype and tuple(x.shape) == tuple(a.shape)
    assert verify.inverse_residual(a, x) < res_tol
    assert _rel_diff(x, want) < close_tol
    verify.assert_paper_op_counts(grid, counts)


@pytest.mark.parametrize("engine", ENGINE_PAIRS, ids=lambda p: p[0])
@pytest.mark.parametrize("grid", GRIDS)
def test_op_counts_equal_reference(grid, engine):
    (eng, j_eng) = engine
    a = _matrix("spd", grid * BS)
    with count_ops() as counts, multiply_engine(eng):
        spin_inverse(BlockMatrix.from_dense(a, BS), leaf_solver="linalg")
    with j_count_ops() as j_counts, j_multiply_engine(j_eng):
        j_spin_inverse(JBlockMatrix.from_dense(_to_jax(a), BS))
    assert counts.as_dict() == bridge.op_counts_from_dict(j_counts.as_dict()).as_dict()
    assert counts.as_dict() == verify.expected_spin_counts(grid).as_dict()


@pytest.mark.parametrize("engine", ENGINE_PAIRS, ids=lambda p: p[0])
def test_bf16_operand_matches_reference(engine):
    eng, j_eng = engine
    a = _matrix("spd", 128, torch.bfloat16)
    x = spin_inverse_dense(a, 32, "cuda", engine=eng, device="cpu")
    want = j_spin_inverse_dense(_to_jax(a), 32, "pallas", engine=j_eng)
    assert x.dtype == torch.bfloat16
    tol = verify.residual_tolerance(torch.bfloat16)
    assert verify.inverse_residual(a, x) < tol
    assert j_verify.inverse_residual(_to_jax(a), want) < tol
    # Both round every product and leaf to bf16, at different places.
    assert _rel_diff(x, want) < 2e-2


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("engine", ENGINE_PAIRS, ids=lambda p: p[0])
def test_lu_inverse_matches_reference(grid, engine):
    eng, j_eng = engine
    a = _matrix("diag_dominant", grid * BS)
    with count_ops() as counts:
        x = lu_inverse_dense(a, BS, engine=eng, device="cpu")
    with j_count_ops() as j_counts, j_multiply_engine(j_eng):
        want = j_lu_inverse(JBlockMatrix.from_dense(_to_jax(a), BS)).to_dense()
    assert verify.inverse_residual(a, x) < verify.residual_tolerance(torch.float32)
    assert _rel_diff(x, want) < 1e-4
    assert counts.as_dict() == j_counts.as_dict()
    assert counts.leaf_lu == grid


def test_lu_block_form_matches_dense_entry_point():
    a = _matrix("spd", 64)
    x = lu_inverse(BlockMatrix.from_dense(a, BS)).to_dense()
    assert torch.equal(x, lu_inverse_dense(a, BS, device="cpu"))


@pytest.mark.parametrize("leaf", ["linalg", "qr", "gauss_jordan", "cuda"])
def test_run_conformance_is_ok(leaf):
    reports = verify.run_conformance(grids=(1, 2, 4), block_size=16,
                                     leaf_solver=leaf, device="cpu")
    assert len(reports) == 12
    assert all(r.ok for r in reports), [r.as_dict() for r in reports if not r.ok]


@pytest.mark.parametrize("grid", [1, 2, 4, 8, 16, 32])
def test_op_count_oracle_equals_reference(grid):
    assert (verify.expected_spin_counts(grid).as_dict()
            == j_verify.expected_spin_counts(grid).as_dict())


def test_oracle_rejects_divergence_and_bad_grids():
    counts = verify.expected_spin_counts(4)
    counts.multiplies += 1
    with pytest.raises(AssertionError):
        verify.assert_paper_op_counts(4, counts)
    with pytest.raises(ValueError):
        verify.expected_spin_counts(3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_residual_tolerance_table_equals_reference(dtype):
    assert (verify.residual_tolerance(getattr(torch, dtype))
            == j_verify.residual_tolerance(jnp.dtype(dtype)))


def test_unported_engines_and_leaves_raise():
    a = _matrix("spd", 32)
    for name in ("pallas",):
        with pytest.raises(ValueError, match="einsum"):
            spin_inverse_dense(a, BS, engine=name, device="cpu")
        with pytest.raises(ValueError):
            with multiply_engine(name):
                pass
    with pytest.raises(ValueError, match="leaf solver"):
        spin_inverse_dense(a, BS, "pallas", device="cpu")
    # the SUMMA engines are ported; off the mesh they are the einsum product
    ref = spin_inverse_dense(a, BS, engine="einsum", device="cpu")
    for name in ("allgather", "ring"):
        assert torch.equal(spin_inverse_dense(a, BS, engine=name,
                                              device="cpu"), ref)
    assert ENGINES == ("einsum", "cuda", "strassen", "allgather", "ring")


def test_engines_agree_on_block_grids():
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.standard_normal((4, 4, 8, 8)).astype(np.float32))
            for _ in range(2))
    assert torch.allclose(multiply_blocks(a, b, "einsum"),
                          multiply_blocks(a, b, "cuda"), atol=1e-5)


@pytest.mark.parametrize("grid", [1, 2, 4, 8])
def test_blockmatrix_layout_matches_reference(grid):
    a = _matrix("spd", grid * 8)
    bm = BlockMatrix.from_dense(a, 8)
    jbm = JBlockMatrix.from_dense(_to_jax(a), 8)
    np.testing.assert_array_equal(bm.blocks.numpy(), np.asarray(jbm.blocks))
    assert torch.equal(bm.to_dense(), a)
    if grid > 1:
        parts = bm.split()
        j_parts = jbm.split()
        for p, jp in zip(parts, j_parts):
            np.testing.assert_array_equal(p.blocks.numpy(), np.asarray(jp.blocks))
        assert torch.equal(BlockMatrix.arrange(*parts).to_dense(), a)
    zeros = BlockMatrix.zeros(grid, 8, device="cpu").to_dense()
    assert torch.equal(zeros, torch.zeros(grid * 8, grid * 8))
    with pytest.raises(ValueError):
        BlockMatrix.from_dense(torch.zeros(grid * 8 + 1, grid * 8 + 1), 8)


def test_generators_are_seeded_and_shaped():
    for family in FAMILIES:
        a1, a2 = _matrix(family, 64), _matrix(family, 64)
        assert torch.equal(a1, a2) and a1.shape == (64, 64)
        assert bool(torch.isfinite(a1).all())
    spd = _matrix("spd", 64)
    assert torch.allclose(spd, spd.T, atol=1e-6)
    assert float(torch.linalg.eigvalsh(spd.double()).min()) > 0


def _ev(cat, name, ts, dur, corr=None, grid=None):
    """A Chrome-trace event; `corr` ties a device event to its launch."""
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    if grid:
        e["args"]["grid"] = grid
    return e


def test_profile_breakdown_reads_device_time_and_idle_share():
    from repro_torch.profile_spin import CALL, device_breakdown

    trace = {"traceEvents": [
        _ev("user_annotation", CALL, 100.0, 60.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 40.0, 2.0, 1),   # before the call
        _ev("kernel", "gemm_kernel", 50.0, 10.0, 1, [8, 8, 1]),
        *(_ev("cuda_runtime", "cudaLaunchKernel", 101.0 + i, 1.0, i) for i in (2, 3, 4)),
        _ev("kernel", "gemm_kernel", 110.0, 10.0, 2, [16, 8, 1]),
        _ev("kernel", "gemm_kernel", 115.0, 15.0, 3, [16, 8, 1]),   # overlaps the last
        _ev("gpu_memcpy", "Memcpy DtoD", 140.0, 10.0, 4),
        {"ph": "i", "name": "marker", "ts": 120.0}]}
    got = device_breakdown(trace)
    # Span 100..150 us; busy 110..130 and 140..150, 30 us: idle 20 of 50.
    assert got["span_ms"] == pytest.approx(0.05)
    assert got["busy_ms"] == pytest.approx(0.03)
    assert got["idle_share"] == pytest.approx(0.4)
    assert [(g["name"], g["grid"], g["count"]) for g in got["groups"]] == [
        ("gemm_kernel", "16x8x1", 2), ("Memcpy DtoD", "", 1)]
    assert got["groups"][0]["device_ms"] == pytest.approx(0.025)
    with pytest.raises(ValueError, match="one"):
        device_breakdown({"traceEvents": trace["traceEvents"][1:]})


def test_profile_breakdown_assigns_device_work_by_its_launch():
    from repro_torch.profile_spin import CALL, device_breakdown

    # The second call's first kernel carries a device time before the
    # second range starts (the two clocks disagree); its launch, matched by
    # correlation id, lies in the second range.
    trace = {"traceEvents": [
        _ev("user_annotation", f"{CALL}#0", 100.0, 40.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 105.0, 2.0, corr=1),
        _ev("kernel", "gemm_tc", 110.0, 10.0, corr=1),
        _ev("user_annotation", f"{CALL}#1", 200.0, 70.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 202.0, 2.0, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 204.0, 2.0, corr=3),
        _ev("kernel", "gj_inplace", 190.0, 10.0, corr=2),
        _ev("kernel", "gemm_tc", 230.0, 20.0, corr=3)]}
    first, second = (device_breakdown(trace, f"{CALL}#{i}") for i in range(2))
    assert [g["name"] for g in first["groups"]] == ["gemm_tc"]
    assert sorted(g["name"] for g in second["groups"]) == ["gemm_tc", "gj_inplace"]
    assert second["busy_ms"] == pytest.approx(0.03)
