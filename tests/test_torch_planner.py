"""The planner: the PyTorch port against the JAX package.

On a CPU signature the port prices as the JAX package prices, number for
number: the same candidate set (the port's ``cuda`` leaf and engine where
that package has ``pallas``), the same model seconds within 1e-9
relative, the same argmin, the same cache keys. A CUDA signature is built
by hand (pure Python, no card) and must offer the kernel engine, keep
Strassen out below the card's crossover, and rank the card's fitted
U-curve, not a single leaf, first. The planned entry points are checked
bit for bit against the explicit call with the chosen plan, and the port's
plan file against the reference's.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import planner as jp
from repro_torch import bridge, planner as P
from repro_torch.core import (BlockMatrix, spin_inverse, spin_inverse_batched,
                              spin_inverse_dense, spin_solve, spin_solve_dense,
                              testing, verify)
from repro_torch.planner import (Plan, PlanCache, candidate_grids,
                                 enumerate_plans, execute_inverse, get_plan,
                                 plan_inverse, plan_solve, planned_block_size,
                                 predict_cost, rank_plans, signature_for)

CORES = 8
_REF_NAMES = {"cuda": "pallas"}


def _spd(n: int, seed: int = 0) -> torch.Tensor:
    return testing.make_spd(n, np.random.default_rng([seed, n]), device="cpu")


def _ref_key(plan: Plan) -> tuple:
    """A port plan's execution key in the reference's names, with the
    reference's (single-device) mesh axes."""
    return (plan.block_size, _REF_NAMES.get(plan.leaf_solver, plan.leaf_solver),
            _REF_NAMES.get(plan.multiply_engine, plan.multiply_engine),
            plan.compute_dtype, plan.refine_sweeps, plan.store_dtype,
            ("data", "model"))


def _sigs(kind: str, n: int, precision: str = ""):
    port = signature_for(kind, n, torch.float32, backend="cpu", cores=CORES,
                         precision=precision)
    ref = jp.signature_for(kind, n, jnp.float32, backend="cpu", device_count=1,
                           cores=CORES, precision=precision)
    return port, ref


# ----------------------------------------------------------- enumeration

@pytest.mark.parametrize("n", [8, 50, 64, 256, 1 << 14])
def test_candidate_grids_equal_reference(n):
    assert candidate_grids(n) == jp.candidate_grids(n)
    assert candidate_grids(n, max_grid=16) == jp.candidate_grids(n, max_grid=16)


CPU_CASES = [("inverse", 256, ""), ("solve", 256, ""), ("inverse", 4096, ""),
             ("solve", 4096, ""), ("inverse", 512, "bf16"),
             ("inverse", 512, "auto"), ("solve", 512, "bf16")]


@pytest.mark.parametrize("kind,n,precision", CPU_CASES)
def test_cpu_candidates_prices_and_argmin_equal_reference(kind, n, precision):
    sig, jsig = _sigs(kind, n, precision)
    assert sig.key() == jsig.key()
    plans = enumerate_plans(sig)
    jplans = jp.enumerate_plans(jsig)
    assert sorted(map(_ref_key, plans)) == sorted(p.execution_key() for p in jplans)
    assert "cuda" not in {p.multiply_engine for p in plans}
    jcost = {p.execution_key(): jp.predict_cost(jsig, p) for p in jplans}
    for p in plans:
        want = jcost[_ref_key(p)]
        assert predict_cost(sig, p) == pytest.approx(want, rel=1e-9)
    best = rank_plans(sig, plans)[0]
    jbest = jp.rank_plans(jsig, jplans)[0]
    assert _ref_key(best) == jbest.execution_key()


def test_cpu_prices_of_the_kernel_leaf_and_engine_and_calibration_equal_reference():
    sig, jsig = _sigs("inverse", 1024)
    calib = {"t_flop": 2e-10, "t_leaf": 3e-10, "t_block_op": 1e-6, "t_elem": 5e-10}
    for leaf, engine, dtype, sweeps in [("cuda", "cuda", "float32", 0),
                                        ("qr", "strassen", "float32", 0),
                                        ("linalg", "einsum", "bfloat16", 2)]:
        plan = Plan(block_size=128, leaf_solver=leaf, multiply_engine=engine,
                    compute_dtype=dtype, refine_sweeps=sweeps)
        jplan = jp.Plan(block_size=128, leaf_solver=_REF_NAMES.get(leaf, leaf),
                        multiply_engine=_REF_NAMES.get(engine, engine),
                        compute_dtype=dtype, refine_sweeps=sweeps)
        for c in (None, calib):
            assert predict_cost(sig, plan, c) == pytest.approx(
                jp.predict_cost(jsig, jplan, c), rel=1e-9)


def test_signature_keys_and_axes_equal_reference():
    for kw in ({}, {"update_rank": 16}, {"precision": "bf16"},
               {"constraint": "block_sizes=64"}):
        port = signature_for("inverse", 256, torch.float32, backend="cpu",
                             cores=4, **kw)
        ref = jp.signature_for("inverse", 256, jnp.float32, backend="cpu",
                               device_count=1, cores=4, **kw)
        assert port.key() == ref.key()
        assert port.as_dict() == ref.as_dict()
    assert signature_for("inverse", 64, torch.bfloat16).dtype == "bfloat16"
    # the sharded placement is ported: off the mesh its key is the JAX
    # package's; an unknown placement still raises
    port = signature_for("inverse", 256, torch.float32, backend="cpu",
                         cores=4, placement="sharded")
    ref = jp.signature_for("inverse", 256, jnp.float32, backend="cpu",
                           device_count=1, cores=4, placement="sharded")
    assert port.key() == ref.key()
    with pytest.raises(ValueError):
        signature_for("inverse", 256, placement="replicated")
    with pytest.raises(ValueError):
        signature_for("inverse", 256, backend="tpu")
    with pytest.raises(ValueError):
        signature_for("inverse", 256, update_rank=-1)


# ----------------------------------------------------------- the card

def test_cuda_signature_offers_the_kernel_engine_and_gates_strassen():
    sig = signature_for("inverse", 16384, torch.float32, backend="cuda")
    assert (sig.cores, sig.device_count, sig.mesh) == (1, 1, "")
    engines = {p.multiply_engine for p in enumerate_plans(sig)}
    assert engines == {"cuda", "einsum"}
    assert {p.leaf_solver for p in enumerate_plans(sig)} == {
        "linalg", "gauss_jordan", "cuda", "qr"}
    # Strassen only from the card's measured crossover, not the CPU's 2048
    assert P.STRASSEN_MIN_N_CUDA == 32768
    for n in (2048, 16384):
        sig = signature_for("inverse", n, torch.float32, backend="cuda")
        assert "strassen" not in {p.multiply_engine for p in enumerate_plans(sig)}
    big = signature_for("inverse", 32768, torch.float32, backend="cuda")
    assert "strassen" in {p.multiply_engine for p in enumerate_plans(big)}
    # ... and the kernel engine never off the card
    cpu = signature_for("inverse", 16384, torch.float32, backend="cpu")
    assert "cuda" not in {p.multiply_engine for p in enumerate_plans(cpu)}


def test_cuda_pricing_has_the_cards_u_shape():
    n = 16384
    sig = signature_for("inverse", n, torch.float32, backend="cuda")
    ranked = rank_plans(sig, enumerate_plans(sig))
    best = ranked[0]
    assert best.grid(n) > 1, "a single leaf ranked first"
    assert (best.block_size, best.leaf_solver, best.multiply_engine,
            best.refine_sweeps) == (1024, "cuda", "cuda", 0)
    cost = {b: predict_cost(sig, Plan(block_size=n // b, leaf_solver="cuda",
                                      multiply_engine="cuda"))
            for b in candidate_grids(n)}
    interior = min(cost[b] for b in cost if 1 < b < max(cost))
    assert interior < cost[1] and interior < cost[max(cost)]
    # the fitted model is the card's sweep, b = 1 … 64, within 1.04 %
    # (profile_spin --sweep; PERF.md, PR 18)
    sweep_ms = {16384: 366.84, 8192: 157.30, 4096: 108.30, 2048: 97.44,
                1024: 95.41, 512: 98.91, 256: 104.76}
    for bs, ms in sweep_ms.items():
        assert cost[n // bs] * 1e3 == pytest.approx(ms, rel=0.0105)


def test_cuda_solve_and_refinement_plans():
    sig = signature_for("solve", 4096, torch.float32, backend="cuda")
    assert not any(p.refine_sweeps for p in
                   enumerate_plans(sig, include_refinement=True))
    inv = signature_for("inverse", 4096, torch.float32, backend="cuda")
    refined = [p for p in enumerate_plans(inv) if p.refine_sweeps]
    assert refined and all(p.compute_dtype == "bfloat16" for p in refined)
    # bf16 runs on the tensor cores, but two f32 sweeps never pay on the card
    assert rank_plans(inv, enumerate_plans(inv))[0].refine_sweeps == 0


# ----------------------------------------------------------- plan cache

def test_plan_cache_round_trip(tmp_path):
    cache = PlanCache(str(tmp_path / "plans.json"))
    sig = signature_for("inverse", 128, torch.float32, backend="cpu")
    plan = Plan(block_size=32, leaf_solver="cuda", multiply_engine="cuda",
                predicted_s=1e-3, measured_s=2e-3, source="measured")
    cache.put(sig, plan)
    got = PlanCache(str(tmp_path / "plans.json")).get(sig)     # a new process
    assert got == plan
    assert got.execution_key() == plan.execution_key()
    assert cache.get(signature_for("inverse", 128, torch.bfloat16,
                                   backend="cpu")) is None


def test_plan_cache_discards_another_version_and_corrupt_files(tmp_path):
    path = tmp_path / "plans.json"
    sig = signature_for("inverse", 128, torch.float32, backend="cpu")
    PlanCache(str(path)).put(sig, Plan(block_size=32))
    raw = json.loads(path.read_text())
    assert raw["version"] == P.PLAN_CACHE_VERSION
    raw["version"] = P.PLAN_CACHE_VERSION + 1
    path.write_text(json.dumps(raw))
    assert PlanCache(str(path)).get(sig) is None
    path.write_text("{not json")
    cache = PlanCache(str(path))
    assert cache.get(sig) is None
    cache.put(sig, Plan(block_size=64))            # and it can still write
    assert PlanCache(str(path)).get(sig).block_size == 64


def test_plan_cache_concurrent_writers_merge(tmp_path):
    path = str(tmp_path / "plans.json")
    sig_a = signature_for("inverse", 64, torch.float32, backend="cpu")
    sig_b = signature_for("inverse", 1024, torch.float32, backend="cpu")
    a, b = PlanCache(path), PlanCache(path)
    a.get(sig_a)
    b.get(sig_b)
    b.put(sig_b, Plan(block_size=128))
    a.put(sig_a, Plan(block_size=16))              # a's snapshot predates b's write
    fresh = PlanCache(path)
    assert fresh.get(sig_a).block_size == 16
    assert fresh.get(sig_b).block_size == 128


def test_measured_plan_is_recalled_without_measuring_again(tmp_path, monkeypatch):
    path = str(tmp_path / "plans.json")
    p1 = get_plan("inverse", 64, torch.float32, measure=True, top_k=None,
                  cache=PlanCache(path), backend="cpu", leaf_solvers=("linalg",))
    assert p1.source == "measured" and p1.measured_s is not None
    calls = []
    orig = P.autotune.measure_plans
    monkeypatch.setattr(P.autotune, "measure_plans",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    p2 = get_plan("inverse", 64, torch.float32, measure=True, top_k=None,
                  cache=PlanCache(path), backend="cpu", leaf_solvers=("linalg",))
    assert not calls, "a cache hit must not measure"
    assert p2.execution_key() == p1.execution_key()
    # a cost-model plan is replaced by a measured one
    path2 = str(tmp_path / "p2.json")
    q1 = get_plan("inverse", 64, torch.float32, measure=False,
                  cache=PlanCache(path2), backend="cpu")
    assert q1.source == "costmodel"
    q2 = get_plan("inverse", 64, torch.float32, measure=True, top_k=2,
                  cache=PlanCache(path2), backend="cpu")
    assert q2.source == "measured" and len(calls) == 1


def test_constrained_enumeration_never_poisons_the_unconstrained_key(tmp_path):
    cache = PlanCache(str(tmp_path / "plans.json"))
    pinned = get_plan("inverse", 256, torch.float32, measure=False, cache=cache,
                      backend="cpu", block_sizes=(8,), leaf_solvers=("qr",))
    assert (pinned.block_size, pinned.leaf_solver) == (8, "qr")
    free = get_plan("inverse", 256, torch.float32, measure=False, cache=cache,
                    backend="cpu")
    assert free.execution_key() != pinned.execution_key()
    keys = json.loads((tmp_path / "plans.json").read_text())["plans"]
    assert len(keys) == 2
    assert any(k.endswith("block_sizes=8;leaf_solvers=qr") for k in keys)


def test_port_keeps_its_own_file_beside_the_references(tmp_path, monkeypatch):
    ref_path = tmp_path / "plans.json"
    monkeypatch.setenv("SPIN_PLAN_CACHE", str(ref_path))
    assert P.default_cache_path() == str(tmp_path / "plans.torch.json")
    assert jp.default_cache_path() == str(ref_path)
    jsig = jp.signature_for("inverse", 128, jnp.float32, backend="cpu")
    jp.PlanCache(str(ref_path)).put(jsig, jp.Plan(block_size=32))
    before = ref_path.read_bytes()
    a = _spd(128)
    spin_inverse_dense(a, device="cpu")
    spin_solve_dense(a, torch.ones(128, 2), device="cpu")
    assert ref_path.read_bytes() == before
    assert jp.PlanCache(str(ref_path)).get(jsig).block_size == 32
    port = json.loads((tmp_path / "plans.torch.json").read_text())
    assert port["version"] == P.PLAN_CACHE_VERSION and len(port["plans"]) == 2
    # without the variable: $XDG_CACHE_HOME/repro_torch_spin/plans.json
    monkeypatch.delenv("SPIN_PLAN_CACHE")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert P.default_cache_path() == os.path.join(
        str(tmp_path / "xdg"), "repro_torch_spin", "plans.json")


# ----------------------------------------------------------- planned calls

def test_auto_inverse_bitwise_matches_explicit_plan(tmp_path):
    a = _spd(128)
    cache = PlanCache(str(tmp_path / "plans.json"))
    x_auto, plan = plan_inverse(a, cache=cache, return_plan=True)
    x_explicit = spin_inverse_dense(a, plan.block_size, plan.leaf_solver,
                                    engine=plan.multiply_engine, device="cpu")
    assert torch.equal(x_auto, x_explicit)
    assert torch.equal(x_auto, execute_inverse(plan, a))
    # the entry point's spellings agree with the recalled plan
    recalled = get_plan("inverse", 128, torch.float32, backend="cpu")
    x_none = spin_inverse_dense(a, device="cpu")
    x_auto2 = spin_inverse_dense(a, auto=True, device="cpu")
    assert torch.equal(x_none, x_auto2)
    assert torch.equal(x_none, spin_inverse_dense(
        a, recalled.block_size, recalled.leaf_solver,
        engine=recalled.multiply_engine, device="cpu"))
    assert verify.inverse_residual(a, x_none) < 1e-3


def test_auto_solve_bitwise_matches_explicit_plan(tmp_path):
    a = _spd(128, seed=1)
    b = torch.from_numpy(np.random.default_rng(2).standard_normal((128, 4),
                                                                  dtype=np.float32))
    cache = PlanCache(str(tmp_path / "plans.json"))
    x_auto, plan = plan_solve(a, b, cache=cache, return_plan=True)
    x_explicit = spin_solve_dense(a, b, plan.block_size, plan.leaf_solver,
                                  engine=plan.multiply_engine, device="cpu")
    assert torch.equal(x_auto, x_explicit)
    x = spin_solve_dense(a, b, device="cpu")
    assert verify.solve_residual(a, x, b) < 1e-3


def test_explicit_arguments_override_the_planner():
    a = _spd(128, seed=3)
    x = spin_inverse_dense(a, 16, auto=True, device="cpu")
    plan = get_plan("inverse", 128, torch.float32, measure=False,
                    backend="cpu", block_sizes=(16,))
    assert plan.block_size == 16
    assert torch.equal(x, spin_inverse_dense(a, 16, plan.leaf_solver,
                                             engine=plan.multiply_engine,
                                             device="cpu"))
    x_qr = spin_inverse_dense(a, leaf_solver="qr", engine="cuda", device="cpu")
    p_qr = get_plan("inverse", 128, torch.float32, backend="cpu",
                    leaf_solvers=("qr",), engines=("cuda",))
    assert (p_qr.leaf_solver, p_qr.multiply_engine) == ("qr", "cuda")
    assert torch.equal(x_qr, spin_inverse_dense(a, p_qr.block_size, "qr",
                                                engine="cuda", device="cpu"))


def test_blockmatrix_auto_picks_the_leaf_for_the_fixed_grid():
    a = _spd(128, seed=4)
    bm = BlockMatrix.from_dense(a, 32)
    leaf = P.planned_leaf_solver(128, 32, torch.float32, backend="cpu")
    assert torch.equal(spin_inverse(bm, auto=True).blocks,
                       spin_inverse(bm, leaf_solver=leaf).blocks)
    rhs = torch.ones(128, 3)
    sleaf = P.planned_leaf_solver(128, 32, torch.float32, kind="solve",
                                  backend="cpu")
    assert torch.equal(spin_solve(bm, rhs, auto=True),
                       spin_solve(bm, rhs, leaf_solver=sleaf))


def test_precision_rides_the_signature(tmp_path):
    a = _spd(128, seed=5)
    x = spin_inverse_dense(a, precision="bf16", device="cpu")
    assert x.dtype == torch.bfloat16
    sig = signature_for("inverse", 128, torch.float32, backend="cpu",
                        precision="bf16")
    cached = P.default_cache().get(sig)
    assert cached is not None and cached.store_dtype == "bfloat16"
    assert sig.key().endswith("/pbf16")
    assert verify.inverse_residual(a, x.float()) < verify.residual_tolerance(torch.bfloat16)


def test_planned_block_size_and_batched_inverse():
    for n in (50, 64, 96, 256, 6144):
        bs = planned_block_size(n, backend="cpu")
        assert n % bs == 0 and (n // bs) & (n // bs - 1) == 0
    bs = planned_block_size(4096, backend="cuda")
    assert bs == 1024
    stack = torch.stack([_spd(64, seed=s) for s in range(3)])
    out = spin_inverse_batched(stack, device="cpu")
    bs = planned_block_size(64, backend="cpu")
    for m, x in zip(stack, out):
        assert torch.equal(x, spin_inverse_dense(m, bs, "linalg", device="cpu"))


def test_refined_plan_executes_and_polishes():
    a = _spd(64, seed=6)
    raw = spin_inverse_dense(a.to(torch.bfloat16), 16, device="cpu").float()
    plan = Plan(block_size=16, compute_dtype="bfloat16", refine_sweeps=2)
    polished = execute_inverse(plan, a)
    eye = torch.eye(64)
    assert polished.dtype == a.dtype
    assert float(torch.linalg.norm(polished @ a - eye)) < \
        0.1 * float(torch.linalg.norm(raw @ a - eye))


# ----------------------------------------------------------- carrying state

def test_plan_from_reference_maps_the_kernel_names():
    for leaf, engine in [("pallas", "pallas"), ("linalg", "einsum"),
                         ("qr", "strassen")]:
        jplan = jp.Plan(block_size=64, leaf_solver=leaf, multiply_engine=engine,
                        compute_dtype="bfloat16", refine_sweeps=2,
                        store_dtype="bfloat16", predicted_s=0.5)
        plan = bridge.plan_from_reference(jplan.to_dict())
        assert isinstance(plan, Plan)
        assert _ref_key(plan) == jplan.execution_key()
        assert plan.predicted_s == 0.5
    # the SUMMA engines are ported and map as they are; a name the port
    # does not have raises
    assert bridge.plan_from_reference(jp.Plan(
        block_size=64, multiply_engine="ring").to_dict()).multiply_engine == "ring"
    with pytest.raises(ValueError):
        bridge.plan_from_reference(jp.Plan(block_size=64,
                                           multiply_engine="mosaic").to_dict())
    # a recalled reference plan runs in the port
    a = _spd(64, seed=7)
    plan = bridge.plan_from_reference(jp.Plan(block_size=16, leaf_solver="pallas",
                                              multiply_engine="pallas").to_dict())
    x = execute_inverse(plan, a)
    assert torch.equal(x, spin_inverse_dense(a, 16, "cuda", engine="cuda",
                                             device="cpu"))
