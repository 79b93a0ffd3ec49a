"""The port's sharded placement on CPU meshes, against the JAX package.

The JAX package runs its mesh tests (`tests/test_distributed.py`) in
subprocesses with fake XLA devices; the port's mesh is single-controller
(`launch.mesh`), so a 2×2 or 4×2 mesh of the CPU runs in this process.
Covered here, each against the JAX single-device path on the same numpy
inputs:

  * the engines: `allgather`, `ring` and `cuda` (its plain version on the
    CPU) on 2×2 and 4×2 meshes, `multiply_blocks` and
    `schur_update_blocks` against the JAX einsum product; SPIN and LU
    under each engine with a plain BlockMatrix under an ambient mesh (the
    reference's `test_multiply_engines_and_spin_on_mesh`); `allgather` and
    `ring` bitwise the einsum product off the mesh; Strassen on the mesh
    with every intermediate in the spec ledger;
  * the entry points: `spin_inverse_sharded` / `spin_solve_sharded` with
    dense, BlockMatrix and ShardedBlockMatrix operands, auto=True and
    block_size=None, the precision cast-in/cast-out and its rejection;
  * the SMW update's sharded branches against the dense SMW;
  * the planner's sharded placement (`test_planner_signature_sees_mesh_
    topology`'s counterpart): keys, the descriptor, distinct devices, a
    plan recalled from the plan file;
  * the service tests that waited for this slice:
    `test_sharded_state_stays_sharded_off_mesh` and
    `test_refactor_policy_both_paths_on_mesh_without_gather`, this one on a
    2×2 CPU mesh beside a dense tenant and the spec ledger.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlockMatrix as JBlockMatrix
from repro.core import lu_inverse as j_lu_inverse
from repro.core import smw_update_inverse as j_smw_update_inverse
from repro.core import spin_inverse as j_spin_inverse
from repro.core.multiply import matmul_blocks_einsum as j_matmul_blocks
from repro.parallel import ShardedBlockMatrix as JSharded
from repro.planner import signature_for as j_signature_for
from repro_torch import bridge
from repro_torch.core import (BlockMatrix, PRECISION_PRESETS, add_low_rank,
                              apply_inverse, count_ops, lu_inverse,
                              multiply_engine, smw_update_inverse,
                              smw_update_solve, spin_inverse,
                              spin_inverse_dense, spin_inverse_sharded,
                              spin_solve_sharded, testing, verify)
from repro_torch.core.multiply import multiply_blocks, schur_update_blocks
from repro_torch.launch.mesh import current_mesh, make_worker_mesh, set_mesh
from repro_torch.parallel import (ShardedBlockMatrix, assert_mesh_resident,
                                  collective_bytes, record_specs,
                                  reset_collective_bytes)
from repro_torch.planner import (PlanCache, default_cache_path, get_plan,
                                 mesh_descriptor, signature_for)

TOL = verify.residual_tolerance(torch.float32)
MESHES = [pytest.param((2, 2), id="4dev-2x2"), pytest.param((4, 2), id="8dev-4x2")]
MESH_ENGINES = ["allgather", "ring", "cuda"]


def _mesh(shape):
    return make_worker_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))


def _spd(n: int, seed: int = 0) -> torch.Tensor:
    return testing.make_spd(n, np.random.default_rng([seed, n]), device="cpu")


def _normal(shape, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32))


def _jax(t: torch.Tensor):
    return jnp.asarray(bridge.to_numpy(t))


# ------------------------------------------------------------------- engines


@pytest.mark.parametrize("engine", MESH_ENGINES)
@pytest.mark.parametrize("shape", MESHES)
def test_multiply_and_schur_update_on_mesh_match_the_einsum_product(shape, engine):
    a, b, c = (_normal((8, 8, 16, 16), s) for s in (1, 2, 3))
    ref = np.asarray(j_matmul_blocks(_jax(a), _jax(b)))
    reset_collective_bytes()
    with set_mesh(_mesh(shape)):
        prod = multiply_blocks(a, b, engine)
        v = schur_update_blocks(c, a, b, negate_c=True, engine=engine)
        c11 = schur_update_blocks(c, a, b, negate_c=False, engine=engine)
    scale = float(np.abs(ref).max())
    assert float(np.abs(prod.numpy() - ref).max()) < 1e-5 * scale
    assert float(np.abs(v.numpy() - (ref - c.numpy())).max()) < 1e-5 * scale
    assert float(np.abs(c11.numpy() - (c.numpy() - ref)).max()) < 1e-5 * scale
    moved = collective_bytes()
    assert moved["gather"] > 0 and (moved["ring"] > 0) == (engine == "ring")


@pytest.mark.parametrize("engine", ["einsum"] + MESH_ENGINES)
@pytest.mark.parametrize("shape", MESHES)
def test_spin_and_lu_under_each_engine_on_mesh(shape, engine):
    """A plain BlockMatrix under an ambient mesh: the mesh engines lay each
    product out on the mesh (the reference's shard_map path); SPIN and LU
    hold the reference's residual and its inverse."""
    n, bs = 256, 32
    a = _spd(n, 4)
    ja = JBlockMatrix.from_dense(_jax(a), bs)
    ref_spin = np.asarray(j_spin_inverse(ja).to_dense())
    ref_lu = np.asarray(j_lu_inverse(ja).to_dense())
    with set_mesh(_mesh(shape)), multiply_engine(engine):
        x = spin_inverse(BlockMatrix.from_dense(a, bs)).to_dense()
        y = lu_inverse(BlockMatrix.from_dense(a, bs)).to_dense()
    for got, ref in ((x, ref_spin), (y, ref_lu)):
        assert verify.inverse_residual(a, got) < TOL
        assert float(np.abs(got.numpy() - ref).max()) < TOL


@pytest.mark.parametrize("engine", ["allgather", "ring"])
def test_summa_engines_collapse_to_einsum_off_mesh(engine):
    a, b, c = (_normal((4, 4, 8, 8), s) for s in (5, 6, 7))
    assert current_mesh() is None
    assert torch.equal(multiply_blocks(a, b, engine),
                       multiply_blocks(a, b, "einsum"))
    for neg in (True, False):
        assert torch.equal(schur_update_blocks(c, a, b, negate_c=neg, engine=engine),
                           schur_update_blocks(c, a, b, negate_c=neg,
                                               engine="einsum"))


def test_strassen_on_mesh_anchors_every_intermediate(monkeypatch):
    monkeypatch.setenv("SPIN_STRASSEN_CUTOFF", "16")
    n, bs = 128, 16
    grid = n // bs
    a = _spd(n, 8)
    with set_mesh(_mesh((2, 2))), record_specs() as recs, count_ops() as c:
        x = spin_inverse_sharded(a, bs, engine="strassen")
    assert verify.inverse_residual(a, x) < TOL
    assert (c.strassen_base_multiplies, c.strassen_adds) == \
        verify.expected_spin_strassen_counts(grid, bs, 16)
    ops = {r.op for r in recs}
    assert {"strassen_add", "strassen_combine"} <= ops
    tally = assert_mesh_resident(recs)
    assert tally["grid_sharded"] > 0
    # off the mesh the plain Strassen records the same anchors, unlaid
    with record_specs() as plain, multiply_engine("strassen"):
        spin_inverse(BlockMatrix.from_dense(a, bs))
    assert {r.op for r in plain if r.op.startswith("strassen")} == \
        {r.op for r in recs if r.op.startswith("strassen")}
    assert all(r.spec is None for r in plain)


# -------------------------------------------------------------- entry points


@pytest.mark.parametrize("shape", MESHES)
def test_entry_points_take_dense_block_and_sharded_operands(shape):
    n, bs = 128, 16
    a, rhs = _spd(n, 9), _normal((n, 3), 10)
    with set_mesh(_mesh(shape)):
        dense = spin_inverse_sharded(a, bs)
        blocked = spin_inverse_sharded(BlockMatrix.from_dense(a, bs))
        sbm = ShardedBlockMatrix.from_dense(a, bs)
        sharded = spin_inverse_sharded(sbm)
        xs = [spin_solve_sharded(op, rhs, bs) for op in
              (a, BlockMatrix.from_dense(a, bs), sbm)]
    assert isinstance(dense, torch.Tensor)
    assert isinstance(blocked, ShardedBlockMatrix)
    assert isinstance(sharded, ShardedBlockMatrix)
    assert sharded.spec == ("data", "model", None, None)
    assert torch.equal(blocked.to_dense(), dense)
    assert torch.equal(sharded.to_dense(), dense)
    assert verify.inverse_residual(a, dense) < TOL
    for x in xs:
        assert torch.equal(x, xs[0])
        assert verify.solve_residual(a, x, rhs) < TOL


def test_auto_and_planned_block_size_on_mesh(tmp_path, monkeypatch):
    monkeypatch.setenv("SPIN_PLAN_CACHE", str(tmp_path / "plans.json"))
    n = 256
    a, rhs = _spd(n, 11), _normal((n, 2), 12)
    with set_mesh(_mesh((2, 2))):
        planned = spin_inverse_sharded(a)
        plan = get_plan("inverse", n, torch.float32, measure=False,
                        placement="sharded", backend="cpu")
        explicit = spin_inverse_sharded(a, plan.block_size,
                                        leaf_solver=plan.leaf_solver,
                                        engine=plan.multiply_engine)
        auto = spin_inverse_sharded(a, plan.block_size, auto=True)
        x = spin_solve_sharded(a, rhs)
    assert torch.equal(planned, explicit) and torch.equal(auto, explicit)
    assert verify.inverse_residual(a, planned) < TOL
    assert verify.solve_residual(a, x, rhs) < TOL


def test_precision_casts_in_and_out_and_block_operands_refuse_it():
    n, bs = 128, 32
    a = _spd(n, 13)
    bound = PRECISION_PRESETS["bf16"].bound(torch.float32)
    with set_mesh(_mesh((2, 2))):
        x = spin_inverse_sharded(a, bs, precision="bf16")
        y = spin_solve_sharded(a, torch.ones(n, 2), bs, precision="bf16")
        with pytest.raises(ValueError, match="dense operand"):
            spin_inverse_sharded(ShardedBlockMatrix.from_dense(a, bs),
                                 precision="bf16")
        with pytest.raises(ValueError, match="dense operand"):
            spin_solve_sharded(BlockMatrix.from_dense(a, bs), torch.ones(n),
                               precision="bf16")
        exact = spin_inverse_sharded(a, bs, precision="exact")
    assert x.dtype == torch.bfloat16 and y.dtype == torch.float32
    assert verify.inverse_residual(a, x.float()) < bound
    assert torch.equal(exact, spin_inverse_sharded(a, bs, device="cpu"))


def test_entry_points_resolve_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = torch.eye(32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spin_inverse_sharded(a, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_worker_mesh((2, 2), devices=["cuda:0"] * 4)
    with pytest.raises(ValueError, match="conflicts"):
        with set_mesh(_mesh((2, 2))):
            spin_inverse_sharded(a, 16, device="cuda")
    assert spin_inverse_sharded(a, 16, device="cpu").device.type == "cpu"


# ----------------------------------------------------------------------- SMW


@pytest.mark.parametrize("shape", [None, (2, 2), (4, 2)])
def test_smw_sharded_branches_match_the_dense_update(shape):
    n, bs, k = 128, 16, 4
    a = _spd(n, 14)
    u, v = _normal((n, k), 15) / n, _normal((n, k), 16) / n
    rhs = _normal((n, 3), 17)
    inv = spin_inverse_dense(a, bs, device="cpu")
    ref = np.asarray(j_smw_update_inverse(_jax(inv), _jax(u), _jax(v)))
    with set_mesh(_mesh(shape) if shape else None), record_specs() as recs:
        sinv = ShardedBlockMatrix.from_dense(inv, bs)
        upd = smw_update_inverse(sinv, u, v)
        applied = apply_inverse(sinv, rhs)
        solved = smw_update_solve(sinv, u, v, rhs)
        a2 = add_low_rank(ShardedBlockMatrix.from_dense(a, bs), u, v)
    assert isinstance(upd, ShardedBlockMatrix) and isinstance(a2, ShardedBlockMatrix)
    assert float(np.abs(upd.to_dense().numpy() - ref).max()) < 1e-5
    dense_a2 = a + u @ v.T
    assert float((a2.to_dense() - dense_a2).abs().max()) < 1e-6
    assert verify.inverse_residual(dense_a2, upd.to_dense()) < TOL
    assert float((applied - inv @ rhs).abs().max()) < 1e-5
    assert verify.solve_residual(dense_a2, solved, rhs) < TOL
    if shape is None:
        # off the mesh: bitwise the BlockMatrix path
        bm = BlockMatrix.from_dense(inv, bs)
        assert torch.equal(upd.to_dense(), smw_update_inverse(bm, u, v).to_dense())
        assert torch.equal(applied, apply_inverse(bm, rhs))
        assert torch.equal(a2.to_dense(), add_low_rank(
            BlockMatrix.from_dense(a, bs), u, v).to_dense())
    else:
        assert {"smw_panel", "smw_update", "apply_inverse",
                "add_low_rank"} <= {r.op for r in recs}
        assert assert_mesh_resident(recs)["panel_sharded"] > 0


# ------------------------------------------------------------------- planner


def test_planner_signature_sees_mesh_topology(tmp_path, monkeypatch):
    monkeypatch.setenv("SPIN_PLAN_CACHE", str(tmp_path / "plans.json"))
    # off the mesh the sharded key is the reference's
    port = signature_for("inverse", 256, torch.float32, backend="cpu",
                         placement="sharded")
    ref = j_signature_for("inverse", 256, jnp.float32, backend="cpu",
                          device_count=1, placement="sharded")
    assert port.key() == ref.key()
    assert mesh_descriptor() == ""
    dense_out = get_plan("inverse", 256, torch.float32, measure=False,
                         backend="cpu")
    with set_mesh(_mesh((2, 2))):
        assert mesh_descriptor() == "data2:model2"
        sig = signature_for("inverse", 256, torch.float32, backend="cpu",
                            placement="sharded")
        plan = get_plan("inverse", 256, torch.float32, measure=False,
                        placement="sharded", backend="cpu")
        sig_cuda = signature_for("inverse", 256, torch.float32,
                                 backend="cuda", placement="sharded")
    assert "/mdata2:model2/sharded" in sig.key()
    # four coordinates on one device count once: no promised 4× speed-up
    assert sig.device_count == 1 and sig_cuda.cores == 1
    assert len({port.key(), sig.key(), signature_for(
        "inverse", 256, torch.float32, backend="cpu").key()}) == 3
    # recalled from the plan file by a fresh cache
    recalled = PlanCache(default_cache_path()).get(sig)
    assert recalled is not None
    assert recalled.execution_key() == plan.execution_key()
    # the dense placement off the mesh is untouched by the mesh's plans
    assert get_plan("inverse", 256, torch.float32, measure=False,
                    backend="cpu").execution_key() == dense_out.execution_key()
    # the SUMMA engines enter only the sharded placement under a mesh
    from repro_torch.planner import enumerate_plans

    assert {"allgather", "ring"} <= {p.multiply_engine
                                     for p in enumerate_plans(sig)}
    assert not {"allgather", "ring"} & {p.multiply_engine
                                        for p in enumerate_plans(port)}
    assert not any(p.refine_sweeps for p in enumerate_plans(sig_cuda))


# ---------------------------------------------------------------- the bridge


def test_bridge_lays_the_references_blocks_out_on_the_mesh():
    n, bs = 64, 8
    a = _spd(n, 18)
    jblocks = np.asarray(JSharded.from_dense(_jax(a), bs).blocks)
    with set_mesh(_mesh((2, 2))):
        sbm = bridge.sharded_from_numpy(jblocks)
    assert sbm.spec == ("data", "model", None, None)
    assert torch.equal(sbm.to_dense(), a)
    off = bridge.sharded_from_numpy(jblocks, device="cpu")
    assert off.mesh is None and torch.equal(off.to_dense(), a)


# ------------------------------------------------- the service on the mesh


def _rank_k(n: int, k: int, seed: int) -> torch.Tensor:
    return _normal((n, k), seed) / n ** 0.5


def test_sharded_state_stays_sharded_off_mesh():
    from repro_torch.serving import SpinService

    n, bs = 64, 16
    a = _spd(n, 19)
    svc = SpinService(slots=2, device="cpu")
    svc.add_matrix("s", ShardedBlockMatrix.from_dense(a, bs))
    st = svc.matrix("s")
    assert st.placement == "sharded"
    r1 = svc.solve("s", _normal((n,), 20))
    u = _rank_k(n, 4, 21)
    svc.update("s", u)
    r2 = svc.solve("s", _normal((n,), 22))
    svc.run_until_done()
    assert isinstance(st.a, ShardedBlockMatrix)
    assert isinstance(st.inv, ShardedBlockMatrix)
    assert r1.path == "recursion" and r2.path == "maintained"
    a2 = a + u @ u.T
    assert float((a2 @ r2.x - r2.rhs).abs().max()) < 1e-3


def test_refactor_policy_both_paths_on_mesh_without_gather():
    """On a 2×2 mesh: below the crossover the service folds SMW updates;
    above it (forced through the policy's slack) it re-factorizes. In both
    regimes matrix AND inverse stay ShardedBlockMatrix, the spec ledger
    shows them laid out on the mesh, and the answers agree with a dense
    tenant of the same matrix."""
    from repro_torch.planner import RefactorPolicy
    from repro_torch.serving import SpinService

    n, bs = 128, 32
    a = _spd(n, 23)
    u, b = _rank_k(n, 4, 24), _normal((n,), 25)
    a2 = a + u @ u.T
    with set_mesh(_mesh((2, 2))):
        for slack, refactored, reason, path, pending in (
                (1e9, False, "smw", "maintained", 4),
                (1e-9, True, "crossover", "recursion", 0)):
            svc = SpinService(slots=2, policy=RefactorPolicy(slack=slack),
                              device="cpu")
            with record_specs() as recs:
                svc.add_matrix("g", ShardedBlockMatrix.from_dense(a, bs))
                svc.add_matrix("d", a, block_size=bs)
                st = svc.matrix("g")
                ups = [svc.update(m, u) for m in ("g", "d")]
                reqs = [svc.solve(m, b) for m in ("g", "d")]
                svc.run_until_done()
            assert ups[0].refactored == refactored and ups[0].reason == reason
            assert reqs[0].path == path and st.pending_rank == pending
            assert type(st.a).__name__ == type(st.inv).__name__ == \
                "ShardedBlockMatrix"
            assert st.inv.spec == ("data", "model", None, None)
            assert float((a2 @ reqs[0].x - b).abs().max()) < 1e-3
            assert float((reqs[0].x - reqs[1].x).abs().max()) < \
                1e-4 * float(reqs[1].x.abs().max())
            tally = assert_mesh_resident(recs)
            assert tally["grid_sharded"] > 0 and tally["panel_sharded"] > 0


def test_sharded_calls_emit_the_references_spans(tmp_path, monkeypatch):
    """Under $SPIN_TRACE a sharded call emits what the JAX package's does:
    no recursion span (its sharded program carries none), and the
    planner's decision events when the planner is asked."""
    from repro.core import spin_inverse_sharded as j_spin_inverse_sharded
    from repro.obs import TRACER as J_TRACER
    from repro.obs import tracing as j_tracing
    from repro_torch.obs import TRACER, tracing

    monkeypatch.setenv("SPIN_PLAN_CACHE", str(tmp_path / "plans.json"))
    n, bs = 64, 16
    a = _spd(n, 26)
    names = {}
    for label, run, tracer, ctx in (
            ("port", lambda auto: spin_inverse_sharded(
                a, None if auto else bs, device="cpu"), TRACER, tracing),
            ("ref", lambda auto: j_spin_inverse_sharded(
                _jax(a), None if auto else bs), J_TRACER, j_tracing)):
        got = []
        for auto in (False, True):
            tracer.clear()
            with ctx(True):
                run(auto)
            got.append(sorted({s.name for s in tracer.spans()}))
        tracer.clear()
        names[label] = got
    assert names["port"] == names["ref"]
    assert names["port"][0] == []


def test_collective_byte_count_survives_concurrent_workers():
    """The coded pool's threads copy between coordinates at once: the byte
    counter, shared by them, must lose no update."""
    import sys
    import threading

    from repro_torch.parallel import collectives as col

    mesh = _mesh((2, 2))
    x = col.distribute(torch.ones(4, 4, 2, 2), ("data", "model", None, None),
                       mesh)
    whole = ((0, 4), (0, 4), (0, 2), (0, 2))
    per_fetch = 3 * 2 * 2 * 2 * 2 * 4     # three remote 2×2-block shards
    threads, rounds = 24, 200
    reset_collective_bytes()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            col.fetch(x, whole, (0, 0), "gather") for _ in range(rounds)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert collective_bytes()["gather"] == threads * rounds * per_fetch
