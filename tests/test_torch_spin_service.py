"""SpinService, the online inverse server: the PyTorch port, and the port
against the JAX package.

The port's tests are those of `tests/test_spin_service.py` on dense
placement: coalesced solves bitwise the offline `spin_solve_dense`, per-
matrix FIFO barriers, the refactor policy's two paths, snapshot/restore,
degraded mode under injected faults. The sharded placement's tests are in
`tests/test_torch_distributed.py`.

Against the JAX package, inputs are made with numpy from a seed and handed
bit for bit to both services:

  * answers: max |x_port − x_ref| ≤ 1e-4 · max |x_ref| (f32; both sum the
    same products in other orders), and both residuals within
    `residual_tolerance`;
  * verdicts: with `drift_probes=0` (the probes' random draws differ
    between the frameworks) the path of every request, `refactored` and
    `reason` of every update and the whole `stats` dict are equal;
  * a snapshot written by the JAX service restores in the port's and
    answers within the same tolerance.
"""

import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import SpinService as JSpinService
from repro_torch.core import spin_solve_dense, testing, verify
from repro_torch.parallel import FaultPlan
from repro_torch.planner import RefactorPolicy
from repro_torch.serving import SpinService

N, BS = 128, 32
REL = 1e-4


def _spd(seed: int = 0, n: int = N, cond_boost: float = 1.0) -> torch.Tensor:
    return testing.make_spd(n, np.random.default_rng(seed), device="cpu",
                            cond_boost=cond_boost)


def _normal(seed: int, *shape) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape, dtype=np.float32))


def _service(slots=4, **kw) -> tuple[torch.Tensor, SpinService]:
    a = _spd(0)
    svc = SpinService(slots=slots, device="cpu", **kw)
    svc.add_matrix("m", a, block_size=BS)
    return a, svc


def _rank_k(k: int, seed: int) -> torch.Tensor:
    return _normal(seed, N, k) / N ** 0.5


def _resid(a, x, b) -> float:
    return float((a @ x - b).abs().max())


def test_coalesced_batch_is_bitwise_offline_spin_solve():
    """c concurrent solves on a fresh matrix == ONE offline multi-RHS
    spin_solve_dense on the stacked panel, column for column, bitwise."""
    a, svc = _service()
    st = svc.matrix("m")
    cols = [_normal(i + 1, N) for i in range(3)]
    reqs = [svc.solve("m", c) for c in cols]
    svc.tick()
    assert all(r.done and r.path == "recursion" for r in reqs)
    assert svc.stats["batches"] == 1 and svc.stats["coalesced_cols"] == 3
    offline = spin_solve_dense(a, torch.stack(cols, dim=1), st.block_size,
                               st.leaf_solver, engine=st.engine, device="cpu")
    for i, r in enumerate(reqs):
        assert torch.equal(r.x, offline[:, i]), i


def test_matrix_rhs_and_vector_rhs_coalesce():
    a, svc = _service()
    panel, vec = _normal(2, N, 2), _normal(3, N)
    r1, r2 = svc.solve("m", panel), svc.solve("m", vec)
    svc.run_until_done()
    assert r1.x.shape == (N, 2) and r2.x.shape == (N,)
    st = svc.matrix("m")
    offline = spin_solve_dense(a, torch.cat([panel, vec[:, None]], dim=1),
                               st.block_size, st.leaf_solver,
                               engine=st.engine, device="cpu")
    assert torch.equal(r1.x, offline[:, :2])
    assert torch.equal(r2.x, offline[:, 2])


def test_update_switches_to_maintained_path_and_stays_correct():
    a, svc = _service()
    u = _rank_k(4, seed=9)
    up = svc.update("m", u)
    req = svc.solve("m", _normal(4, N))
    svc.run_until_done()
    assert up.done and not up.refactored and up.reason == "smw"
    assert req.path == "maintained"
    assert _resid(a + u @ u.T, req.x, req.rhs) < 1e-3
    assert svc.matrix("m").pending_rank == 4


def test_per_matrix_fifo_barrier():
    """A solve submitted before an update completes against the old
    matrix; one submitted after sees the new one."""
    a, svc = _service(slots=1)
    rhs = _normal(5, N)
    before = svc.solve("m", rhs)
    u = _rank_k(4, seed=10)
    up = svc.update("m", u)
    after = svc.solve("m", rhs)
    svc.tick()                      # serves `before`; the update must wait
    assert before.done and not up.done and not after.done
    svc.run_until_done()
    assert up.done and after.done
    assert _resid(a, before.x, rhs) < 1e-3
    assert _resid(a + u @ u.T, after.x, rhs) < 1e-3
    assert not torch.equal(before.x, after.x)


def test_matrices_are_isolated():
    _, svc = _service()
    svc.add_matrix("other", _spd(50, cond_boost=2.0), block_size=BS)
    svc.update("m", _rank_k(2, seed=11))
    r_m = svc.solve("m", _normal(6, N))
    r_o = svc.solve("other", _normal(7, N))
    svc.run_until_done()
    assert r_m.path == "maintained"          # churned matrix
    assert r_o.path == "recursion"           # untouched matrix stays exact
    assert svc.matrix("other").pending_rank == 0


def test_crossover_triggers_refactor_and_restores_exact_path():
    """Steady rank-8 updates: early ones fold (SMW), the cumulative spend
    crosses the modeled re-inversion price, the service re-factorizes,
    and solves return to the exact path."""
    _, svc = _service()
    st = svc.matrix("m")
    reasons = []
    for i in range(50):
        up = svc.update("m", _rank_k(8, seed=100 + i))
        svc.run_until_done()
        reasons.append(up.reason)
        if up.refactored:
            break
    assert reasons[0] == "smw", reasons
    assert reasons[-1] == "crossover", reasons
    assert st.refactors == 1 and st.smw_applied == len(reasons) - 1
    assert st.pending_rank == 0
    req = svc.solve("m", _normal(8, N))
    svc.run_until_done()
    assert req.path == "recursion"
    assert _resid(st.a, req.x, req.rhs) < 1e-3


def test_drift_bound_triggers_refactor():
    """A tiny drift tolerance: the first fold's probe residual exceeds it,
    so the SECOND update refactors with reason='drift'."""
    _, svc = _service(drift_scale=1e-6, policy=RefactorPolicy(slack=1e9))
    u1 = svc.update("m", _rank_k(2, seed=30))
    svc.run_until_done()
    u2 = svc.update("m", _rank_k(2, seed=31))
    svc.run_until_done()
    assert not u1.refactored and u1.reason == "smw"
    assert u2.refactored and u2.reason == "drift"


def test_block_replacement_update_request():
    _, svc = _service()
    r = 1
    delta = _normal(12, BS, N) * 0.05
    d = delta[:, r * BS:(r + 1) * BS]
    delta[:, r * BS:(r + 1) * BS] = (d + d.T) / 2
    up = svc.update("m", delta_row=delta, index=r)
    req = svc.solve("m", _normal(13, N))
    svc.run_until_done()
    # rank 2·bs = n/2 sits at the policy's rank bound, so either verdict is
    # legitimate: this pins the delta_row plumbing itself.
    assert up.done
    assert svc.matrix("m").pending_rank == (0 if up.refactored else 2 * BS)
    assert _resid(svc.matrix("m").a, req.x, req.rhs) < 1e-3


def test_submit_validation():
    _, svc = _service()
    with pytest.raises(KeyError):
        svc.solve("nope", torch.zeros(N))
    with pytest.raises(ValueError):
        svc.update("m")                       # neither factors nor delta_row
    with pytest.raises(ValueError):
        svc.add_matrix("m", _spd(1))          # duplicate
    # malformed delta_row requests fail AT SUBMISSION and leave the queue
    pending = svc.solve("m", torch.zeros(N))
    delta = torch.zeros(BS, N)
    with pytest.raises(ValueError):
        svc.update("m", delta_row=delta)              # missing index
    with pytest.raises(ValueError):
        svc.update("m", torch.zeros(N, 2), torch.zeros(N, 3))  # k mismatch
    with pytest.raises(ValueError):
        svc.update("m", torch.zeros(N + 1, 2))        # wrong n
    with pytest.raises(ValueError):
        svc.update("m", delta_row=delta, index=N // BS)   # out of range
    with pytest.raises(ValueError):
        svc.update("m", delta_row=torch.zeros(BS, N + 1), index=0)
    svc.run_until_done()
    assert pending.done                       # earlier request survived
    for bad in ("a__b", "a/b", ".."):         # snapshot-unsafe ids
        with pytest.raises(ValueError):
            svc.add_matrix(bad, _spd(2))


def test_malformed_rhs_fails_at_submit():
    """A wrong-shaped rhs fails AT SUBMISSION with the queue untouched,
    never inside tick()'s coalesced batch."""
    _, svc = _service()
    for bad in (torch.zeros(N + 1), torch.zeros(N - 1, 3),
                torch.zeros(N, 2, 2), torch.zeros(())):
        with pytest.raises(ValueError):
            svc.solve("m", bad)
    assert not svc._queue and len(svc._free) == svc.slots
    ok = svc.solve("m", torch.zeros(N))
    svc.run_until_done()
    assert ok.done and not ok.failed


def test_failing_batch_recycles_slots_and_fails_requests(monkeypatch):
    """An exception inside the coalesced solve fails the batch CLOSED:
    each request marked failed with the error, every slot back in the
    pool, and the service keeps serving."""
    _, svc = _service()

    def boom(state, rhs):
        raise FloatingPointError("injected batch failure")

    monkeypatch.setattr(svc, "_solve_batch", boom)
    reqs = [svc.solve("m", _normal(i, N)) for i in range(3)]
    svc.tick()
    assert all(r.done and r.failed for r in reqs)
    assert all("FloatingPointError" in r.error for r in reqs)
    assert all(r.x is None for r in reqs)
    assert len(svc._free) == svc.slots and not svc._live   # no slot leak
    assert svc.stats["batch_failures"] == 1
    monkeypatch.undo()
    ok = svc.solve("m", _normal(9, N))
    svc.run_until_done()
    assert ok.done and not ok.failed and ok.path == "recursion"


def test_mixed_dtype_solves_never_co_batch():
    """dtype is part of the coalesce key: the f32 answer is bitwise the
    same with or without a bf16 neighbour."""
    _, svc = _service()
    rhs32 = _normal(20, N)
    solo = svc.solve("m", rhs32)
    svc.tick()
    rhs16 = _normal(21, N).to(torch.bfloat16)
    r32, r16 = svc.solve("m", rhs32), svc.solve("m", rhs16)
    batches_before = svc.stats["batches"]
    svc.tick()
    assert r32.done and r16.done
    assert svc.stats["batches"] == batches_before + 2      # two groups
    assert r32.x.dtype == torch.float32
    assert torch.equal(r32.x, solo.x)                      # bitwise contract


def test_update_only_and_idle_ticks_are_counted():
    _, svc = _service()
    svc.update("m", _rank_k(2, seed=70))
    svc.tick()                                   # update-only tick
    assert svc.ticks == 1
    svc.tick()                                   # idle tick
    assert svc.ticks == 2
    svc.solve("m", torch.zeros(N))
    svc.run_until_done()
    assert svc.ticks == 3


def test_restore_preserves_straggler_guard_config():
    plan = FaultPlan().inject_straggler(1, 30.0)     # rank 1: NOT matrix "m"
    _, svc = _service(solve_deadline_s=0.25, fault_plan=plan,
                      solve_retries=3, backoff_base_s=0.07,
                      degraded_max_sweeps=17)
    with tempfile.TemporaryDirectory() as d:
        svc.snapshot(d)
        restored = SpinService.restore(d, device="cpu")
        assert restored.solve_deadline_s == 0.25
        assert restored.solve_retries == 3
        assert restored.backoff_base_s == 0.07
        assert restored.degraded_max_sweeps == 17
        assert restored.fault_plan is not None
        assert restored.fault_plan.stragglers == plan.stragglers
        retuned = SpinService.restore(d, device="cpu", solve_deadline_s=1.5,
                                      fault_plan=None, solve_retries=1)
        assert retuned.solve_deadline_s == 1.5
        assert retuned.fault_plan is None and retuned.solve_retries == 1


def test_add_matrix_preblocked_input_fixes_the_plan_grid():
    """A BlockMatrix operand's own grid constrains the plan, so the chosen
    leaf and engine are priced for the grid the recursion runs."""
    from repro_torch.core import BlockMatrix

    svc = SpinService(slots=2, device="cpu")
    st_b = svc.add_matrix("bm", BlockMatrix.from_dense(_spd(0), BS))
    assert st_b.block_size == BS and st_b.plan.block_size == BS


def test_default_device_is_the_card(monkeypatch):
    """Without device= the service runs on the card, and raises where
    there is none, before admitting anything; restore does the same."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpinService(slots=2)
    _, svc = _service()
    with tempfile.TemporaryDirectory() as d:
        svc.snapshot(d)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SpinService.restore(d)


def test_sharded_placement_raises_until_ported():
    # The sharded placement is ported (tests/test_torch_distributed.py);
    # what it still refuses is a block size that re-blocks a sharded
    # operand's fixed grid, and nothing is admitted then.
    from repro_torch.parallel import ShardedBlockMatrix

    svc = SpinService(slots=2, device="cpu")
    sbm = ShardedBlockMatrix.from_dense(_spd(0), BS)
    with pytest.raises(ValueError, match="fixed grid"):
        svc.add_matrix("s", sbm, block_size=2 * BS)
    assert not svc._matrices
    assert svc.add_matrix("s", sbm).placement == "sharded"


def test_snapshot_restore_resumes_bit_identically():
    _, svc = _service()
    svc.update("m", _rank_k(4, seed=40))
    svc.run_until_done()
    with tempfile.TemporaryDirectory() as d:
        svc.snapshot(d)
        restored = SpinService.restore(d, device="cpu")
        st, st2 = svc.matrix("m"), restored.matrix("m")
        assert (st2.pending_rank, st2.smw_applied, st2.refactors) == \
            (st.pending_rank, st.smw_applied, st.refactors)
        assert st2.block_size == st.block_size
        assert restored.ticks == svc.ticks
        assert torch.equal(st2.a, st.a) and torch.equal(st2.inv, st.inv)
        rhs = _normal(41, N, 2)
        r1, r2 = svc.solve("m", rhs), restored.solve("m", rhs)
        svc.run_until_done()
        restored.run_until_done()
        assert r1.path == r2.path == "maintained"
        assert torch.equal(r1.x, r2.x)
        u1 = svc.update("m", _rank_k(2, seed=42))
        u2 = restored.update("m", _rank_k(2, seed=42))
        svc.run_until_done()
        restored.run_until_done()
        assert (u1.refactored, u1.reason) == (u2.refactored, u2.reason)


def test_snapshot_requires_quiesced_service():
    _, svc = _service()
    svc.solve("m", torch.zeros(N))
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError):
            svc.snapshot(d)


# -- degraded-mode serving under injected shard faults ------------------------


def _offline(a, svc, rhs) -> torch.Tensor:
    st = svc.matrix("m")
    return spin_solve_dense(a, rhs[:, None], st.block_size, st.leaf_solver,
                            engine=st.engine, device="cpu")[:, 0]


def test_hung_shard_serves_degraded_and_never_drops():
    """A shard hung past the deadline: every queued solve is answered from
    the sketched inverse, its probe residual reported and within the
    DriftTracker bound."""
    plan = FaultPlan().inject_straggler(0, 30.0)     # rank 0 = matrix "m"
    a, svc = _service(slots=2, solve_deadline_s=0.05, fault_plan=plan)
    st = svc.matrix("m")
    reqs = [svc.solve("m", _normal(i, N)) for i in range(3)]
    svc.run_until_done()                             # 3 reqs, 2 slots: 2 ticks
    assert all(r.done for r in reqs)                 # NEVER dropped
    assert all(r.path == "degraded" for r in reqs)
    assert all(r.residual_est is not None
               and r.residual_est <= st.drift.tolerance for r in reqs)
    assert svc.stats["shard_timeouts"] == 1          # flipped once
    assert svc.stats["degraded_serves"] == 2         # one per served batch
    assert st.degraded and st.background is not None
    for r in reqs:
        assert _resid(a, r.x, r.rhs) < st.drift.tolerance * 50
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError):            # hung work in flight
            svc.snapshot(d)


def test_background_landing_recovers_exact_path():
    """When the hung shard's work lands, the service re-factorizes, leaves
    degraded mode, and the next solve is bitwise the offline call."""
    plan = FaultPlan().inject_straggler(0, 0.4)
    a, svc = _service(solve_deadline_s=0.05, fault_plan=plan)
    st = svc.matrix("m")
    r1 = svc.solve("m", _normal(1, N))
    svc.run_until_done()
    assert r1.path == "degraded" and st.background is not None
    st.background.wait(30.0)                         # the straggler lands...
    plan.stragglers.clear()                          # ...and is healthy now
    # the deadline guards a solve, not the background landing: give the
    # exact solve room so that a loaded host cannot time it out
    svc.solve_deadline_s = 30.0
    r2 = svc.solve("m", _normal(2, N))
    svc.run_until_done()
    assert r2.path == "recursion" and r2.residual_est is None
    assert not st.degraded and st.sketch is None and st.background is None
    assert st.refactors == 1 and svc.stats["recoveries"] == 1
    assert torch.equal(r2.x, _offline(a, svc, r2.rhs))


def test_transient_worker_failure_is_retried():
    plan = FaultPlan().inject_failure(0, at_level=0, count=1)
    a, svc = _service(solve_deadline_s=30.0, fault_plan=plan,
                      solve_retries=2)
    r = svc.solve("m", _normal(3, N))
    svc.run_until_done()
    assert r.done and r.path == "recursion"
    assert svc.stats["retries"] >= 1
    assert svc.stats["shard_timeouts"] == 0
    assert not svc.matrix("m").degraded
    assert torch.equal(r.x, _offline(a, svc, r.rhs))


def test_dead_worker_degrades_and_keeps_serving():
    plan = FaultPlan().inject_failure(0)             # stays dead
    _, svc = _service(solve_deadline_s=30.0, fault_plan=plan)
    st = svc.matrix("m")
    r1 = svc.solve("m", _normal(4, N))
    svc.run_until_done()
    assert r1.path == "degraded" and st.background is None
    assert svc.stats["shard_failures"] == 1
    r2 = svc.solve("m", _normal(5, N))
    svc.run_until_done()
    assert r2.path == "degraded"
    assert r2.residual_est <= st.drift.tolerance
    with tempfile.TemporaryDirectory() as d:
        svc.snapshot(d)                              # no in-flight work: ok


def test_update_in_degraded_mode_invalidates_sketch():
    plan = FaultPlan().inject_failure(0)
    a, svc = _service(solve_deadline_s=30.0, fault_plan=plan)
    st = svc.matrix("m")
    svc.solve("m", _normal(6, N))
    svc.run_until_done()
    assert st.degraded and st.sketch is not None
    u = _rank_k(4, seed=60)
    svc.update("m", u)
    svc.run_until_done()
    assert st.sketch is None                         # invalidated
    r = svc.solve("m", _normal(7, N))
    svc.run_until_done()
    assert r.path == "degraded"
    assert _resid(a + u @ u.T, r.x, r.rhs) < st.drift.tolerance * 50


def test_snapshot_async_sees_no_later_in_place_write(monkeypatch):
    """The capture holds tensor references, so it is only a copy while
    nothing writes `a` or `inv` in place. After snapshot_async, an SMW
    fold, a refactor and a bf16 certify with polish must each bind new
    tensors: the captured ones keep their version counters and bits."""
    import threading

    import repro_torch.core.solver_ckpt as solver_ckpt

    _, svc = _service(slots=2, policy=RefactorPolicy(slack=1e9))
    tight = svc.add_matrix("lowp", _spd(3), block_size=BS, precision="bf16")
    captured = {mid: (st.a, st.inv, st.a._version, st.inv._version,
                      st.a.clone(), st.inv.clone())
                for mid, st in svc._matrices.items()}
    gate = threading.Event()
    orig = solver_ckpt.save_service_snapshot

    def gated(*args, **kwargs):
        assert gate.wait(30.0)
        return orig(*args, **kwargs)

    monkeypatch.setattr(solver_ckpt, "save_service_snapshot", gated)
    with tempfile.TemporaryDirectory() as d:
        task = svc.snapshot_async(d)
        svc.update("m", _rank_k(2, seed=80))           # SMW fold
        svc.run_until_done()
        svc.policy = RefactorPolicy(slack=1e-9)
        svc.update("m", _rank_k(2, seed=81))           # refactor
        svc.run_until_done()
        # a tight bound forces the certify's polish and its cast back
        tight.serve_bound = 1e-9
        svc.policy = RefactorPolicy(slack=1e9)
        svc.update("lowp", _rank_k(2, seed=82))
        svc.run_until_done()
        assert svc.stats["updates_refactor"] == 1
        assert tight.polish_triggers >= 1
        gate.set()
        task.wait(30.0)
        restored = SpinService.restore(d, device="cpu")
        for mid, (a, inv, va, vi, a0, inv0) in captured.items():
            assert (a._version, inv._version) == (va, vi), mid
            assert torch.equal(a, a0) and torch.equal(inv, inv0), mid
            st2 = restored.matrix(mid)
            assert torch.equal(st2.a, a0) and torch.equal(st2.inv, inv0), mid


# -- against the JAX package --------------------------------------------------


def _both(seed: int = 0, **kw):
    """The same matrix admitted to both services (drift probes off)."""
    a = _spd(seed)
    port = SpinService(slots=4, drift_probes=0, device="cpu", **kw)
    ref = JSpinService(slots=4, drift_probes=0, **kw)
    port.add_matrix("m", a, block_size=BS)
    ref.add_matrix("m", jnp.asarray(a.numpy()), block_size=BS)
    return a, port, ref


def _assert_close(got: torch.Tensor, want) -> None:
    want = torch.from_numpy(np.array(want))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= REL * float(want.abs().max())


def test_verdicts_and_stats_match_jax_service():
    """One stream of solves and rank-8 updates, to the refactor and past
    it: the path of each request, the verdict of each update and the
    stats dict are the JAX service's; the answers agree within 1e-4 of
    their scale and each meets the f32 residual bound."""
    a, port, ref = _both()
    tol = verify.residual_tolerance(torch.float32)
    a_now = a.clone()
    for step in range(12):
        b = _normal(200 + step, N, 3)
        rp, rr = port.solve("m", b), ref.solve("m", jnp.asarray(b.numpy()))
        u = _rank_k(8, seed=300 + step)
        up = port.update("m", u)
        ur = ref.update("m", jnp.asarray(u.numpy()))
        port.run_until_done()
        ref.run_until_done()
        assert rp.path == rr.path, step
        assert (up.refactored, up.reason) == (ur.refactored, ur.reason), step
        _assert_close(rp.x, rr.x)
        assert float((a_now @ rp.x - b).abs().max()) / float(b.abs().max()) <= tol
        a_now = a_now + u @ u.T
    assert port.stats["updates_refactor"] >= 1
    assert port.stats == ref.stats


def test_jax_snapshot_restores_in_the_port():
    """The JAX service's snapshot (meta.json + block directories) restores
    in the port's service, which answers as the JAX service does."""
    a, _, ref = _both()
    u = _rank_k(4, seed=90)
    ref.update("m", jnp.asarray(u.numpy()))
    ref.run_until_done()
    b = _normal(91, N, 2)
    with tempfile.TemporaryDirectory() as d:
        ref.snapshot(d)
        port = SpinService.restore(d, device="cpu")
    rr = ref.solve("m", jnp.asarray(b.numpy()))
    rp = port.solve("m", b)
    ref.run_until_done()
    port.run_until_done()
    st = port.matrix("m")
    assert (st.pending_rank, st.smw_applied, st.leaf_solver) == (4, 1, "linalg")
    assert rp.path == rr.path == "maintained"
    _assert_close(rp.x, rr.x)
    tol = verify.residual_tolerance(torch.float32)
    assert verify.solve_residual(a + u @ u.T, rp.x, b) <= tol
