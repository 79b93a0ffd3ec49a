"""SpinService's SLA posture in the PyTorch port, and its admission
outcomes against the JAX package.

The port's tests are those of `tests/test_serving_sla.py`: admission sheds
with typed verdicts, priorities reorder across matrices but never break
the per-matrix FIFO barrier, deadlines expire queued requests, cost-aware
residency evicts and rehydrates bit for bit, async snapshots capture a
consistent state without stalling the tick loop, and the admission and
residency settings survive snapshot/restore. The JAX package's
compilation-cache test becomes the port's `ValueError` for a cache
directory: the port has no compilation cache.

Against the JAX package: one scripted stream on a fake clock (bounded
queue, quota, priorities, deadlines, two tenants) gives the same verdict,
path and completion tick for every request, and the same stats.
"""

import tempfile
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import AdmissionRejected as JAdmissionRejected
from repro.serving import SpinService as JSpinService
from repro_torch.core import spin_solve_dense, testing
from repro_torch.serving import AdmissionRejected, SpinService
from repro_torch.serving.admission import (effective_priorities,
                                           order_for_admission, shed_victim)

N, BS = 128, 32


class FakeClock:
    """Injectable monotonic clock: deadlines and latency math on rails."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _spd(seed: int, n: int = N) -> torch.Tensor:
    return testing.make_spd(n, np.random.default_rng(seed), device="cpu")


def _service(slots=1, **kw) -> tuple[torch.Tensor, SpinService]:
    a = _spd(0)
    svc = SpinService(slots=slots, device="cpu", **kw)
    svc.add_matrix("m", a, block_size=BS)
    return a, svc


def _rhs(seed: int, *shape) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape or (N,), dtype=np.float32))


def _resid(a, x, b) -> float:
    return float((a @ x - b).abs().max())


# -- admission: bounded queue, shedding, quotas -------------------------------


def test_queue_full_rejects_with_typed_verdict():
    _, svc = _service(max_queue=2)
    queued = [svc.solve("m", _rhs(i)) for i in range(2)]
    with pytest.raises(AdmissionRejected) as exc:
        svc.solve("m", _rhs(9))
    assert exc.value.rejection.reason == "queue_full"
    assert svc.stats["rejected"] == 1
    assert svc.metrics()["counters"]["rejected_queue_full"] == 1
    svc.run_until_done()                          # admitted work unharmed
    assert all(r.done and not r.rejected for r in queued)


def test_higher_priority_sheds_lowest_queued_solve():
    _, svc = _service(max_queue=2)
    keeper = svc.solve("m", _rhs(1), priority=1)
    victim = svc.solve("m", _rhs(2), priority=0)
    vip = svc.solve("m", _rhs(3), priority=5)     # sheds `victim`
    assert victim.done and victim.rejected
    assert victim.verdict.reason == "shed" and victim.x is None
    assert svc.stats["shed"] == 1
    svc.run_until_done()
    assert keeper.done and not keeper.rejected
    assert vip.done and not vip.rejected and vip.path == "recursion"


def test_equal_priority_never_sheds():
    _, svc = _service(max_queue=1)
    first = svc.solve("m", _rhs(1), priority=3)
    with pytest.raises(AdmissionRejected) as exc:
        svc.solve("m", _rhs(2), priority=3)
    assert exc.value.rejection.reason == "queue_full"
    assert not first.rejected


def test_updates_are_never_shed():
    _, svc = _service(max_queue=1)
    up = svc.update("m", torch.ones(N, 1) / N, priority=0)
    with pytest.raises(AdmissionRejected):
        svc.solve("m", _rhs(1), priority=99)
    assert not up.rejected
    svc.run_until_done()
    assert up.done


def test_per_matrix_quota_preserves_fairness():
    _, svc = _service(per_matrix_quota=2)
    svc.add_matrix("other", _spd(5), block_size=BS)
    hogs = [svc.solve("m", _rhs(i)) for i in range(2)]
    with pytest.raises(AdmissionRejected) as exc:
        svc.solve("m", _rhs(9))                   # tenant at quota
    assert exc.value.rejection.reason == "tenant_quota"
    other = svc.solve("other", _rhs(10))          # other tenant: admitted
    svc.run_until_done()
    assert other.done and all(r.done for r in hogs)


def test_deadline_expires_queued_request():
    clock = FakeClock()
    _, svc = _service(clock=clock)
    urgent = svc.solve("m", _rhs(1), deadline_s=1.0)
    lazy = svc.solve("m", _rhs(2))                # no deadline
    clock.advance(2.0)                            # deadline passes in queue
    svc.run_until_done()
    assert urgent.done and urgent.rejected
    assert urgent.verdict.reason == "deadline" and urgent.x is None
    assert lazy.done and not lazy.rejected
    assert len(svc._free) == svc.slots            # no slot consumed
    assert svc.metrics()["counters"]["rejected_deadline"] == 1


def test_deadline_met_when_served_in_time():
    clock = FakeClock()
    _, svc = _service(clock=clock)
    req = svc.solve("m", _rhs(1), deadline_s=10.0)
    clock.advance(1.0)
    svc.run_until_done()
    assert req.done and not req.rejected and req.path == "recursion"


# -- priority ordering vs per-matrix FIFO -------------------------------------


def test_priority_reorders_across_matrices():
    _, svc = _service(slots=1)
    svc.add_matrix("other", _spd(5), block_size=BS)
    low = svc.solve("m", _rhs(1), priority=0)
    high = svc.solve("other", _rhs(2), priority=5)
    svc.tick()                                    # one slot: high wins it
    assert high.done and not low.done
    svc.run_until_done()
    assert low.done


def test_priority_cannot_overtake_same_matrix_barrier():
    a, svc = _service(slots=1)
    rhs = _rhs(1)
    blocker = svc.solve("m", rhs)                 # occupies the slot first
    u = _rhs(7, N, 4) / N ** 0.5
    up = svc.update("m", u, priority=0)
    after = svc.solve("m", rhs, priority=10)
    svc.tick()
    assert blocker.done and not up.done and not after.done
    svc.run_until_done()
    assert up.done and after.done
    assert _resid(a + u @ u.T, after.x, rhs) < 1e-3
    assert not torch.equal(blocker.x, after.x)


def test_effective_priority_clamp_is_per_matrix():
    class R:
        def __init__(self, mid, p):
            self.matrix_id, self.priority = mid, p

    q = [R("a", 5), R("a", 9), R("b", 7), R("a", 2), R("b", 1)]
    assert effective_priorities(q) == [5, 5, 7, 2, 1]
    ordered = order_for_admission(q)
    assert [(r.matrix_id, r.priority) for r in ordered] == \
        [("b", 7), ("a", 5), ("a", 9), ("a", 2), ("b", 1)]
    assert shed_victim(q, incoming_priority=5) is None   # no rhs attr
    q[3].rhs = object()
    q[4].rhs = object()
    assert shed_victim(q, incoming_priority=2) is q[4]   # strictly lower
    assert shed_victim(q, incoming_priority=1) is None


# -- multi-tenant residency: cost-aware LRU eviction + rehydration ------------


def test_lru_eviction_and_transparent_rehydration():
    with tempfile.TemporaryDirectory() as spill:
        a, svc = _service(slots=2, max_resident=1, spill_dir=spill)
        st = svc.matrix("m")
        offline = spin_solve_dense(a, _rhs(3)[:, None], st.block_size,
                                   st.leaf_solver, engine=st.engine,
                                   device="cpu")[:, 0]
        svc.add_matrix("other", _spd(5), block_size=BS)
        assert not svc.is_resident("m")           # evicted for "other"
        assert svc.is_resident("other")
        assert svc.stats["evictions"] == 1
        req = svc.solve("m", _rhs(3))             # transparent rehydration
        svc.run_until_done()
        assert svc.is_resident("m") and not svc.is_resident("other")
        assert svc.stats["rehydrations"] == 1
        assert req.path == "recursion"
        assert torch.equal(req.x, offline)        # round trip is bit-exact


def test_eviction_is_cost_aware_not_pure_lru():
    with tempfile.TemporaryDirectory() as spill:
        svc = SpinService(slots=2, max_resident=2, spill_dir=spill,
                          device="cpu")
        svc.add_matrix("big", _spd(1, 256), block_size=64)  # oldest, dear
        svc.add_matrix("small", _spd(2, 64), block_size=32)
        big = svc.matrix("big")
        small = svc.matrix("small")
        assert big.reinvert_cost_s > small.reinvert_cost_s > 0
        svc.add_matrix("third", _spd(3, 64), block_size=32)
        assert svc.is_resident("big")             # survived despite age
        assert not svc.is_resident("small")


def test_evicted_matrix_still_updates_and_snapshots():
    with tempfile.TemporaryDirectory() as spill:
        a, svc = _service(slots=2, max_resident=1, spill_dir=spill)
        svc.add_matrix("other", _spd(5), block_size=BS)
        assert not svc.is_resident("m")
        u = _rhs(7, N, 2) / N ** 0.5
        up = svc.update("m", u)                   # rehydrates on apply
        svc.run_until_done()
        assert up.done and svc.is_resident("m")
        with tempfile.TemporaryDirectory() as d:
            svc.snapshot(d)                       # includes evicted "other"
            restored = SpinService.restore(d, device="cpu", max_resident=None)
            assert set(restored._matrices) == {"m", "other"}
            r = restored.solve("m", _rhs(8))
            restored.run_until_done()
            assert _resid(a + u @ u.T, r.x, r.rhs) < 1e-3


def test_unknown_matrix_still_raises_keyerror():
    _, svc = _service(max_resident=1)
    with pytest.raises(KeyError):
        svc.solve("nope", torch.zeros(N))
    with pytest.raises(KeyError):
        svc.is_resident("nope")


def test_transient_residency_pressure_defers_solve_not_fails():
    with tempfile.TemporaryDirectory() as spill:
        a, svc = _service(slots=4, max_resident=1, spill_dir=spill)
        svc.add_matrix("other", _spd(5), block_size=BS)   # evicts "m"
        r_m = svc.solve("m", _rhs(1))     # needs rehydration, no room yet
        r_o = svc.solve("other", _rhs(2))  # keeps "other" hot this tick
        svc.tick()
        assert r_o.done and not r_o.failed
        assert not r_m.done and not r_m.failed        # deferred, NOT failed
        svc.run_until_done()
        assert r_m.done and not r_m.failed and not r_m.rejected
        assert r_m.path == "recursion"
        assert svc.stats["batch_failures"] == 0
        assert _resid(a, r_m.x, r_m.rhs) < 1e-3


def test_transient_residency_pressure_defers_update_not_drops():
    with tempfile.TemporaryDirectory() as spill:
        a, svc = _service(slots=2, max_resident=1, spill_dir=spill)
        svc.add_matrix("other", _spd(5), block_size=BS)   # evicts "m"
        r_o = svc.solve("other", _rhs(1))  # holds "other" hot this tick
        u = _rhs(7, N, 1) / N ** 0.5
        up = svc.update("m", u)
        svc.run_until_done()
        assert r_o.done and not r_o.failed
        assert up.done and not up.rejected and not up.failed
        r = svc.solve("m", _rhs(8))
        svc.run_until_done()
        assert _resid(a + u @ u.T, r.x, r.rhs) < 1e-3


def test_update_rehydration_io_failure_is_typed_not_dropped(monkeypatch):
    import repro_torch.core.solver_ckpt as ckpt

    with tempfile.TemporaryDirectory() as spill:
        _, svc = _service(slots=2, max_resident=1, spill_dir=spill)
        svc.add_matrix("other", _spd(5), block_size=BS)   # evicts "m"

        def boom(*args, **kw):
            raise OSError("spill device gone")

        monkeypatch.setattr(ckpt, "load_matrix_spill", boom)
        up = svc.update("m", torch.ones(N, 1) / N)
        svc.run_until_done()                          # must not raise
        assert up.done and up.failed and not up.rejected
        assert "OSError" in up.error
        assert svc.stats["batch_failures"] == 1
        assert svc.metrics()["counters"]["rehydration_failures"] == 1


# -- async snapshots ----------------------------------------------------------


def test_async_snapshot_never_stalls_the_tick_loop(monkeypatch):
    """Block the snapshot's file I/O on an event: the service keeps
    admitting and serving while the writer is stuck, the captured payload
    is the quiesced PRE-update state, and a second in-flight snapshot is
    refused."""
    import repro_torch.core.solver_ckpt as solver_ckpt

    a, svc = _service(slots=2)
    st = svc.matrix("m")
    inv_before = st.inv
    gate, started = threading.Event(), threading.Event()
    orig = solver_ckpt.save_service_snapshot

    def gated(*args, **kwargs):
        started.set()
        assert gate.wait(30.0)
        return orig(*args, **kwargs)

    monkeypatch.setattr(solver_ckpt, "save_service_snapshot", gated)
    with tempfile.TemporaryDirectory() as d:
        task = svc.snapshot_async(d)
        assert started.wait(30.0)
        with pytest.raises(RuntimeError):         # one in flight at a time
            svc.snapshot_async(d)
        ticks0 = svc.ticks
        req = svc.solve("m", _rhs(1))             # serving while I/O blocked
        svc.update("m", _rhs(7, N, 2) / N ** 0.5)
        svc.run_until_done()
        assert req.done and svc.ticks > ticks0    # tick loop never stalled
        assert not task.done                      # writer still gated
        gate.set()
        task.wait(30.0)
        restored = SpinService.restore(d, device="cpu")
        st2 = restored.matrix("m")
        # pre-update capture: the mid-snapshot update never leaked in
        assert st2.smw_applied == 0
        assert torch.equal(st2.inv, inv_before)
        assert torch.equal(st2.a, a)


def test_async_snapshot_requires_quiesced_service():
    _, svc = _service()
    svc.solve("m", _rhs(1))
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError):
            svc.snapshot_async(d)
    svc.run_until_done()


# -- warm restarts: the port has no compilation cache -------------------------


def test_compile_cache_directory_raises(tmp_path):
    """The JAX service points XLA's persistent cache at a directory; the
    port's kernels are built once into build/, so a directory is refused
    (never silently ignored) and None / False are accepted."""
    with pytest.raises(ValueError, match="no compilation cache"):
        SpinService(slots=1, device="cpu", compile_cache=str(tmp_path))
    assert not list(tmp_path.iterdir())
    for off in (None, False):
        assert SpinService(slots=1, device="cpu",
                           compile_cache=off).compile_cache_dir is None


# -- config persistence -------------------------------------------------------


def test_restore_preserves_admission_and_residency_config():
    _, svc = _service(max_queue=7, per_matrix_quota=3, max_resident=4)
    with tempfile.TemporaryDirectory() as d:
        svc.snapshot(d)
        restored = SpinService.restore(d, device="cpu")
        assert restored.admission.max_queue == 7
        assert restored.admission.per_matrix_quota == 3
        assert restored.max_resident == 4
        retuned = SpinService.restore(d, device="cpu", max_queue=2,
                                      max_resident=None)
        assert retuned.admission.max_queue == 2
        assert retuned.max_resident is None
        assert retuned.admission.per_matrix_quota == 3   # untouched knob


# -- against the JAX package --------------------------------------------------


def _admission_run(svc, to_rhs, rejected_type, clock):
    """One scripted stream: two tenants, max_queue 4, quota 3, priorities
    and a deadline; returns each request's outcome and the stats."""
    b = {i: to_rhs(_rhs(40 + i)) for i in range(8)}
    log, reqs = [], {}

    def submit(tag, mid, i, **kw):
        try:
            reqs[tag] = svc.solve(mid, b[i], **kw)
        except rejected_type as e:
            log.append((tag, "rejected", e.rejection.reason))

    submit("m0", "m", 0)
    submit("m1", "m", 1, priority=1)
    submit("m2", "m", 2, deadline_s=0.5)
    submit("m3", "m", 3)                      # quota: 3 queued on "m"
    submit("o0", "o", 4, priority=0)
    submit("o1", "o", 5, priority=2)          # sheds the latest priority-0
    submit("o2", "o", 6, priority=0)          # queue full, nothing lower
    clock.advance(1.0)                        # m2's deadline passes
    for t in range(1, 20):
        if not svc._queue and not svc._live:
            break
        svc.tick()
        for tag, r in sorted(reqs.items()):
            if r.done and (tag, "done") not in {x[:2] for x in log}:
                log.append((tag, "done", r.path,
                            r.verdict.reason if r.rejected else None, t))
    return sorted(log, key=str), dict(svc.stats)


def test_admission_outcomes_match_jax_service():
    a, o = _spd(0), _spd(5)
    out = []
    for svc, conv, rej, kw in (
            (SpinService, lambda t: t, AdmissionRejected, {"device": "cpu"}),
            (JSpinService, lambda t: jnp.asarray(t.numpy()),
             JAdmissionRejected, {})):
        clock = FakeClock()
        s = svc(slots=2, max_queue=4, per_matrix_quota=3, drift_probes=0,
                clock=clock, **kw)
        s.add_matrix("m", conv(a), block_size=BS)
        s.add_matrix("o", conv(o), block_size=BS)
        out.append(_admission_run(s, conv, rej, clock))
    (port_log, port_stats), (ref_log, ref_stats) = out
    assert any(x[1] == "rejected" for x in port_log)
    assert any(x[3] == "shed" for x in port_log if x[1] == "done")
    assert any(x[3] == "deadline" for x in port_log if x[1] == "done")
    assert port_log == ref_log
    assert port_stats == ref_stats
