"""Coded straggler-robust inversion in the PyTorch port, against the JAX
package.

The coding layer is numpy in both packages, so the Vandermonde generator
and every worker's right-hand-side panel must be the reference's bits; the
MDS property holds and any quorum decodes. `coded_inverse` runs under the
same `FaultPlan` in both packages and must report the same stragglers,
attempts and decoded ranks, with an inverse within tolerance (the
reference's `tests/test_straggler.py` coded cases). Deadlines are set
explicitly (`min_deadline_s`, with `deadline_factor` 0 where a verdict is
asserted) and every injected delay is a fixed multiple of them, so that
no verdict depends on how fast a loaded host runs the solves. The obs
test that waited for this slice
(`test_coded_fault_run_dumps_overdue_retry_timeline`) is ported the same
way, as are the multi-process helpers of `launch.mesh`.
"""

import itertools
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import mesh as j_mesh
from repro.parallel import straggler as j_straggler
from repro_torch import bridge
from repro_torch.core import spin_inverse_sharded, testing, verify
from repro_torch.launch.mesh import (init_distributed, local_worker_ranks,
                                     make_worker_mesh, set_mesh, worker_info)
from repro_torch.obs import (CostLedger, FlightRecorder, MetricsRegistry,
                             TRACER, tracing)
from repro_torch.obs import flight as obs_flight
from repro_torch.obs import ledger as obs_ledger
from repro_torch.obs import registry as obs_registry
from repro_torch.parallel import (CodedConfig, CodedLayout, FaultPlan,
                                  InsufficientWorkers, coded_inverse,
                                  generator_is_mds, make_generator)

TOL = verify.residual_tolerance(torch.float32)


def _spd(n: int, seed: int) -> torch.Tensor:
    return testing.make_spd(n, np.random.default_rng([seed, n]), device="cpu")


def _jax(t: torch.Tensor):
    return jnp.asarray(bridge.to_numpy(t))


@pytest.fixture
def fresh_obs():
    """Hermetic observability globals, restored after."""
    prev_reg = obs_registry.set_default_registry(MetricsRegistry())
    prev_rec = obs_flight.set_recorder(FlightRecorder(capacity=256))
    prev_led = obs_ledger.set_ledger(CostLedger())
    TRACER.clear()
    try:
        yield SimpleNamespace(registry=obs_registry.default_registry(),
                              recorder=obs_flight.recorder(),
                              ledger=obs_ledger.ledger())
    finally:
        obs_registry.set_default_registry(prev_reg)
        obs_flight.set_recorder(prev_rec)
        obs_ledger.set_ledger(prev_led)
        TRACER.clear()


# ------------------------------------------------------------ coding layer


@pytest.mark.parametrize("w,k", [(4, 3), (5, 3), (6, 4), (8, 6), (3, 3)])
def test_generator_is_the_reference_and_mds(w, k):
    g = make_generator(w, k)
    assert np.array_equal(g, j_straggler.make_generator(w, k))
    assert generator_is_mds(g)
    assert generator_is_mds(g) == j_straggler.generator_is_mds(g)


@pytest.mark.parametrize("scheme,w,s", [("vandermonde", 4, 1),
                                        ("vandermonde", 5, 2),
                                        ("replication", 4, 1),
                                        ("replication", 6, 2)])
def test_worker_panels_are_the_reference_bits(scheme, w, s):
    lay = CodedLayout.build(50, w, s, scheme)
    ref = j_straggler.CodedLayout.build(50, w, s, scheme)
    assert (lay.data_shards, lay.shard_cols, lay.quorum) == \
        (ref.data_shards, ref.shard_cols, ref.quorum)
    for r in range(w):
        for dtype in (np.float32, np.float64):
            assert np.array_equal(lay.worker_rhs(r, dtype),
                                  ref.worker_rhs(r, dtype))


@pytest.mark.parametrize("scheme,w,s", [("vandermonde", 4, 1),
                                        ("vandermonde", 6, 2),
                                        ("replication", 4, 1),
                                        ("replication", 6, 2)])
def test_any_quorum_decodes_the_same_inverse(scheme, w, s):
    n = 24
    a = np.random.default_rng(1).standard_normal((n, n))
    a = a @ a.T / n + np.eye(n)
    inv = np.linalg.inv(a)
    lay = CodedLayout.build(n, w, s, scheme)
    ref = j_straggler.CodedLayout.build(n, w, s, scheme)
    results = {r: inv @ lay.worker_rhs(r, np.float64) for r in range(w)}
    for alive in itertools.combinations(range(w), w - s):
        if not lay.can_decode(set(alive)):
            assert scheme == "replication" and not ref.can_decode(set(alive))
            continue
        sub = {r: results[r] for r in alive}
        got = lay.decode(sub)
        assert np.abs(got - inv).max() < 1e-9
        assert np.array_equal(got, ref.decode(sub))
        # torch panels decode on their device, in float64 too
        on_torch = lay.decode({r: torch.from_numpy(x) for r, x in sub.items()})
        assert on_torch.dtype == torch.float64
        assert np.abs(on_torch.numpy() - got).max() < 1e-12


def test_replication_covers_any_s_losses_and_decode_rejects_below_quorum():
    for w, s in ((4, 1), (6, 2)):
        lay = CodedLayout.build(64, w, s, "replication")
        for lost in itertools.combinations(range(w), s):
            assert lay.can_decode(set(range(w)) - set(lost)), (w, s, lost)
        assert not lay.can_decode(set(range(w)) - set(lay.owners(0)))
    lay = CodedLayout.build(32, 4, 1, "vandermonde")
    with pytest.raises(InsufficientWorkers):
        lay.decode({r: np.zeros((32, lay.shard_cols), np.float32)
                    for r in range(2)})


# ---------------------------------------------------- coded inversion vs JAX

# Explicit deadlines: with deadline_factor 0 a worker is overdue past
# min_deadline_s exactly, whatever the median; every delay below is a fixed
# multiple of it.
_NO_VERDICT = dict(min_deadline_s=60.0)          # no worker is ever overdue
_DEADLINE_S = 0.5


def _scenarios():
    # Each scenario pins which workers finish: with quorum = all 4, every
    # worker; otherwise a worker that fails for good or sleeps far past the
    # run is the one left out, so the decoded ranks do not race.
    return [
        ("fault_free_vandermonde", dict(redundancy=0, **_NO_VERDICT),
         lambda P: P()),
        # replication, s = 1: ranks 1 and 3 own every shard between them
        ("replication_two_asleep", dict(redundancy=1, scheme="replication",
                                        **_NO_VERDICT),
         lambda P: P().inject_straggler(0, 10.0).inject_straggler(2, 10.0)),
        ("permanent_failure", dict(redundancy=1, **_NO_VERDICT),
         lambda P: P().inject_failure(1, at_level=0)),
        ("transient_failure", dict(redundancy=0, **_NO_VERDICT),
         lambda P: P().inject_failure(2, at_level=0, count=1)),
        ("straggler_waited_on", dict(redundancy=0, deadline_factor=0.0,
                                     min_deadline_s=_DEADLINE_S),
         lambda P: P().inject_straggler(3, 4 * _DEADLINE_S)),
    ]


@pytest.mark.parametrize("name,cfg,plan", _scenarios(),
                         ids=[s[0] for s in _scenarios()])
def test_coded_inverse_matches_the_reference_under_the_same_fault_plan(
        name, cfg, plan):
    n, bs = 64, 16
    a = _spd(n, 2)
    inv, report = coded_inverse(a, CodedConfig(workers=4, **cfg),
                                block_size=bs, fault_plan=plan(FaultPlan),
                                device="cpu")
    jinv, jreport = j_straggler.coded_inverse(
        _jax(a), j_straggler.CodedConfig(workers=4, **cfg), block_size=bs,
        fault_plan=plan(j_straggler.FaultPlan))
    if name == "straggler_waited_on":
        # the injected straggler is overdue in both; under load a healthy
        # worker may be declared too, so only rank 3's verdict is held
        assert 3 in report.stragglers and 3 in jreport.stragglers
    else:
        assert report.stragglers == jreport.stragglers == []
    assert report.used_ranks == jreport.used_ranks
    assert {r: report.attempts[r] for r in report.used_ranks} == \
        {r: jreport.attempts[r] for r in jreport.used_ranks}
    assert verify.inverse_residual(a, inv) < TOL * 10
    assert float(np.abs(inv.numpy() - np.asarray(jinv)).max()) < TOL
    want = {"fault_free_vandermonde": [0, 1, 2, 3],
            "replication_two_asleep": [1, 3],
            "permanent_failure": [0, 2, 3],
            "transient_failure": [0, 1, 2, 3],
            "straggler_waited_on": [0, 1, 2, 3]}[name]
    assert report.used_ranks == want
    if name == "transient_failure":
        assert report.attempts == {0: 1, 1: 1, 2: 2, 3: 1}


def test_coded_inverse_insufficient_workers_raises_in_both():
    a = _spd(64, 3)
    cfg = dict(workers=4, redundancy=1, retries=0)
    with pytest.raises(InsufficientWorkers):
        coded_inverse(a, CodedConfig(**cfg), block_size=16, device="cpu",
                      fault_plan=FaultPlan().inject_failure(0).inject_failure(1))
    with pytest.raises(j_straggler.InsufficientWorkers):
        j_straggler.coded_inverse(
            _jax(a), j_straggler.CodedConfig(**cfg), block_size=16,
            fault_plan=j_straggler.FaultPlan().inject_failure(0)
            .inject_failure(1))


def test_straggler_is_not_waited_on():
    """One of 4 workers delayed far past the run: the inversion completes
    from the other three without waiting."""
    import time

    a = _spd(128, 4)
    cfg = CodedConfig(workers=4, redundancy=1, **_NO_VERDICT)
    ref, _ = coded_inverse(a, cfg, block_size=32, fault_plan=FaultPlan(),
                           device="cpu")
    delay = 10.0
    t0 = time.monotonic()
    inv, report = coded_inverse(a, cfg, block_size=32, device="cpu",
                                fault_plan=FaultPlan().inject_straggler(3, delay))
    assert time.monotonic() - t0 < delay / 2
    assert report.used_ranks == [0, 1, 2]
    assert float((inv - ref).abs().max()) < TOL


@pytest.mark.parametrize("sharded", [False, True])
def test_spin_inverse_sharded_coded_on_a_2x2_mesh(sharded):
    n, bs = 128, 32
    a = _spd(n, 5)
    cfg = CodedConfig(workers=4, redundancy=1, **_NO_VERDICT)
    mesh = make_worker_mesh((2, 2), devices=["cpu"] * 4)
    with set_mesh(mesh):
        if sharded:
            inv = spin_inverse_sharded(a, bs, coded=cfg, fault_plan=FaultPlan())
        else:
            inv, _ = coded_inverse(a, cfg, block_size=bs, sharded=True,
                                   fault_plan=FaultPlan())
        with pytest.raises(ValueError, match="coded"):
            from repro_torch.parallel import ShardedBlockMatrix

            spin_inverse_sharded(ShardedBlockMatrix.from_dense(a, bs),
                                 coded=cfg)
    assert verify.inverse_residual(a, inv) < TOL * 10


def test_coded_fault_run_dumps_overdue_retry_timeline(fresh_obs, tmp_path,
                                                      monkeypatch):
    """A SPIN_FAULT_PLAN-injected straggler and a transient failure leave a
    flight dump whose timeline shows the overdue declaration and the retry.
    The deadline is explicit (0.5 s, deadline_factor 0) and the straggler
    sleeps 4 deadlines, so the verdict does not depend on the host's load."""
    monkeypatch.setenv("SPIN_TRACE_DIR", str(tmp_path))
    a = _spd(64, 6)
    cfg = CodedConfig(workers=4, redundancy=0, deadline_factor=0.0,
                      min_deadline_s=_DEADLINE_S)          # quorum = all 4
    for _ in range(2):
        coded_inverse(a, CodedConfig(workers=4, redundancy=0, **_NO_VERDICT),
                      block_size=16, fault_plan=FaultPlan(), device="cpu")
    plan = (FaultPlan().inject_straggler(3, 4 * _DEADLINE_S)
            .inject_failure(2, at_level=0, count=1))
    for k, v in plan.env().items():
        monkeypatch.setenv(k, v)                          # the env channel
    with tracing(True):
        inv, report = coded_inverse(a, cfg, block_size=16, device="cpu")
    assert verify.inverse_residual(a, inv) < TOL * 10
    assert 3 in report.stragglers and report.attempts[2] == 2
    names = [e.get("name") for e in fresh_obs.recorder.events("worker_event")]
    assert "worker.overdue" in names and "worker.retry" in names
    assert "worker.done" in names
    dumps = [p for p in fresh_obs.recorder.dumps
             if "stragglers" in Path(p).name]
    assert dumps, f"no straggler dump in {fresh_obs.recorder.dumps}"
    text = Path(dumps[-1]).read_text()
    assert "worker.overdue" in text and "worker.retry" in text
    reg = fresh_obs.registry
    assert reg.get("spin_coded_runs_total").value() >= 3.0
    assert reg.get("spin_coded_stragglers_total").value() >= 1.0
    assert reg.get("spin_coded_retries_total").value() >= 1.0
    assert reg.get("spin_coded_wall_seconds").summary()["count"] >= 3
    # the run was folded into the ledger's straggle statistics
    stats = fresh_obs.ledger.straggle_stats()
    assert stats.runs >= 3 and stats.stragglers >= 1


def test_redundancy_planned_from_the_observed_straggle_rate(fresh_obs):
    a = _spd(64, 7)
    inv, report = coded_inverse(
        a, CodedConfig(workers=4, redundancy=None, straggler_prob=0.0,
                       **_NO_VERDICT), block_size=16, device="cpu",
        fault_plan=FaultPlan())
    assert report.layout.redundancy == 0        # no straggling, no slack
    assert verify.inverse_residual(a, inv) < TOL * 10


# ----------------------------------------------------- multi-process helpers


def test_local_worker_ranks_equal_the_reference():
    for workers, procs in ((8, 3), (4, 1), (5, 2), (16, 4)):
        for p in range(procs):
            assert local_worker_ranks(workers, process_index=p,
                                      process_count=procs) == \
                j_mesh.local_worker_ranks(workers, process_index=p,
                                          process_count=procs)
    with pytest.raises(ValueError):
        local_worker_ranks(4, process_index=3, process_count=3)


def test_init_distributed_single_process_noop(monkeypatch):
    for var in ("SPIN_COORDINATOR", "SPIN_NUM_PROCS", "SPIN_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    info = init_distributed(num_processes=1)
    assert info.process_index == 0 and info.process_count == 1
    assert info.is_coordinator and info.coordinator is None
    assert local_worker_ranks(4) == [0, 1, 2, 3]
    monkeypatch.setenv("SPIN_NUM_PROCS", "1")
    monkeypatch.setenv("SPIN_COORDINATOR", "localhost:1")
    assert init_distributed().coordinator is None     # one process: no group
    assert worker_info().global_device_count >= 1


def test_worker_mesh_factors_as_the_reference():
    for n, want in ((1, (1, 1)), (2, (2, 1)), (4, (2, 2)), (8, (4, 2)),
                    (16, (4, 4)), (6, (3, 2))):
        mesh = make_worker_mesh(devices=["cpu"] * n)
        assert tuple(mesh.shape.values()) == want
        assert mesh.descriptor() == f"data{want[0]}:model{want[1]}"
    with pytest.raises(ValueError):
        make_worker_mesh((3, 2), devices=["cpu"] * 4)
