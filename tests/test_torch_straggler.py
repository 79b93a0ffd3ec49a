"""The runtime half of the straggler layer in the PyTorch port: fault
plans, retries with backoff, heartbeats and background tasks, held to the
tests of `tests/test_straggler.py` for those pieces and, where both
packages produce the same artefact (a serialized `FaultPlan`, a backoff
schedule, an overdue verdict), to the JAX package's output exactly.
"""

import threading
import time

import pytest

from repro.parallel import straggler as j_straggler
from repro_torch.parallel import (FAULT_PLAN_ENV, BackgroundTask, FaultPlan,
                                  HeartbeatTracker, ShardTimeout,
                                  WorkerFailure, retry_with_backoff,
                                  start_background)


def _plans():
    port = (FaultPlan(seed=7).inject_straggler(0, 1.5)
            .inject_failure(2, at_level=3, count=1).inject_failure(5))
    ref = (j_straggler.FaultPlan(seed=7).inject_straggler(0, 1.5)
           .inject_failure(2, at_level=3, count=1).inject_failure(5))
    return port, ref


def test_fault_plan_roundtrips_through_env_json():
    plan, ref = _plans()
    back = FaultPlan.from_json(plan.env()[FAULT_PLAN_ENV])
    assert back.seed == 7
    assert back.stragglers == {0: 1.5}                 # int keys restored
    assert back.failures == {2: {"at": 3, "count": 1},
                             5: {"at": 0, "count": None}}
    # the serialized plan is the JAX package's, byte for byte, both ways
    assert plan.env() == ref.env()
    assert j_straggler.FaultPlan.from_json(plan.to_json()).failures == \
        back.failures


def test_fault_plan_from_env(monkeypatch):
    monkeypatch.delenv(FAULT_PLAN_ENV, raising=False)
    assert FaultPlan.from_env() is None
    plan, _ = _plans()
    monkeypatch.setenv(FAULT_PLAN_ENV, plan.to_json())
    got = FaultPlan.from_env()
    assert (got.stragglers, got.failures, got.seed) == \
        (plan.stragglers, plan.failures, plan.seed)


def test_fault_plan_injection_semantics():
    outcomes = []
    for cls, failure in ((FaultPlan, WorkerFailure),
                         (j_straggler.FaultPlan, j_straggler.WorkerFailure)):
        plan = (cls().inject_straggler(1, 0.25)
                .inject_failure(2, at_level=1, count=1).inject_failure(3))
        slept, raised = [], []
        plan.apply(0, 0, sleep=slept.append)           # healthy rank: no-op
        plan.apply(1, 0, sleep=slept.append)           # straggler sleeps
        for rank, step in ((2, 0), (2, 1), (2, 2), (3, 0), (3, 1), (3, 2)):
            try:
                plan.check(rank, step)
                raised.append(False)
            except failure:
                raised.append(True)
        outcomes.append((slept, raised))
    # before at_level ok; fails once, then recovers; count=None stays dead
    assert outcomes[0] == ([0.25], [False, True, False, True, True, True])
    assert outcomes[0] == outcomes[1]


def test_retry_with_backoff_is_exponential():
    plan = FaultPlan().inject_failure(0, at_level=0, count=2)
    slept = []
    result, attempts = retry_with_backoff(
        lambda i: (plan.check(0, i), "ok")[1],
        retries=3, base_s=0.01, sleep=slept.append)
    assert result == "ok" and attempts == 3
    assert slept == [0.01, 0.02]                       # geometric series
    ref_slept = []
    j_plan = j_straggler.FaultPlan().inject_failure(0, at_level=0, count=2)
    j_straggler.retry_with_backoff(lambda i: j_plan.check(0, i), retries=3,
                                   base_s=0.01, sleep=ref_slept.append)
    assert slept == ref_slept
    dead = FaultPlan().inject_failure(0)
    with pytest.raises(WorkerFailure):
        retry_with_backoff(lambda i: dead.check(0, i),
                           retries=2, sleep=slept.append)


def test_heartbeat_tracker_median_deadline():
    verdicts = []
    for cls in (HeartbeatTracker, j_straggler.HeartbeatTracker):
        now = {"t": 0.0}
        tr = cls(clock=lambda: now["t"])
        for shard, dur in ((0, 1.0), (1, 2.0), (2, 3.0)):
            now["t"] = 10.0
            tr.record_start(shard)
            now["t"] = 10.0 + dur
            tr.done(shard)
        assert tr.median() == 2.0
        now["t"] = 100.0
        tr.record_start(7)
        assert tr.outstanding() == [7]
        row = []
        for t in (115.0, 121.0):                       # 10 × median = 20 s
            now["t"] = t
            row.append(tr.overdue(7, factor=10.0))
        row.append(tr.overdue(0, factor=10.0))         # completed: never
        verdicts.append(row)
    assert verdicts[0] == [False, True, False]
    assert verdicts[0] == verdicts[1]


def test_background_task_result_error_and_deadline():
    assert start_background(lambda: 41 + 1).wait(30.0) == 42

    def fail():
        raise WorkerFailure("worker died")

    task = start_background(fail)
    with pytest.raises(WorkerFailure):
        task.wait(30.0)
    assert task.done and isinstance(task.error, WorkerFailure)

    gate = threading.Event()
    slow = BackgroundTask(lambda: gate.wait(30.0) and "landed")
    t0 = time.monotonic()
    with pytest.raises(ShardTimeout):
        slow.wait(0.05)                                # misses its deadline
    assert time.monotonic() - t0 < 5.0
    assert not slow.done                               # ...but keeps running
    gate.set()
    assert slow.wait(30.0) == "landed" and slow.done
