"""Serving observability in the PyTorch port, and its dashboard against the
JAX package's.

The port's tests are those of `tests/test_serving_metrics.py`: exact
linear-interpolation percentiles, rolling reservoir windows, the
queue-wait / solve / total split from service-stamped timestamps, per-path
and per-rejection counters through `SpinService.metrics()`, and the
`PhaseLedger`. Against the JAX package, one stream on a fake clock gives
the same latency summaries, queue-depth summary and counters, exactly:
they are host-side arithmetic on the same timestamps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import SpinService as JSpinService
from repro_torch.core import testing
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serving import (PhaseLedger, Reservoir, ServiceMetrics,
                                 SpinService)
from repro_torch.serving.metrics import percentile, profiled

N, BS = 128, 32


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _spd(seed: int = 0) -> torch.Tensor:
    return testing.make_spd(N, np.random.default_rng(seed), device="cpu")


# -- percentile / reservoir ---------------------------------------------------


def test_percentile_linear_interpolation_matches_numpy():
    samples = sorted([3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.3])
    for q in (0.0, 25.0, 50.0, 75.0, 95.0, 99.0, 100.0):
        assert percentile(samples, q) == pytest.approx(
            float(np.percentile(samples, q)))
    assert percentile([7.0], 99.0) == 7.0
    with pytest.raises(ValueError):
        percentile([], 50.0)
    with pytest.raises(ValueError):
        percentile([1.0], 101.0)


def test_reservoir_window_rolls_but_lifetime_counts():
    r = Reservoir(window=4)
    for v in range(1, 9):                   # 1..8; window keeps 5,6,7,8
        r.record(float(v))
    assert len(r) == 4
    assert r.percentile(0.0) == 5.0 and r.percentile(100.0) == 8.0
    assert r.count == 8 and r.total == 36.0          # lifetime, not window
    s = r.summary()
    assert s["count"] == 8 and s["max"] == 8.0
    assert s["p50"] == 6.5
    assert s["mean"] == pytest.approx(36.0 / 8)


def test_empty_reservoir_summary_is_zeros_not_error():
    s = Reservoir().summary()
    assert s == {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0,
                 "p99": 0.0, "max": 0.0}
    with pytest.raises(ValueError):
        Reservoir(window=0)


# -- ServiceMetrics -----------------------------------------------------------


def test_latency_split_from_request_timestamps():
    class Req:
        path = "maintained"
        submit_t, admit_t, finish_t = 1.0, 3.0, 7.5

    m = ServiceMetrics(registry=MetricsRegistry())
    m.observe_solve(Req())
    snap = m.snapshot()
    assert snap["latency_s"]["queue_wait"]["p50"] == 2.0
    assert snap["latency_s"]["solve"]["p50"] == 4.5
    assert snap["latency_s"]["total"]["p50"] == 6.5
    assert snap["counters"]["path_maintained"] == 1


def test_rejection_counters():
    m = ServiceMetrics(registry=MetricsRegistry())
    for reason in ("queue_full", "deadline", "queue_full"):
        m.observe_rejection(reason)
    c = m.snapshot()["counters"]
    assert c["rejected"] == 3
    assert c["rejected_queue_full"] == 2 and c["rejected_deadline"] == 1


def test_service_metrics_end_to_end_with_injected_clock():
    """A real service on a fake clock: the queue wait is exactly the
    injected delay between submission and the admitting tick."""
    clock = FakeClock()
    svc = SpinService(slots=2, clock=clock, device="cpu")
    svc.add_matrix("m", _spd(0), block_size=BS)
    req = svc.solve("m", torch.ones(N))
    clock.advance(0.25)                     # waits a quarter-second queued
    svc.run_until_done()
    assert req.done
    m = svc.metrics()
    lat = m["latency_s"]
    assert lat["queue_wait"]["count"] == 1
    assert lat["queue_wait"]["p50"] == pytest.approx(0.25)
    assert lat["total"]["p50"] >= lat["queue_wait"]["p50"]
    assert m["counters"]["path_recursion"] == 1
    assert m["queue_depth"]["count"] == svc.ticks   # sampled every tick
    assert m["queue"]["depth_now"] == 0
    assert m["residency"]["resident"] == 1
    assert m["stats"]["solves"] == 1


def test_metrics_window_is_rolling():
    clock = FakeClock()
    svc = SpinService(slots=1, clock=clock, metrics_window=2, device="cpu")
    svc.add_matrix("m", _spd(0), block_size=BS)
    for wait in (10.0, 1.0, 2.0):
        svc.solve("m", torch.zeros(N))
        clock.advance(wait)
        svc.run_until_done()
    lat = svc.metrics()["latency_s"]["queue_wait"]
    assert lat["count"] == 3                # lifetime
    assert lat["max"] == 2.0                # the 10 s outlier rolled out


# -- PhaseLedger --------------------------------------------------------------


def test_phase_ledger_accumulates_reentrant_phases():
    clock = FakeClock()
    ledger = PhaseLedger(clock=clock)
    for _ in range(3):
        with ledger.profile("solve"):
            clock.advance(0.5)
    with ledger.profile("update"):
        clock.advance(1.0)
    d = ledger.to_dict()
    assert d["solve"] == {"seconds": pytest.approx(1.5), "entries": 3}
    assert d["update"] == {"seconds": pytest.approx(1.0), "entries": 1}


def test_phase_ledger_records_on_exception():
    clock = FakeClock()
    ledger = PhaseLedger(clock=clock)
    with pytest.raises(RuntimeError):
        with ledger.profile("boom"):
            clock.advance(0.25)
            raise RuntimeError("phase body failed")
    assert ledger.to_dict()["boom"]["seconds"] == pytest.approx(0.25)


def test_profiled_decorator():
    ledger = PhaseLedger()

    @profiled("fn", ledger)
    def f(x):
        return x + 1

    assert f(1) == 2 and f(2) == 3
    assert ledger.to_dict()["fn"]["entries"] == 2


# -- against the JAX package --------------------------------------------------


def test_dashboard_matches_jax_service():
    """The same stream on the same fake clock: solves queued for different
    times, an update, a rejection at the queue bound. Latency summaries,
    queue depth and counters are equal; the registry view is additive."""
    a = _spd(0)
    rng = np.random.default_rng(7)
    b = [rng.standard_normal(N, dtype=np.float32) for _ in range(5)]
    u = rng.standard_normal((N, 2), dtype=np.float32) / N ** 0.5
    snaps = []
    for make, arr in ((lambda **kw: SpinService(device="cpu", **kw),
                       torch.from_numpy),
                      (JSpinService, jnp.asarray)):
        clock = FakeClock()
        svc = make(slots=2, clock=clock, max_queue=3, drift_probes=0)
        svc.add_matrix("m", arr(a.numpy()), block_size=BS)
        for i, wait in enumerate((0.5, 0.25, 1.0)):
            svc.solve("m", arr(b[i]))
            clock.advance(wait)
        try:
            svc.solve("m", arr(b[3]))
        except Exception as e:
            assert type(e).__name__ == "AdmissionRejected"
        svc.run_until_done()
        svc.update("m", arr(u))
        svc.solve("m", arr(b[4]))
        clock.advance(0.125)
        svc.run_until_done()
        snaps.append(svc.metrics())
    port, ref = snaps
    for key in ("latency_s", "queue_depth", "residual", "counters", "queue",
                "residency", "ticks", "stats"):
        assert port[key] == ref[key], key
    assert port["counters"]["rejected_queue_full"] == 1
    assert "spin_serve_requests_total" in port["registry"]
