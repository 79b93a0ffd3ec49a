"""The observability layer of the PyTorch port (`repro_torch.obs`): tracer,
registry, flight recorder, cost ledger and the environment table, with the
cross-subsystem paths (recursion spans against the op-count oracle,
planner decision records, the modeled-against-measured ledger), held to
the tests of `tests/test_obs.py` and to the JAX package's spans.

Differences from the JAX package, by design: the port's recursion is
eager, so every call emits its spans (the JAX package emits them once per
jit trace); their durations are host dispatch time. The span STRUCTURE,
(name, kind, level, grid, op) and the rest of the attributes, is the JAX
package's for the same grid and leaf solver, exactly. The coded-run flight
dump of the JAX tests waits for the port's coded execution.
"""

import json
import re
import threading
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlockMatrix as JBlockMatrix
from repro.core.spin import spin_inverse as j_spin_inverse
from repro.obs.trace import TRACER as J_TRACER
from repro.obs.trace import tracing as j_tracing
from repro_torch import envconfig
from repro_torch.core import testing
from repro_torch.core.blockmatrix import BlockMatrix
from repro_torch.core.spin import spin_inverse, spin_inverse_dense
from repro_torch.core.verify import expected_spin_counts, residual_tolerance
from repro_torch.obs import flight as obs_flight
from repro_torch.obs import ledger as obs_ledger
from repro_torch.obs import registry as obs_registry
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.ledger import CostLedger
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import TRACER, tracing
from repro_torch.planner.cache import PlanCache
from repro_torch.planner.dispatch import get_plan, plan_inverse

ROOT = Path(__file__).resolve().parent.parent
F32_TOL = residual_tolerance(torch.float32)


def make_spd(n: int, seed: int) -> torch.Tensor:
    return testing.make_spd(n, np.random.default_rng(seed), device="cpu")


def _inverse_residual(a, x) -> float:
    return float((a @ x - torch.eye(a.shape[0])).abs().max())


@pytest.fixture
def fresh_obs():
    """Hermetic observability globals: a fresh registry, flight recorder
    and cost ledger, an empty tracer; everything restored after."""
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


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_counter_labels_and_negative_rejected():
    reg = MetricsRegistry()
    c = reg.counter("spin_test_total", "help text")
    c.inc()
    c.inc(2, path="maintained")
    c.inc(path="maintained")
    assert c.value() == 1.0
    assert c.value(path="maintained") == 3.0
    with pytest.raises(ValueError):
        c.inc(-1)
    assert reg.counter("spin_test_total") is c
    with pytest.raises(TypeError):
        reg.gauge("spin_test_total")


def test_gauge_and_histogram():
    reg = MetricsRegistry()
    g = reg.gauge("spin_test_gauge")
    g.set(4.0)
    g.inc(1.0)
    assert g.value() == 5.0
    h = reg.histogram("spin_test_seconds", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    s = h.summary()
    assert s["count"] == 4 and s["sum"] == pytest.approx(55.55)
    row = h.collect()[""]
    assert row["buckets"]["le=0.1"] == 1
    assert row["buckets"]["le=1"] == 2
    assert row["buckets"]["le=10"] == 3
    assert row["buckets"]["le=+Inf"] == 4


def test_prometheus_text_and_json_roundtrip():
    from repro.obs.registry import MetricsRegistry as JMetricsRegistry

    texts = []
    for cls in (MetricsRegistry, JMetricsRegistry):
        reg = cls()
        reg.counter("spin_reqs_total", "requests").inc(3, path="recursion")
        reg.gauge("spin_depth").set(7)
        reg.histogram("spin_lat_seconds", buckets=(1.0,)).observe(0.5)
        texts.append(reg.prometheus_text())
        blob = json.loads(json.dumps(reg.to_json()))
        assert blob["spin_reqs_total"]["type"] == "counter"
        assert blob["spin_depth"]["type"] == "gauge"
    text = texts[0]
    assert "# TYPE spin_reqs_total counter" in text
    assert 'spin_reqs_total{path="recursion"} 3.0' in text
    assert 'spin_lat_seconds_bucket{le="1"} 1' in text
    assert 'spin_lat_seconds_bucket{le="+Inf"} 1' in text
    assert "spin_lat_seconds_sum 0.5" in text
    assert "spin_lat_seconds_count 1" in text
    assert texts[0] == texts[1]           # the exposition is the JAX one


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def test_tracer_disabled_records_nothing(fresh_obs):
    with tracing(False):
        assert TRACER.event("x", "k", a=1) is None
        with TRACER.span("y", "k") as s:
            assert s is None
    assert TRACER.spans() == []


def test_tracer_records_events_and_spans(fresh_obs):
    with tracing(True, clear=True):
        TRACER.event("e1", "kind_a", rank=3)
        with TRACER.span("s1", "kind_b", n=64):
            pass
    assert [s.name for s in TRACER.spans(kind="kind_a")] == ["e1"]
    (sp,) = TRACER.spans(kind="kind_b")
    assert sp.attrs["n"] == 64 and sp.duration_s >= 0.0
    assert [e["name"] for e in fresh_obs.recorder.events()] == ["e1", "s1"]
    assert TRACER.enabled is False


def test_tracing_context_restores_on_exception(fresh_obs):
    with pytest.raises(RuntimeError):
        with tracing(True):
            raise RuntimeError("boom")
    assert TRACER.enabled is False


# ---------------------------------------------------------------------------
# recursion spans vs the op-count oracle and the JAX package
# ---------------------------------------------------------------------------


def test_recursion_spans_match_oracle_eager(fresh_obs):
    """Eager recursion on a 4x4 grid: 2^i internal nodes at level i (b − 1
    in all), b leaves."""
    grid = 4
    a = BlockMatrix.from_dense(make_spd(8, 0), 2)
    assert a.grid == grid
    with tracing(True, clear=True):
        spin_inverse(a)
    counts = expected_spin_counts(grid)
    internal = TRACER.spans(kind="recursion_level", name="spin.level")
    leaves = TRACER.spans(kind="recursion_level", name="spin.leaf")
    assert len(internal) == grid - 1 == counts.splits
    assert len(leaves) == grid == counts.leaf_inversions
    assert sorted(s.attrs["level"] for s in internal) == [0, 1, 1]
    assert all(s.attrs["level"] == 2 for s in leaves)
    for s in internal:
        assert s.attrs["grid"] == {0: 4, 1: 2}[s.attrs["level"]]


def test_recursion_spans_emitted_on_every_eager_call(fresh_obs):
    """The port's dense path is eager: a second call emits the same span
    structure again (the JAX package's jit cache would emit none)."""
    a = make_spd(20, 1)
    with tracing(True, clear=True):
        spin_inverse_dense(a, 5, device="cpu")
        first = [(s.name, s.attrs["level"], s.attrs["grid"])
                 for s in TRACER.spans(kind="recursion_level")]
        assert len(first) == (4 - 1) + 4            # internal + leaves
        spin_inverse_dense(a, 5, device="cpu")
        both = [(s.name, s.attrs["level"], s.attrs["grid"])
                for s in TRACER.spans(kind="recursion_level")]
    assert both == first + first


def _structure(spans) -> list[tuple]:
    return [(s.name, s.kind, tuple(sorted(s.attrs.items()))) for s in spans]


@pytest.mark.parametrize("n,bs,leaf", [(8, 2, "linalg"), (64, 8, "linalg"),
                                       (32, 32, "qr")])
def test_recursion_span_list_equals_jax_package(fresh_obs, n, bs, leaf):
    """Same grid and leaf: the port's recursion spans, in order, with every
    attribute (level, grid, op, block_size, dtype, engine, solver), are
    the JAX package's eager BlockMatrix recursion's."""
    a = make_spd(n, 2)
    with tracing(True, clear=True):
        spin_inverse(BlockMatrix.from_dense(a, bs), leaf_solver=leaf)
    port = _structure(TRACER.spans(kind="recursion_level"))
    J_TRACER.clear()
    try:
        with j_tracing(True, clear=True):
            j_spin_inverse(JBlockMatrix.from_dense(jnp.asarray(a.numpy()), bs),
                           leaf_solver=leaf)
        ref = _structure(J_TRACER.spans(kind="recursion_level"))
    finally:
        J_TRACER.clear()
    assert len(port) == 2 * (n // bs) - 1
    assert port == ref


# ---------------------------------------------------------------------------
# planner decision records + cost ledger
# ---------------------------------------------------------------------------


def test_planner_decision_recorded(fresh_obs, tmp_path):
    cache = PlanCache(str(tmp_path / "plans.json"))
    with tracing(True, clear=True):
        get_plan("inverse", 64, measure=False, cache=cache, force_replan=True,
                 backend="cpu")
    decisions = TRACER.spans(kind="planner_decision")
    assert {s.attrs["decision"] for s in decisions} >= {"costmodel",
                                                        "autotuned"}
    chosen = [s for s in decisions if s.name == "planner.rank"][0]
    assert chosen.attrs["candidates"] >= 1
    assert chosen.attrs["chosen"]["block_size"] >= 1
    with tracing(True, clear=True):
        get_plan("inverse", 64, measure=False, cache=cache, backend="cpu")
    (hit,) = TRACER.spans(kind="planner_decision")
    assert hit.attrs["decision"] == "cache_hit"


def test_traced_plan_inverse_lands_in_cost_ledger(fresh_obs, tmp_path):
    cache = PlanCache(str(tmp_path / "plans.json"))
    a = make_spd(32, 2)
    with tracing(True, clear=True):
        inv = plan_inverse(a, measure=False, cache=cache)
    assert _inverse_residual(a, inv) < F32_TOL * 10
    (entry,) = fresh_obs.ledger.entries("inverse")
    assert entry.n == 32 and entry.measured_s > 0.0
    assert entry.predicted_s is not None and entry.predicted_s > 0.0
    assert entry.ratio == pytest.approx(entry.predicted_s / entry.measured_s)
    (span,) = TRACER.spans(kind="cost_ledger")
    assert span.attrs["measured_s"] == entry.measured_s
    summary = fresh_obs.ledger.summary()
    assert summary["entries"] == 1 and summary["mean_ratio"] > 0.0


def test_untraced_plan_inverse_stays_async(fresh_obs, tmp_path):
    """With tracing off the ledger sees nothing: no sync, no measurement."""
    cache = PlanCache(str(tmp_path / "plans.json"))
    a = make_spd(32, 3)
    with tracing(False):
        plan_inverse(a, measure=False, cache=cache)
    assert fresh_obs.ledger.entries() == []
    assert TRACER.spans() == []


def test_ledger_calibration_roundtrip(fresh_obs, tmp_path):
    """Measured (grid -> seconds) points fit a CostParams scale that lands
    in the plan cache's calibration table."""
    led = fresh_obs.ledger
    for b, secs in ((2, 0.08), (4, 0.02), (8, 0.04)):
        p = SimpleNamespace(block_size=256 // b, leaf_solver="linalg",
                            multiply_engine="einsum", predicted_s=None,
                            grid=lambda n, b=b: b)
        led.record_solve(kind="inverse", n=256, plan=p, backend="cpu",
                         dtype="float32", measured_s=secs)
    pts = led.calibration_points("inverse")
    assert pts[(256, "float32")] == {2: 0.08, 4: 0.02, 8: 0.04}
    cache = PlanCache(str(tmp_path / "plans.json"))
    constants = led.flush_calibration(cache, min_grids=3)
    assert constants and all(v >= 0.0 for v in constants.values())


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def test_flight_ring_is_bounded():
    rec = FlightRecorder(capacity=8)
    for i in range(20):
        rec.record("k", i=i)
    assert len(rec) == 8
    assert [e["i"] for e in rec.events()] == list(range(12, 20))


def test_flight_dump_writes_jsonl(fresh_obs, tmp_path, monkeypatch):
    monkeypatch.setenv("SPIN_TRACE_DIR", str(tmp_path))
    rec = fresh_obs.recorder
    rec.record("worker_event", name="worker.start", rank=0)
    rec.record("worker_event", name="worker.failed", rank=0, error="boom")
    path = rec.dump("unit-test")
    assert path is not None and Path(path).exists()
    lines = [json.loads(line) for line in Path(path).read_text().splitlines()]
    assert lines[0]["flight_dump"] == "unit-test"
    assert lines[0]["events"] == 2
    assert [ln["name"] for ln in lines[1:]] == ["worker.start",
                                                "worker.failed"]


def test_flight_dump_without_dir_is_noop(fresh_obs, monkeypatch):
    monkeypatch.delenv("SPIN_TRACE_DIR", raising=False)
    fresh_obs.recorder.record("k")
    assert fresh_obs.recorder.dump("nowhere") is None


# ---------------------------------------------------------------------------
# straggle statistics
# ---------------------------------------------------------------------------


def test_observed_straggle_feedback(fresh_obs):
    led = fresh_obs.ledger
    mk = lambda stragglers, failed: SimpleNamespace(  # noqa: E731
        used_ranks=[0, 1, 2], stragglers=stragglers, failed=failed,
        attempts={0: 1, 1: 1, 2: 1}, wall_s=0.1, median_shard_s=0.01)
    led.record_coded_run(mk([3], []), workers=4)
    assert led.observed_straggler_prob(0.05) == 0.05   # below min_runs
    led.record_coded_run(mk([], []), workers=4)
    led.record_coded_run(mk([3], [1]), workers=4)
    assert led.observed_straggler_prob(0.05) == pytest.approx(0.25)
    stats = led.straggle_stats()
    assert stats.runs == 3 and stats.per_rank == {"3": 2}
    clean = CostLedger()
    for _ in range(3):
        clean.record_coded_run(mk([], []), workers=4)
    assert clean.observed_straggler_prob(0.05) == pytest.approx(0.025)


# ---------------------------------------------------------------------------
# serving metrics: registry mirroring + thread-safety
# ---------------------------------------------------------------------------


def test_service_metrics_mirror_into_registry():
    from repro_torch.serving.metrics import ServiceMetrics

    reg = MetricsRegistry()
    m = ServiceMetrics(window=16, registry=reg)
    req = SimpleNamespace(path="maintained", residual_est=None,
                          submit_t=0.0, admit_t=0.5, finish_t=1.5)
    m.observe_solve(req)
    m.observe_queue_depth(3)
    m.observe_rejection("queue_full")
    snap = m.snapshot()
    assert set(snap) == {"latency_s", "queue_depth", "residual", "counters"}
    assert snap["counters"]["path_maintained"] == 1
    assert snap["counters"]["rejected_queue_full"] == 1
    assert reg.get("spin_serve_requests_total").value(path="maintained") == 1
    lat = reg.get("spin_serve_latency_seconds")
    assert lat.summary(stage="solve")["sum"] == pytest.approx(1.0)
    assert lat.summary(stage="total")["sum"] == pytest.approx(1.5)
    assert reg.get("spin_serve_events_total").value(
        event="rejected_queue_full") == 1
    assert reg.get("spin_serve_queue_depth").summary()["count"] == 1


def test_reservoir_concurrent_append_and_read():
    """summary()'s sorted(deque) racing record() must not raise: 4 writers
    and a reader coexist."""
    from repro_torch.serving.metrics import Reservoir

    res = Reservoir(window=512)
    res.record(0.0)
    stop = threading.Event()
    errors = []

    def write(k):
        try:
            for i in range(5000):
                res.record(float(i % 97) + k)
        except Exception as e:                      # pragma: no cover
            errors.append(e)

    def read():
        try:
            while not stop.is_set():
                res.summary()
                res.percentile(99.0)
                len(res)
        except Exception as e:                      # pragma: no cover
            errors.append(e)

    reader = threading.Thread(target=read)
    writers = [threading.Thread(target=write, args=(k,)) for k in range(4)]
    reader.start()
    for t in writers:
        t.start()
    for t in writers:
        t.join(60.0)
    stop.set()
    reader.join(60.0)
    assert not reader.is_alive() and not any(t.is_alive() for t in writers)
    assert not errors
    assert res.count == 4 * 5000 + 1 and len(res) == 512


def test_phase_ledger_concurrent_profile():
    from repro_torch.serving.metrics import PhaseLedger

    led = PhaseLedger()
    errors = []

    def work():
        try:
            for _ in range(2000):
                with led.profile("phase"):
                    pass
                led.to_dict()
        except Exception as e:                      # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert led.to_dict()["phase"]["entries"] == 4 * 2000


def test_service_metrics_payload_exposes_registry(fresh_obs):
    from repro_torch.serving import SpinService

    svc = SpinService(slots=2, device="cpu")
    svc.add_matrix("m", make_spd(16, 5), block_size=8)
    svc.solve("m", torch.ones(16))
    svc.run_until_done()
    snap = svc.metrics()
    reqs = snap["registry"]["spin_serve_requests_total"]
    assert reqs["type"] == "counter"
    assert sum(reqs["values"].values()) == 1


def test_traced_service_tick_spans(fresh_obs):
    from repro_torch.serving import SpinService

    svc = SpinService(slots=2, device="cpu")
    svc.add_matrix("m", make_spd(16, 6), block_size=8)
    with tracing(True, clear=True):
        for _ in range(3):
            svc.solve("m", torch.ones(16))
            svc.tick()
    ticks = TRACER.spans(kind="serve_tick", name="serve.tick")
    assert [s.attrs["tick"] for s in ticks] == [1, 2, 3]
    assert all(s.attrs["queued"] == 1 for s in ticks)


# ---------------------------------------------------------------------------
# envconfig
# ---------------------------------------------------------------------------


def test_env_accessors(monkeypatch):
    monkeypatch.setenv("SPIN_TRACE", "1")
    assert envconfig.env_bool("SPIN_TRACE") is True
    monkeypatch.setenv("SPIN_TRACE", "off")
    assert envconfig.env_bool("SPIN_TRACE") is False
    monkeypatch.setenv("SPIN_TRACE", "yess")
    with pytest.raises(ValueError, match="boolean-ish"):
        envconfig.env_bool("SPIN_TRACE")
    monkeypatch.setenv("SPIN_FLIGHT_CAPACITY", "3")
    assert envconfig.env_int("SPIN_FLIGHT_CAPACITY", 1) == 3
    assert FlightRecorder().capacity == 3
    monkeypatch.setenv("SPIN_FLIGHT_CAPACITY", "three")
    with pytest.raises(ValueError, match="integer"):
        envconfig.env_int("SPIN_FLIGHT_CAPACITY")
    with pytest.raises(KeyError, match="register"):
        envconfig.env_str("SPIN_NOT_A_KNOB")


def test_env_table_names_the_reference_knobs():
    """Every knob of the port is one of the JAX package's, under the same
    name, and the compilation-cache knob, which the port has no use for,
    is not among them."""
    from repro import envconfig as j_envconfig

    assert set(envconfig.ENV_VARS) <= j_envconfig.registered_names()
    assert {"SPIN_TRACE", "SPIN_TRACE_DIR", "SPIN_FLIGHT_CAPACITY",
            "SPIN_FAULT_PLAN"} <= set(envconfig.ENV_VARS)
    assert "SPIN_COMPILE" + "_CACHE" not in envconfig.ENV_VARS


def test_every_spin_env_var_in_the_port_is_registered():
    """Any SPIN_* name anywhere in the port's sources or chip_smoke.py is a
    knob of its own ENV_VARS table."""
    found = set()
    paths = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    paths.append(ROOT / "chip_smoke.py")
    for path in paths:
        found |= set(re.findall(r"\bSPIN_[A-Z][A-Z0-9_]*\b",
                                path.read_text()))
    assert found <= set(envconfig.ENV_VARS), sorted(
        found - set(envconfig.ENV_VARS))


def test_tracer_env_switch(monkeypatch):
    prev = TRACER.enabled
    try:
        monkeypatch.setenv("SPIN_TRACE", "1")
        assert obs_trace.refresh() is True
        monkeypatch.setenv("SPIN_TRACE", "0")
        assert obs_trace.refresh() is False
    finally:
        TRACER.enabled = prev


# ---------------------------------------------------------------------------
# end-to-end acceptance: one traced auto-planned inversion
# ---------------------------------------------------------------------------


def test_acceptance_traced_auto_inverse(fresh_obs, tmp_path, monkeypatch):
    """One traced auto-planned inversion: recursion spans matching the
    oracle's levels, a planner decision record, and a cost-ledger entry
    with modeled AND measured seconds."""
    monkeypatch.setenv("SPIN_PLAN_CACHE", str(tmp_path / "plans.json"))
    cache = PlanCache(str(tmp_path / "plans.json"))
    a = make_spd(56, 6)
    bm = BlockMatrix.from_dense(a, 14)
    with tracing(True, clear=True):
        spin_inverse(bm, auto=True)
        internal = TRACER.spans(kind="recursion_level", name="spin.level")
        leaves = TRACER.spans(kind="recursion_level", name="spin.leaf")
        inv = plan_inverse(a, measure=False, cache=cache)
    assert _inverse_residual(a, inv) < F32_TOL * 10

    grid = bm.grid
    counts = expected_spin_counts(grid)
    assert len(internal) == grid - 1
    assert len(leaves) == counts.leaf_inversions == grid
    for level in range(grid.bit_length() - 1):
        at = [s for s in internal if s.attrs["level"] == level]
        assert len(at) == 2 ** level and all(
            s.attrs["grid"] == grid >> level for s in at)

    decisions = TRACER.spans(kind="planner_decision")
    assert any("/n56/" in s.attrs["sig"] for s in decisions)

    (entry,) = fresh_obs.ledger.entries("inverse")
    assert entry.n == 56
    assert entry.measured_s > 0.0 and entry.predicted_s > 0.0
    assert 0.0 < entry.ratio < float("inf")
