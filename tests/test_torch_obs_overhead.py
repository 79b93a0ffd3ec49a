"""Tracing costs nothing when it is off, and changes no result when it is on.

The contract of `repro_torch.obs.trace`: with `SPIN_TRACE` off, every
instrumentation site is one attribute read, builds no span and inserts no
device synchronisation; with it on, the same launches run on the same
operands, so results are bitwise equal and the op and launch counts are
the same. Only the traced planned entry points synchronise (to measure a
device time for the cost ledger).
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import count_ops, spin_inverse_dense, spin_solve_dense, testing
from repro_torch.core.blockmatrix import BlockMatrix
from repro_torch.core.spin import spin_inverse
from repro_torch.obs.trace import TRACER, SpanTracer, tracing
from repro_torch.planner import dispatch
from repro_torch.planner.cache import PlanCache
from repro_torch.serving import SpinService

N, BS = 64, 16


def _spd(seed: int = 0) -> torch.Tensor:
    return testing.make_spd(N, np.random.default_rng(seed), device="cpu")


def _workload(tmp_path):
    """Inversion (einsum and strassen engines), solve, both planned entry
    points and a service drain; returns every result."""
    a = _spd(0)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (N, 3), dtype=np.float32))
    cache = PlanCache(str(tmp_path / "plans.json"))
    out = [spin_inverse_dense(a, BS, device="cpu"),
           spin_inverse_dense(a, BS, engine="strassen", device="cpu"),
           spin_solve_dense(a, b, BS, device="cpu"),
           dispatch.plan_inverse(a, measure=False, cache=cache),
           dispatch.plan_solve(a, b, measure=False, cache=cache)]
    svc = SpinService(slots=2, device="cpu")
    svc.add_matrix("m", a, block_size=BS)
    reqs = [svc.solve("m", b[:, i]) for i in range(3)]
    svc.run_until_done()
    out += [r.x for r in reqs]
    return out


@pytest.fixture
def sync_calls(monkeypatch):
    """Counts every device synchronisation the port could make: the CUDA
    device-wide and event waits, and the planner's traced sync helper."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("cuda.synchronize"))
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda self: calls.append("Event.synchronize"))
    orig = dispatch._synchronize
    monkeypatch.setattr(dispatch, "_synchronize",
                        lambda dev: (calls.append("planned"), orig(dev)))
    monkeypatch.setenv("SPIN_STRASSEN_CUTOFF", "32")
    return calls


def test_traced_results_counts_and_launches_equal_untraced(tmp_path, sync_calls):
    runs = {}
    for on in (False, True):
        kernels.reset_launch_counts()
        with tracing(on, clear=True), count_ops() as counts:
            results = _workload(tmp_path / str(on))
        runs[on] = (results, counts.as_dict(), kernels.launch_counts(),
                    len(TRACER.spans()))
    TRACER.clear()
    (off, off_ops, off_launch, off_spans), (on, on_ops, on_launch, on_spans) = \
        runs[False], runs[True]
    assert len(off) == len(on)
    for x, y in zip(off, on):
        assert torch.equal(x, y)
    assert off_ops == on_ops and off_ops["strassen_base_multiplies"] > 0
    assert off_launch == on_launch
    assert off_spans == 0 and on_spans > 0


def test_untraced_paths_never_synchronise(tmp_path, sync_calls):
    with tracing(False, clear=True):
        _workload(tmp_path)
    assert sync_calls == []
    # ... and the traced planned calls do: before and after each of the two
    with tracing(True, clear=True):
        _workload(tmp_path / "traced")
    assert sync_calls == ["planned"] * 4
    TRACER.clear()


def test_disabled_guard_is_single_attribute_read():
    """`enabled` is a plain instance attribute (no property or descriptor
    on the class), and the disabled event() and span() return before
    building a span or touching their attributes."""
    assert "enabled" in vars(TRACER)
    assert not hasattr(SpanTracer, "enabled")
    with tracing(False):
        assert TRACER.event("x", "k") is None
        with TRACER.span("x", "k", big_attr=list(range(3))) as s:
            assert s is None
        spin_inverse(BlockMatrix.from_dense(torch.eye(8) * 3.0, 2))
    assert TRACER.spans() == []
