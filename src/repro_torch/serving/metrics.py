"""Serving observability: latency reservoirs, percentiles, phase profiling.

`SpinService` answers requests; this module answers "how fast, and where
did the time go". Three pieces:

  * `Reservoir` — a bounded sliding window of float samples with exact
    percentiles over the window (sort-on-read; windows are a few thousand
    samples, so the sort is microseconds next to a solve). Rolling, not
    cumulative: an SLA dashboard wants the *recent* p99, not the lifetime
    one.
  * `ServiceMetrics` — the service-side ledger: per-request queue-wait /
    solve / total latency reservoirs, a queue-depth reservoir sampled
    every tick, and named counters (per solve path, per rejection reason,
    batch failures). `SpinService.metrics()` returns its `snapshot()`.
    Every observation is also mirrored into an `obs.registry`
    MetricsRegistry (the process-global `default_registry()` unless one is
    injected), so the same numbers are scrapable as Prometheus text,
    without changing the `snapshot()` payload.
  * `PhaseLedger` + `profiled` — named wall-clock phases for measured
    sections: each phase records wall seconds into a ledger and opens a
    `torch.profiler.record_function` of its name, so the phase shows up
    named in a captured profile.

Thread-safety: `Reservoir` and `PhaseLedger` are recorded into by
background threads (`snapshot_async`, guarded solves) while the tick loop
reads, so both take an internal lock: without it a `sorted(deque)` read
racing an append raises "deque mutated during iteration".

Timestamps come from an injectable monotonic clock so tests can drive
deadlines and latency math deterministically.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Callable, Iterator

import torch

__all__ = ["percentile", "Reservoir", "ServiceMetrics", "PhaseLedger",
           "profiled", "PERCENTILES"]

# The SLA percentiles every summary reports, keyed as "p50"/"p95"/"p99".
PERCENTILES = (50.0, 95.0, 99.0)


def percentile(sorted_samples, q: float) -> float:
    """Linear-interpolation percentile of an ascending-sorted sequence.

    Matches numpy's default ("linear") method without requiring the
    samples as an ndarray; q in [0, 100].
    """
    n = len(sorted_samples)
    if n == 0:
        raise ValueError("percentile of an empty sample set")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q must be in [0, 100], got {q}")
    pos = (n - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_samples[lo] * (1.0 - frac)
                 + sorted_samples[hi] * frac)


class Reservoir:
    """Bounded sliding window of samples with exact window percentiles.

    `window` bounds memory AND defines "rolling": once full, each new
    sample evicts the oldest. `count`/`total` keep the lifetime tally so
    throughput math is not limited to the window. Thread-safe: writers
    (daemon worker threads, async snapshots) and readers (the tick loop's
    summaries) take the same lock.
    """

    def __init__(self, window: int = 4096):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._samples: deque[float] = deque(maxlen=window)
        self._lock = threading.Lock()
        self.count = 0            # lifetime samples (window evicts, this doesn't)
        self.total = 0.0          # lifetime sum

    def record(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._samples.append(v)
            self.count += 1
            self.total += v

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def percentile(self, q: float) -> float:
        with self._lock:
            ordered = sorted(self._samples)
        return percentile(ordered, q)

    def summary(self) -> dict:
        """{count, mean, p50, p95, p99, max} over the rolling window
        (count/mean are lifetime). Zeros when nothing was recorded —
        a dashboard row, not an error."""
        with self._lock:
            ordered = sorted(self._samples)
            count, total = self.count, self.total
        if not ordered:
            return {"count": count, "mean": 0.0,
                    **{f"p{int(q)}": 0.0 for q in PERCENTILES}, "max": 0.0}
        return {"count": count,
                "mean": total / max(count, 1),
                **{f"p{int(q)}": percentile(ordered, q)
                   for q in PERCENTILES},
                "max": ordered[-1]}


class ServiceMetrics:
    """The per-service observability ledger `SpinService` writes into.

    Request lifecycle timestamps (submit → admit → finish, stamped by the
    service from its injectable clock) turn into three latency reservoirs:

      queue_wait  admit − submit   (admission-control pressure)
      solve       finish − admit   (compute, incl. coalesced batchmates)
      total       finish − submit  (what the client experiences)

    plus a queue-depth reservoir sampled once per tick and free-form
    counters (`path_recursion`/`path_maintained`/`path_degraded`,
    `rejected_<reason>`, `batch_failures`, …).

    `registry`: an `obs.registry.MetricsRegistry` every observation is
    mirrored into (`spin_serve_*` metrics); defaults to the process-global
    `default_registry()` so multi-service processes aggregate naturally,
    Prometheus-style. Pass a fresh registry for hermetic tests.
    """

    def __init__(self, *, window: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        from ..obs.registry import default_registry

        self.clock = clock
        self.registry = registry if registry is not None else default_registry()
        self.queue_wait_s = Reservoir(window)
        self.solve_s = Reservoir(window)
        self.total_s = Reservoir(window)
        self.queue_depth = Reservoir(window)
        # served-residual distribution: populated by requests that REPORT a
        # residual (low-precision certified serving, degraded sketches) —
        # the accuracy half of the SLA dashboard next to the latency half
        self.residual = Reservoir(window)
        self.counters: dict[str, int] = {}
        self._counters_lock = threading.Lock()
        self._h_latency = self.registry.histogram(
            "spin_serve_latency_seconds",
            "Request latency split by stage (queue_wait/solve/total)")
        self._h_queue_depth = self.registry.histogram(
            "spin_serve_queue_depth",
            "Queue depth sampled once per tick",
            buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128, 256))
        self._c_requests = self.registry.counter(
            "spin_serve_requests_total", "Completed requests by solve path")
        self._c_events = self.registry.counter(
            "spin_serve_events_total",
            "Free-form service events (rejections, batch failures, ...)")

    def count(self, name: str, k: int = 1) -> None:
        with self._counters_lock:
            self.counters[name] = self.counters.get(name, 0) + k
        self._c_events.inc(k, event=name)

    def observe_queue_depth(self, depth: int) -> None:
        self.queue_depth.record(float(depth))
        self._h_queue_depth.observe(float(depth))

    def observe_solve(self, req) -> None:
        """Record a completed solve's latency split from its timestamps
        (requests that never got a slot — rejected/shed — only count)."""
        if req.path is not None:
            self.count(f"path_{req.path}")
            self._c_requests.inc(path=req.path)
        if getattr(req, "residual_est", None) is not None:
            self.residual.record(float(req.residual_est))
        if req.admit_t is None or req.finish_t is None:
            return
        self.queue_wait_s.record(req.admit_t - req.submit_t)
        self.solve_s.record(req.finish_t - req.admit_t)
        self.total_s.record(req.finish_t - req.submit_t)
        self._h_latency.observe(req.admit_t - req.submit_t,
                                stage="queue_wait")
        self._h_latency.observe(req.finish_t - req.admit_t, stage="solve")
        self._h_latency.observe(req.finish_t - req.submit_t, stage="total")

    def observe_rejection(self, reason: str) -> None:
        self.count("rejected")
        self.count(f"rejected_{reason}")

    def snapshot(self) -> dict:
        """The `SpinService.metrics()` payload: JSON-ready, no live refs."""
        with self._counters_lock:
            counters = dict(self.counters)
        return {
            "latency_s": {"queue_wait": self.queue_wait_s.summary(),
                          "solve": self.solve_s.summary(),
                          "total": self.total_s.summary()},
            "queue_depth": self.queue_depth.summary(),
            "residual": self.residual.summary(),
            "counters": counters,
        }


class PhaseLedger:
    """Named wall-clock phases for measured sections.

    Usage:
        ledger = PhaseLedger()
        with ledger.profile("solve_recursion"):
            ...
        report["phases"] = ledger.to_dict()

    Re-entering a phase name accumulates (and counts) — a phase run per
    request sums to its total share of the run. Thread-safe: phases opened
    on worker/background threads accumulate under a lock, concurrent with
    `to_dict()` reads.
    """

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self.seconds: dict[str, float] = {}
        self.entries: dict[str, int] = {}

    @contextlib.contextmanager
    def profile(self, name: str) -> Iterator[None]:
        t0 = self._clock()
        with torch.profiler.record_function(name):
            try:
                yield
            finally:
                dt = self._clock() - t0
                with self._lock:
                    self.seconds[name] = self.seconds.get(name, 0.0) + dt
                    self.entries[name] = self.entries.get(name, 0) + 1

    def to_dict(self) -> dict:
        with self._lock:
            return {name: {"seconds": self.seconds[name],
                           "entries": self.entries[name]}
                    for name in self.seconds}


def profiled(name: str, ledger: PhaseLedger):
    """Decorator form of `PhaseLedger.profile`."""
    def wrap(fn):
        import functools

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with ledger.profile(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
