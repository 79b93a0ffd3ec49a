"""Cost ledger: modeled cost against measured wall clock, fed back to the
planner.

SPIN's central empirical claim is that the Lemma-4.1 running times match
the observed wall clock (the paper's Fig. 4). This module keeps that
comparison running in service:

  * every traced planned inversion or solve records a `LedgerEntry`
    pairing the plan's modeled seconds (`planner.autotune.predict_cost`)
    with the measured wall clock of the same call. Entries are recorded
    only while `SPIN_TRACE` is on, because measuring needs a device
    synchronisation that the untraced path never pays;
  * `flush_calibration()` fits `costmodel.fit_scale` constants from the
    entries on the backend's base axis and keeps them in the plan cache
    (`PlanCache.put_calibration`), as the autotuner's timings do;
  * `record_coded_run` folds a coded run's report into per-process
    straggle statistics, and `observed_straggler_prob()` gives the rate
    seen once enough runs are on record; `parallel.straggler.coded_inverse`
    writes those records and reads the rate back when it plans its
    redundancy.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

__all__ = ["LedgerEntry", "StraggleStats", "CostLedger", "ledger",
           "set_ledger", "MIN_CODED_RUNS"]

# Observed straggle rates are trusted only past this many coded runs —
# below it one unlucky run would swing `plan_redundancy` wildly.
MIN_CODED_RUNS = 3


@dataclasses.dataclass
class LedgerEntry:
    """One traced solve: what the model said vs what the clock said."""

    kind: str                  # "inverse" | "solve"
    n: int
    b: int                     # block grid
    block_size: int
    leaf_solver: str
    engine: str
    dtype: str
    backend: str              # "cuda" | "cpu"
    predicted_s: Optional[float]
    measured_s: float
    source: str = "traced"     # provenance of the prediction

    @property
    def ratio(self) -> Optional[float]:
        """modeled / measured — 1.0 is a perfect model."""
        if not self.predicted_s or self.measured_s <= 0:
            return None
        return self.predicted_s / self.measured_s

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ratio"] = self.ratio
        return d


@dataclasses.dataclass
class StraggleStats:
    """Per-process straggle history folded from CodedRunReports."""

    runs: int = 0
    worker_slots: int = 0      # total worker executions observed
    stragglers: int = 0        # workers declared overdue
    failures: int = 0          # workers that exhausted retries
    extra_attempts: int = 0    # retries beyond the first attempt
    per_rank: dict = dataclasses.field(default_factory=dict)

    def straggler_prob(self) -> float:
        if self.worker_slots == 0:
            return 0.0
        # Failures count as stragglers for redundancy planning: a dead
        # worker delays completion at least as much as an overdue one.
        return (self.stragglers + self.failures) / self.worker_slots


class CostLedger:
    """Thread-safe store of LedgerEntries + coded-run straggle stats."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: list[LedgerEntry] = []
        self._straggle = StraggleStats()

    # -- modeled-vs-measured entries -----------------------------------------

    def record(self, entry: LedgerEntry) -> None:
        with self._lock:
            if len(self._entries) < self.capacity:
                self._entries.append(entry)

    def record_solve(self, *, kind: str, n: int, plan, backend: str,
                     dtype: str, measured_s: float,
                     predicted_s: float | None = None) -> LedgerEntry:
        """Record one traced planned execution from its Plan + wall time."""
        entry = LedgerEntry(
            kind=kind, n=int(n), b=plan.grid(int(n)),
            block_size=plan.block_size, leaf_solver=plan.leaf_solver,
            engine=plan.multiply_engine, dtype=dtype, backend=backend,
            predicted_s=(predicted_s if predicted_s is not None
                         else plan.predicted_s),
            measured_s=float(measured_s))
        self.record(entry)
        return entry

    def entries(self, kind: str | None = None) -> list[LedgerEntry]:
        with self._lock:
            out = list(self._entries)
        if kind is not None:
            out = [e for e in out if e.kind == kind]
        return out

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._straggle = StraggleStats()

    def summary(self) -> dict:
        """Aggregate model quality: count + mean/worst modeled/measured
        ratio, plus the straggle statistics."""
        entries = self.entries()
        ratios = [e.ratio for e in entries if e.ratio is not None]
        with self._lock:
            straggle = dataclasses.asdict(self._straggle)
        straggle["straggler_prob"] = self._straggle.straggler_prob()
        return {
            "entries": len(entries),
            "with_prediction": len(ratios),
            "mean_ratio": (sum(ratios) / len(ratios)) if ratios else None,
            "min_ratio": min(ratios) if ratios else None,
            "max_ratio": max(ratios) if ratios else None,
            "straggle": straggle,
        }

    # -- calibration feedback ------------------------------------------------

    def calibration_points(self, kind: str = "inverse"
                           ) -> dict[tuple[int, str], dict[int, float]]:
        """Base-axis {(n, dtype): {b: best measured seconds}} groups.

        Same axis rule as `autotune._calibration_points`: the leaf and
        engine whose rate multipliers are 1.0 on the entry's backend
        (linalg/einsum on the CPU, cuda/cuda on the card), so the fit
        recovers the shared constants. Best (min) per grid, as in
        `measure_plans`: noise is additive.
        """
        from ..planner.autotune import _BASE_AXIS

        groups: dict[tuple[int, str], dict[int, float]] = {}
        for e in self.entries(kind):
            if (e.leaf_solver, e.engine) != _BASE_AXIS.get(e.backend):
                continue
            pts = groups.setdefault((e.n, e.dtype), {})
            pts[e.b] = min(pts.get(e.b, float("inf")), e.measured_s)
        return groups

    def flush_calibration(self, cache=None, *, min_grids: int = 3,
                          kind: str = "inverse") -> dict | None:
        """Fit cost-model constants from recorded entries and persist them.

        Needs >= `min_grids` distinct block grids for one (n, dtype).
        Returns the new constants, or None when no group qualifies. The
        constants are kept under the signature of the entries' backend.
        """
        from ..core.costmodel import fit_scale, spin_cost
        from ..planner.autotune import _BASE_AXIS
        from ..planner.cache import default_cache
        from ..planner.plan import signature_for

        best = None
        for (n, dtype), pts in self.calibration_points(kind).items():
            if len(pts) >= min_grids and (best is None
                                          or len(pts) > len(best[2])):
                best = (n, dtype, pts)
        if best is None:
            return None
        n, dtype, pts = best
        backend = next(e.backend for e in self.entries(kind)
                       if (e.n, e.dtype) == (n, dtype)
                       and (e.leaf_solver, e.engine) == _BASE_AXIS.get(e.backend))
        sig = signature_for(kind, n, dtype, backend=backend)
        fit = fit_scale(spin_cost, pts, n=n, cores=sig.cores)
        constants = {"t_flop": fit.t_flop, "t_leaf": fit.t_leaf,
                     "t_block_op": fit.t_block_op, "t_elem": fit.t_elem}
        (cache or default_cache()).put_calibration(sig, constants)
        return constants

    # -- straggle feedback ---------------------------------------------------

    def record_coded_run(self, report, workers: int) -> None:
        """Fold one CodedRunReport into the straggle statistics."""
        with self._lock:
            s = self._straggle
            s.runs += 1
            s.worker_slots += int(workers)
            s.stragglers += len(report.stragglers)
            s.failures += len(report.failed)
            s.extra_attempts += sum(max(a - 1, 0)
                                    for a in report.attempts.values())
            for rank in report.stragglers:
                key = str(rank)
                s.per_rank[key] = s.per_rank.get(key, 0) + 1

    def observed_straggler_prob(self, default: float,
                                *, min_runs: int = MIN_CODED_RUNS) -> float:
        """Observed per-worker straggle rate, or `default` below min_runs.

        A zero observed rate is floored at half the default rather than 0:
        `plan_redundancy` at p=0 would drop ALL redundancy, and absence of
        stragglers in a handful of runs is weak evidence they never occur.
        """
        with self._lock:
            runs = self._straggle.runs
            prob = self._straggle.straggler_prob()
        if runs < min_runs:
            return default
        return max(prob, default / 2.0)

    def straggle_stats(self) -> StraggleStats:
        with self._lock:
            return dataclasses.replace(
                self._straggle, per_rank=dict(self._straggle.per_rank))


_ledger = CostLedger()


def ledger() -> CostLedger:
    """The process-global cost ledger."""
    return _ledger


def set_ledger(new: CostLedger) -> CostLedger:
    """Swap the global ledger (hermetic tests); returns the previous one."""
    global _ledger
    prev, _ledger = _ledger, new
    return prev
