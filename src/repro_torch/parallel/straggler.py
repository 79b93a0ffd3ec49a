"""Fault injection, deadlines and retries for straggler-robust execution.

The paper's Spark runtime tolerates stragglers and failures through the
RDD scheduler: a lost or slow partition is recomputed elsewhere. The port
keeps the JAX package's runtime pieces for that:

  * **deterministic fault injection** — `FaultPlan` scripts stragglers
    (rank → delay) and failures (rank → first failing step + count),
    serializable through the SPIN_FAULT_PLAN env var, so a scenario
    replays identically;
  * **heartbeats and deadlines** — `HeartbeatTracker` records per-shard
    start, last beat and duration; a shard is overdue past a multiple of
    the median completed-shard time;
  * **retries and background work** — `retry_with_backoff` retries a
    `WorkerFailure` on a geometric schedule, and `BackgroundTask` runs a
    function on a daemon thread whose `wait(timeout)` raises
    `ShardTimeout` at its deadline while the work keeps running.

`SpinService` (`serving.spin_service`) guards its exact solves with these.
The coded half of the JAX module (MDS-coded panel solves over a worker
pool) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from ..obs import flight as _flight
from ..obs.trace import TRACER as _TRACER

__all__ = [
    "WorkerFailure", "ShardTimeout", "InsufficientWorkers",
    "FaultPlan", "HeartbeatTracker", "retry_with_backoff",
    "BackgroundTask", "start_background", "FAULT_PLAN_ENV",
]

FAULT_PLAN_ENV = "SPIN_FAULT_PLAN"


def _timeline(event: str, **attrs) -> None:
    """One worker-timeline event: a tracer span when $SPIN_TRACE is on
    (the tracer mirrors every span into the flight recorder), else a
    direct flight-recorder append — the ring always carries the timeline
    a failure dump needs, and nothing is recorded twice."""
    if _TRACER.enabled:
        _TRACER.event(event, "worker_event", **attrs)
    else:
        _flight.recorder().record("worker_event", name=event, **attrs)


class WorkerFailure(RuntimeError):
    """A worker died mid-shard (injected by a FaultPlan, or real)."""


class ShardTimeout(RuntimeError):
    """A guarded shard missed its deadline (the shard keeps running)."""


class InsufficientWorkers(RuntimeError):
    """Fewer than the decodable quorum of workers reported results."""


# ---------------------------------------------------------------------------
# Deterministic fault injection
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FaultPlan:
    """Scripted faults: which ranks straggle (and by how much) and which
    ranks fail (from which step, how many times). Everything is explicit and
    seeded, so a scenario replays identically — the harness serializes plans
    through the SPIN_FAULT_PLAN env var for subprocess harnesses.

    `apply(rank, step)` is called by the executor at the top of every attempt:
    it sleeps the rank's injected delay, then raises `WorkerFailure` if the
    rank is scripted to fail at this step. `check(rank, step)` is the
    no-sleep variant for op-granular faults (e.g. solver_ckpt's on_op hook).
    """

    stragglers: dict[int, float] = dataclasses.field(default_factory=dict)
    failures: dict[int, dict] = dataclasses.field(default_factory=dict)
    seed: int = 0

    def __post_init__(self):
        self._raised: dict[int, int] = {}
        self._lock = threading.Lock()

    # -- construction --------------------------------------------------------

    def inject_straggler(self, rank: int, delay_s: float) -> "FaultPlan":
        self.stragglers[int(rank)] = float(delay_s)
        return self

    def inject_failure(self, rank: int, at_level: int = 0,
                       count: int | None = None) -> "FaultPlan":
        """Rank starts failing at step/level `at_level`; `count=None` means
        it stays dead (every later attempt fails), count=k injects exactly k
        transient failures (retry then succeeds)."""
        self.failures[int(rank)] = {"at": int(at_level),
                                    "count": None if count is None
                                    else int(count)}
        return self

    # -- runtime -------------------------------------------------------------

    def delay_for(self, rank: int) -> float:
        return self.stragglers.get(int(rank), 0.0)

    def check(self, rank: int, step: int) -> None:
        """Raise WorkerFailure if `rank` is scripted to fail at `step`."""
        f = self.failures.get(int(rank))
        if f is None or step < f["at"]:
            return
        with self._lock:
            raised = self._raised.get(int(rank), 0)
            if f["count"] is not None and raised >= f["count"]:
                return
            self._raised[int(rank)] = raised + 1
        raise WorkerFailure(
            f"injected failure: rank {rank} at step {step}")

    def apply(self, rank: int, step: int = 0, *,
              sleep: Callable[[float], None] = time.sleep) -> None:
        delay = self.delay_for(rank)
        if delay > 0:
            sleep(delay)
        self.check(rank, step)

    # -- serialization (env var for subprocess harnesses) ---------------------

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "stragglers": self.stragglers,
                           "failures": self.failures})

    @classmethod
    def from_json(cls, payload: str) -> "FaultPlan":
        d = json.loads(payload)
        return cls(
            stragglers={int(k): float(v)
                        for k, v in d.get("stragglers", {}).items()},
            failures={int(k): {"at": int(v["at"]),
                               "count": None if v.get("count") is None
                               else int(v["count"])}
                      for k, v in d.get("failures", {}).items()},
            seed=int(d.get("seed", 0)))

    def env(self) -> dict[str, str]:
        return {FAULT_PLAN_ENV: self.to_json()}

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        from .. import envconfig

        payload = envconfig.env_raw(FAULT_PLAN_ENV)
        return cls.from_json(payload) if payload else None


# ---------------------------------------------------------------------------
# Heartbeats, deadlines, backoff
# ---------------------------------------------------------------------------


class HeartbeatTracker:
    """Per-shard start/heartbeat/duration ledger with a median-based deadline.

    A shard is `overdue` once now − start > max(floor, factor × median
    completed-shard time); with no completions yet only the floor applies.
    The clock is injectable so deadline logic is unit-testable without
    real sleeps.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self.starts: dict[int, float] = {}
        self.beats: dict[int, float] = {}
        self.durations: dict[int, float] = {}

    def record_start(self, shard: int) -> None:
        with self._lock:
            now = self._clock()
            self.starts[shard] = now
            self.beats[shard] = now

    def heartbeat(self, shard: int) -> None:
        with self._lock:
            self.beats[shard] = self._clock()

    def done(self, shard: int) -> None:
        with self._lock:
            self.beats[shard] = self._clock()
            self.durations[shard] = self.beats[shard] - self.starts[shard]

    def median(self) -> float | None:
        with self._lock:
            if not self.durations:
                return None
            return float(np.median(list(self.durations.values())))

    def outstanding(self) -> list[int]:
        with self._lock:
            return sorted(s for s in self.starts if s not in self.durations)

    def overdue(self, shard: int, *, factor: float = 10.0,
                floor: float = 0.05) -> bool:
        med = self.median()
        deadline = floor if med is None else max(floor, factor * med)
        with self._lock:
            start = self.starts.get(shard)
            if start is None or shard in self.durations:
                return False
            return self._clock() - start > deadline


def retry_with_backoff(fn: Callable[[int], Any], *, retries: int = 2,
                       base_s: float = 0.01, factor: float = 2.0,
                       sleep: Callable[[float], None] = time.sleep
                       ) -> tuple[Any, int]:
    """Call fn(attempt); on WorkerFailure retry with exponential backoff.

    Returns (result, attempts_used). The last failure propagates once the
    retry budget is exhausted. Deterministic: backoff is a pure geometric
    series (no jitter — the injected schedules are scripted, and on real
    fleets the per-rank seeds of FaultPlan can decorrelate retries).
    """
    attempt = 0
    while True:
        try:
            return fn(attempt), attempt + 1
        except WorkerFailure:
            if attempt >= retries:
                raise
            sleep(base_s * factor ** attempt)
            attempt += 1


class BackgroundTask:
    """A function running on a daemon thread with a waitable result."""

    def __init__(self, fn: Callable[[], Any]):
        self._done = threading.Event()
        self._result: Any = None
        self._error: BaseException | None = None

        def _run():
            try:
                self._result = fn()
            except BaseException as e:            # marshalled to wait()
                self._error = e
            finally:
                self._done.set()

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def error(self) -> BaseException | None:
        return self._error

    def wait(self, timeout: float | None = None) -> Any:
        if not self._done.wait(timeout):
            raise ShardTimeout(f"shard missed its {timeout}s deadline")
        if self._error is not None:
            raise self._error
        return self._result


def start_background(fn: Callable[[], Any]) -> BackgroundTask:
    return BackgroundTask(fn)
