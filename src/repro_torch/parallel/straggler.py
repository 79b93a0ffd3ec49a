"""Straggler-robust coded execution: fault injection, deadlines, retries,
and coded panel solves.

The paper's Spark runtime tolerates stragglers and failures through the
RDD scheduler: a lost or slow partition is recomputed elsewhere. The port
keeps the JAX package's layer for that:

  * **coded redundancy** — A⁻¹ is assembled from w worker panel-solves
    A·X_j = B_j (`coded_inverse`). With the ``vandermonde`` scheme the
    right-hand-side panels are MDS-coded combinations of identity panels,
    so any k = w − s results decode all data panels by a k×k solve on the
    code dimension (solving is linear in the right-hand side). With the
    ``replication`` scheme each of the w identity shards is solved by
    s + 1 cyclically assigned workers. Either way any w − s of w workers
    suffice;
  * **deterministic fault injection** — `FaultPlan` scripts stragglers
    (rank → delay) and failures (rank → first failing step + count),
    serializable through the SPIN_FAULT_PLAN env var, so a scenario
    replays identically;
  * **heartbeats and deadlines** — `HeartbeatTracker` records per-shard
    start, last beat and duration; a shard is overdue past a multiple of
    the median completed-shard time, or past an explicit floor;
  * **the worker pool** — `WorkerPool` runs one daemon thread per worker
    (on the card each on its own CUDA stream, so a slow worker does not
    serialise the others), retries a `WorkerFailure` on a geometric
    schedule, and returns as soon as a decodable quorum is in;
  * **background work** — `BackgroundTask` runs a function on a daemon
    thread whose `wait(timeout)` raises `ShardTimeout` at its deadline
    while the work keeps running.

`SpinService` (`serving.spin_service`) guards its exact solves with these.
Workers are logical ranks: threads of one process here, mapped onto
processes by `launch.mesh.local_worker_ranks` in a multi-process run.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import contextlib
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .. import threads as _threads
from ..obs import flight as _flight
from ..obs.registry import default_registry as _default_registry
from ..obs.trace import TRACER as _TRACER

__all__ = [
    "WorkerFailure", "ShardTimeout", "InsufficientWorkers",
    "FaultPlan", "HeartbeatTracker", "retry_with_backoff",
    "BackgroundTask", "start_background",
    "make_generator", "generator_is_mds", "CodedLayout", "CodedConfig",
    "WorkerPool", "PoolReport", "CodedRunReport", "coded_inverse",
    "WORKER_THREAD_PREFIX", "FAULT_PLAN_ENV",
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

        self._thread = _threads.start(_run, name="background-task")

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


# ---------------------------------------------------------------------------
# Coded shard layouts: replication and Vandermonde (MDS) erasure coding
# ---------------------------------------------------------------------------


def make_generator(workers: int, data_shards: int) -> np.ndarray:
    """(w, k) real Vandermonde generator on Chebyshev nodes.

    Rows are [1, x_j, x_j², …] at distinct nodes x_j ∈ (−1, 1), so every
    k×k row-submatrix is a Vandermonde matrix with distinct nodes, hence
    invertible: any k of w coded panels decode (the MDS property).
    Chebyshev spacing keeps the k×k solves well conditioned at the small
    w (≤ 16) this layer targets.
    """
    if not 0 < data_shards <= workers:
        raise ValueError(f"need 0 < k <= w, got k={data_shards}, w={workers}")
    nodes = np.cos(np.pi * (2 * np.arange(workers) + 1) / (2 * workers))
    return np.vander(nodes, data_shards, increasing=True)


def generator_is_mds(g: np.ndarray) -> bool:
    """Check every k-row submatrix is invertible (exhaustive: only for the
    small w of tests)."""
    import itertools

    w, k = g.shape
    for rows in itertools.combinations(range(w), k):
        sub = g[list(rows), :]
        if abs(np.linalg.det(sub)) < 1e-12 * max(1.0, abs(sub).max()) ** k:
            return False
    return True


@dataclasses.dataclass(frozen=True)
class CodedLayout:
    """How n identity columns map onto w workers' right-hand-side panels.

    vandermonde: k = w − s data shards of ceil(n/k) columns; worker j
    solves the coded panel Σ_m G[j,m]·E_m. replication: w data shards of
    ceil(n/w) columns; worker j solves shards {j, …, j+s mod w}
    concatenated, so any s losses leave each shard an owner.
    """

    n: int
    workers: int
    redundancy: int
    scheme: str                       # "replication" | "vandermonde"
    generator: Optional[np.ndarray]   # (w, k), vandermonde only

    @classmethod
    def build(cls, n: int, workers: int, redundancy: int,
              scheme: str = "vandermonde") -> "CodedLayout":
        if scheme not in ("replication", "vandermonde"):
            raise ValueError(f"unknown coding scheme {scheme!r}")
        if not 0 <= redundancy < workers:
            raise ValueError(
                f"redundancy must be in [0, workers), got s={redundancy} "
                f"w={workers}")
        gen = (make_generator(workers, workers - redundancy)
               if scheme == "vandermonde" else None)
        return cls(n=n, workers=workers, redundancy=redundancy,
                   scheme=scheme, generator=gen)

    @property
    def data_shards(self) -> int:
        return (self.workers - self.redundancy
                if self.scheme == "vandermonde" else self.workers)

    @property
    def shard_cols(self) -> int:
        k = self.data_shards
        return -(-self.n // k)                    # ceil(n / k)

    @property
    def quorum(self) -> int:
        """Results needed before decode can even be attempted."""
        return self.workers - self.redundancy

    def owners(self, shard: int) -> list[int]:
        """Workers computing data shard `shard` (replication only)."""
        if self.scheme != "replication":
            raise ValueError("owners() is a replication-scheme concept")
        w, s = self.workers, self.redundancy
        return sorted((shard - d) % w for d in range(s + 1))

    def worker_shards(self, rank: int) -> list[int]:
        if self.scheme != "replication":
            raise ValueError("worker_shards() is a replication-scheme "
                             "concept")
        return [(rank + d) % self.workers for d in range(self.redundancy + 1)]

    def _data_panel(self, shard: int, dtype) -> np.ndarray:
        """Identity columns of data shard `shard`, zero-padded to shard_cols
        (padding columns decode to A⁻¹·0 = 0 and are sliced away)."""
        cols = self.shard_cols
        e = np.zeros((self.n, cols), dtype=dtype)
        lo = shard * cols
        for c in range(cols):
            if lo + c < self.n:
                e[lo + c, c] = 1.0
        return e

    def worker_rhs(self, rank: int, dtype=np.float32) -> np.ndarray:
        """The (n, cols) right-hand-side panel worker `rank` solves."""
        if self.scheme == "vandermonde":
            acc = np.zeros((self.n, self.shard_cols), dtype=np.float64)
            for m in range(self.data_shards):
                acc += self.generator[rank, m] * self._data_panel(
                    m, np.float64)
            return acc.astype(dtype)
        panels = [self._data_panel(s, dtype)
                  for s in self.worker_shards(rank)]
        return np.concatenate(panels, axis=1)

    def can_decode(self, available: set[int]) -> bool:
        if self.scheme == "vandermonde":
            return len(available) >= self.data_shards
        return all(any(o in available for o in self.owners(s))
                   for s in range(self.data_shards))

    def decode(self, results: dict):
        """Assemble A⁻¹ (n, n) in float64 from any decodable subset of
        worker panels, always from the lowest decodable ranks, so one fault
        scenario always decodes from the same subset. numpy panels decode
        in numpy, as the JAX package's do; torch panels decode in torch on
        their device (the inverse of the k×k generator block is taken in
        numpy either way)."""
        available = set(results)
        if not self.can_decode(available):
            raise InsufficientWorkers(
                f"cannot decode from ranks {sorted(available)} "
                f"(scheme={self.scheme}, w={self.workers}, "
                f"s={self.redundancy})")
        cols, k = self.shard_cols, self.data_shards
        on_torch = isinstance(next(iter(results.values())), torch.Tensor)
        if self.scheme == "vandermonde":
            use = sorted(available)[:k]
            g_inv = np.linalg.inv(self.generator[use, :])       # (k, k)
            if on_torch:
                stacked = torch.stack([results[r].double() for r in use])
                data = torch.einsum("mj,jnc->mnc", torch.from_numpy(g_inv).to(
                    stacked.device), stacked)
                return torch.cat(list(data), dim=1)[:, :self.n]
            stacked = np.stack([np.asarray(results[r], dtype=np.float64)
                                for r in use])                  # (k, n, c)
            data = np.einsum("mj,jnc->mnc", g_inv, stacked)
            return np.concatenate(list(data), axis=1)[:, :self.n]
        panels = []
        for shard in range(k):
            owner = min(o for o in self.owners(shard) if o in available)
            pos = self.worker_shards(owner).index(shard)
            block = results[owner] if on_torch else np.asarray(results[owner])
            panels.append(block[:, pos * cols:(pos + 1) * cols])
        if on_torch:
            return torch.cat(panels, dim=1)[:, :self.n].double()
        return np.concatenate(panels, axis=1)[:, :self.n]


# ---------------------------------------------------------------------------
# The worker pool
# ---------------------------------------------------------------------------

# Worker threads are named "<prefix><rank>", so a caller can join the
# stragglers a pool returned without waiting for.
WORKER_THREAD_PREFIX = "coded-worker-"


@dataclasses.dataclass
class PoolReport:
    results: dict[int, Any]
    errors: dict[int, BaseException]
    stragglers: list[int]             # ranks declared overdue (still running)
    attempts: dict[int, int]
    wall_s: float
    median_shard_s: float | None


class WorkerPool:
    """One daemon thread per logical worker, with scripted faults,
    heartbeat/deadline tracking, retry with exponential backoff, and early
    return on a decodable quorum: a straggler left running never blocks
    the caller, and the exit hook of `repro_torch.threads` lets it finish
    before the process exits."""

    def __init__(self, workers: int, *, fault_plan: FaultPlan | None = None,
                 deadline_factor: float = 10.0, min_deadline_s: float = 0.05,
                 retries: int = 2, backoff_base_s: float = 0.01,
                 poll_s: float = 0.002, overall_timeout_s: float | None = None):
        self.workers = workers
        self.fault_plan = fault_plan
        self.deadline_factor = deadline_factor
        self.min_deadline_s = min_deadline_s
        self.retries = retries
        self.backoff_base_s = backoff_base_s
        self.poll_s = poll_s
        self.overall_timeout_s = overall_timeout_s

    def run(self, tasks: Sequence[Callable[[], Any]], *,
            complete_when: Callable[[set[int]], bool] | None = None,
            required: int | None = None) -> PoolReport:
        """Run tasks[rank]() per rank; return once `complete_when(done
        ranks)` holds (default: `required` results in, default all)."""
        w = len(tasks)
        need = w if required is None else required
        ready = complete_when or (lambda av: len(av) >= need)
        tracker = HeartbeatTracker()
        lock = threading.Lock()
        results: dict[int, Any] = {}
        errors: dict[int, BaseException] = {}
        attempts: dict[int, int] = {}
        stragglers: set[int] = set()
        t0 = time.monotonic()

        def _worker(rank: int):
            tracker.record_start(rank)
            _timeline("worker.start", rank=rank)

            def attempt(i: int):
                if i > 0:
                    _timeline("worker.retry", rank=rank, attempt=i)
                if self.fault_plan is not None:
                    self.fault_plan.apply(rank, step=i)
                tracker.heartbeat(rank)
                return tasks[rank]()

            try:
                res, used = retry_with_backoff(
                    attempt, retries=self.retries,
                    base_s=self.backoff_base_s)
                tracker.done(rank)
                _timeline("worker.done", rank=rank, attempts=used,
                          duration_s=tracker.durations.get(rank))
                with lock:
                    results[rank] = res
                    attempts[rank] = used
            except WorkerFailure as e:
                _timeline("worker.failed", rank=rank,
                          attempts=self.retries + 1, error=str(e))
                _flight.recorder().dump("worker-failure")
                with lock:
                    errors[rank] = e
                    attempts[rank] = self.retries + 1

        for r in range(w):
            _threads.start(_worker, args=(r,), name=f"{WORKER_THREAD_PREFIX}{r}")
        while True:
            with lock:
                done = set(results)
                failed = set(errors)
            if ready(done):
                break
            for rank in tracker.outstanding():
                if rank not in failed and rank not in stragglers \
                        and tracker.overdue(
                            rank, factor=self.deadline_factor,
                            floor=self.min_deadline_s):
                    stragglers.add(rank)
                    _timeline("worker.overdue", rank=rank,
                              median_shard_s=tracker.median())
            if len(done) + len(failed) == w:
                _timeline("pool.quorum_failed", done=sorted(done),
                          failed=sorted(failed), need=need)
                _flight.recorder().dump("insufficient-workers")
                raise InsufficientWorkers(
                    f"all workers finished but quorum not met: "
                    f"{sorted(done)} succeeded, {sorted(failed)} failed")
            if (self.overall_timeout_s is not None
                    and time.monotonic() - t0 > self.overall_timeout_s):
                _timeline("pool.timeout", done=sorted(done),
                          failed=sorted(failed),
                          timeout_s=self.overall_timeout_s)
                _flight.recorder().dump("pool-timeout")
                raise InsufficientWorkers(
                    f"quorum not met within {self.overall_timeout_s}s: "
                    f"{sorted(done)} succeeded, {sorted(failed)} failed")
            time.sleep(self.poll_s)
        if stragglers:
            # Quorum met with workers left overdue: dump the timeline for
            # the postmortem unprompted.
            _timeline("pool.quorum_with_stragglers",
                      stragglers=sorted(stragglers), done=sorted(done))
            _flight.recorder().dump("stragglers")
        with lock:
            return PoolReport(
                results=dict(results), errors=dict(errors),
                stragglers=sorted(stragglers), attempts=dict(attempts),
                wall_s=time.monotonic() - t0,
                median_shard_s=tracker.median())


# ---------------------------------------------------------------------------
# Coded inversion entry point
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CodedConfig:
    """Coded-execution knobs for spin_inverse_sharded(coded=…).

    redundancy=None asks `core.costmodel.plan_redundancy` (the s+1 or
    w/(w−s) work overhead against the expected straggler penalty) to
    choose s. A worker is overdue past max(min_deadline_s,
    deadline_factor × the median completed-worker time).
    """

    workers: int = 4
    redundancy: int | None = 1
    scheme: str = "vandermonde"
    deadline_factor: float = 10.0
    min_deadline_s: float = 0.05
    retries: int = 2
    backoff_base_s: float = 0.01
    straggler_prob: float = 0.05
    straggler_slowdown: float = 10.0


@dataclasses.dataclass
class CodedRunReport:
    layout: CodedLayout
    used_ranks: list[int]             # ranks whose results fed the decode
    stragglers: list[int]
    failed: list[int]
    attempts: dict[int, int]
    wall_s: float
    median_shard_s: float | None


def _decode_ranks(layout: CodedLayout, available: set[int]) -> list[int]:
    if layout.scheme == "vandermonde":
        return sorted(available)[:layout.data_shards]
    used = set()
    for shard in range(layout.data_shards):
        used.add(min(o for o in layout.owners(shard) if o in available))
    return sorted(used)


def coded_inverse(a, config: CodedConfig | None = None, *,
                  block_size: int | None = None,
                  leaf_solver: str = "linalg", engine: str | None = None,
                  sharded: bool = False,
                  fault_plan: FaultPlan | None = None,
                  overall_timeout_s: float | None = None,
                  device: str | torch.device | None = None):
    """Invert dense SPD `a` by w coded panel solves; any w−s workers suffice.

    Each worker solves A·X_j = B_j for its coded right-hand-side panel
    through the SPIN solve (`spin_solve_dense`, or the mesh-resident
    `spin_solve_sharded` over the caller's ambient mesh when sharded=True),
    on a CUDA stream of its own on the card, and waits for its own stream
    inside the worker, so the deadlines see device time. The results
    decode to A⁻¹ (float64, on the call's device) without waiting on
    overdue workers. Returns (inverse in a's dtype on the call's device,
    CodedRunReport).

    fault_plan=None picks up $SPIN_FAULT_PLAN when set; pass FaultPlan()
    to force a fault-free run. `device` applies as on the solve entry
    points (default the card; a mesh decides under sharded=True).
    """
    from ..core.multiply import current_engine, validate_engine
    from ..core.solve import spin_solve_dense, spin_solve_sharded
    from ..core.spin import _sharded_device
    from ..device import DEFAULT_DEVICE, resolve_device
    from ..launch.mesh import current_mesh, set_mesh

    validate_engine(engine)
    cfg = config or CodedConfig()
    if fault_plan is None:
        fault_plan = FaultPlan.from_env()
    dev = (_sharded_device(device) if sharded
           else resolve_device(DEFAULT_DEVICE if device is None else device))
    a = torch.as_tensor(a).to(dev)
    n, dtype = int(a.shape[0]), a.dtype
    if block_size is None:
        from ..planner import planned_block_size

        block_size = planned_block_size(n, dtype, kind="solve",
                                        backend=dev.type)
    redundancy = cfg.redundancy
    if redundancy is None:
        from ..core.costmodel import plan_redundancy
        from ..obs import ledger as obs_ledger

        # The observed straggle history replaces the static guess once
        # enough coded runs are on record.
        prob = obs_ledger.ledger().observed_straggler_prob(cfg.straggler_prob)
        redundancy = plan_redundancy(
            cfg.workers, straggler_prob=prob,
            straggler_slowdown=cfg.straggler_slowdown, scheme=cfg.scheme)
        _timeline("coded.redundancy_planned", workers=cfg.workers,
                  redundancy=redundancy, straggler_prob=prob,
                  observed=prob != cfg.straggler_prob)
    layout = CodedLayout.build(n, cfg.workers, redundancy, cfg.scheme)
    rhs_panels = [torch.from_numpy(layout.worker_rhs(r, np.float32)
                                   ).to(dev, dtype)
                  for r in range(cfg.workers)]
    # Worker threads start with no ambient mesh or engine: carry the
    # caller's into each.
    mesh = current_mesh()
    if mesh is not None and mesh.spans_processes:
        raise NotImplementedError(
            "the coded pool's worker threads post transfers in no fixed order: a mesh "
            "that spans processes is driven from one thread")
    engine = engine or current_engine()
    cuda = dev.type == "cuda"
    ready = None
    if cuda:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))

    def make_task(rank: int):
        stream = torch.cuda.Stream(dev) if cuda else None

        def task():
            ctx = (torch.cuda.stream(stream) if cuda
                   else contextlib.nullcontext())
            with set_mesh(mesh), ctx:
                if cuda:
                    stream.wait_event(ready)       # operands are written
                if sharded:
                    x = spin_solve_sharded(a, rhs_panels[rank], block_size,
                                           leaf_solver=leaf_solver,
                                           engine=engine)
                else:
                    x = spin_solve_dense(a, rhs_panels[rank], block_size,
                                         leaf_solver, engine=engine,
                                         device=dev)
                if cuda:
                    stream.synchronize()
            return x
        return task

    pool = WorkerPool(cfg.workers, fault_plan=fault_plan,
                      deadline_factor=cfg.deadline_factor,
                      min_deadline_s=cfg.min_deadline_s,
                      retries=cfg.retries,
                      backoff_base_s=cfg.backoff_base_s,
                      overall_timeout_s=overall_timeout_s)
    report = pool.run([make_task(r) for r in range(cfg.workers)],
                      complete_when=layout.can_decode)
    if cuda:
        # The panels were made on the workers' streams: their memory must
        # not be handed back to those streams while the decode reads it.
        for x in report.results.values():
            x.record_stream(torch.cuda.current_stream(dev))
    inv = layout.decode(report.results)   # float64, on the device
    run = CodedRunReport(
        layout=layout,
        used_ranks=_decode_ranks(layout, set(report.results)),
        stragglers=report.stragglers,
        failed=sorted(report.errors),
        attempts=report.attempts,
        wall_s=report.wall_s,
        median_shard_s=report.median_shard_s)
    _timeline("coded.decode", used_ranks=run.used_ranks,
              stragglers=run.stragglers, failed=run.failed,
              wall_s=run.wall_s, scheme=layout.scheme)
    _publish_coded_run(run, cfg.workers)
    return inv.to(dtype), run


def _publish_coded_run(run: CodedRunReport, workers: int) -> None:
    """Fold a CodedRunReport into the cost ledger's straggle statistics
    (which feed the next `plan_redundancy`) and publish it to the default
    metrics registry (`SpinService.metrics()["registry"]`)."""
    from ..obs import ledger as obs_ledger

    obs_ledger.ledger().record_coded_run(run, workers)
    reg = _default_registry()
    reg.counter("spin_coded_runs_total",
                "Coded inversions completed").inc()
    reg.counter("spin_coded_workers_total",
                "Worker executions launched by coded runs").inc(workers)
    reg.counter("spin_coded_stragglers_total",
                "Workers declared overdue during coded runs"
                ).inc(len(run.stragglers))
    reg.counter("spin_coded_worker_failures_total",
                "Workers that exhausted retries").inc(len(run.failed))
    reg.counter("spin_coded_retries_total",
                "Retry attempts beyond the first, across workers").inc(
                    sum(max(a - 1, 0) for a in run.attempts.values()))
    reg.gauge("spin_coded_last_used_ranks",
              "Ranks whose panels fed the last decode").set(
                  len(run.used_ranks))
    reg.gauge("spin_coded_last_median_shard_seconds",
              "Median completed-shard seconds of the last coded run").set(
                  run.median_shard_s or 0.0)
    reg.histogram("spin_coded_wall_seconds",
                  "Coded-inversion wall time").observe(run.wall_s)
