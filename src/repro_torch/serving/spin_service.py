"""SpinService: the online inverse server.

The offline stack (solve → planner → recursion → kernels) answers "invert
this matrix once, fast". `SpinService` serves a long-lived inverse: a
stream of solve requests while the matrix itself changes underneath.

  * **the factorization stays on the device** — each admitted matrix
    keeps its current A and maintained A⁻¹ as dense tensors on the
    service's device (``device="cuda"`` by default; the tests pass
    ``"cpu"``);
  * **continuous batching** — the slot scheduler of `ServingEngine`: a
    fixed pool of slots, requests admitted from a queue as slots free up,
    one `tick()` advancing every live slot. Solves on the same matrix AND
    the same rhs dtype are COALESCED into one multi-RHS call a tick, so c
    concurrent requests cost one panel recursion instead of c (the dtype
    is part of the key: concatenating a bf16 panel beside an f32 one
    would upcast it and change the f32 request's bits);
  * **admission control** (`serving.admission`) — a bounded queue with
    priority- and deadline-aware admission and an explicit shed-load
    policy: at `max_queue` a new request either evicts a strictly
    lower-priority queued solve (the victim gets a typed `Rejection`) or
    is rejected at submission with `AdmissionRejected`;
    `per_matrix_quota` keeps one hot tenant from starving the rest;
    queued requests whose deadline expires are shed, never served late.
    Every outcome is a typed verdict;
  * **observability** (`serving.metrics`, `obs`) — per-request queue
    wait, solve and total latency with rolling p50/p95/p99, the queue
    depth sampled a tick, counters by path and rejection reason, surfaced
    as `metrics()` and mirrored into the `obs` registry; a "serve.tick"
    span a tick under $SPIN_TRACE;
  * **exact path** — a matrix with no pending churn serves its coalesced
    batch through `spin_solve_dense` with the matrix's planned
    configuration, bitwise the offline call on the same stacked panel.
    Once SMW updates are folded in, solves come from the maintained
    inverse in O(n²·c) (`core.update.apply_inverse`);
  * **low-precision serving** (`core.precision.PrecisionPolicy`) — a
    matrix admitted under a low-precision policy (``precision="bf16"``,
    a policy object, or the service's or $SPIN_PRECISION's default)
    keeps its maintained inverse at the policy's store dtype and serves
    every request from it through the policy's compute dtype with an f32
    accumulator: one product (B2's bf16 body on the card), never the
    recursion. The serve error is CERTIFIED: after factorization and
    after every SMW fold the service probes the residual through the same
    product and, only when the probe exceeds the policy's bound, runs
    Newton–Schulz polish sweeps (f32, recast to the store dtype) until it
    is back under the bound or the policy's cap. The certified residual
    rides each request (`SolveRequest.residual_est`);
  * **incremental updates** — rank-k changes and block row/column
    replacements (`UpdateRequest`) fold into the maintained inverse by
    the Woodbury identity in O(n²k) (`core.update.smw_update_inverse`),
    with A kept in step (`add_low_rank`);
  * **refactor policy** — every update is priced by
    `planner.RefactorPolicy` (cumulative SMW spend against the planned
    re-inversion, plus drift and rank bounds). At the crossover the
    service re-factorizes: the inversion is only DISPATCHED (CUDA
    launches return at once), and the first consumer of the new inverse
    waits for it on the stream;
  * **multi-tenant residency** — `max_resident` bounds the matrices on
    the device. Beyond it the service evicts by GreedyDual (residency
    credit = recency clock + the planner's modeled re-inversion price,
    `RefactorPolicy.reinversion_cost`), spilling the pair through
    `core.solver_ckpt.save_matrix_spill`; a request for an evicted matrix
    rehydrates it from its spill, bit for bit, never re-factorized. When
    every resident matrix is hot (live slot, queued request, background
    work) a rehydration hits `ResidencyBusy` and the request waits a
    tick; only a spill I/O `OSError` fails a request, with a typed
    verdict;
  * **degraded mode** — with a `solve_deadline_s` or a `fault_plan`, the
    exact path runs guarded on a background thread (fault injection,
    retry with backoff on `WorkerFailure`, a deadline). A hung shard
    flips the matrix into degraded mode: queued solves are never dropped,
    they are answered from a sketched approximate inverse
    (`core.solve.sketched_approx_inverse`, polished to the DriftTracker
    tolerance) with its probe residual reported. When the hung work
    lands, the service re-factorizes and leaves degraded mode;
  * **snapshot and restore** — `snapshot()` / `SpinService.restore()`
    persist every matrix's state, resident and evicted, with the guard,
    admission and residency settings, in the JAX package's on-disk
    layout (`core.solver_ckpt.save_service_snapshot`), so a restarted
    service resumes bit for bit, and a snapshot of the JAX package's
    service restores here. `snapshot_async()` captures the tensors by
    reference (the service never writes `a` or `inv` in place: every
    update binds new tensors) and records an event on the current
    stream; a background thread waits on that event, then copies to the
    host and writes, so the tick loop never stalls on a snapshot.

Consistency model: per-matrix FIFO. An update is a barrier: solves
submitted before it complete against the old matrix, solves after it see
the new one; requests on different matrices reorder freely (admission
drains highest priority first, with priorities clamped so that the
per-matrix order holds; see `serving.admission`).

Timestamps (`submit_t`, `admit_t`, `finish_t`) are taken on the host
after dispatch, as under the JAX package's asynchronous dispatch: on the
card a request's `finish_t` may precede the end of its kernels. Measure
device time by synchronising before reading a clock.

Sharded placement is not ported yet (ROADMAP.md A14): ``sharded=True``
raises `ValueError`.
"""

from __future__ import annotations

import dataclasses
import itertools
import tempfile
import time
from collections import defaultdict, deque
from typing import Optional

import torch

from .. import bridge
from ..core.blockmatrix import BlockMatrix
from ..core.multiply import multiply_engine
from ..core.precision import (PrecisionPolicy, _dtype_name, resolve_precision,
                              torch_dtype)
from ..core.solve import sketched_approx_inverse, spin_solve_dense
from ..core.solver_ckpt import validate_snapshot_key as _validate_snapshot_key
from ..core.spin import spin_inverse_dense
from ..core.update import (DriftTracker, add_low_rank, apply_inverse,
                           block_update_factors, estimate_inverse_residual,
                           smw_update_inverse)
from ..device import DEFAULT_DEVICE, resolve_device
from ..obs import flight as _flight
from ..obs.trace import TRACER as _TRACER
from ..parallel.straggler import (FaultPlan, ShardTimeout, WorkerFailure,
                                  retry_with_backoff, start_background)
from .admission import (AdmissionConfig, AdmissionRejected, Rejection,
                        order_for_admission, shed_victim)
from .metrics import ServiceMetrics

__all__ = ["SolveRequest", "UpdateRequest", "MatrixState", "ResidencyBusy",
           "SpinService"]


class ResidencyBusy(RuntimeError):
    """Transient: room is needed for one more resident matrix but every
    candidate is hot (live slot, queued request, background work).
    Admission defers the request and retries next tick; this is not a
    failure, unlike an `OSError` from the spill I/O."""


def _ns_polish_dense(a: torch.Tensor, x: torch.Tensor, sweeps: int
                     ) -> torch.Tensor:
    """`sweeps` Newton–Schulz iterations X ← X(2I − AX) in f32 on a dense
    pair: the certification polish of a low-precision maintained inverse.
    Plain f32 products (TF32 stays off unless the caller turned it on);
    returns f32, and the caller recasts to the store dtype."""
    a32 = a.float()
    x32 = x.float()
    eye2 = 2.0 * torch.eye(a.shape[0], dtype=torch.float32, device=a.device)
    for _ in range(sweeps):
        x32 = x32 @ (eye2 - a32 @ x32)
    return x32


def _wait_for(t: torch.Tensor) -> None:
    """Wait until the work producing `t` is done, and for nothing else the
    process queued later: an event recorded on the current stream, then a
    wait on that event (never a device-wide synchronise)."""
    if t.is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(t.device))
        event.synchronize()


@dataclasses.dataclass
class SolveRequest:
    """One A⁻¹·b request. rhs: (n,) or (n, c); x gets the matching shape."""

    uid: int
    matrix_id: str
    rhs: torch.Tensor
    priority: int = 0                # higher admits first / sheds last
    deadline_s: Optional[float] = None   # relative to submission
    # filled by the service
    x: Optional[torch.Tensor] = None
    done: bool = False
    slot: Optional[int] = None
    path: Optional[str] = None       # "recursion" | "maintained" | "degraded"
    residual_est: Optional[float] = None   # reported when the path has one
    rejected: bool = False           # shed/rejected by admission control
    verdict: Optional[Rejection] = None    # typed verdict when rejected
    failed: bool = False             # batch execution failed
    error: Optional[str] = None      # the failure, when failed
    submit_t: Optional[float] = None       # service-clock timestamps
    admit_t: Optional[float] = None
    finish_t: Optional[float] = None


@dataclasses.dataclass
class UpdateRequest:
    """One matrix change: rank-k factors (u, v) with A ← A + u vᵀ, or a
    symmetric block row/column replacement (delta_row, index), see
    `core.update.block_update_factors`."""

    uid: int
    matrix_id: str
    u: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    delta_row: Optional[torch.Tensor] = None
    index: Optional[int] = None
    priority: int = 0
    # filled by the service
    done: bool = False
    refactored: Optional[bool] = None
    reason: Optional[str] = None     # policy verdict ("smw"/"crossover"/…)
    rejected: bool = False
    verdict: Optional[Rejection] = None
    failed: bool = False             # rehydration/apply failed
    error: Optional[str] = None      # the failure, when failed
    submit_t: Optional[float] = None
    finish_t: Optional[float] = None


@dataclasses.dataclass
class MatrixState:
    """Device-resident serving state of one maintained inverse."""

    matrix_id: str
    a: torch.Tensor                  # dense (n, n)
    inv: Optional[torch.Tensor]      # dense (n, n), store dtype
    placement: str                   # "dense"
    block_size: int
    leaf_solver: str
    engine: str | None
    plan: object                     # the planner Plan the config came from
    drift: DriftTracker
    n: int = 0
    dtype: object = None             # the operand's torch dtype
    smw_spent_s: float = 0.0         # modeled SMW spend since last factorize
    smw_applied: int = 0
    refactors: int = 0
    # low-precision serving (core.precision.PrecisionPolicy)
    precision: str = ""              # pinned policy descriptor; "" = exact
    store_dtype: str = ""            # maintained-inverse dtype ("" = operand)
    serve_bound: float = 0.0         # certified residual bound when lowp
    polish_triggers: int = 0         # certifications that needed polish
    polish_sweeps: int = 0           # total NS sweeps those firings ran
    # straggler/degraded-mode state
    rank: int = 0                    # fault-plan rank of this matrix's shard
    degraded: bool = False
    sketch: object = None            # SketchedInverse, built lazily
    background: object = None        # the hung shard's BackgroundTask
    degraded_serves: int = 0
    # residency (cost-aware LRU)
    last_used: int = 0               # tick of the last touch
    credit: float = 0.0              # GreedyDual credit: clock + cost
    reinvert_cost_s: float = 0.0     # planner-modeled re-inversion price

    @property
    def pending_rank(self) -> int:
        return self.drift.update_rank


class SpinService:
    """Continuous-batching solve/update server over maintained inverses."""

    def __init__(self, *, slots: int = 8, policy=None,
                 drift_probes: int = 2, drift_scale: float = 10.0,
                 seed: int = 0, solve_deadline_s: float | None = None,
                 fault_plan=None, solve_retries: int = 1,
                 backoff_base_s: float = 0.01,
                 degraded_max_sweeps: int = 60,
                 max_queue: int | None = None,
                 per_matrix_quota: int | None = None,
                 max_resident: int | None = None,
                 spill_dir: str | None = None,
                 metrics_window: int = 4096,
                 clock=time.monotonic,
                 compile_cache: str | bool | None = None,
                 precision=None,
                 device: str | torch.device = DEFAULT_DEVICE):
        from ..planner import RefactorPolicy  # late: planner imports core

        # The JAX package points XLA's compilation cache at a directory
        # here. The port has no such cache: its kernels are built once
        # into build/repro_torch_kernels/ by kernels.build.
        if compile_cache not in (None, False):
            raise ValueError(
                f"compile_cache={compile_cache!r}: the PyTorch port has no "
                "compilation cache to point at a directory (its CUDA "
                "kernels are built once by repro_torch.kernels.build); "
                "pass None or False")
        self.compile_cache_dir = None
        self.device = resolve_device(device)
        self.slots = slots
        self.policy = policy or RefactorPolicy()
        # Service-default precision for add_matrix(precision=None): a
        # PrecisionPolicy, preset string, or None (per-matrix env/exact).
        self.precision = precision
        self.drift_probes = drift_probes         # 0 disables probe estimates
        self.drift_scale = drift_scale
        # Straggler guard: None deadline + None fault_plan keeps the exact
        # path a direct (bitwise-identical) call: no thread, no guard.
        self.solve_deadline_s = solve_deadline_s
        self.fault_plan = fault_plan
        self.solve_retries = solve_retries
        self.backoff_base_s = backoff_base_s
        self.degraded_max_sweeps = degraded_max_sweeps
        self.admission = AdmissionConfig(max_queue=max_queue,
                                         per_matrix_quota=per_matrix_quota)
        # Residency: None = everything stays resident.
        if max_resident is not None and max_resident < 1:
            raise ValueError(f"max_resident must be >= 1, got {max_resident}")
        self.max_resident = max_resident
        self._spill_dir = spill_dir
        self._evicted: dict[str, dict] = {}      # mid -> {"n", "rank"}
        self._evict_clock = 0.0                  # GreedyDual recency clock
        self._clock = clock
        self._metrics = ServiceMetrics(window=metrics_window, clock=clock)
        self._snapshot_task = None               # in-flight async snapshot
        self._free: deque[int] = deque(range(slots))
        self._live: dict[int, SolveRequest] = {}
        self._queue: deque = deque()
        self._matrices: dict[str, MatrixState] = {}
        self._uid = itertools.count()
        # One generator draws every probe and sketch (the JAX package
        # splits a PRNGKey chain at the same places).
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.ticks = 0
        self.stats = {"solves": 0, "batches": 0, "coalesced_cols": 0,
                      "updates_smw": 0, "updates_refactor": 0,
                      "degraded_serves": 0, "shard_timeouts": 0,
                      "shard_failures": 0, "retries": 0, "recoveries": 0,
                      "rejected": 0, "shed": 0, "batch_failures": 0,
                      "evictions": 0, "rehydrations": 0,
                      "lowp_serves": 0, "polish_triggers": 0,
                      "polish_sweeps": 0}
        if self.device.type == "cuda":
            # Build the kernels now, so that a solve deadline never races
            # nvcc on the first guarded call.
            from ..kernels import build

            build.build_all(("matmul", "leaf_inverse"))

    def _on_device(self, x):
        return None if x is None else torch.as_tensor(x).to(self.device)

    # -- matrix admission ----------------------------------------------------

    def add_matrix(self, matrix_id: str, a, *, block_size: int | None = None,
                   leaf_solver: str | None = None, engine: str | None = None,
                   sharded: bool = False, precision=None) -> MatrixState:
        """Admit a matrix: plan its configuration, factorize, hold it on the
        service's device.

        `a`: dense (n, n) SPD tensor (or anything `torch.as_tensor` takes),
        or a `BlockMatrix`, whose grid then fixes the plan's block size
        unless `block_size` re-blocks it. Explicit block_size / leaf_solver
        / engine override the planner, as on the offline entry points.

        `precision` (PrecisionPolicy | preset string | None) selects this
        matrix's serve precision; None falls back to the service default,
        then $SPIN_PRECISION, then exact. A non-exact policy rides the
        planner signature, the maintained inverse is held at the resolved
        store dtype, and serving is certified against the policy's bound.
        """
        if matrix_id in self._matrices or matrix_id in self._evicted:
            raise ValueError(f"matrix {matrix_id!r} already admitted")
        _validate_snapshot_key(matrix_id)       # snapshot dirs embed the id
        pol = resolve_precision(
            precision if precision is not None else self.precision)
        if sharded:
            raise ValueError(
                "sharded placement is not ported yet (ROADMAP.md A14): the "
                "port's service is dense-only"
                + ("" if pol.is_exact else
                   "; low-precision serving is dense-only in any case"))
        if isinstance(a, BlockMatrix):
            # a pre-blocked operand's grid is the plan constraint unless
            # it is explicitly re-blocked
            block_size = block_size or a.block_size
            a = a.to_dense()
        a = self._on_device(a)
        n, dtype = a.shape[0], a.dtype
        kw = {"block_sizes": (int(block_size),)} if block_size else {}
        from ..planner import get_plan

        plan = get_plan("inverse", n, dtype, measure=False, placement="dense",
                        precision=None if pol.is_exact else pol,
                        backend=self.device.type, **kw)
        block_size = block_size or plan.block_size
        # Pin the policy's store decision: the plan's store_dtype is the
        # planner's (cost-priced) choice.
        op_name = _dtype_name(dtype)
        store = plan.store_dtype or (pol.store_dtype or "")
        if store == op_name:
            store = ""
        active = not pol.is_exact and (
            bool(store) or pol.resolve_compute(dtype) != op_name)
        if active:
            eff = dataclasses.replace(pol, store_dtype=store or None,
                                      auto_store=False)
            drift = DriftTracker(tolerance=self.drift_scale * eff.bound(dtype))
        else:
            eff = None
            drift = DriftTracker.for_dtype(dtype, scale=self.drift_scale)
        state = MatrixState(
            matrix_id=matrix_id, a=a, inv=None, placement="dense",
            block_size=int(block_size),
            leaf_solver=leaf_solver or plan.leaf_solver,
            engine=engine or plan.multiply_engine, plan=plan,
            drift=drift, n=int(n), dtype=dtype,
            rank=len(self._matrices) + len(self._evicted))
        if eff is not None:
            state.precision = eff.descriptor()
            state.store_dtype = store
            state.serve_bound = eff.bound(dtype)
        state.reinvert_cost_s = self._reinvert_cost(state)
        self._make_room(protect={matrix_id})
        self._factorize(state)
        self._matrices[matrix_id] = state
        self._touch(state)
        return state

    def matrix(self, matrix_id: str) -> MatrixState:
        """The matrix's serving state, rehydrating it if evicted."""
        return self._ensure_resident(matrix_id)

    def is_resident(self, matrix_id: str) -> bool:
        """Residency probe that never triggers a rehydration."""
        if matrix_id in self._matrices:
            return True
        if matrix_id in self._evicted:
            return False
        raise KeyError(f"unknown matrix {matrix_id!r}")

    def _factorize(self, state: MatrixState) -> None:
        """(Re)compute the maintained inverse. Dispatch only: the launches
        return before the kernels finish, no value is read back, and the
        scheduler keeps ticking while the inversion runs; the first
        consumer of `state.inv` waits for it on the stream. A low-precision
        matrix also CERTIFIES the fresh inverse (one probe, polish only if
        the probe exceeds the bound): that probe is the one synchronisation
        low-precision factorization pays."""
        state.inv = spin_inverse_dense(
            state.a, state.block_size, state.leaf_solver,
            engine=state.engine, device=self.device,
            precision=self._policy_of(state))
        state.drift.reset()
        state.smw_spent_s = 0.0
        if state.precision:
            self._certify(state)

    # -- low-precision certification -----------------------------------------

    def _policy_of(self, state: MatrixState) -> PrecisionPolicy | None:
        """The matrix's pinned PrecisionPolicy (None for exact serving)."""
        if not state.precision:
            return None
        return PrecisionPolicy.from_descriptor(state.precision)

    def _probe(self, state: MatrixState, policy: PrecisionPolicy) -> float:
        """Residual probe through the SAME low-precision product the policy
        serves with: an f32 probe would under-report what requests see."""
        return estimate_inverse_residual(
            lambda p: apply_inverse(state.a, p), state.inv, self._gen,
            state.n, probes=max(1, self.drift_probes), precision=policy)

    def _certify(self, state: MatrixState) -> float:
        """Certify the low-precision maintained inverse: probe the served
        residual, and only while it exceeds the policy's bound run
        Newton–Schulz polish (f32 sweeps, recast to the store dtype) up to
        the policy's cap. The last probe becomes the residual reported on
        each request (`drift.residual_est`)."""
        policy = self._policy_of(state)
        res = self._probe(state, policy)
        fired = False
        sweeps_run = 0
        while (res > state.serve_bound and policy.polish_sweeps > 0
               and sweeps_run < policy.max_polish_sweeps):
            fired = True
            k = min(policy.polish_sweeps,
                    policy.max_polish_sweeps - sweeps_run)
            state.inv = _ns_polish_dense(
                state.a, state.inv, k).to(state.inv.dtype)
            sweeps_run += k
            res = self._probe(state, policy)
        if fired:
            state.polish_triggers += 1
            state.polish_sweeps += sweeps_run
            self.stats["polish_triggers"] += 1
            self.stats["polish_sweeps"] += sweeps_run
            self._metrics.count("polish_triggers")
            self._metrics.count("polish_sweeps", sweeps_run)
        state.drift.residual_est = res
        return res

    # -- residency (cost-aware LRU over resident matrices) -------------------

    def _reinvert_cost(self, state: MatrixState) -> float:
        """The eviction price: the planner's modeled fresh-inversion cost
        (`RefactorPolicy.reinversion_cost`) on the service's backend.
        Policies without the method degrade to pure LRU."""
        pricer = getattr(self.policy, "reinversion_cost", None)
        if pricer is None:
            return 0.0
        return float(pricer(state.n, state.dtype, placement=state.placement,
                            backend=self.device.type))

    def _touch(self, state: MatrixState) -> None:
        """GreedyDual credit refresh: an access re-earns the matrix its
        re-inversion price on top of the current recency clock."""
        state.last_used = self.ticks
        state.credit = self._evict_clock + max(state.reinvert_cost_s, 1e-12)

    def _spill(self) -> str:
        if self._spill_dir is None:
            self._spill_dir = tempfile.mkdtemp(prefix="spin-spill-")
        return self._spill_dir

    def _hot_matrices(self) -> set[str]:
        """Matrices that must not be evicted right now: referenced by a
        live slot or a queued request, or with background work in flight."""
        hot = {r.matrix_id for r in self._live.values()}
        hot.update(r.matrix_id for r in self._queue)
        hot.update(mid for mid, st in self._matrices.items()
                   if st.background is not None)
        return hot

    def _evict_one(self, protect: set[str]) -> None:
        """Evict the resident matrix with the least GreedyDual credit
        (ties: least recently used), spilling its state to disk."""
        from ..core import solver_ckpt

        hot = self._hot_matrices() | protect
        candidates = [st for mid, st in self._matrices.items()
                      if mid not in hot]
        if not candidates:
            raise ResidencyBusy(
                "cannot evict: every resident matrix is busy (live slot, "
                "queued request, or background work); raise max_resident")
        victim = min(candidates,
                     key=lambda st: (st.credit, st.last_used, st.matrix_id))
        meta, pair = self._matrix_payload(victim)
        solver_ckpt.save_matrix_spill(self._spill(), victim.matrix_id,
                                      meta=meta, pair=pair)
        self._evicted[victim.matrix_id] = {"n": victim.n,
                                           "rank": victim.rank}
        del self._matrices[victim.matrix_id]
        self._evict_clock = victim.credit        # GreedyDual clock advance
        self.stats["evictions"] += 1
        self._metrics.count("evictions")

    def _make_room(self, protect: set[str]) -> None:
        """Ensure capacity for ONE more resident matrix."""
        if self.max_resident is None:
            return
        while len(self._matrices) >= self.max_resident:
            self._evict_one(protect)

    def _ensure_resident(self, matrix_id: str,
                         protect: set[str] = frozenset()) -> MatrixState:
        """Resident state for `matrix_id`, rehydrating from its spill if
        evicted (an evicted matrix is still admitted: it pays an I/O read
        on its next touch)."""
        from ..core import solver_ckpt

        st = self._matrices.get(matrix_id)
        if st is not None:
            return st
        rec = self._evicted.get(matrix_id)
        if rec is None:
            raise KeyError(f"unknown matrix {matrix_id!r}")
        self._make_room(protect=set(protect) | {matrix_id})
        meta, pair = solver_ckpt.load_matrix_spill(self._spill(), matrix_id,
                                                   device=self.device)
        st = self._state_from_meta(matrix_id, meta, pair)
        st.rank = rec["rank"]
        del self._evicted[matrix_id]
        self._matrices[matrix_id] = st
        self._touch(st)
        self.stats["rehydrations"] += 1
        self._metrics.count("rehydrations")
        return st

    def _dim_of(self, matrix_id: str) -> int:
        st = self._matrices.get(matrix_id)
        if st is not None:
            return st.n
        rec = self._evicted.get(matrix_id)
        if rec is not None:
            return rec["n"]
        raise KeyError(f"unknown matrix {matrix_id!r}")

    # -- request plumbing ----------------------------------------------------

    def submit(self, req) -> None:
        """Admission gate: validate, apply the shed-load policy, enqueue.

        Raises `KeyError` for an unknown matrix, `ValueError` for a
        malformed request (a bad rhs fails HERE, never inside a coalesced
        batch in `tick()`), and `AdmissionRejected`, carrying a typed
        `Rejection`, when the bounded queue sheds this request.
        """
        n = self._dim_of(req.matrix_id)
        if isinstance(req, SolveRequest):
            rhs = req.rhs
            if (not hasattr(rhs, "ndim") or rhs.ndim not in (1, 2)
                    or rhs.shape[0] != n):
                raise ValueError(
                    f"rhs for matrix {req.matrix_id!r} must be (n={n},) or "
                    f"(n={n}, c), got shape "
                    f"{tuple(getattr(rhs, 'shape', ()))}")
        cfg = self.admission
        if cfg.per_matrix_quota is not None:
            queued = sum(1 for r in self._queue
                         if r.matrix_id == req.matrix_id)
            if queued >= cfg.per_matrix_quota:
                self._raise_rejected(req, "tenant_quota",
                                     f"matrix {req.matrix_id!r} already has "
                                     f"{queued} queued requests (quota "
                                     f"{cfg.per_matrix_quota})")
        if cfg.max_queue is not None and len(self._queue) >= cfg.max_queue:
            victim = shed_victim(self._queue, int(req.priority))
            if victim is None:
                self._raise_rejected(req, "queue_full",
                                     f"{len(self._queue)} queued (bound "
                                     f"{cfg.max_queue}) and no lower-"
                                     "priority request to shed")
            self._queue = deque(r for r in self._queue if r is not victim)
            self._mark_shed(victim, "shed",
                            f"evicted for priority-{req.priority} request "
                            f"{req.uid}")
        req.submit_t = self._clock()
        self._queue.append(req)

    def _raise_rejected(self, req, reason: str, detail: str):
        verdict = Rejection(reason, detail)
        req.rejected = True
        req.verdict = verdict
        req.done = True
        self.stats["rejected"] += 1
        self._metrics.observe_rejection(reason)
        raise AdmissionRejected(verdict)

    def _mark_shed(self, req, reason: str, detail: str) -> None:
        """Typed verdict for a request evicted AFTER admission (priority
        shed, deadline expiry): its submitter already holds the object, so
        the verdict lands on the request, not in an exception."""
        req.rejected = True
        req.verdict = Rejection(reason, detail)
        req.done = True
        req.finish_t = self._clock()
        self.stats["shed"] += 1
        self._metrics.observe_rejection(reason)

    def _mark_failed(self, req, exc: BaseException) -> None:
        """Typed failure verdict on the request object (solve or update):
        done=True + failed=True + the error string, never a silent hang."""
        req.failed = True
        req.error = f"{type(exc).__name__}: {exc}"
        req.done = True
        req.finish_t = self._clock()
        self.stats["batch_failures"] += 1

    def solve(self, matrix_id: str, rhs, *, priority: int = 0,
              deadline_s: float | None = None) -> SolveRequest:
        req = SolveRequest(uid=next(self._uid), matrix_id=matrix_id,
                           rhs=self._on_device(rhs), priority=int(priority),
                           deadline_s=deadline_s)
        self.submit(req)
        return req

    def update(self, matrix_id: str, u=None, v=None, *, delta_row=None,
               index: int | None = None, priority: int = 0) -> UpdateRequest:
        if (u is None) == (delta_row is None):
            raise ValueError("pass exactly one of (u[, v]) or "
                             "(delta_row, index)")
        u, v, delta_row = map(self._on_device, (u, v, delta_row))
        # Validate HERE, not at apply time: a malformed request must fail
        # at submission, never mid-_admit with the queue in hand.
        n = self._dim_of(matrix_id)
        if u is not None:
            uc = u.shape[1] if u.ndim == 2 else 1
            vv = u if v is None else v
            vc = vv.shape[1] if vv.ndim == 2 else 1
            if u.shape[0] != n or vv.shape[0] != n or uc != vc:
                raise ValueError(
                    f"update factors must be (n={n}, k) with equal "
                    f"k, got u{tuple(u.shape)} v{tuple(vv.shape)}")
        if delta_row is not None:
            if index is None:
                raise ValueError("delta_row updates require index=")
            bs = delta_row.shape[0]
            if tuple(delta_row.shape) != (bs, n) or n % bs:
                raise ValueError(
                    f"delta_row must be (bs, n={n}) with bs | n, "
                    f"got {tuple(delta_row.shape)}")
            if not 0 <= index < n // bs:
                raise ValueError(f"block index {index} out of range for "
                                 f"n={n}, bs={bs}")
        req = UpdateRequest(uid=next(self._uid), matrix_id=matrix_id,
                            u=u, v=v if v is not None else u,
                            delta_row=delta_row, index=index,
                            priority=int(priority))
        self.submit(req)
        return req

    # -- scheduling ----------------------------------------------------------

    def _live_matrices(self) -> set[str]:
        return {r.matrix_id for r in self._live.values()}

    def _expired(self, req) -> bool:
        dl = getattr(req, "deadline_s", None)
        return dl is not None and (self._clock() - req.submit_t) > dl

    def _admit(self) -> None:
        """One admission pass: highest effective priority first (per-matrix
        FIFO preserved, see `serving.admission.order_for_admission`).
        Updates execute inline the moment no earlier solve on their matrix
        is still live; a deferred request bars every later request on the
        same matrix (per-matrix order). Queued solves whose deadline has
        expired are shed with a typed verdict instead of admitted."""
        if len(self._queue) > 1:
            self._queue = order_for_admission(self._queue)
        deferred: deque = deque()
        barred: set[str] = set()
        live = self._live_matrices()
        try:
            while self._queue:
                req = self._queue.popleft()
                m = req.matrix_id
                if isinstance(req, UpdateRequest):
                    if m in barred or m in live:
                        deferred.append(req)
                        barred.add(m)
                    else:
                        try:
                            self._ensure_resident(m, protect=barred)
                        except ResidencyBusy:
                            # transient: retry next tick (bar the matrix
                            # to keep per-matrix order)
                            deferred.append(req)
                            barred.add(m)
                            continue
                        except OSError as e:
                            # spill I/O failure: a typed verdict, never a
                            # dropped request
                            self._mark_failed(req, e)
                            self._metrics.count("rehydration_failures")
                            continue
                        self._apply_update(req)
                else:
                    if self._expired(req):
                        self._mark_shed(req, "deadline",
                                        f"deadline_s={req.deadline_s} "
                                        "expired while queued")
                        continue
                    if m in barred or not self._free:
                        deferred.append(req)
                        barred.add(m)
                    else:
                        try:
                            self._ensure_resident(m, protect=barred)
                        except ResidencyBusy:
                            # transient: nothing evictable this instant;
                            # defer and retry next tick
                            deferred.append(req)
                            barred.add(m)
                            continue
                        except OSError as e:
                            # spill I/O failed: fail THIS request, never
                            # lose it or its batchmates
                            self._mark_failed(req, e)
                            self._metrics.count("rehydration_failures")
                            continue
                        slot = self._free.popleft()
                        req.slot = slot
                        req.admit_t = self._clock()
                        self._live[slot] = req
                        live.add(m)
        finally:
            # An exception mid-pass must not drop the requests already
            # moved onto the local deque: reattach them ahead of whatever
            # is still queued.
            deferred.extend(self._queue)
            self._queue = deferred

    def tick(self) -> int:
        """Admit + advance: one coalesced solve per (matrix, rhs dtype)
        group with live slots. EVERY call counts toward `ticks`, update-
        only and idle ticks included. Returns the number of live slots
        after recycling (always 0: solves are single-shot)."""
        if not _TRACER.enabled:
            return self._tick()
        with _TRACER.span("serve.tick", "serve_tick", tick=self.ticks + 1,
                          queued=len(self._queue),
                          live_slots=len(self._live)):
            return self._tick()

    def _tick(self) -> int:
        self.ticks += 1
        self._admit()
        self._metrics.observe_queue_depth(len(self._queue))
        if not self._live:
            return len(self._live)
        groups: dict[tuple[str, str], list[SolveRequest]] = defaultdict(list)
        for slot in sorted(self._live):
            req = self._live[slot]
            # dtype is part of the coalesce key: stacking a bf16 panel
            # beside an f32 one would upcast it and change the f32
            # requests' bits (the coalesce-bitwise contract)
            groups[(req.matrix_id, _dtype_name(req.rhs.dtype))].append(req)
        for (matrix_id, _rhs_dtype), reqs in groups.items():
            state = self._matrices[matrix_id]
            self._touch(state)
            panels = [r.rhs if r.rhs.ndim == 2 else r.rhs[:, None]
                      for r in reqs]
            rhs = panels[0] if len(panels) == 1 else torch.cat(panels, dim=1)
            try:
                x, path, residual = self._solve_batch(state, rhs)
            except Exception as e:
                # A failing batch must not leak its slots or hang its
                # co-batched requests: recycle everything, mark each
                # request failed with the error, keep serving.
                now = self._clock()
                for req in reqs:
                    req.failed = True
                    req.error = f"{type(e).__name__}: {e}"
                    req.done = True
                    req.finish_t = now
                    self._recycle(req)
                self.stats["batch_failures"] += 1
                self._metrics.count("batch_failures")
                # Post-mortem: the recent event window is worth more than
                # this one traceback.
                _flight.recorder().record(
                    "serve_event", name="batch.failed", tick=self.ticks,
                    matrix_id=matrix_id, cols=int(rhs.shape[1]),
                    requests=len(reqs), error=f"{type(e).__name__}: {e}")
                _flight.recorder().dump("batch-failure")
                continue
            col = 0
            now = self._clock()
            for req, panel in zip(reqs, panels):
                c = panel.shape[1]
                out = x[:, col:col + c]
                col += c
                req.x = out[:, 0] if req.rhs.ndim == 1 else out
                req.path = path
                req.residual_est = residual
                req.done = True
                req.finish_t = now
                self._recycle(req)
                self._metrics.observe_solve(req)
            self.stats["solves"] += len(reqs)
            self.stats["batches"] += 1
            self.stats["coalesced_cols"] += rhs.shape[1]
        return len(self._live)

    def _recycle(self, req: SolveRequest) -> None:
        """Return the request's slot to the free pool (idempotent)."""
        slot = req.slot
        if slot is not None and self._live.get(slot) is req:
            del self._live[slot]
            self._free.append(slot)

    def run_until_done(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self._queue and not self._live:
                return
            self.tick()
        raise RuntimeError("service did not drain")

    # -- observability -------------------------------------------------------

    def metrics(self) -> dict:
        """The SLA dashboard payload: rolling latency percentiles
        (queue wait / solve / total), queue-depth distribution, per-path
        and per-rejection counters, residency and lifetime stats, and the
        `obs` registry view of the same numbers."""
        snap = self._metrics.snapshot()
        snap["queue"] = {"depth_now": len(self._queue),
                         "live_slots": len(self._live),
                         "free_slots": len(self._free),
                         "max_queue": self.admission.max_queue,
                         "per_matrix_quota": self.admission.per_matrix_quota}
        snap["residency"] = {"resident": len(self._matrices),
                             "evicted": len(self._evicted),
                             "max_resident": self.max_resident}
        snap["ticks"] = self.ticks
        snap["stats"] = dict(self.stats)
        snap["registry"] = self._metrics.registry.to_json()
        return snap

    # -- execution -----------------------------------------------------------

    def _solve_batch(self, state: MatrixState, rhs: torch.Tensor
                     ) -> tuple[torch.Tensor, str, float | None]:
        """Serve one coalesced (n, c) panel for `state`.

        No pending churn → `spin_solve_dense` with the matrix's plan
        (bitwise the offline call on the same panel). Pending SMW churn →
        one panel product against the maintained inverse. A hung or failed
        shard (deadline missed, retries exhausted) flips the matrix into
        degraded mode: the panel is answered from the sketched inverse
        with its probe residual reported, and the matrix recovers when
        the background work lands.
        """
        if state.degraded:
            self._poll_background(state)
        if state.precision and not state.degraded:
            # Low-precision path: EVERY request serves from the maintained
            # store-dtype inverse through the policy's product, never the
            # recursion; the certified residual rides each request.
            self.stats["lowp_serves"] += 1
            return (apply_inverse(state.inv, rhs,
                                  precision=self._policy_of(state)),
                    "maintained", state.drift.residual_est)
        if state.pending_rank == 0 and not state.degraded:
            if self.solve_deadline_s is None and self.fault_plan is None:
                return self._exact_solve(state, rhs), "recursion", None
            task = start_background(self._guarded_solve(state, rhs))
            try:
                return task.wait(self.solve_deadline_s), "recursion", None
            except ShardTimeout:
                state.degraded = True
                state.background = task      # still running; lands later
                self.stats["shard_timeouts"] += 1
                _flight.recorder().record(
                    "serve_event", name="degraded.entered", tick=self.ticks,
                    matrix_id=state.matrix_id, cause="shard_timeout",
                    deadline_s=self.solve_deadline_s)
                _flight.recorder().dump("degraded-shard-timeout")
            except WorkerFailure:
                state.degraded = True
                state.background = None      # dead, nothing to wait on
                self.stats["shard_failures"] += 1
                _flight.recorder().record(
                    "serve_event", name="degraded.entered", tick=self.ticks,
                    matrix_id=state.matrix_id, cause="worker_failure")
                _flight.recorder().dump("degraded-worker-failure")
        if state.degraded:
            sketch = self._ensure_sketch(state)
            state.degraded_serves += 1
            self.stats["degraded_serves"] += 1
            return (apply_inverse(sketch.inverse, rhs), "degraded",
                    sketch.residual_est)
        return apply_inverse(state.inv, rhs), "maintained", None

    def _exact_solve(self, state: MatrixState, rhs: torch.Tensor
                     ) -> torch.Tensor:
        return spin_solve_dense(state.a, rhs, state.block_size,
                                state.leaf_solver, engine=state.engine,
                                device=self.device)

    def _guarded_solve(self, state: MatrixState, rhs: torch.Tensor):
        """The exact solve wrapped for background execution: fault-plan
        injection per attempt (rank = the matrix's admission index), retry
        with exponential backoff on WorkerFailure, and a wait for the
        solve's own work inside the worker, so that the deadline sees the
        device time of this solve and of nothing queued after it."""
        def attempt(i: int) -> torch.Tensor:
            if self.fault_plan is not None:
                self.fault_plan.apply(state.rank, step=i)
            x = self._exact_solve(state, rhs)
            _wait_for(x)
            return x

        def run() -> torch.Tensor:
            x, used = retry_with_backoff(attempt,
                                         retries=self.solve_retries,
                                         base_s=self.backoff_base_s)
            if used > 1:
                self.stats["retries"] += used - 1
            return x

        return run

    def _ensure_sketch(self, state: MatrixState):
        """Build the degraded-mode sketched inverse of the CURRENT matrix
        on first use (updates invalidate it), polished under the matrix's
        engine until the probe residual is within the DriftTracker
        tolerance, drift_scale × the dtype's residual tolerance: the
        service's advertised degraded bound."""
        if state.sketch is None:
            with multiply_engine(state.engine):
                state.sketch = sketched_approx_inverse(
                    state.a, self._gen, block_size=state.block_size,
                    tol=state.drift.tolerance,
                    max_sweeps=self.degraded_max_sweeps,
                    probes=max(1, self.drift_probes))
        return state.sketch

    def _poll_background(self, state: MatrixState) -> None:
        """Leave degraded mode once the hung shard's background work lands:
        the recovered shard re-factorizes (dispatch only, like any
        refactor) and later solves take the exact path again. A background
        task that DIED keeps the matrix degraded."""
        task = state.background
        if task is None or not task.done:
            return
        state.background = None
        if task.error is not None:
            self.stats["shard_failures"] += 1
            return                           # still degraded, still serving
        state.degraded = False
        state.sketch = None
        self._factorize(state)
        state.refactors += 1
        self.stats["recoveries"] += 1
        _flight.recorder().record(
            "serve_event", name="degraded.recovered", tick=self.ticks,
            matrix_id=state.matrix_id, degraded_serves=state.degraded_serves)

    def _apply_update(self, req: UpdateRequest) -> None:
        state = self._matrices[req.matrix_id]
        self._touch(state)
        if req.delta_row is not None:
            u, v = block_update_factors(req.delta_row, req.index, state.n)
        else:
            u = req.u if req.u.ndim == 2 else req.u[:, None]
            v = req.v if req.v.ndim == 2 else req.v[:, None]
        k = u.shape[1]
        decision = self.policy.decide(
            state.n, state.dtype, new_rank=k,
            pending_rank=state.pending_rank,
            cumulative_s=state.smw_spent_s,
            residual_est=state.drift.residual_est,
            drift_tolerance=state.drift.tolerance,
            placement=state.placement, backend=self.device.type)
        # new tensors, never in place: a snapshot_async capture holds the
        # old ones
        state.a = add_low_rank(state.a, u, v)
        state.sketch = None          # the degraded sketch tracks CURRENT A
        if decision.refactor:
            self._factorize(state)               # dispatch only
            state.refactors += 1
            self.stats["updates_refactor"] += 1
        else:
            state.inv = smw_update_inverse(state.inv, u, v)
            state.drift.note(k)
            state.smw_spent_s = decision.cumulative_s
            state.smw_applied += 1
            self.stats["updates_smw"] += 1
            if state.precision:
                # the low-precision certify IS the drift probe, plus the
                # polish-on-exceed repair the exact path never needs
                self._certify(state)
            elif self.drift_probes:
                state.drift.residual_est = estimate_inverse_residual(
                    lambda p: apply_inverse(state.a, p), state.inv,
                    self._gen, state.n, probes=self.drift_probes)
        req.done = True
        req.finish_t = self._clock()
        req.refactored = decision.refactor
        req.reason = decision.reason

    # -- snapshot / restore --------------------------------------------------

    def _matrix_payload(self, st: MatrixState
                        ) -> tuple[dict, dict[str, BlockMatrix]]:
        """One matrix's snapshot entry: (meta dict, {"a","inv"} pair)."""
        meta = {
            "placement": st.placement, "block_size": st.block_size,
            "leaf_solver": st.leaf_solver, "engine": st.engine,
            "plan": st.plan.to_dict(), "n": st.n,
            "dtype": _dtype_name(st.dtype),
            "drift": {"tolerance": st.drift.tolerance,
                      "update_rank": st.drift.update_rank,
                      "updates": st.drift.updates,
                      "residual_est": st.drift.residual_est},
            "smw_spent_s": st.smw_spent_s,
            "smw_applied": st.smw_applied, "refactors": st.refactors,
            "precision": st.precision, "store_dtype": st.store_dtype,
            "serve_bound": st.serve_bound,
            "polish_triggers": st.polish_triggers,
            "polish_sweeps": st.polish_sweeps,
        }
        pair = {"a": BlockMatrix.from_dense(st.a, st.block_size),
                "inv": BlockMatrix.from_dense(st.inv, st.block_size)}
        return meta, pair

    def _state_from_meta(self, mid: str, m: dict,
                         pair: dict[str, BlockMatrix]) -> MatrixState:
        """Inverse of `_matrix_payload` (shared by restore and rehydrate).
        A JAX-package snapshot's leaf and engine names map to the port's
        (`bridge.port_name`)."""
        if m["placement"] != "dense":
            raise ValueError(
                f"matrix {mid!r} has placement {m['placement']!r}; sharded "
                "placement is not ported yet (ROADMAP.md A14)")
        st = MatrixState(
            matrix_id=mid, a=pair["a"].to_dense(), inv=pair["inv"].to_dense(),
            placement="dense", block_size=m["block_size"],
            leaf_solver=bridge.port_name(m["leaf_solver"]),
            engine=bridge.port_name(m["engine"]),
            plan=bridge.plan_from_reference(m["plan"]),
            drift=DriftTracker(**m["drift"]), n=m["n"],
            dtype=torch_dtype(m["dtype"]),
            smw_spent_s=m["smw_spent_s"],
            smw_applied=m["smw_applied"], refactors=m["refactors"])
        st.precision = m.get("precision", "")
        st.store_dtype = m.get("store_dtype", "")
        st.serve_bound = m.get("serve_bound", 0.0)
        st.polish_triggers = m.get("polish_triggers", 0)
        st.polish_sweeps = m.get("polish_sweeps", 0)
        st.reinvert_cost_s = self._reinvert_cost(st)
        return st

    def _snapshot_payload(self) -> tuple[dict, dict]:
        """Quiesce-checked snapshot payload (meta + matrices: resident ones
        by reference, evicted ones read from their spills). References are
        a consistent copy because the service never writes `a` or `inv`
        in place: later updates bind new tensors."""
        from ..core import solver_ckpt

        if self._queue or self._live:
            raise RuntimeError(
                "snapshot requires a quiesced service (drain with "
                "run_until_done() first); "
                f"{len(self._queue)} queued / {len(self._live)} live")
        pending = [mid for mid, st in self._matrices.items()
                   if st.background is not None]
        if pending:
            raise RuntimeError(
                "snapshot requires landed background work; hung-shard "
                f"tasks still pending on {pending}")
        meta = {"slots": self.slots, "ticks": self.ticks,
                "drift_probes": self.drift_probes,
                "drift_scale": self.drift_scale,
                "stats": dict(self.stats),
                # the straggler guard MUST survive a restart: a restored
                # service silently losing its deadline protection is an
                # outage waiting for a straggler
                "guard": {
                    "solve_deadline_s": self.solve_deadline_s,
                    "solve_retries": self.solve_retries,
                    "backoff_base_s": self.backoff_base_s,
                    "degraded_max_sweeps": self.degraded_max_sweeps,
                    "fault_plan": (None if self.fault_plan is None
                                   else self.fault_plan.to_json()),
                },
                "admission": {
                    "max_queue": self.admission.max_queue,
                    "per_matrix_quota": self.admission.per_matrix_quota,
                },
                # service-default precision (per-matrix policies live in
                # each matrix entry; this only seeds future add_matrix)
                "precision": ("" if self.precision is None else
                              resolve_precision(self.precision).descriptor()),
                "residency": {"max_resident": self.max_resident},
                "matrices": {}}
        matrices: dict[str, dict[str, BlockMatrix]] = {}
        for mid, st in self._matrices.items():
            meta["matrices"][mid], matrices[mid] = self._matrix_payload(st)
        for mid in self._evicted:
            m, pair = solver_ckpt.load_matrix_spill(self._spill(), mid,
                                                    device=self.device)
            meta["matrices"][mid], matrices[mid] = m, pair
        return meta, matrices

    def snapshot(self, directory: str) -> None:
        """Persist every matrix's serving state (quiesce first: queued
        requests and live slots are NOT snapshotted)."""
        from ..core import solver_ckpt

        meta, matrices = self._snapshot_payload()
        solver_ckpt.save_service_snapshot(directory, meta=meta,
                                          matrices=matrices)

    def snapshot_async(self, directory: str):
        """`snapshot()` without stalling the tick loop: the quiesced state
        is captured NOW (tensor references, plus an event on the current
        stream), then a background thread waits on the event, copies to
        the host and writes the files. Returns the `BackgroundTask`;
        `task.wait()` for durability. Serving may continue at once: later
        updates and evictions bind new tensors and cannot leak into the
        capture. One snapshot in flight at a time."""
        from ..core import solver_ckpt

        if self._snapshot_task is not None and not self._snapshot_task.done:
            raise RuntimeError("a snapshot is already in flight; wait() on "
                               "it before starting another")
        meta, matrices = self._snapshot_payload()
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))

        def write() -> None:
            if event is not None:
                event.synchronize()
            solver_ckpt.save_service_snapshot(directory, meta=meta,
                                              matrices=matrices)

        task = start_background(write)
        self._snapshot_task = task
        return task

    @classmethod
    def restore(cls, directory: str, *, policy=None, seed: int = 0,
                device: str | torch.device = DEFAULT_DEVICE,
                **overrides) -> "SpinService":
        """Rebuild a service from `snapshot()` output (this package's or the
        JAX package's), its tensors on `device`. The maintained inverse is
        reloaded, NOT recomputed: a restart costs I/O, never a
        re-factorization, and resumed serving is bit for bit. The guard
        (solve_deadline_s, fault_plan, solve_retries, backoff_base_s,
        degraded_max_sweeps) and the admission and residency settings come
        from the snapshot; `**overrides` changes any constructor knob on
        the way back up (e.g. ``restore(d, solve_deadline_s=0.5)``)."""
        from ..core import solver_ckpt

        dev = resolve_device(device)
        meta, matrices = solver_ckpt.load_service_snapshot(directory,
                                                           device=dev)
        guard = dict(meta.get("guard", {}))
        fault_plan = guard.pop("fault_plan", None)
        if fault_plan is not None:
            guard["fault_plan"] = FaultPlan.from_json(fault_plan)
        kwargs = {**guard, **meta.get("admission", {}),
                  **meta.get("residency", {})}
        if meta.get("precision"):
            kwargs["precision"] = meta["precision"]
        kwargs.update(overrides)
        svc = cls(slots=meta["slots"], policy=policy,
                  drift_probes=meta["drift_probes"],
                  drift_scale=meta["drift_scale"], seed=seed, device=dev,
                  **kwargs)
        svc.stats.update(meta.get("stats", {}))
        svc.ticks = meta.get("ticks", 0)
        for mid, m in meta["matrices"].items():
            st = svc._state_from_meta(mid, m, matrices[mid])
            st.rank = len(svc._matrices)
            svc._matrices[mid] = st
            svc._touch(st)
        # a restored set larger than max_resident spills back down
        if svc.max_resident is not None:
            while len(svc._matrices) > svc.max_resident:
                svc._evict_one(protect=set())
        return svc
