"""Planned execution: `plan_inverse` / `plan_solve` and the `auto=` path.

`get_plan` is the policy: cache lookup, candidate enumeration
(`plan.enumerate_plans`), cost-model ranking, optionally refined by
timing (`autotune.autotune`), then a cache write. `execute_inverse` and
`execute_solve` are the mechanism: they run one concrete plan, including
the Newton–Schulz refinement stage when the plan has one.

A plan is chosen for the backend of the device the operands lie on, so a
tensor on the CPU is planned with the CPU's pricing and one on the card
with the card's. `planned_block_size` never measures and memoizes per
process.

Under $SPIN_TRACE `get_plan` emits a "planner.plan" event (a cache hit or
a fresh choice), and `plan_inverse` / `plan_solve` run inside a
"plan.inverse" / "plan.solve" span, synchronise the device to take the
call's wall time, and record it beside the plan's modeled time in the
cost ledger (`obs.ledger`, a "ledger.solve" event). Untraced calls never
synchronise.
"""

from __future__ import annotations

import functools
import time

import torch

from ..core.blockmatrix import BlockMatrix
from ..core.multiply import multiply_engine
from ..core.newton_schulz import newton_schulz_polish
from ..core.precision import _dtype_name, resolve_precision, torch_dtype
from ..obs.trace import TRACER as _TRACER
from .autotune import autotune as _autotune_plans
from .cache import PlanCache, default_cache, default_cache_path
from .plan import (Plan, default_backend, enumerate_plans, mesh_descriptor,
                   signature_for)

__all__ = ["get_plan", "plan_inverse", "plan_solve", "planned_block_size",
           "planned_leaf_solver", "execute_inverse", "execute_solve",
           "MEASURE_MAX_N"]

# `measure="auto"` times only problems at or below this size; above it the
# cost model decides alone, so a first planned 16384² inversion never pays
# a sweep of warm-up runs.
MEASURE_MAX_N = 512


def _resolve_measure(measure, n: int) -> bool:
    if measure == "auto":
        return n <= MEASURE_MAX_N
    return bool(measure)


def get_plan(kind: str, n: int, dtype=torch.float32, *,
             measure: bool | str = "auto",
             top_k: int | None = 4,
             cache: PlanCache | None = None,
             force_replan: bool = False,
             placement: str = "dense",
             update_rank: int = 0,
             precision=None,
             backend: str | None = None,
             **enumerate_kw) -> Plan:
    """Select (or recall) the plan for one (kind, n, dtype) problem.

    measure: True / False / "auto" (measure iff n <= MEASURE_MAX_N). A
    cached cost-model plan is replaced the first time the same problem is
    planned with measurement. `backend` ("cuda" | "cpu"; default: the card
    where there is one) selects the pricing. `update_rank` is the online
    service's axis (accumulated SMW churn a re-inversion is priced under,
    see `refactor_policy`); `precision` puts a policy on the signature,
    whose candidates then gain store-dtype variants priced for serving.
    Keyword arguments of `enumerate_plans` constrain the candidates and
    the cache key alike.
    """
    if kind not in ("inverse", "solve"):
        raise ValueError(f"unknown plan kind {kind!r}")
    policy = resolve_precision(precision)
    sig = signature_for(kind, n, dtype, backend=backend, placement=placement,
                        update_rank=update_rank,
                        precision="" if policy.is_exact else policy.descriptor(),
                        constraint=_constraint_key(enumerate_kw))
    cache = cache or default_cache()
    do_measure = _resolve_measure(measure, n)

    cached = cache.get(sig)
    if cached is not None and not force_replan:
        if not (do_measure and cached.source == "costmodel"):
            if _TRACER.enabled:
                _TRACER.event("planner.plan", "planner_decision",
                              sig=sig.key(), decision="cache_hit",
                              plan=cached.to_dict())
            return cached

    candidates = enumerate_plans(sig, **enumerate_kw)
    if not candidates:
        raise ValueError(f"no feasible plans for {sig.key()} "
                         f"(constraints: {enumerate_kw})")
    plan, calib = _autotune_plans(
        sig, candidates, measure=do_measure, top_k=top_k,
        calibration=cache.get_calibration(sig))
    cache.put(sig, plan)
    if calib:
        cache.put_calibration(sig, calib)
    if _TRACER.enabled:
        _TRACER.event("planner.plan", "planner_decision", sig=sig.key(),
                      decision="autotuned", measured=do_measure,
                      candidates=len(candidates), plan=plan.to_dict(),
                      calibrated=calib is not None)
    return plan


def _constraint_key(enumerate_kw: dict) -> str:
    """Cache-key suffix for constrained enumerations.

    Every non-default enumeration knob appears here: a plan chosen from a
    restricted candidate space, cached under the unconstrained key, would
    be served to every later unconstrained lookup.
    """
    parts = []
    for k in sorted(enumerate_kw):
        v = enumerate_kw[k]
        if isinstance(v, (tuple, list)):
            v = "+".join(str(x) for x in v)
        parts.append(f"{k}={v}")
    return ";".join(parts)


# ---------------------------------------------------------------------------
# Executing a plan
# ---------------------------------------------------------------------------


def _refined_inverse(plan: Plan, dense: torch.Tensor) -> torch.Tensor:
    """Low-precision recursion, then a Newton–Schulz polish back to the
    operand's precision, both under the plan's engine."""
    from ..core.spin import spin_inverse_dense

    approx = spin_inverse_dense(
        dense.to(torch_dtype(plan.compute_dtype)), plan.block_size,
        plan.leaf_solver, engine=plan.multiply_engine,
        device=dense.device).to(dense.dtype)
    a = BlockMatrix.from_dense(dense, plan.block_size)
    x0 = BlockMatrix.from_dense(approx, plan.block_size)
    with multiply_engine(plan.multiply_engine):
        return newton_schulz_polish(a, x0,
                                    sweeps=plan.refine_sweeps).to_dense()


def execute_inverse(plan: Plan, dense: torch.Tensor,
                    placement: str = "dense") -> torch.Tensor:
    """Run one concrete inversion plan on a dense (n, n) matrix, on the
    device the matrix lies on. placement="sharded" runs the mesh-resident
    recursion over the ambient mesh instead (no refinement stage exists
    there; enumeration never produces one)."""
    if placement == "sharded":
        from ..core.spin import spin_inverse_sharded

        return spin_inverse_sharded(dense, plan.block_size,
                                    leaf_solver=plan.leaf_solver,
                                    engine=plan.multiply_engine,
                                    device=dense.device)
    from ..core.spin import spin_inverse_dense

    if plan.compute_dtype != _dtype_name(dense.dtype) and plan.refine_sweeps:
        out = _refined_inverse(plan, dense)
    else:
        out = spin_inverse_dense(dense, plan.block_size, plan.leaf_solver,
                                 engine=plan.multiply_engine,
                                 device=dense.device)
    # Precision-axis plans may store the result below the operand dtype
    # (the maintained-inverse serving representation); "" = the operand's.
    if plan.store_dtype and plan.store_dtype != _dtype_name(out.dtype):
        out = out.to(torch_dtype(plan.store_dtype))
    return out


def execute_solve(plan: Plan, dense: torch.Tensor, rhs: torch.Tensor,
                  placement: str = "dense") -> torch.Tensor:
    """Run one concrete solve plan on dense A (n, n) and B (n, k) or (n,)
    (placement="sharded": the mesh-resident solve)."""
    if placement == "sharded":
        from ..core.solve import spin_solve_sharded

        return spin_solve_sharded(dense, rhs, plan.block_size,
                                  leaf_solver=plan.leaf_solver,
                                  engine=plan.multiply_engine,
                                  device=dense.device)
    from ..core.solve import spin_solve_dense

    return spin_solve_dense(dense, rhs, plan.block_size, plan.leaf_solver,
                            engine=plan.multiply_engine, device=dense.device)


# ---------------------------------------------------------------------------
# Public planned entry points
# ---------------------------------------------------------------------------


def _traced(kind: str, plan: Plan, dense: torch.Tensor, run):
    """Run one planned call inside its span, synchronised so that the wall
    time is the device's, and record modeled against measured seconds in
    the cost ledger. Only called under $SPIN_TRACE."""
    with _TRACER.span(f"plan.{kind}", "solve", n=int(dense.shape[0]),
                      block_size=plan.block_size,
                      engine=plan.multiply_engine):
        _synchronize(dense.device)
        t0 = time.perf_counter()
        out = run()
        _synchronize(dense.device)
        _ledger_record(kind, plan, dense, time.perf_counter() - t0)
    return out


def _ledger_record(kind: str, plan: Plan, dense: torch.Tensor,
                   measured_s: float) -> None:
    """One traced planned call into the cost ledger. The prediction is the
    plan's own `predicted_s` when the autotuner annotated it, else
    `predict_cost` under the call's signature: both are Lemma 4.1."""
    from ..obs import ledger as obs_ledger
    from .autotune import predict_cost

    n = int(dense.shape[0])
    sig = signature_for(kind, n, dense.dtype, backend=dense.device.type)
    pred = plan.predicted_s
    if pred is None:
        pred = predict_cost(sig, plan)
    entry = obs_ledger.ledger().record_solve(
        kind=kind, n=n, plan=plan, backend=sig.backend, dtype=sig.dtype,
        measured_s=measured_s, predicted_s=pred)
    attrs = entry.to_dict()
    attrs["solve_kind"] = attrs.pop("kind")    # "kind" names the span kind
    _TRACER.event("ledger.solve", "cost_ledger", **attrs)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def plan_inverse(dense: torch.Tensor, *, plan: Plan | None = None,
                 measure: bool | str = "auto",
                 cache: PlanCache | None = None,
                 return_plan: bool = False, **plan_kw):
    """Invert a dense SPD matrix with an autotuned plan.

    Equivalent to `spin_inverse_dense(dense, p.block_size, p.leaf_solver,
    engine=p.multiply_engine)`, bit for bit when `p` has no refinement
    stage. The plan is priced for the device `dense` lies on. A traced
    call synchronises and records its time in the cost ledger.
    """
    if plan is None:
        plan = get_plan("inverse", dense.shape[0], dense.dtype,
                        measure=measure, cache=cache,
                        backend=dense.device.type, **plan_kw)
    if _TRACER.enabled:
        out = _traced("inverse", plan, dense,
                      lambda: execute_inverse(plan, dense))
    else:
        out = execute_inverse(plan, dense)
    return (out, plan) if return_plan else out


def plan_solve(dense: torch.Tensor, rhs: torch.Tensor, *,
               plan: Plan | None = None, measure: bool | str = "auto",
               cache: PlanCache | None = None,
               return_plan: bool = False, **plan_kw):
    """Solve A X = B with an autotuned plan (inverse-free SPIN recursion)."""
    if plan is None:
        plan = get_plan("solve", dense.shape[0], dense.dtype,
                        measure=measure, cache=cache,
                        backend=dense.device.type, **plan_kw)
    if _TRACER.enabled:
        out = _traced("solve", plan, dense,
                      lambda: execute_solve(plan, dense, rhs))
    else:
        out = execute_solve(plan, dense, rhs)
    return (out, plan) if return_plan else out


@functools.lru_cache(maxsize=256)
def _planned_fields(kind: str, n: int, dtype_name: str,
                    block_sizes: tuple[int, ...] | None,
                    cache_path: str, backend: str,
                    mesh: str = "") -> tuple[int, str]:
    # cache_path is part of the memo key, so a changed $SPIN_PLAN_CACHE
    # (a test pointing at a temporary directory) is seen instead of
    # answers memoized against the previous file; `mesh` likewise, since
    # the ambient mesh is on the signature get_plan derives.
    kw = {"block_sizes": block_sizes} if block_sizes else {}
    plan = get_plan(kind, n, dtype_name, measure=False, backend=backend, **kw)
    return plan.block_size, plan.leaf_solver


def planned_block_size(n: int, dtype=torch.float32, kind: str = "inverse", *,
                       backend: str | None = None) -> int:
    """Cost-model block size for (kind, n, dtype) on `backend`."""
    return _planned_fields(kind, int(n), _dtype_name(dtype), None,
                           default_cache_path(), backend or default_backend(),
                           mesh_descriptor())[0]


def planned_leaf_solver(n: int, block_size: int, dtype=torch.float32,
                        kind: str = "inverse", *,
                        backend: str | None = None) -> str:
    """Leaf solver for a problem whose block grid is already fixed."""
    return _planned_fields(kind, int(n), _dtype_name(dtype), (int(block_size),),
                           default_cache_path(), backend or default_backend(),
                           mesh_descriptor())[1]
