"""Plan scoring and (optional) live refinement for the SPIN autotuner.

Scoring is the paper's §4 cost model, `costmodel.spin_cost` (Lemma 4.1
evaluated per level), or `costmodel.strassen_cost` for the Strassen
engine, with constants from the plan cache when a previous session fitted
them (`costmodel.fit_scale`), else the backend's defaults:

  * "cpu" — the model's default constants and the JAX package's rates,
    number for number, so a CPU signature is priced as that package
    prices it (with the ``cuda`` leaf and engine in place of ``pallas``);
  * "cuda" — `CUDA_CONSTANTS`, fitted to a block-size sweep on the card,
    and the card's measured leaf and engine rates.

The card is not priced with the roofline (`costmodel.roofline_cost`): it
books leaves and small products at peak, so it ranks a single 16384²
leaf first, where the card takes 367 ms for it against 95 ms at b = 16
(PERF.md, PR 18).

Leaf-solver and engine choice are per-backend multipliers on the leafNode
and multiply terms. A Newton–Schulz refinement stage is charged its two
full-size multiplies per sweep.

`autotune` optionally *measures* the top-k model-ranked candidates and
picks the fastest, the paper's Fig. 4 theory-against-practice loop.
Measurements along the backend's base axis (leaf and engine at rate 1)
feed `fit_scale`, and the fitted constants are kept in the cache so the
next problem size is priced with them. Under $SPIN_TRACE a ranking emits
a "planner.rank" event and a measured choice a "planner.measure" event
(kind "planner_decision").
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from ..core.costmodel import (DTYPE_BYTES, CostParams, apply_inverse_cost,
                              fit_scale, spin_cost, strassen_cost)
from ..obs.trace import TRACER as _TRACER
from .plan import Plan, ProblemSignature

__all__ = ["predict_cost", "rank_plans", "measure_plan", "measure_plans",
           "autotune", "LEAF_SOLVER_RATE", "ENGINE_RATE", "CUDA_CONSTANTS",
           "CUDA_HALF_PRODUCT_RATE", "SERVE_HORIZON_COLS"]

# RHS columns a maintained inverse is assumed to serve over its lifetime:
# the horizon the precision axis prices storage against.
SERVE_HORIZON_COLS = 1024

# The card's constants for `spin_cost` at cores = 1 (one card: the
# parallelism is inside each constant). Fitted by `costmodel.fit_scale` to
# the block-size sweep of `python -m repro_torch.profile_spin --sweep`
# (n = 16384, f32, engine and leaf `cuda`, b = 1 … 64; the best of six
# calls over two runs at each b; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md,
# PR 18). The fit reproduces that sweep within 1.04 % at every b and has
# its minimum at b = 16, where the card's is. Beside the kernels' own
# times: B2 runs an 8192³ f32 product at 1.8e-14 s a multiply-add, and B3
# a 16384² leaf at 8.3e-14 s a bs³ unit; t_block_op (per block touched)
# and t_elem (per element of a subtract) carry the launches, the copies
# and the small products' and leaves' latency.
CUDA_CONSTANTS = {"t_flop": 1.585889753846211e-14,
                  "t_leaf": 8.341468963651707e-14,
                  "t_block_op": 1.561204541792774e-07,
                  "t_elem": 9.843084035997208e-11}

# A bf16 or f16 product's time over an f32 one's on the card: B2 at 8192³,
# 2.352 ms bf16 against 9.789 ms f32 (PERF.md §6; H100 80GB HBM3, 700 W).
CUDA_HALF_PRODUCT_RATE = 2.352 / 9.789

# Leaf-inversion time relative to the backend's base leaf (rate 1): on the
# CPU LAPACK's getrf/getri (`linalg`), as in the JAX package, where the
# kernels' plain versions run step by step; on the card the blocked
# Gauss–Jordan kernel B3 (`cuda`), and each other leaf at its time over
# B3's at bs = 1024, the block size planned on the card (the sweep above:
# linalg.inv 2.639 ms, the QR leaf 4.956, the scalar Gauss–Jordan kernel
# B4 409.3, B3 0.3916; H100 80GB HBM3, 700 W).
LEAF_SOLVER_RATE: dict[str, dict[str, float]] = {
    "linalg": {"cuda": 2.639 / 0.3916},
    "qr": {"cuda": 4.956 / 0.3916, "default": 3.0},
    "gauss_jordan": {"cuda": 409.3 / 0.3916, "default": 200.0},
    "cuda": {"cuda": 1.0, "default": 150.0},
}

# Multiply rates, same convention: the GEMM kernel B2 (`cuda`) is the
# card's base; `einsum` is cuBLAS SGEMM through torch.einsum, 2.2× B2 at
# 8192³ (21.49 against 9.789 ms, PERF.md §6). Off the card the kernel
# engine runs its plain version and is priced out, as the JAX package
# prices its interpreted engine. Strassen's win is modeled structurally
# (`strassen_cost`), so its rate is 1.0. The SUMMA engines multiply each
# shard with the same einsum, so they take its rate.
ENGINE_RATE: dict[str, dict[str, float]] = {
    "einsum": {"cuda": 2.2},
    "allgather": {"cuda": 2.2},
    "ring": {"cuda": 2.2},
    "cuda": {"cuda": 1.0, "default": 200.0},
    "strassen": {},
}

_HALF = ("bfloat16", "float16")
_LOW_STORE = ("bfloat16", "float16", "float8_e4m3fn")
# The leaf and engine whose measurements calibrate the model (rate 1).
_BASE_AXIS = {"cpu": ("linalg", "einsum"), "cuda": ("cuda", "cuda")}


def _rate(table: dict[str, dict[str, float]], name: str, backend: str) -> float:
    rates = table.get(name, {})
    return rates.get(backend, rates.get("default", 1.0))


def _cost_params(sig: ProblemSignature, b: int, calibration: dict | None
                 ) -> CostParams:
    kw = dict(CUDA_CONSTANTS) if sig.backend == "cuda" else {}
    kw.update({k: v for k, v in (calibration or {}).items()
               if k in ("t_flop", "t_leaf", "t_block_op", "t_elem")})
    return CostParams(n=sig.n, b=b, cores=sig.cores, **kw)


def predict_cost(sig: ProblemSignature, plan: Plan,
                 calibration: dict | None = None) -> float:
    """Model seconds for `plan` on `sig`'s problem. Lower is better."""
    b = plan.grid(sig.n)
    cuda = sig.backend == "cuda"
    p = _cost_params(sig, b, calibration)
    # strassen swaps the multiply term for the 7-multiply recurrence (and
    # its add passes); every other class is shared.
    c = (strassen_cost(p) if plan.multiply_engine == "strassen"
         else spin_cost(p))
    leaf, mult = c["leafNode"], c["multiply"]
    half = plan.compute_dtype in _HALF
    if half and cuda:
        mult *= CUDA_HALF_PRODUCT_RATE            # bf16 on the tensor cores
    total = (c["total"] - c["leafNode"] - c["multiply"]
             + leaf * _rate(LEAF_SOLVER_RATE, plan.leaf_solver, sig.backend)
             + mult * _rate(ENGINE_RATE, plan.multiply_engine, sig.backend))
    if half and not cuda:
        total *= 1.5                              # emulated half precision
    # one Newton–Schulz sweep = 2 full-size multiplies (2 n³ MACs)
    sweep = 2 * sig.n**3 * p.t_flop / max(1.0, min(b * b, sig.cores))
    total += plan.refine_sweeps * sweep

    # Precision axis: with a policy on the signature the plan is priced for
    # serving too, SERVE_HORIZON_COLS columns of `apply_inverse`. On the
    # card that product streams the stored inverse through HBM
    # (costmodel.apply_inverse_cost), so a bf16 store halves it; on the CPU
    # half precision is emulated and exact storage wins.
    if sig.precision and sig.kind == "inverse":
        store = plan.store_dtype or sig.dtype
        if cuda:
            t_serve = apply_inverse_cost(sig.n, 1, 1,
                                         dtype_bytes=DTYPE_BYTES.get(store, 4))
        else:
            t_serve = (2 * sig.n**2 * p.t_flop
                       / max(1.0, min(float(sig.n), sig.cores)))
            if store in _LOW_STORE:
                t_serve *= 1.5
        total += SERVE_HORIZON_COLS * t_serve
        if store != sig.dtype:
            total += sweep                   # certification polish, one-off
    return float(total)


def rank_plans(sig: ProblemSignature, candidates: list[Plan],
               calibration: dict | None = None) -> list[Plan]:
    """Candidates sorted by modeled cost, each annotated with its score."""
    scored = [dataclasses.replace(p, predicted_s=predict_cost(
        sig, p, calibration)) for p in candidates]
    return sorted(scored, key=lambda p: p.predicted_s)


# ---------------------------------------------------------------------------
# Live refinement
# ---------------------------------------------------------------------------


def _bench_operands(sig: ProblemSignature):
    from ..core import testing
    from ..core.precision import torch_dtype

    dtype = torch_dtype(sig.dtype)
    a = testing.make_spd(sig.n, np.random.default_rng(0), dtype=dtype,
                         device=sig.backend)
    if sig.kind == "solve":
        rhs = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (sig.n, 8), dtype=np.float32)).to(a.device, dtype)
        return a, rhs
    return (a,)


def measure_plans(sig: ProblemSignature, plans: list[Plan], *,
                  warmup: int = 1, iters: int = 5) -> list[float]:
    """Best-of-`iters` wall seconds for each plan, measured round-robin.

    Every plan runs `warmup` times first, so that no kernel's build or
    first launch is timed. Min, not median: noise on a loaded host is
    additive, so the fastest observation is the least contaminated.
    Round-robin (every candidate once a round) so a slow phase of the
    system penalizes every candidate alike. On the card each run ends in
    `torch.cuda.synchronize`.
    """
    from . import dispatch  # late: dispatch imports this module

    operands = _bench_operands(sig)
    # Time the executor the plan will run under: for a sharded signature
    # the mesh-resident recursion, not the dense path.
    run = functools.partial(
        dispatch.execute_solve if sig.kind == "solve"
        else dispatch.execute_inverse, placement=sig.placement)
    sync = torch.cuda.synchronize if sig.backend == "cuda" else (lambda: None)
    for plan in plans:
        for _ in range(warmup):
            run(plan, *operands)
    sync()
    best = [float("inf")] * len(plans)
    for _ in range(iters):
        for i, plan in enumerate(plans):
            t0 = time.perf_counter()
            run(plan, *operands)
            sync()
            best[i] = min(best[i], time.perf_counter() - t0)
    return best


def measure_plan(sig: ProblemSignature, plan: Plan, *, warmup: int = 1,
                 iters: int = 5) -> float:
    """Best-of-`iters` wall seconds of one planned execution."""
    return measure_plans(sig, [plan], warmup=warmup, iters=iters)[0]


def _calibration_points(measured: list[Plan], sig: ProblemSignature
                        ) -> dict[int, float]:
    """{b: seconds} along the backend's base axis at the native dtype."""
    leaf, engine = _BASE_AXIS[sig.backend]
    pts = {}
    for p in measured:
        if (p.leaf_solver == leaf and p.multiply_engine == engine
                and p.compute_dtype == sig.dtype and p.refine_sweeps == 0
                and not p.store_dtype and p.measured_s is not None):
            pts[p.grid(sig.n)] = p.measured_s
    return pts


def _behavior(sig: ProblemSignature, p: Plan) -> tuple:
    """What a plan executes: its execution key, with `allgather` and
    `ring` read as `einsum` off the mesh."""
    key = p.execution_key()
    if not sig.mesh and p.multiply_engine in ("allgather", "ring"):
        key = key[:2] + ("einsum",) + key[3:]
    return key


def autotune(sig: ProblemSignature, candidates: list[Plan], *,
             measure: bool = False, top_k: int | None = 4,
             calibration: dict | None = None
             ) -> tuple[Plan, dict | None]:
    """Choose a plan; returns (plan, new_calibration_or_None).

    measure=False: the cost model's argmin; nothing runs. measure=True:
    time the `top_k` model-ranked candidates (all of them when top_k is
    None) and take the fastest; the calibration constants are refitted
    when at least three grids were timed along the base axis.
    """
    ranked = rank_plans(sig, candidates, calibration)
    if not measure:
        if _TRACER.enabled:
            _TRACER.event(
                "planner.rank", "planner_decision", sig=sig.key(),
                decision="costmodel", candidates=len(candidates),
                chosen=ranked[0].to_dict(),
                modeled_top=[{"block_size": p.block_size,
                              "engine": p.multiply_engine,
                              "leaf_solver": p.leaf_solver,
                              "predicted_s": p.predicted_s}
                             for p in ranked[:4]])
        return ranked[0], None

    short = ranked if top_k is None else ranked[:max(top_k, 1)]
    # One timing per executed configuration (the best-ranked plan of each,
    # so ties resolve to the model's preference). Off the mesh (the
    # signature's descriptor decides) the SUMMA engines are the einsum
    # product, so they share its timing instead of letting timer noise
    # pick among one program.
    reps: dict[tuple, Plan] = {}
    for p in short:
        reps.setdefault(_behavior(sig, p), p)
    uniq = list(reps.values())
    secs = dict(zip(reps, measure_plans(sig, uniq)))
    timed = [dataclasses.replace(p, measured_s=secs[_behavior(sig, p)],
                                 source="measured") for p in short]
    best = min(timed, key=lambda p: p.measured_s)   # ties -> ranked order

    new_calib = None
    pts = _calibration_points(timed, sig)
    if len(pts) >= 3:
        fit = fit_scale(spin_cost, pts, n=sig.n, cores=sig.cores)
        new_calib = {"t_flop": fit.t_flop, "t_leaf": fit.t_leaf,
                     "t_block_op": fit.t_block_op, "t_elem": fit.t_elem}
    if _TRACER.enabled:
        _TRACER.event(
            "planner.measure", "planner_decision", sig=sig.key(),
            decision="measured", candidates=len(candidates),
            measured=len(short), behavior_groups=len(uniq),
            chosen=best.to_dict(), calibrated=new_calib is not None,
            microbench=[{"block_size": p.block_size,
                         "engine": p.multiply_engine,
                         "leaf_solver": p.leaf_solver,
                         "predicted_s": p.predicted_s,
                         "measured_s": p.measured_s}
                        for p in timed])
    return best, new_calib
