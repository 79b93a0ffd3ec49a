"""repro_torch.planner — cost-model-driven autotuning for SPIN.

Turns the paper's §4 cost model into the system's execution policy:
enumerate candidate (block grid, leaf solver, multiply engine, dtype,
refinement) plans, score them with the per-level Lemma 4.1 sums (with the
card's fitted constants on a CUDA signature, the model's defaults on the
CPU), optionally refine the top-k by timing them, and keep the winner in a
JSON plan cache shared across processes. `spin_inverse_dense(a)` without a
block size, and every `auto=True`, route through here.
"""

from .plan import (STRASSEN_MIN_N, STRASSEN_MIN_N_CUDA, Plan,
                   ProblemSignature, candidate_grids, default_backend,
                   enumerate_plans, mesh_descriptor, signature_for)
# NB: the `autotune` *function* is not re-exported: it would shadow the
# `repro_torch.planner.autotune` submodule. Use
# `repro_torch.planner.autotune.autotune` (or `get_plan`).
from .autotune import (CUDA_CONSTANTS, ENGINE_RATE, LEAF_SOLVER_RATE,
                       measure_plan, measure_plans, predict_cost, rank_plans)
from .cache import (PLAN_CACHE_VERSION, PlanCache, default_cache,
                    default_cache_path)
from .dispatch import (MEASURE_MAX_N, execute_inverse, execute_solve,
                       get_plan, plan_inverse, plan_solve,
                       planned_block_size, planned_leaf_solver)
from .refactor_policy import (RefactorDecision, RefactorPolicy,
                              smw_update_cost)

__all__ = [
    "Plan", "ProblemSignature", "signature_for", "enumerate_plans",
    "candidate_grids", "default_backend", "mesh_descriptor",
    "STRASSEN_MIN_N", "STRASSEN_MIN_N_CUDA",
    "predict_cost", "rank_plans", "measure_plan", "measure_plans",
    "LEAF_SOLVER_RATE", "ENGINE_RATE", "CUDA_CONSTANTS",
    "PlanCache", "default_cache", "default_cache_path", "PLAN_CACHE_VERSION",
    "get_plan", "plan_inverse", "plan_solve", "planned_block_size",
    "planned_leaf_solver", "execute_inverse", "execute_solve",
    "MEASURE_MAX_N",
    "RefactorDecision", "RefactorPolicy", "smw_update_cost",
]
