"""Refactor-or-update policy for a maintained inverse under churn.

A maintained inverse has two ways to absorb a rank-k change: fold it in
with a Woodbury update (O(n²k), `core.update`) or re-run the planned SPIN
inversion (O(n³), but it resets the accumulated drift). This module
prices both with the autotuner's machinery: `autotune.predict_cost` for
the re-inversion and a panel-product model for the update.

The crossover rule is rent-or-buy: fold updates in until the SMW spend
since the last factorization reaches `slack ×` the modeled re-inversion,
then re-factorize. With slack = 1 the total spend is at most twice the
offline optimum for any update stream (the ski-rental bound). Two
triggers bypass the race:

  * drift: the probe residual (`core.update.DriftTracker`) exceeds its
    dtype-aware bound, so accuracy forces a rebuild whatever the cost;
  * rank: the accumulated rank approaches n (`max_rank_fraction`), where
    the k×k capacitance solve stops being small.

Re-inversion plans are fetched with the signature's `update_rank` set to
the next power of two at or above the accumulated rank, so a stream of
rank-1 updates adds at most log₂(n) cache entries.
"""

from __future__ import annotations

import dataclasses

from ..core.costmodel import DTYPE_BYTES, H100_SXM, CostParams
from ..core.precision import PrecisionPolicy
from .autotune import predict_cost
from .cache import PlanCache, default_cache
from .plan import Plan, ProblemSignature, signature_for

__all__ = ["RefactorDecision", "RefactorPolicy", "smw_update_cost"]


def _store_dtype(sig: ProblemSignature) -> str:
    """The dtype the maintained inverse is resident in: a low-precision
    policy on the signature narrows the bytes each update streams."""
    if sig.precision:
        store = PrecisionPolicy.from_descriptor(sig.precision).store_dtype
        if store:
            return store
    return sig.dtype


def smw_update_cost(sig: ProblemSignature, k: int,
                    calibration: dict | None = None) -> float:
    """Modeled seconds to fold one rank-k Woodbury update into the inverse.

    Four n×k panel products against the resident n² operand (A⁻¹U, VᵀA⁻¹,
    the capacitance product, the rank-k correction) and the k³ capacitance
    solve. CPU: the paper's §4 convention, multiply-adds × t_flop
    (calibrated when the cache holds fitted constants) over PF = min(items,
    cores). Card: the larger of the flop time at the f32 rate outside the
    tensor cores (`core.update` sums in f32 through cuBLAS, TF32 off) and
    two passes of the resident inverse through HBM at 3.35 TB/s, the term
    that dominates for small k.
    """
    n = sig.n
    if sig.backend == "cuda":
        bytes_ = DTYPE_BYTES.get(_store_dtype(sig), 4)
        flops = (4 * n * n * k + k ** 3) * 2
        t_compute = flops / H100_SXM["peak_flops_f32"]
        t_memory = 2 * n * n * bytes_ / H100_SXM["hbm_bw"]
        return float(max(t_compute, t_memory))
    t_flop = (calibration or {}).get("t_flop") or CostParams(
        n=n, b=1, cores=sig.cores).t_flop
    pf = max(1.0, min(float(n * k), sig.cores))
    return float((4 * n * n * k + k ** 3) * t_flop / pf)


@dataclasses.dataclass(frozen=True)
class RefactorDecision:
    """One policy verdict, with the prices that produced it."""

    refactor: bool
    reason: str             # "smw" | "crossover" | "drift" | "rank"
    smw_cost_s: float       # modeled price of folding THIS update in
    refactor_cost_s: float  # modeled price of a fresh planned re-inversion
    cumulative_s: float     # SMW spend since last factorization, incl. this
    plan: Plan              # the re-inversion plan the refactor would run


class RefactorPolicy:
    """Prices cumulative SMW updates against a planned re-inversion.

    slack: rent-or-buy multiplier (1.0 = 2-competitive; >1 defers
    refactors, <1 hastens them). max_rank_fraction: accumulated-rank bound
    as a fraction of n. The policy only prices: it changes nothing, and
    the caller acts on the returned decision. `backend=` on the methods
    ("cuda" | "cpu"; default: the card where there is one) selects the
    pricing.
    """

    def __init__(self, *, slack: float = 1.0,
                 max_rank_fraction: float = 0.5,
                 cache: PlanCache | None = None):
        if slack <= 0:
            raise ValueError(f"slack must be positive, got {slack}")
        self.slack = slack
        self.max_rank_fraction = max_rank_fraction
        self._cache = cache

    def _plan_for(self, sig: ProblemSignature) -> tuple[Plan, dict | None]:
        from .dispatch import get_plan  # late: dispatch imports siblings

        cache = self._cache or default_cache()
        plan = get_plan(sig.kind, sig.n, sig.dtype, measure=False,
                        cache=cache, placement=sig.placement,
                        update_rank=sig.update_rank,
                        precision=sig.precision or None, backend=sig.backend)
        return plan, cache.get_calibration(sig)

    def decide(self, n: int, dtype, *, new_rank: int,
               pending_rank: int = 0,
               cumulative_s: float = 0.0,
               residual_est: float = 0.0,
               drift_tolerance: float = float("inf"),
               placement: str = "dense",
               precision: str = "",
               backend: str | None = None) -> RefactorDecision:
        """Fold the next rank-`new_rank` update in, or re-factorize?

        pending_rank / cumulative_s: accumulated rank and modeled SMW spend
        since the last factorization. residual_est / drift_tolerance: the
        drift tracker's probe estimate and bound. `precision` (a
        PrecisionPolicy descriptor, "" = exact) prices both sides at the
        policy's resident store dtype.
        """
        total_rank = pending_rank + int(new_rank)
        # The next power of two ≥ total_rank: the cache axis the plan is
        # fetched under (see the module docstring).
        bucket = 1 << max(total_rank - 1, 0).bit_length()
        sig = signature_for("inverse", n, dtype, backend=backend,
                            placement=placement, update_rank=bucket,
                            precision=precision)
        plan, calibration = self._plan_for(sig)
        smw_s = smw_update_cost(sig, int(new_rank), calibration)
        refactor_s = predict_cost(sig, plan, calibration)
        cumulative = cumulative_s + smw_s

        if residual_est > drift_tolerance:
            reason, refactor = "drift", True
        elif total_rank >= self.max_rank_fraction * n:
            reason, refactor = "rank", True
        elif cumulative >= self.slack * refactor_s:
            reason, refactor = "crossover", True
        else:
            reason, refactor = "smw", False
        return RefactorDecision(refactor=refactor, reason=reason,
                                smw_cost_s=smw_s,
                                refactor_cost_s=refactor_s,
                                cumulative_s=cumulative, plan=plan)

    def reinversion_cost(self, n: int, dtype, *,
                         placement: str = "dense",
                         precision: str = "",
                         backend: str | None = None) -> float:
        """Modeled seconds of a fresh planned inversion of an (n, n)
        matrix, under the offline signature (no churn axis): the price a
        service's cost-aware eviction weighs."""
        sig = signature_for("inverse", n, dtype, backend=backend,
                            placement=placement, precision=precision)
        plan, calibration = self._plan_for(sig)
        return float(predict_cost(sig, plan, calibration))

    def crossover_rank(self, n: int, dtype, *, step_rank: int = 1,
                       placement: str = "dense",
                       backend: str | None = None) -> int:
        """Accumulated rank at which a steady rank-`step_rank` update stream
        first triggers a refactor."""
        cumulative, rank = 0.0, 0
        while True:
            d = self.decide(n, dtype, new_rank=step_rank,
                            pending_rank=rank, cumulative_s=cumulative,
                            placement=placement, backend=backend)
            rank += step_rank
            if d.refactor:
                return rank
            cumulative = d.cumulative_s
