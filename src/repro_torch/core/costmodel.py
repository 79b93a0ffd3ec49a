"""Paper §4 cost models (Lemmas 4.1 / 4.2), Strassen pricing, and an H100
roofline.

The paper expresses wall-clock cost as Σ_levels (work / parallelization
factor), with the parallelization factor min(items_in_flight, cores). The
collapsed closed forms of Eq. (1)/(12) leave a dangling level index `i`
inside `min(·)`, so the per-level sums of Table 1 are evaluated directly.
`fit_scale` calibrates the model's abstract op units to seconds against
measurements (one multiplicative constant per cost class), as the paper's
Fig. 4 compares theory with practice.

`spin_schedule` gives the exact (method, shape, count) trace per recursion
level. `roofline_cost` and `apply_inverse_cost` price one inversion and one
served product on the card in `hw` (default `H100_SXM`, NVIDIA's data-sheet
peaks); they are the same formulas as the JAX package's TPU roofline.

Pure Python and numpy: this module imports no torch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

__all__ = [
    "CostParams", "spin_cost", "lu_cost", "spin_schedule",
    "roofline_cost", "H100_SXM", "apply_inverse_cost", "fit_scale",
    "DTYPE_BYTES",
    "coded_work_multiplier", "coded_completion_cost", "plan_redundancy",
    "STRASSEN_CUTOFF", "strassen_multiply_counts", "strassen_cost",
    "strassen_crossover_n",
]

# Storage bytes per element, by dtype name: one table for every pricer
# that turns a dtype into roofline traffic.
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8,
               "float8_e4m3fn": 1}


@dataclasses.dataclass(frozen=True)
class CostParams:
    n: int              # matrix dimension (2^p)
    b: int              # number of splits per side (2^(p-q))
    cores: int          # paper's `cores`; = cards on the GPU
    # calibration constants (seconds per abstract unit); fit via fit_scale()
    t_flop: float = 1e-9        # per scalar flop in distributed multiplies
    t_block_op: float = 1e-6    # per block-touch in breakMat/xy/arrange class
    t_elem: float = 1e-9        # per element in subtract/scalarMul class
    # leaf inversions run a different code path (serial LAPACK/JBlas vs
    # distributed GEMM) — their own rate, like the paper's separate leafNode
    # instrumentation. None -> share t_flop.
    t_leaf: float | None = None

    @property
    def levels(self) -> int:
        return int(math.log2(self.b))

    @property
    def block_size(self) -> int:
        return self.n // self.b


def _pf(items: float, cores: int) -> float:
    return max(1.0, min(items, cores))


def spin_cost(p: CostParams) -> dict[str, float]:
    """Lemma 4.1 evaluated per level. Returns per-method seconds + total."""
    n, b, cores = p.n, p.b, p.cores
    bs = p.block_size
    m = p.levels
    c: dict[str, float] = {k: 0.0 for k in (
        "leafNode", "breakMat", "xy", "multiply", "subtract", "scalar",
        "arrange")}

    # Leaf: 2^m = b leaf nodes, one (n/b)^3 inversion each, parallel across
    # leaves is impossible (the recursion serializes A11 before V), so the
    # paper books them sequentially: b * (n/b)^3 = n^3/b^2.  (Eq. 2)
    t_leaf = p.t_flop if p.t_leaf is None else p.t_leaf
    c["leafNode"] = b * bs**3 * t_leaf

    for i in range(m):
        nodes = 2**i
        gb = b // 2**i            # grid side of this level's matrices
        half = gb // 2
        blocks_lvl = gb * gb
        sub_n = n // 2**i          # matrix dim at this level
        # breakMat touches every block once (Eq. 3/4)
        c["breakMat"] += nodes * blocks_lvl * p.t_block_op / _pf(blocks_lvl, cores)
        # xy: 4 filters over all blocks + 4 maps over quadrant blocks (Eq. 5)
        c["xy"] += nodes * (4 * blocks_lvl * p.t_block_op / _pf(blocks_lvl, cores)
                            + 4 * (blocks_lvl // 4) * p.t_block_op
                            / _pf(blocks_lvl // 4, cores))
        # multiply: 6 half-size block-grid multiplies, (half)^3 block GEMMs of
        # bs^3 flops each; PF = min((sub_n/2)^2, cores) per the paper (Eq. 6/7)
        gemm_flops = 6 * half**3 * bs**3
        c["multiply"] += nodes * gemm_flops * p.t_flop / _pf((sub_n / 2)**2, cores)
        # subtract: 2 per level over (sub_n/2)^2 elements (Eq. 8/9)
        c["subtract"] += nodes * 2 * (sub_n / 2)**2 * p.t_elem / _pf((sub_n / 2)**2, cores)
        # scalarMul: 1 per level over quadrant blocks (Eq. 10/11)
        c["scalar"] += nodes * (blocks_lvl // 4) * p.t_block_op / _pf(blocks_lvl // 4, cores)
        # arrange: 4 maps over quadrant blocks (same cost class as scalarMul)
        c["arrange"] += nodes * 4 * (blocks_lvl // 4) * p.t_block_op / _pf(blocks_lvl // 4, cores)

    c["total"] = sum(c.values())
    return c


# ---------------------------------------------------------------------------
# Strassen (Stark) pricing: 7 multiplies + 18 add passes per split level
# ---------------------------------------------------------------------------

# Operand dimension at/below which the Strassen recursion goes classical.
# One constant for both the executed recursion (core.strassen.
# strassen_cutoff, env-overridable) and the pricing here, so the modeled
# and executed recursions agree by construction.
STRASSEN_CUTOFF = 512


def strassen_multiply_counts(n: float, cutoff: int = STRASSEN_CUTOFF
                             ) -> tuple[float, float]:
    """(classical-equivalent MACs, add/sub elements) of ONE Strassen multiply.

    Each split level of dimension n performs 7 recursive multiplies of
    dimension ceil(n/2) (odd n pads to the next even split) plus 18
    quadrant add/sub passes of (n/2)² elements each — the n^log2(7)
    recurrence. At/below the cutoff the multiply is classical: n³ MACs,
    no add passes.
    """
    if n <= max(cutoff, 1):
        return float(n) ** 3, 0.0
    half = math.ceil(n / 2)
    macs, adds = strassen_multiply_counts(half, cutoff)
    return 7 * macs, 18 * float(half) ** 2 + 7 * adds


def strassen_cost(p: CostParams, *, cutoff: int = STRASSEN_CUTOFF,
                  add_weight: float = 3.0) -> dict[str, float]:
    """`spin_cost` with each of the 6 multiplies per level run by Strassen.

    The multiply term swaps the classical (sub_n/2)³ MACs for the Strassen
    recurrence's 7-multiply count; the 18 add passes per split level are
    the calibrated crossover term — each streams 2 operand reads + 1 result
    write per element (add_weight=3), charged at the subtract class's
    t_elem rate, which is what keeps Strassen from being modeled as a win
    at small n. Every other cost class is engine-blind and unchanged.
    """
    c = spin_cost(p)
    n, cores = p.n, p.cores
    mult = 0.0
    for i in range(p.levels):
        nodes = 2 ** i
        half_n = n // 2 ** (i + 1)
        macs, adds = strassen_multiply_counts(half_n, cutoff)
        pf = _pf((n / 2 ** (i + 1)) ** 2, cores)
        mult += nodes * 6 * (macs * p.t_flop
                             + add_weight * adds * p.t_elem) / pf
    c["total"] += mult - c["multiply"]
    c["multiply"] = mult
    return c


def strassen_crossover_n(*, cutoff: int = STRASSEN_CUTOFF,
                         t_flop: float = 1e-9, t_elem: float = 1e-9,
                         add_weight: float = 3.0,
                         max_n: int = 1 << 20) -> int | None:
    """Smallest power-of-two n where one modeled Strassen multiply beats n³.

    The model's crossover point (chip_smoke.py prints the measured one next
    to it): scans doubling n until the Strassen MAC saving outweighs the add
    traffic. Monotone in `cutoff` — a larger cutoff defers the first split,
    so the crossover can only move right. None if no n ≤ max_n wins.
    """
    n = 2
    while n <= max_n:
        macs, adds = strassen_multiply_counts(n, cutoff)
        if macs * t_flop + add_weight * adds * t_elem < float(n) ** 3 * t_flop:
            return n
        n *= 2
    return None


def lu_cost(p: CostParams) -> dict[str, float]:
    """Lemma 4.2 evaluated per level (Liu et al. optimized variant)."""
    n, b, cores = p.n, p.b, p.cores
    bs = p.block_size
    m = p.levels
    c: dict[str, float] = {k: 0.0 for k in (
        "leafNode", "breakMat", "xy", "multiply", "subtract", "scalar",
        "additional")}

    # 9 O(bs^3) ops per leaf (2 LU + 4 tri-inv + 3 mult), b leaves (Eq. 14)
    t_leaf = p.t_flop if p.t_leaf is None else p.t_leaf
    c["leafNode"] = 9 * b * bs**3 * t_leaf

    for i in range(m):
        # LU recursion has 2^i - 1 -> use paper's note: 2^i nodes for SPIN,
        # ~2^i for LU at level i with the -1 correction.
        nodes = max(2**i - 1, 1) if i else 1
        gb = b // 2**i
        half = gb // 2
        blocks_lvl = gb * gb
        sub_n = n // 2**i
        c["breakMat"] += nodes * blocks_lvl * p.t_block_op / _pf(blocks_lvl, cores)
        c["xy"] += nodes * (4 * blocks_lvl * p.t_block_op / _pf(blocks_lvl, cores)
                            + 4 * (blocks_lvl // 4) * p.t_block_op
                            / _pf(blocks_lvl // 4, cores))
        # 7 multiplies inside the joint LU+inverse recursion + 4 inside getLU
        # bookkeeping ~ the paper's 12-multiplies-per-level characterization;
        # we charge 12 half-grid multiplies.
        gemm_flops = 12 * half**3 * bs**3
        c["multiply"] += nodes * gemm_flops * p.t_flop / _pf((sub_n / 2)**2, cores)
        c["subtract"] += nodes * (sub_n / 2)**2 * p.t_elem / _pf((sub_n / 2)**2, cores)
        c["scalar"] += nodes * 2 * (blocks_lvl // 4) * p.t_block_op / _pf(blocks_lvl // 4, cores)

    # Additional cost: 7 multiplies of dimension n/2 after decomposition
    c["additional"] = 7 * (n / 2)**3 * p.t_flop / _pf((n / 2)**2 / 4, cores)
    c["total"] = sum(c.values())
    return c


def spin_schedule(n: int, block_size: int) -> list[dict]:
    """Exact per-level (method, count, operand dims) trace of Algorithm 2.

    A benchmark can time each method alone at the exact shapes the
    recursion invokes it with.
    """
    b = n // block_size
    m = int(math.log2(b))
    out = []
    for i in range(m):
        nodes = 2**i
        gb = b // 2**i
        sub_n = n // 2**i
        out.append(dict(level=i, nodes=nodes, grid=gb, sub_n=sub_n,
                        multiplies=6, subtracts=2, scalar_muls=1,
                        splits=1, arranges=1))
    out.append(dict(level=m, nodes=b, grid=1, sub_n=block_size,
                    leaf_inversions=1))
    return out


# ---------------------------------------------------------------------------
# Coded-redundancy pricing (DESIGN.md §10): work overhead vs straggler risk
# ---------------------------------------------------------------------------


def coded_work_multiplier(workers: int, redundancy: int,
                          scheme: str = "vandermonde") -> float:
    """Per-worker work overhead of tolerating s of w lost/overdue workers.

    vandermonde (MDS erasure coding): each worker solves one coded panel of
    n/(w−s) columns instead of n/w → ×w/(w−s). replication: each worker
    solves its own shard plus s cyclic backups → ×(s+1). Erasure coding is
    strictly cheaper for s ≥ 1, which is why it is the default scheme; the
    decode is a k×k solve on the code dimension, negligible next to the
    panel solves it amortizes over.
    """
    if not 0 <= redundancy < workers:
        raise ValueError(
            f"redundancy must be in [0, workers), got s={redundancy} "
            f"w={workers}")
    if scheme == "vandermonde":
        return workers / (workers - redundancy)
    if scheme == "replication":
        return float(redundancy + 1)
    raise ValueError(f"unknown coding scheme {scheme!r}")


def _binom_tail(w: int, s: int, p: float) -> float:
    """P[X > s] for X ~ Binomial(w, p) — the chance the redundancy budget
    is exhausted and the run must wait on a straggler after all."""
    return sum(math.comb(w, i) * p ** i * (1 - p) ** (w - i)
               for i in range(s + 1, w + 1))


def coded_completion_cost(base_shard_s: float, workers: int, redundancy: int,
                          *, scheme: str = "vandermonde",
                          straggler_prob: float = 0.05,
                          straggler_slowdown: float = 10.0,
                          decode_s: float = 0.0) -> float:
    """Expected completion seconds of one coded fan-out.

    Each worker's shard takes base_shard_s × the scheme's work multiplier;
    when MORE than s of the w workers straggle (each independently with
    straggler_prob, running straggler_slowdown× slow), the quorum must wait
    on a straggler and the whole fan-out pays the slowdown. The model is
    deliberately coarse — a binomial tail times the slowdown — because its
    job is the planner's s decision, not wall-clock prediction.
    """
    work = base_shard_s * coded_work_multiplier(workers, redundancy, scheme)
    p_blocked = _binom_tail(workers, redundancy, straggler_prob)
    return work * (1.0 + (straggler_slowdown - 1.0) * p_blocked) + decode_s


def plan_redundancy(workers: int, *, straggler_prob: float = 0.05,
                    straggler_slowdown: float = 10.0,
                    scheme: str = "vandermonde",
                    max_redundancy: int | None = None) -> int:
    """The s minimizing expected completion — the planner's replication
    factor decision. s=0 when stragglers are free or absent; rises with
    straggler_prob/slowdown until the work multiplier overtakes the tail
    risk. Ties break toward smaller s (less redundant work)."""
    hi = workers - 1 if max_redundancy is None else min(max_redundancy,
                                                        workers - 1)
    return min(range(hi + 1),
               key=lambda s: (coded_completion_cost(
                   1.0, workers, s, scheme=scheme,
                   straggler_prob=straggler_prob,
                   straggler_slowdown=straggler_slowdown), s))


# ---------------------------------------------------------------------------
# Roofline model on the card: same decomposition, hardware terms
# ---------------------------------------------------------------------------

# One H100 SXM, NVIDIA's data sheet (dense rates, 700 W): `peak_flops` is
# the bf16/f16 tensor-core rate, the one the default 2-byte operands run
# at; pass {**H100_SXM, "peak_flops": H100_SXM["peak_flops_tf32"]} to price
# f32 products on the TF32 tensor cores (the port's 3xTF32 GEMM does three
# of them a product), or "peak_flops_f32" for the FFMA units. `ici_bw` is
# NVLink 4's 450 GB/s a direction between two cards; with one card the
# collective term is 0.
H100_SXM = dict(peak_flops=989e12, peak_flops_tf32=495e12,
                peak_flops_f32=67e12, hbm_bw=3.35e12, ici_bw=450e9)


def roofline_cost(n: int, b: int, chips: int, *, dtype_bytes: int = 2,
                  hw: dict = H100_SXM) -> dict[str, float]:
    """Three-term roofline for one SPIN inversion on `chips` cards.

    compute:   6 multiplies/level, 2·(gb/2)^3·bs^3 flops each (MAC=2 flops)
    memory:    operands+results of each level's multiplies through HBM
    collective:SUMMA ring moves each B panel (√P−1)/√P of total B bytes along
               the ring per multiply.
    """
    bs = n // b
    m = int(math.log2(b))
    flops = bytes_hbm = bytes_ici = 0.0
    side = max(1, int(math.isqrt(chips)))
    for i in range(m):
        nodes = 2**i
        half_n = n / 2**(i + 1)
        lvl_flops = nodes * 6 * 2 * half_n**3
        flops += lvl_flops
        bytes_hbm += nodes * 6 * 3 * half_n**2 * dtype_bytes
        bytes_ici += nodes * 6 * half_n**2 * dtype_bytes * (side - 1) / side
    flops += b * 2 * bs**3 / 3 * 2       # leaves (GJ ~ 2n^3/3 MACs)
    bytes_hbm += b * 2 * bs**2 * dtype_bytes
    t_compute = flops / (chips * hw["peak_flops"])
    t_memory = bytes_hbm / (chips * hw["hbm_bw"])
    t_collective = bytes_ici / (chips * hw["ici_bw"])
    return dict(flops=flops, bytes_hbm=bytes_hbm, bytes_ici=bytes_ici,
                t_compute=t_compute, t_memory=t_memory,
                t_collective=t_collective,
                total=max(t_compute, t_memory, t_collective),
                bottleneck=max(
                    ("compute", t_compute), ("memory", t_memory),
                    ("collective", t_collective), key=lambda kv: kv[1])[0])


def apply_inverse_cost(n: int, cols: int, chips: int, *,
                       dtype_bytes: int = 4, hw: dict = H100_SXM) -> float:
    """Roofline seconds for one served `apply_inverse` GEMM: X @ B with the
    resident (n, n) inverse stored at `dtype_bytes`/element and an (n, cols)
    RHS. Each request streams the whole inverse through HBM, so for serving
    column counts (cols ≪ n) the memory term dominates by orders of
    magnitude — which is exactly why a bf16-stored inverse halves the serve
    cost and the precision axis is worth a planner dimension.
    """
    flops = 2.0 * n * n * cols
    bytes_hbm = (n * n + 2.0 * n * cols) * dtype_bytes
    t_compute = flops / (chips * hw["peak_flops"])
    t_memory = bytes_hbm / (chips * hw["hbm_bw"])
    return float(max(t_compute, t_memory))


def fit_scale(model_fn: Callable[[CostParams], dict], measured: dict[int, float],
              n: int, cores: int) -> CostParams:
    """Least-squares fit of (t_flop, t_leaf, t_block_op, t_elem) to measured
    seconds. measured: {b: wall_seconds}. Returns calibrated CostParams."""
    def basis(b, **kw):
        defaults = dict(t_flop=0.0, t_leaf=0.0, t_block_op=0.0, t_elem=0.0)
        defaults.update(kw)
        return model_fn(CostParams(n=n, b=b, cores=cores, **defaults))["total"]

    rows, ys = [], []
    for b, secs in measured.items():
        rows.append([basis(b, t_flop=1.0), basis(b, t_leaf=1.0),
                     basis(b, t_block_op=1.0), basis(b, t_elem=1.0)])
        ys.append(secs)
    a = np.asarray(rows)
    y = np.asarray(ys)
    # non-negative least squares by exhaustive active set (4 columns):
    # clipping a plain lstsq solution is NOT the NNLS optimum and can
    # overshoot every point when columns are near-colinear.
    best_coef, best_res = np.zeros(4), float(np.sum(y ** 2))
    import itertools
    for k in range(1, 5):
        for cols in itertools.combinations(range(4), k):
            sub = a[:, cols]
            c, *_ = np.linalg.lstsq(sub, y, rcond=None)
            if np.any(c < 0):
                continue
            res = float(np.sum((sub @ c - y) ** 2))
            if res < best_res:
                best_res = res
                best_coef = np.zeros(4)
                best_coef[list(cols)] = c
    coef = best_coef
    return CostParams(n=n, b=max(measured), cores=cores,
                      t_flop=float(coef[0]), t_leaf=float(coef[1]),
                      t_block_op=float(coef[2]), t_elem=float(coef[3]))
