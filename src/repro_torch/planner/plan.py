"""Plan and problem-signature types for the SPIN autotuner.

A *plan* is everything `spin_inverse`/`spin_solve` need beyond the operands:
the block grid (the paper's `b`, stored as `block_size = n/b`), the leaf
solver, the multiply engine, the compute dtype, an optional Newton–Schulz
refinement stage and the store dtype. A *problem signature* is the key the
plan is selected (and cached) under: (kind, n, dtype, backend,
device_count, cores), everything the U-curve of paper Fig. 3 depends on.
Plans are frozen dataclasses, so they round-trip through the JSON plan
cache; their fields and cache keys read as the JAX package's do, with the
``cuda`` leaf and engine where that package has ``pallas``.

The backend is the device the call runs on: "cuda" or "cpu". `mesh` is
the ambient mesh's topology ("data2:model2", "" for none) and
`device_count` counts its DISTINCT devices: a 2×2 mesh of one card is one
device, so the cost model promises no speed-up one card cannot give,
while the key still tells the topologies apart. The sharded placement
(`placement="sharded"`) plans the mesh-resident recursion.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..core.precision import PrecisionPolicy, _dtype_name
from ..core.spin import LEAF_SOLVERS

__all__ = ["Plan", "ProblemSignature", "signature_for", "enumerate_plans",
           "candidate_grids", "default_backend", "mesh_descriptor",
           "STRASSEN_MIN_N",
           "STRASSEN_MIN_N_CUDA", "BACKENDS"]

BACKENDS = ("cuda", "cpu")

# Smallest problem dimension at which the Strassen engine enters the
# default candidate space of a CPU signature: below it every sub-multiply
# of the recursion sits at or below the Strassen cutoff (512), so a
# strassen plan would run the classical program. The JAX package's value.
STRASSEN_MIN_N = 2048

# The same threshold on the card, from its measured crossover (PERF.md §6,
# PR 17; NVIDIA H100 80GB HBM3, 700 W): one Strassen split of an n³
# product loses to one GEMM launch at n = 8192, ties at 16384 and wins by
# 12 % at 32768.
STRASSEN_MIN_N_CUDA = 32768


def default_backend() -> str:
    """The backend of the port's default device: "cuda" where the card is."""
    return "cuda" if torch.cuda.is_available() else "cpu"


@dataclasses.dataclass(frozen=True)
class ProblemSignature:
    """Everything plan selection may depend on. `key()` is the cache key."""

    kind: str            # "inverse" | "solve"
    n: int               # matrix dimension
    dtype: str           # dtype name ("float32", "bfloat16", ...)
    backend: str         # "cuda" | "cpu"
    device_count: int    # distinct devices of the mesh (paper's workers)
    cores: int           # parallel lanes for the §4 cost model's PF terms
    mesh: str = ""       # ambient mesh topology ("data2:model2", "" = none)
    placement: str = "dense"  # engine placement: "dense" | "sharded"
    update_rank: int = 0  # accumulated SMW churn the plan is priced under
    precision: str = ""  # PrecisionPolicy.descriptor() ("" = exact default)
    constraint: str = ""  # e.g. "block_sizes=64" when the grid is pre-fixed

    def key(self) -> str:
        base = (f"{self.kind}/n{self.n}/{self.dtype}/{self.backend}"
                f"/d{self.device_count}/c{self.cores}"
                f"/m{self.mesh or 'none'}/{self.placement}")
        # The churn and precision axes are appended only when set, so the
        # keys of offline exact problems stay short.
        if self.update_rank:
            base += f"/u{self.update_rank}"
        if self.precision:
            base += f"/p{self.precision}"
        return f"{base}/{self.constraint}" if self.constraint else base

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def mesh_descriptor() -> str:
    """The ambient mesh's topology, e.g. "data2:model2" ("" = none)."""
    from ..launch.mesh import current_mesh

    mesh = current_mesh()
    return mesh.descriptor() if mesh is not None else ""


def _mesh_device_count() -> int:
    from ..launch.mesh import current_mesh

    mesh = current_mesh()
    return len(mesh.distinct_devices) if mesh is not None else 1


def signature_for(kind: str, n: int, dtype=torch.float32, *,
                  backend: str | None = None,
                  device_count: int | None = None,
                  cores: int | None = None,
                  mesh: str | None = None,
                  placement: str = "dense",
                  update_rank: int = 0,
                  precision: str = "",
                  constraint: str = "") -> ProblemSignature:
    """The signature of one problem on `backend` (default: the card where
    there is one, else the CPU).

    `device_count` defaults to the distinct devices of the ambient mesh
    (1 without one) and `mesh` to its topology. `cores` feeds the cost
    model's parallelization-factor terms: on the CPU the host's threads run
    block products side by side, so it defaults to os.cpu_count() (at
    least the device count); on the card it is the device count, and the
    card's own parallelism lives in its constants.
    """
    backend = backend or default_backend()
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of {BACKENDS}")
    if placement not in ("dense", "sharded"):
        raise ValueError(f"unknown placement {placement!r}")
    if update_rank < 0:
        raise ValueError(f"update_rank must be >= 0, got {update_rank}")
    device_count = device_count or _mesh_device_count()
    if cores is None:
        cores = (max(os.cpu_count() or 1, device_count) if backend == "cpu"
                 else device_count)
    if mesh is None:
        mesh = mesh_descriptor()
    return ProblemSignature(kind=kind, n=int(n), dtype=_dtype_name(dtype),
                            backend=backend, device_count=int(device_count),
                            cores=int(cores), mesh=mesh, placement=placement,
                            update_rank=int(update_rank),
                            precision=precision, constraint=constraint)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One executable configuration of the SPIN recursion."""

    block_size: int              # paper's n/b; grid b = n // block_size
    leaf_solver: str = "linalg"
    multiply_engine: str = "einsum"   # one of core.multiply.ENGINES
    compute_dtype: str = "float32"    # dtype the recursion runs in
    refine_sweeps: int = 0            # Newton–Schulz polish sweeps afterwards
    store_dtype: str = ""             # result storage dtype ("" = operand's)
    # provenance, not part of plan identity for execution purposes
    predicted_s: float | None = None  # cost-model score (seconds)
    measured_s: float | None = None   # microbenchmark wall-clock (seconds)
    source: str = "costmodel"         # "costmodel" | "measured"

    def grid(self, n: int) -> int:
        return n // self.block_size

    def execution_key(self) -> tuple:
        """Identity of *what runs* (provenance fields excluded)."""
        return (self.block_size, self.leaf_solver, self.multiply_engine,
                self.compute_dtype, self.refine_sweeps, self.store_dtype)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Plan":
        """A plan from its dict; keys it does not have (the JAX package's
        mesh axes) are dropped."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def candidate_grids(n: int, *, min_block: int = 8, max_grid: int = 64
                    ) -> list[int]:
    """Power-of-two grids b with n % b == 0 and n/b >= min_block.

    b=1 (a single-leaf direct inversion) is always a candidate: it is the
    left end of the paper's U-curve and the right answer for small n.
    """
    grids, b = [], 1
    while b <= max_grid and n % b == 0 and n // b >= min_block:
        grids.append(b)
        b *= 2
    return grids or [1]


def _default_engines(sig: ProblemSignature) -> tuple[str, ...]:
    # The kernel engine only where its kernels run (the card), first, so that
    # the multiply-free b = 1 plan names it; the SUMMA engines only for the
    # sharded placement under a mesh; Strassen only from the backend's
    # crossover.
    if sig.backend == "cuda":
        engines = ("cuda", "einsum")
        strassen_min = STRASSEN_MIN_N_CUDA
    else:
        engines = ("einsum",)
        strassen_min = STRASSEN_MIN_N
    if sig.placement == "sharded" and sig.mesh:
        engines = engines + ("allgather", "ring")
    return engines + (("strassen",) if sig.n >= strassen_min else ())


def enumerate_plans(sig: ProblemSignature, *,
                    min_block: int = 8,
                    max_grid: int = 64,
                    leaf_solvers: tuple[str, ...] | None = None,
                    engines: tuple[str, ...] | None = None,
                    include_refinement: bool | None = None,
                    block_sizes: tuple[int, ...] | None = None
                    ) -> list[Plan]:
    """The raw candidate space for `sig` (unscored, deduplicated).

    Refinement variants (a bf16 recursion, then a Newton–Schulz polish back
    to f32) are enumerated by default only for f32 inversions on the card,
    where bf16 runs on the tensor cores; on the CPU bf16 is emulated and
    never wins. Newton–Schulz polishes an inverse, so solve signatures
    never get one, and neither does the sharded placement: the mesh
    recursion has no refinement stage. The ``cuda`` engine is enumerated
    only on a CUDA signature, ``allgather`` and ``ring`` only for a sharded
    signature under a mesh, and ``strassen`` only from the backend's
    crossover (`STRASSEN_MIN_N`, `STRASSEN_MIN_N_CUDA`); pass `engines=`
    to opt in anywhere.
    """
    if leaf_solvers is None:
        leaf_solvers = tuple(LEAF_SOLVERS)
    if engines is None:
        engines = _default_engines(sig)
    if include_refinement is None:
        include_refinement = sig.backend == "cuda" and sig.dtype == "float32"
    include_refinement = (include_refinement and sig.kind == "inverse"
                          and sig.placement != "sharded")

    if block_sizes is not None:
        grids = sorted({sig.n // bs for bs in block_sizes if sig.n % bs == 0})
    else:
        grids = candidate_grids(sig.n, min_block=min_block, max_grid=max_grid)

    plans: list[Plan] = []
    for b in grids:
        bs = sig.n // b
        # b == 1 runs no multiply: the engine is irrelevant.
        for engine in (engines if b > 1 else engines[:1]):
            for leaf in leaf_solvers:
                plans.append(Plan(block_size=bs, leaf_solver=leaf,
                                  multiply_engine=engine,
                                  compute_dtype=sig.dtype))
                if include_refinement and b > 1:
                    plans.append(Plan(block_size=bs, leaf_solver=leaf,
                                      multiply_engine=engine,
                                      compute_dtype="bfloat16",
                                      refine_sweeps=2))
    return _store_dtype_variants(sig, plans)


def _store_dtype_variants(sig: ProblemSignature, plans: list[Plan]
                          ) -> list[Plan]:
    """Expand candidates along the precision axis (`sig.precision`).

    An exact signature passes through untouched. A pinned policy (e.g. the
    "bf16" preset) rewrites every candidate to store at the pinned dtype.
    An `auto_store` policy prices both the exact and the low-precision
    store of each candidate and lets `predict_cost`'s serving term decide.
    Solve and sharded signatures keep exact storage: there is no
    maintained low-precision operand in either.
    """
    if not sig.precision or sig.kind != "inverse" or sig.placement == "sharded":
        return plans
    policy = PrecisionPolicy.from_descriptor(sig.precision)
    out: list[Plan] = []
    for p in plans:
        for store in policy.candidate_store_dtypes(sig.dtype):
            out.append(p if store == sig.dtype
                       else dataclasses.replace(p, store_dtype=store))
    return out
