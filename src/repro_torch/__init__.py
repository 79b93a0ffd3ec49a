"""repro_torch — SPIN block-recursive matrix inversion on PyTorch and CUDA.

The PyTorch port of the JAX package `repro`, built for an NVIDIA H100
(sm_90a). It carries inversion, `spin_inverse_dense` (paper Algorithm 2),
the LU baseline, and the inverse-free multi-RHS solve `spin_solve_dense`,
with the multiplies, Schur updates, leaf inversions and triangular solves
in hand-written CUDA kernels (`repro_torch.kernels`). The entry points take
a precision policy (``precision="bf16"``: a bf16 recursion, then an f32
Newton–Schulz polish) and the ``strassen`` multiply engine; `core.costmodel`
prices both. Without a block size (or with ``auto=True``) they ask the
planner (`repro_torch.planner`), which picks block size, leaf solver and
engine from the paper's cost model with the card's fitted constants and
keeps its plans in a file of its own. A maintained inverse takes low-rank
changes through the SMW update (`core.update`), a degraded-mode answer
comes from the sketched inverse, and long inversions checkpoint and resume
(`core.solver_ckpt`, `core.matrix_io`, in the JAX package's on-disk
layout). On the language-model
side it serves the dense family: `configs` (`get_arch`), `models`
(`transformer.init_params`, `forward`, `prefill`, `init_cache`,
`decode_step`), `serving.ServingEngine` and `launch.serve`, with the
prefill's attention in a hand-written flash attention kernel.
Entry points run on the card by default and raise when it is missing;
pass ``device="cpu"`` to run the kernels' plain PyTorch versions instead.
"""

from .device import resolve_device
from .core import (BlockMatrix, CheckpointedSpin, DriftTracker, OpCounts,
                   PRECISION_PRESETS, PrecisionPolicy, SketchedInverse,
                   add_low_rank, apply_inverse, block_update_factors,
                   count_ops, estimate_inverse_residual, load_blockmatrix,
                   lu_inverse_dense, multiply_engine, resolve_precision,
                   save_blockmatrix, sketched_approx_inverse,
                   smw_update_inverse, smw_update_solve, spin_inverse,
                   spin_inverse_dense, spin_solve, spin_solve_dense)

__all__ = ["resolve_device", "BlockMatrix", "OpCounts", "count_ops",
           "multiply_engine", "spin_inverse", "spin_inverse_dense",
           "lu_inverse_dense", "spin_solve", "spin_solve_dense",
           "PrecisionPolicy", "PRECISION_PRESETS", "resolve_precision",
           "smw_update_inverse", "smw_update_solve", "apply_inverse",
           "add_low_rank", "block_update_factors", "DriftTracker",
           "estimate_inverse_residual", "SketchedInverse",
           "sketched_approx_inverse", "CheckpointedSpin",
           "save_blockmatrix", "load_blockmatrix"]
