"""repro_torch.core — SPIN inversion, the inverse-free solve and the LU
baseline on PyTorch, with precision policies, the Newton–Schulz polish,
the Strassen engine and the cost model; the SMW update of a maintained
inverse and the sketched approximate inverse; checkpointed inversion and
block-matrix I/O in the JAX package's on-disk layout.

As in the JAX package, ``from repro_torch.core import multiply`` gives the
multiply FUNCTION; ``import repro_torch.core.multiply as m`` gives the
module.
"""

from .blockmatrix import BlockMatrix, OpCounts, count_ops, current_counts
from .multiply import multiply, multiply_engine, current_engine, validate_engine
from .precision import PrecisionPolicy, PRECISION_PRESETS, resolve_precision
from .strassen import strassen_cutoff, strassen_matmul, strassen_matmul_blocks
from .spin import (spin_inverse, spin_inverse_dense, spin_inverse_sharded,
                   leaf_inverse, LEAF_SOLVERS)
from .lu_inverse import lu_inverse, lu_inverse_dense, block_lu
from .solve import (spin_solve, spin_solve_dense, spin_solve_sharded,
                    spin_inverse_batched,
                    solve_grid_for, SketchedInverse, sketched_approx_inverse)
from .newton_schulz import newton_schulz_polish, residual_norm
from .solver_ckpt import CheckpointedSpin
from .matrix_io import load_blockmatrix, save_blockmatrix
from .update import (smw_update_inverse, smw_update_solve,
                     block_update_factors, apply_inverse, add_low_rank,
                     DriftTracker, estimate_inverse_residual)
from .verify import solve_residual
from . import costmodel, testing, verify

__all__ = [
    "BlockMatrix", "OpCounts", "count_ops", "current_counts",
    "multiply", "multiply_engine", "current_engine", "validate_engine",
    "PrecisionPolicy", "PRECISION_PRESETS", "resolve_precision",
    "strassen_cutoff", "strassen_matmul", "strassen_matmul_blocks",
    "spin_inverse", "spin_inverse_dense", "spin_inverse_sharded",
    "leaf_inverse", "LEAF_SOLVERS",
    "lu_inverse", "lu_inverse_dense", "block_lu",
    "spin_solve", "spin_solve_dense", "spin_solve_sharded",
    "spin_inverse_batched",
    "solve_grid_for", "solve_residual",
    "SketchedInverse", "sketched_approx_inverse",
    "newton_schulz_polish", "residual_norm", "CheckpointedSpin",
    "load_blockmatrix", "save_blockmatrix",
    "smw_update_inverse", "smw_update_solve", "block_update_factors",
    "apply_inverse", "add_low_rank", "DriftTracker",
    "estimate_inverse_residual",
    "costmodel", "testing", "verify",
]
