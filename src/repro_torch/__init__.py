"""repro_torch — SPIN block-recursive matrix inversion on PyTorch and CUDA.

The PyTorch port of the JAX package `repro`, built for an NVIDIA H100
(sm_90a). It carries inversion, `spin_inverse_dense` (paper Algorithm 2),
the LU baseline, and the inverse-free multi-RHS solve `spin_solve_dense`,
with the multiplies, Schur updates, leaf inversions and triangular solves
in hand-written CUDA kernels (`repro_torch.kernels`). The entry points take
a precision policy (``precision="bf16"``: a bf16 recursion, then an f32
Newton–Schulz polish) and the ``strassen`` multiply engine; `core.costmodel`
prices both. On the language-model
side it serves the dense family: `configs` (`get_arch`), `models`
(`transformer.init_params`, `forward`, `prefill`, `init_cache`,
`decode_step`), `serving.ServingEngine` and `launch.serve`, with the
prefill's attention in a hand-written flash attention kernel.
Entry points run on the card by default and raise when it is missing;
pass ``device="cpu"`` to run the kernels' plain PyTorch versions instead.
"""

from .device import resolve_device
from .core import (BlockMatrix, OpCounts, PRECISION_PRESETS, PrecisionPolicy,
                   count_ops, lu_inverse_dense, multiply_engine,
                   resolve_precision, spin_inverse, spin_inverse_dense,
                   spin_solve, spin_solve_dense)

__all__ = ["resolve_device", "BlockMatrix", "OpCounts", "count_ops",
           "multiply_engine", "spin_inverse", "spin_inverse_dense",
           "lu_inverse_dense", "spin_solve", "spin_solve_dense",
           "PrecisionPolicy", "PRECISION_PRESETS", "resolve_precision"]
