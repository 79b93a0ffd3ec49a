"""Quickstart: invert a matrix with SPIN, check accuracy, count the ops.

The PyTorch twin of examples/quickstart.py, on the port (`repro_torch`).
By default the planner (repro_torch.planner) picks the block grid and leaf
solver from the paper's §4 cost model, with the device's fitted constants,
refined by a short microbenchmark on small problems; pass --block to
override it by hand.

    PYTHONPATH=src python examples_torch/quickstart.py [--n 1024] [--block 128]
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu --n 256

Differences from examples/quickstart.py:
- `--device` (default cuda); without a card it raises unless `--device cpu`
  is given, which runs the kernels' plain PyTorch versions.
- The matrix is `repro_torch.core.testing.make_spd` with numpy's
  `default_rng(0)`, not `jax.random.PRNGKey(0)`: the same distribution,
  other bits. `main(inputs={"a": array})` takes the matrix instead.
- As in the reference the products take the ambient `multiply_engine`
  (einsum unless the caller sets one); the plan's engine is printed, not
  applied.
- The first call's time includes the CUDA kernels' build on first use
  where the reference's includes the compile; each timed call ends with a
  device synchronize in place of `block_until_ready`.
- `main(argv)` returns the printed numbers as a dict, with the inverse
  under "inverse".
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.core import (BlockMatrix, count_ops, lu_inverse_dense,
                              newton_schulz_polish, residual_norm, spin_inverse,
                              spin_inverse_dense, testing)
from repro_torch.device import resolve_device
from repro_torch.planner import get_plan


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, *, inputs=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--block", type=int, default=None,
                    help="block size override (default: planner auto-tunes)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if inputs is None:
        a = testing.make_spd(args.n, np.random.default_rng(0), device=dev)
    else:
        a = bridge.to_torch(inputs["a"], dev)
    if tuple(a.shape) != (args.n, args.n):
        raise ValueError(f"inputs['a'] is {tuple(a.shape)}, --n is {args.n}")

    out = {"n": args.n}
    if args.block is None:
        plan = get_plan("inverse", args.n, a.dtype, backend=dev.type)
        block, leaf = plan.block_size, plan.leaf_solver
        print(f"planner [{plan.source}]: block={block} "
              f"(grid {args.n // block}x{args.n // block}) leaf={leaf} "
              f"engine={plan.multiply_engine}")
        out["plan"] = plan.to_dict()
    else:
        block, leaf = args.block, "linalg"
        print(f"explicit override: block={block} "
              f"(grid {args.n // block}x{args.n // block})")
    print(f"SPD test matrix n={args.n}, block={block}")
    out.update(block=block, leaf=leaf)

    # --- SPIN (the paper's algorithm) -------------------------------------
    t0 = time.perf_counter()
    inv = spin_inverse_dense(a, block, leaf, device=dev)
    _sync(dev)
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    inv = spin_inverse_dense(a, block, leaf, device=dev)
    _sync(dev)
    t_spin = time.perf_counter() - t0
    eye = torch.eye(args.n, dtype=a.dtype, device=dev)
    resid = float(torch.linalg.norm(inv @ a - eye) / args.n ** 0.5)
    print(f"SPIN:  {t_spin * 1e3:8.1f} ms   ||AX-I||/sqrt(n) = {resid:.2e} "
          f"(first call incl. kernel build: {t_compile * 1e3:.0f} ms)")

    # --- LU baseline (Liu et al., the paper's comparison) ------------------
    lu_inverse_dense(a, block, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    lu_inverse_dense(a, block, device=dev)
    _sync(dev)
    t_lu = time.perf_counter() - t0
    print(f"LU:    {t_lu * 1e3:8.1f} ms   -> SPIN speedup {t_lu / t_spin:.2f}x")

    # --- op accounting (the paper's Table 1 claim) -------------------------
    A = BlockMatrix.from_dense(a, block)
    with count_ops() as spin_ops:
        x = spin_inverse(A)
    print(f"SPIN distributed multiplies: {spin_ops.multiplies} "
          f"(6 per recursion node), leaf inversions: {spin_ops.leaf_inversions}")

    # --- optional Newton–Schulz polish -------------------------------------
    polished = newton_schulz_polish(A, x, sweeps=1)
    polished_resid = float(residual_norm(A, polished))
    print(f"residual after 1 Newton–Schulz sweep: {polished_resid:.2e}")

    out.update(spin_ms=t_spin * 1e3, first_call_ms=t_compile * 1e3, residual=resid,
               lu_ms=t_lu * 1e3, speedup=t_lu / t_spin,
               multiplies=spin_ops.multiplies,
               leaf_inversions=spin_ops.leaf_inversions,
               polished_residual=polished_resid, inverse=inv)
    return out


if __name__ == "__main__":
    main()
