"""Application example: distributed ridge regression via SPIN.

The PyTorch twin of examples/ridge_regression.py, on the port
(`repro_torch`). Ridge regression is the canonical inversion workload:
w = (XᵀX + λI)⁻¹ Xᵀ y. The Gram matrix is assembled as a BlockMatrix and
the normal equations are SOLVED with `spin_solve`, the inverse-free path
through the paper's recursion. `--multi-target` demonstrates the multi-RHS
case (one solve for many regression targets), and `--inverse` keeps the
invert-then-multiply path (with one Newton–Schulz sweep) for comparison.
The block grid is autotuned by the planner unless --block overrides it.

    PYTHONPATH=src python examples_torch/ridge_regression.py --features 1024
    PYTHONPATH=src python examples_torch/ridge_regression.py --device cpu \\
        --samples 1024 --features 256

Differences from examples/ridge_regression.py:
- `--device` (default cuda); without a card it raises unless `--device cpu`
  is given, which runs the kernels' plain PyTorch versions.
- X, w* and the noise are drawn with numpy's `default_rng(0)` in that
  order (X scaled on the device), not from `jax.random.split(PRNGKey(0),
  3)`: the same distributions, other bits. `main(inputs={"x": ...,
  "w_true": ..., "noise": ...})` takes them instead (x already scaled by
  1/sqrt(features)).
- XᵀX and Xᵀy are plain `torch.matmul` products, as the reference's are
  plain XLA products outside any kernel; the recursion's products take the
  ambient `multiply_engine`, as in the reference.
- The solve's time starts and ends with a device synchronize (the
  reference's ends with `block_until_ready`).
- `main(argv)` returns the printed numbers as a dict, with the solution
  under "w_hat".
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.core import (BlockMatrix, newton_schulz_polish, spin_inverse,
                              spin_solve)
from repro_torch.device import resolve_device
from repro_torch.planner import get_plan


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, *, inputs=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--features", type=int, default=1024)
    ap.add_argument("--block", type=int, default=None,
                    help="block size override (default: planner auto-tunes)")
    ap.add_argument("--lam", type=float, default=1e-2)
    ap.add_argument("--multi-target", type=int, default=1,
                    help="number of regression targets (multi-RHS solve)")
    ap.add_argument("--inverse", action="store_true",
                    help="materialize A^-1 then multiply (original path)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    shape_x = (args.samples, args.features)
    shape_w = (args.features, args.multi_target)
    shape_y = (args.samples, args.multi_target)
    if inputs is None:
        rng = np.random.default_rng(0)
        x = bridge.to_torch(rng.standard_normal(shape_x, dtype=np.float32), dev) / \
            args.features ** 0.5
        w_true = bridge.to_torch(rng.standard_normal(shape_w, dtype=np.float32), dev)
        noise = bridge.to_torch(rng.standard_normal(shape_y, dtype=np.float32), dev)
    else:
        x, w_true, noise = (bridge.to_torch(inputs[k], dev)
                            for k in ("x", "w_true", "noise"))
    if (tuple(x.shape), tuple(w_true.shape), tuple(noise.shape)) != (shape_x, shape_w,
                                                                      shape_y):
        raise ValueError(f"inputs {tuple(x.shape)}, {tuple(w_true.shape)}, "
                         f"{tuple(noise.shape)} do not fit the arguments")
    y = x @ w_true + 0.01 * noise

    gram = x.T @ x + args.lam * torch.eye(args.features, device=dev)
    rhs = x.T @ y                                  # (features, targets)

    out = {"samples": args.samples, "features": args.features,
           "targets": args.multi_target}
    if args.block is None:
        kind = "inverse" if args.inverse else "solve"
        plan = get_plan(kind, args.features, gram.dtype, backend=dev.type)
        block = plan.block_size
        print(f"planner [{plan.source}]: block={block} "
              f"(grid {args.features // block}) leaf={plan.leaf_solver}")
        out["plan"] = plan.to_dict()
    else:
        block = args.block

    _sync(dev)
    t0 = time.perf_counter()
    a = BlockMatrix.from_dense(gram, block)
    if args.inverse:
        inv = spin_inverse(a)
        inv = newton_schulz_polish(a, inv, sweeps=1)
        w_hat = inv.to_dense() @ rhs
    else:
        w_hat = spin_solve(a, rhs)
    _sync(dev)
    dt = time.perf_counter() - t0

    rel = float(torch.linalg.norm(w_hat - w_true) / torch.linalg.norm(w_true))
    resid = float(torch.linalg.norm(gram @ w_hat - rhs) / torch.linalg.norm(rhs))
    mode = "inverse+NS" if args.inverse else "spin_solve"
    print(f"ridge {args.samples}x{args.features} "
          f"targets={args.multi_target} [{mode}]: solved in {dt * 1e3:.0f} ms"
          f"  ||w-w*||/||w*||={rel:.2e}  normal-eq residual={resid:.2e}")
    assert resid < 1e-3
    out.update(block=block, mode=mode, ms=dt * 1e3, rel=rel, residual=resid,
               w_hat=w_hat)
    return out


if __name__ == "__main__":
    main()
