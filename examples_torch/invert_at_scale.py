"""Distributed SPIN on a 4x4 mesh, plus the roofline projection for a
production-scale inversion.

The PyTorch twin of examples/invert_at_scale.py, on the port
(`repro_torch`). The reference lays its recursion over 16 fake XLA host
devices; here the (data 4, model 4) mesh repeats the one device 16 times
(`make_worker_mesh((4, 4), devices=[device] * 16)`), so every copy the
layout implies is paid on that device. The engines are the port's:
`allgather` and `ring` (SUMMA), `cuda` (the hand-written GEMM on each
shard), `einsum` and `strassen`.

    PYTHONPATH=src python examples_torch/invert_at_scale.py --n 2048 --block 128
    PYTHONPATH=src python examples_torch/invert_at_scale.py --device cpu \\
        --n 256 --block 64 --engine ring

Differences from examples/invert_at_scale.py:
- `--device` (default cuda); without a card it raises unless `--device cpu`
  is given. The mesh repeats that one device; no fake XLA devices.
- `--engine` takes `repro_torch.core.multiply.ENGINES`; the reference's
  `pallas` is read as the port's `cuda` (`bridge.port_name`).
- The matrix is `repro_torch.core.testing.make_spd` with numpy's
  `default_rng(0)`, not `jax.random.PRNGKey(0)`. `main(inputs={"a": array})`
  takes the matrix instead.
- The dense path runs `spin_inverse` eagerly under the ambient mesh and
  engine: each product lays its operands out on the mesh and gathers the
  result (the reference jit-compiles one program over pre-sharded blocks).
  `--sharded` lays the blocks out once (`ShardedBlockMatrix`) and runs
  `inverse_program` on them. The first call is a warm-up, as the
  reference's compile; the timed call ends with a device synchronize.
- The roofline is `repro_torch.core.costmodel.roofline_cost` on one H100
  SXM's data-sheet rates a card (`H100_SXM`, NVLink between cards), where
  the reference prices a TPU pod (`tpu_roofline_cost`): the same flops and
  bytes, other hardware. Its lines say so.
- `main(argv)` returns the printed numbers as a dict, with the inverse
  under "inverse" (dense, on the mesh's first device).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.core import BlockMatrix, multiply_engine, spin_inverse, testing
from repro_torch.core.costmodel import roofline_cost
from repro_torch.core.multiply import ENGINES
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_worker_mesh, set_mesh
from repro_torch.parallel import ShardedBlockMatrix, inverse_program
from repro_torch.planner import get_plan


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, *, inputs=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--block", type=int, default=None,
                    help="block size override (default: planner auto-tunes)")
    ap.add_argument("--engine", default=None, type=bridge.port_name,
                    choices=list(ENGINES),
                    help="multiply engine override (default: planner); "
                         "'cuda' is the hand-written GEMM on each shard "
                         "(its plain version on the CPU; the reference's "
                         "'pallas'), 'strassen' the recursive 7-multiply "
                         "engine")
    ap.add_argument("--sharded", action="store_true",
                    help="mesh-resident recursion (inverse_program): "
                         "every level's quadrants stay laid out over the "
                         "mesh, no inter-level gathers")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the mesh repeats it")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    mesh = make_worker_mesh((4, 4), ("data", "model"), devices=[dev] * 16)
    path = "sharded" if args.sharded else "dense"
    out = {"n": args.n, "mesh": dict(mesh.shape), "path": path}
    # Plan INSIDE the mesh context: the signature then carries the mesh
    # topology, so the candidate space includes the mesh engines and the
    # cached plan is keyed to this (4, 4) mesh and never recalled for
    # another.
    if args.block is None or args.engine is None:
        with set_mesh(mesh):
            plan = get_plan("inverse", args.n, torch.float32, placement=path,
                            backend=dev.type)
        block = args.block or plan.block_size
        engine = args.engine or plan.multiply_engine
        print(f"planner [{plan.source}]: block={plan.block_size} "
              f"engine={plan.multiply_engine} leaf={plan.leaf_solver}")
        out["plan"] = plan.to_dict()
    else:
        block, engine = args.block, args.engine
    if inputs is None:
        a = testing.make_spd(args.n, np.random.default_rng(0), device=dev)
    else:
        a = bridge.to_torch(inputs["a"], dev)
    if tuple(a.shape) != (args.n, args.n):
        raise ValueError(f"inputs['a'] is {tuple(a.shape)}, --n is {args.n}")
    A = BlockMatrix.from_dense(a, block)
    print(f"n={args.n} grid={A.grid}x{A.grid} on mesh {dict(mesh.shape)} "
          f"engine={engine} path={path}")

    with set_mesh(mesh), multiply_engine(engine):
        if args.sharded:
            # laid out once; quadrants stay mesh-resident per level
            blocks = ShardedBlockMatrix.from_blockmatrix(A)
            f = lambda: inverse_program(blocks, engine=engine)  # noqa: E731
        else:
            f = lambda: spin_inverse(A)  # noqa: E731
        f()                                   # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        inv = f()
        _sync(dev)
        dt = time.perf_counter() - t0
    inv = inv.to_dense()
    eye = torch.eye(args.n, dtype=a.dtype, device=dev)
    resid = float(torch.linalg.norm(inv @ a - eye) / args.n ** 0.5)
    print(f"inverted in {dt * 1e3:.0f} ms  residual {resid:.2e}")

    # what this would cost on a cluster of H100s (roofline projection)
    rooflines = []
    for n, b, chips in [(2 ** 17, 16, 256), (2 ** 18, 16, 256)]:
        r = roofline_cost(n=n, b=b, chips=chips)
        print(f"roofline (H100 SXM, not a TPU) n={n} b={b} chips={chips}: "
              f"compute {r['t_compute'] * 1e3:.1f} ms, "
              f"memory {r['t_memory'] * 1e3:.1f} ms, "
              f"collective {r['t_collective'] * 1e3:.1f} ms "
              f"-> bound: {r['bottleneck']}")
        rooflines.append({"n": n, "b": b, "chips": chips, **r})
    out.update(block=block, engine=engine, grid=A.grid, ms=dt * 1e3, residual=resid,
               rooflines=rooflines, inverse=inv)
    return out


if __name__ == "__main__":
    main()
