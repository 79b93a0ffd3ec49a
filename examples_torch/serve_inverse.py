"""Online inverse serving demo: a mutating ridge-regression workload.

The PyTorch twin of examples/serve_inverse.py, on the port
(`repro_torch`). The ridge normal equations w = (XᵀX + λI)⁻¹ Xᵀy are the
paper's canonical workload (examples_torch/ridge_regression.py solves them
ONCE). In production the design matrix keeps growing: every new minibatch
of k samples Xₖ is a rank-k SPD update of the Gram matrix, G ← G + XₖᵀXₖ,
exactly the churn `serving.SpinService` maintains. This demo drives the
service with an interleaved stream of solve requests (fresh regression
targets) and rank-k Gram updates (arriving samples), and reports the
request throughput plus how the refactor policy split the updates between
O(n²k) SMW folds and planned re-factorizations.

    PYTHONPATH=src python examples_torch/serve_inverse.py --features 512 \\
        --requests 32 --update-rank 8
    PYTHONPATH=src python examples_torch/serve_inverse.py --device cpu \\
        --samples 512 --features 128 --requests 8 --block 32

--sharded serves from a mesh-resident `ShardedBlockMatrix` pair (the
matrix AND its maintained inverse stay laid out over a 4×2 mesh). The
token-serving analogue of this loop is examples_torch/serve.py.

Differences from examples/serve_inverse.py:
- `--device` (default cuda); without a card it raises unless `--device cpu`
  is given. The service holds its state there (`SpinService(device=...)`).
- `--sharded` lays the (data 4, model 2) mesh over that one device,
  repeated 8 times (`make_worker_mesh((4, 2), devices=[device] * 8)`). The
  reference takes 8 XLA devices and falls back to a (1, 1) mesh when it
  has fewer; this twin always has the 8 coordinates.
- X, w* and then each request's noise and each update's Xₖ are drawn with
  numpy's `default_rng(0)`, all before the stream starts, not from
  `jax.random` keys: the same distributions, other bits.
  `main(inputs={"x": ..., "w_true": ..., "noise": (requests, samples),
  "xk": (updates, rank, n)})` takes them instead (x scaled by 1/sqrt(n),
  each xk too).
- The stream's time starts and ends with a device synchronize (the
  reference's ends with `block_until_ready` on each answer).
- `main(argv)` returns the printed numbers as a dict, with the probe's
  solution under "w_hat".
"""

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.device import resolve_device
from repro_torch.serving import SpinService


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, *, inputs=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--features", type=int, default=512)
    ap.add_argument("--lam", type=float, default=1e-2)
    ap.add_argument("--requests", type=int, default=32,
                    help="number of solve requests to stream")
    ap.add_argument("--update-rank", type=int, default=8,
                    help="samples per arriving minibatch (Gram update rank)")
    ap.add_argument("--update-every", type=int, default=4,
                    help="one Gram update per this many solve requests")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--block", type=int, default=None,
                    help="block size override (default: planner auto-tunes)")
    ap.add_argument("--sharded", action="store_true",
                    help="mesh-resident service state (ShardedBlockMatrix)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n = args.features
    n_updates = args.requests // args.update_every if args.update_every else 0
    shapes = {"x": (args.samples, n), "w_true": (n,),
              "noise": (args.requests, args.samples),
              "xk": (n_updates, args.update_rank, n)}
    if inputs is None:
        rng = np.random.default_rng(0)
        draws = {k: bridge.to_torch(rng.standard_normal(s, dtype=np.float32), dev)
                 for k, s in shapes.items()}
        draws["x"] /= n ** 0.5
        draws["xk"] /= n ** 0.5
    else:
        draws = {k: bridge.to_torch(inputs[k], dev) for k in shapes}
    for k, s in shapes.items():
        if tuple(draws[k].shape) != s:
            raise ValueError(f"inputs[{k!r}] is {tuple(draws[k].shape)}, want {s}")
    x, w_true = draws["x"], draws["w_true"]
    gram = x.T @ x + args.lam * torch.eye(n, device=dev)

    svc = SpinService(slots=args.slots, device=dev)
    a0 = gram
    mesh_ctx = contextlib.nullcontext()
    if args.sharded:
        from repro_torch.launch.mesh import make_worker_mesh, set_mesh

        mesh = make_worker_mesh((4, 2), ("data", "model"), devices=[dev] * 8)
        mesh_ctx = set_mesh(mesh)               # ambient for the whole run:
        # the service state is laid out over THIS mesh, so every later
        # tick runs under the same context.
    with mesh_ctx:
        if args.sharded:
            from repro_torch.parallel.sharded_blockmatrix import ShardedBlockMatrix
            from repro_torch.planner import get_plan

            block = args.block or get_plan("inverse", n, torch.float32,
                                           placement="sharded",
                                           backend=dev.type).block_size
            a0 = ShardedBlockMatrix.from_dense(gram, block)
        return serve(svc, a0, args, draws, dev)


def serve(svc: SpinService, a0, args, draws: dict, dev: torch.device) -> dict:
    n = args.features
    x, w_true = draws["x"], draws["w_true"]
    state = svc.add_matrix("gram", a0, block_size=args.block)
    print(f"admitted gram {n}x{n} [{state.placement}] block="
          f"{state.block_size} leaf={state.leaf_solver} "
          f"engine={state.engine}")

    solves, updates = [], []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(args.requests):
        y = x @ w_true + 0.01 * draws["noise"][i]
        solves.append(svc.solve("gram", x.T @ y))
        if args.update_every and (i + 1) % args.update_every == 0:
            xk = draws["xk"][len(updates)]
            updates.append(svc.update("gram", xk.T))   # G += XₖᵀXₖ
        svc.tick()
    svc.run_until_done()
    _sync(dev)
    dt = time.perf_counter() - t0

    assert all(r.done for r in solves + updates)
    # Correctness claim of the SERVICE: a solve submitted after the stream
    # drained answers the CURRENT (fully churned) normal equations; the
    # in-stream answers each solved their own barrier-consistent version.
    # Distance to w_true is reported but not asserted: arriving sample
    # batches carry no targets here, so they act as extra regularization
    # that legitimately biases w.
    probe = svc.solve("gram", solves[-1].rhs)
    svc.run_until_done()
    w_hat = probe.x
    a_now = state.a.to_dense() if state.placement == "sharded" else state.a
    resid = float(torch.linalg.norm(a_now @ w_hat - probe.rhs)
                  / torch.linalg.norm(probe.rhs))
    rel = float(torch.linalg.norm(w_hat - w_true) / torch.linalg.norm(w_true))
    smw = sum(1 for u in updates if not u.refactored)
    refac = sum(1 for u in updates if u.refactored)
    print(f"{args.requests} solves + {len(updates)} rank-{args.update_rank} "
          f"updates in {dt * 1e3:.0f} ms "
          f"({args.requests / dt:.1f} req/s, {svc.stats['batches']} batches,"
          f" {svc.stats['coalesced_cols']} coalesced cols)")
    print(f"updates: {smw} SMW folds, {refac} re-factorizations "
          f"(pending rank {state.pending_rank}, drift "
          f"{state.drift.residual_est:.2e} < {state.drift.tolerance:.0e})")
    print(f"last solve: normal-eq residual = {resid:.2e}  "
          f"||w-w*||/||w*|| = {rel:.2e}")
    assert resid < 1e-2
    return {"n": n, "placement": state.placement, "block": state.block_size,
            "leaf": state.leaf_solver, "engine": state.engine,
            "requests": args.requests, "updates": len(updates), "ms": dt * 1e3,
            "req_per_s": args.requests / dt, "batches": svc.stats["batches"],
            "coalesced_cols": svc.stats["coalesced_cols"], "smw": smw,
            "refactorizations": refac, "pending_rank": state.pending_rank,
            "drift": state.drift.residual_est, "drift_tolerance": state.drift.tolerance,
            "residual": resid, "rel": rel, "w_hat": w_hat}


if __name__ == "__main__":
    main()
