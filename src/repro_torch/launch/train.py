"""Training launcher: an LM of any family on synthetic batches.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --batch 8 --seq 2048 --steps 10 [--optimizer spin_shampoo]
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --reduced --device cpu --steps 3 --batch 2 --seq 32 --microbatches 1
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi-3-vision-4.2b \
        --layers 28 --batch 8 --seq 2048 --steps 10

Random weights from seed 0 (MoE experts unpadded, model_size_hint 1, as
the reference's launcher without a mesh), batches from
`data.synthetic.TokenStream` (seed 0); runs on the card unless `--device
cpu`. Every family trains on the card, hymba's sliding window and
hubert's head dim 80 included. `--layers N` keeps the config's first N
layers at full width, for a config whose optimizer state does not fit one
card whole (phi-3-vision-4.2b, qwen2-moe-a2.7b). `--mesh single|multi`
trains under the production mesh (`launch.mesh.make_production_mesh`:
16 x 16, or 2 x 16 x 16) laid over `--device` (its 256 or 512 coordinates
on that one device), with MoE experts padded for a 16-way model axis
(model_size_hint 16), as the reference's launcher does; the embedding
and MoE run their per-coordinate programs there. `--mesh DxM` (e.g.
`2x4`) trains under a (data D, model M) mesh of `--device`, with the same
padding. A smaller mesh of one card also runs through the library
(`set_mesh(make_worker_mesh((2, 4), devices=["cuda:0"] * 8))` around
`Trainer(..., rules=DEFAULT_RULES)`).

Across processes: with SPIN_COORDINATOR set and SPIN_NUM_PROCS > 1 every
process runs this launcher (SPIN_PROC_ID its rank) and joins the group
over `--backend` (gloo, or nccl for one process a card), as the
reference's joins its cluster under JAX_COORDINATOR; `--mesh` then lays
the mesh over every process's devices, process p holding the p-th
contiguous block of coordinates (each process names `--device`, repeated
to its share). Outside the per-coordinate programs the step runs
replicated on each process's device: every process draws the same batch
and holds the whole state, and the regions' outputs and input gradients
reach every process, so every rank's loss and parameters are the same.
Only process 0 prints the step lines and writes checkpoints.

    SPIN_COORDINATOR=127.0.0.1:29500 SPIN_NUM_PROCS=2 SPIN_PROC_ID=<rank> \
        PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b \
        --reduced --device cpu --mesh 2x2 --steps 3 --batch 2 --seq 32 \
        --microbatches 1 --backend gloo
"""

from __future__ import annotations

import argparse
import dataclasses

import torch


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the config's first N layers (a depth cut)")
    ap.add_argument("--shape", default=None,
                    help="assigned shape id (sets batch/seq); overrides "
                         "--batch/--seq")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "spin_shampoo"])
    ap.add_argument("--mesh", default="none",
                    help="none, single (16 x 16), multi (2 x 16 x 16) or DxM")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="the transfers' backend when SPIN_NUM_PROCS > 1")
    args = ap.parse_args(argv)

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import (init_distributed, make_production_mesh,
                                         make_worker_mesh, set_mesh)
    from repro_torch.runtime.trainer import TrainConfig, Trainer, init_state

    info = init_distributed(backend=args.backend)   # a no-op for one process

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        if not 1 <= args.layers <= cfg.n_layers:
            raise ValueError(f"--layers {args.layers}: {cfg.name} has {cfg.n_layers}")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    batch, seq = args.batch, args.seq
    if args.shape:
        sh = SHAPES[args.shape]
        batch, seq = sh.global_batch, sh.seq_len
    device = resolve_device(args.device)

    if args.mesh in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=args.mesh == "multi", devices=[device])
    elif args.mesh != "none":
        shape = tuple(int(k) for k in args.mesh.split("x"))
        if len(shape) != 2 or (shape[0] * shape[1]) % info.process_count:
            raise ValueError(f"--mesh {args.mesh}: want DxM over "
                             f"{info.process_count} process(es)")
        mesh = make_worker_mesh(shape, ("data", "model"),
                                devices=[device] * (shape[0] * shape[1]
                                                    // info.process_count))
    else:
        mesh = None

    tcfg = TrainConfig(microbatches=args.microbatches, optimizer=args.optimizer,
                       total_steps=max(args.steps, 100))
    with set_mesh(mesh):
        state = init_state(cfg, tcfg, torch.Generator(device=device).manual_seed(0),
                           device, model_size_hint=16 if mesh is not None else 1)
        stream = TokenStream(cfg, batch, seq, seed=0, device=str(device))
        trainer = Trainer(cfg, tcfg, stream, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every)
        state = trainer.maybe_restore(state)
        state, logs = trainer.run(state, args.steps, log_every=10)
    if info.is_coordinator:
        print(f"done: step {int(state.step)} loss {logs[-1]['loss']:.4f}; "
              f"straggler events: {len(trainer.straggler_events)}")
    return {"arch": cfg.name, "layers": cfg.n_layers, "device": str(device),
            "mesh": mesh.descriptor() if mesh is not None else None,
            "processes": info.process_count,
            "steps": int(state.step), "loss": logs[-1]["loss"], "logs": logs,
            "state": state}


if __name__ == "__main__":
    main()
