"""Training launcher: an LM of any family on synthetic batches.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --batch 8 --seq 2048 --steps 10 [--optimizer spin_shampoo]
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --reduced --device cpu --steps 3 --batch 2 --seq 32 --microbatches 1

Random weights from seed 0 (MoE experts unpadded, model_size_hint 1, as
the reference's launcher without a mesh), batches from
`data.synthetic.TokenStream` (seed 0); runs on the card unless `--device
cpu`. On the card a config with a sliding window (hymba) or head dim 80
(hubert) raises at its first step: B6-bwd does not take them yet. `--mesh single|multi`
needs the production mesh, which the port does not have yet: it raises.
"""

from __future__ import annotations

import argparse

import torch


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--shape", default=None,
                    help="assigned shape id (sets batch/seq); overrides "
                         "--batch/--seq")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "spin_shampoo"])
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh != "none":
        raise ValueError(f"--mesh {args.mesh} needs the production mesh, which "
                         "comes with the port of the dry run")

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.device import resolve_device
    from repro_torch.runtime.trainer import TrainConfig, Trainer, init_state

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    batch, seq = args.batch, args.seq
    if args.shape:
        sh = SHAPES[args.shape]
        batch, seq = sh.global_batch, sh.seq_len
    device = resolve_device(args.device)

    tcfg = TrainConfig(microbatches=args.microbatches, optimizer=args.optimizer,
                       total_steps=max(args.steps, 100))
    state = init_state(cfg, tcfg, torch.Generator(device=device).manual_seed(0),
                       device, model_size_hint=1)
    stream = TokenStream(cfg, batch, seq, seed=0, device=str(device))
    trainer = Trainer(cfg, tcfg, stream, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every)
    state = trainer.maybe_restore(state)
    state, logs = trainer.run(state, args.steps, log_every=10)
    print(f"done: step {int(state.step)} loss {logs[-1]['loss']:.4f}; "
          f"straggler events: {len(trainer.straggler_events)}")
    return {"arch": cfg.name, "device": str(device), "steps": int(state.step),
            "loss": logs[-1]["loss"], "logs": logs}


if __name__ == "__main__":
    main()
