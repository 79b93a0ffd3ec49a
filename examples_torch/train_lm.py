"""End-to-end training driver: any registered arch (reduced or full), AdamW
or the SPIN-Shampoo second-order optimizer (whose preconditioner inversions
run the paper's SPIN recursion on the hand-written kernels).

The PyTorch twin of examples/train_lm.py, on the port (`repro_torch`).

    # ~100M-param LM, a few hundred steps:
    PYTHONPATH=src python examples_torch/train_lm.py --scale 100m --steps 200

    # quick demo (~10M params), on the CPU:
    PYTHONPATH=src python examples_torch/train_lm.py --device cpu --scale 10m \\
        --steps 50

    # any assigned arch at reduced size, SPIN-Shampoo optimizer:
    PYTHONPATH=src python examples_torch/train_lm.py --arch qwen2-moe-a2.7b \\
        --reduced --optimizer spin_shampoo --steps 20

Differences from examples/train_lm.py:
- `--device` (default cuda); without a card it raises unless `--device cpu`
  is given.
- Random weights come from a `torch.Generator` on the device seeded 0
  (`init_state(..., model_size_hint=1)`), the batches from the port's
  `data.synthetic.TokenStream` (numpy, seed 0), not from `jax.random`.
  `main(inputs={"params": tree of arrays, "batches": [batch, ...]})` takes
  the parameters (the reference's tree as numpy,
  `repro_torch.bridge.lm_params_from_numpy`; the optimizer state is made
  fresh from them) and one batch of arrays a step instead.
- The step runs eagerly (the reference jit-compiles it), with attention in
  the hand-written flash attention kernels on the card.
- `main(argv)` returns the printed numbers as a dict, with every step's
  log under "logs".
"""

import argparse
import json

import torch

from repro_torch import bridge
from repro_torch.configs import ArchConfig, get_arch
from repro_torch.data.synthetic import TokenStream
from repro_torch.device import resolve_device
from repro_torch.optim import adamw_init, spin_shampoo_init
from repro_torch.runtime.trainer import TrainConfig, Trainer, TrainState, init_state

SCALES = {
    # ~106M params: 10 x (4*640^2 attn + 3*640*2560 mlp) + 2*32000*640 embed
    "100m": ArchConfig(name="lm-100m", family="dense", n_layers=10,
                       d_model=640, n_heads=10, n_kv_heads=10, head_dim=64,
                       d_ff=2560, vocab=32000),
    "10m": ArchConfig(name="lm-10m", family="dense", n_layers=6,
                      d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
                      d_ff=1024, vocab=8192),
}


class _Batches:
    """A restorable stream over given batches (dicts of arrays), one a step."""

    def __init__(self, batches, device: torch.device):
        self.batches, self.device, self.step = list(batches), device, 0

    def next(self) -> dict:
        b = {k: bridge.to_torch(v, self.device) for k, v in self.batches[self.step].items()}
        self.step += 1
        return {k: v.long() if not v.is_floating_point() and v.dtype != torch.bool else v
                for k, v in b.items()}

    def state_dict(self) -> dict:
        return {"seed": 0, "step": self.step}

    def load_state_dict(self, s: dict) -> None:
        self.step = int(s["step"])


def main(argv=None, *, inputs=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="registered arch id")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--scale", default="10m", choices=sorted(SCALES))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "spin_shampoo"])
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.arch:
        cfg = get_arch(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    else:
        cfg = SCALES[args.scale]
    print(f"arch={cfg.name}  params≈{cfg.param_count() / 1e6:.1f}M  "
          f"optimizer={args.optimizer}")

    tcfg = TrainConfig(microbatches=args.microbatches,
                       optimizer=args.optimizer, warmup=10,
                       total_steps=max(args.steps, 100))
    if inputs is None:
        stream = TokenStream(cfg, args.batch, args.seq, seed=0, device=str(dev))
        state = init_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(0), dev,
                           model_size_hint=1)
    else:
        stream = _Batches(inputs["batches"], dev)
        params = bridge.lm_params_from_numpy(inputs["params"], dev)
        opt = (adamw_init(params) if args.optimizer == "adamw"
               else spin_shampoo_init(params, tcfg.shampoo))
        state = TrainState(params, opt, torch.zeros((), dtype=torch.int32))
    trainer = Trainer(cfg, tcfg, stream, ckpt_dir=args.ckpt_dir,
                      ckpt_every=50)
    state = trainer.maybe_restore(state)
    state, logs = trainer.run(state, args.steps, log_every=10)
    median_dt = sorted(log["dt"] for log in logs)[len(logs) // 2]
    print(f"final loss {logs[-1]['loss']:.4f} "
          f"(start {logs[0]['loss']:.4f}), "
          f"median step {median_dt * 1e3:.0f} ms")
    if args.log_json:
        with open(args.log_json, "w") as f:
            json.dump(logs, f)
    return {"arch": cfg.name, "params": cfg.param_count(), "optimizer": args.optimizer,
            "steps": int(state.step), "final_loss": logs[-1]["loss"],
            "start_loss": logs[0]["loss"], "median_step_ms": median_dt * 1e3,
            "losses": [log["loss"] for log in logs], "logs": logs}


if __name__ == "__main__":
    main()
