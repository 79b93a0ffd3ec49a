"""Training step and loop: microbatch accumulation, remat, restart.

The port of `repro.runtime.trainer`, for every LM family. `make_train_step`
builds the step:
    state -> for each microbatch: loss and gradients by autograd (the
             layers checkpointed, attention through B6 and B6-bwd on the
             card), summed in f32 -> the mean -> the schedule -> AdamW or
             SPIN-Shampoo
The microbatches run one after another, so activation memory is one
microbatch deep whatever the global batch.

`Trainer` adds the operational layer: checkpoint / restart, a step-time
watchdog (EWMA), and a restartable data stream. The optimizer state is
updated in place, as the reference's jitted step donates it: a state
passed to the step is consumed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..configs.registry import ArchConfig
from ..device import DEFAULT_DEVICE
from ..models import transformer as T
from ..optim import (AdamWConfig, SpinShampooConfig, adamw_init, adamw_update,
                     schedule, spin_shampoo_init, spin_shampoo_update)
from ..tree import leaves, unflatten

__all__ = ["TrainConfig", "TrainState", "make_train_step", "init_state",
           "Trainer"]

OPTIMIZERS = ("adamw", "spin_shampoo")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 8
    optimizer: str = "adamw"          # adamw | spin_shampoo
    adamw: AdamWConfig = AdamWConfig()
    shampoo: SpinShampooConfig = SpinShampooConfig()
    warmup: int = 100
    total_steps: int = 10_000
    remat: bool = True
    remat_policy: str = "full"        # full | dots
    straggler_ewma: float = 0.9
    straggler_factor: float = 3.0     # step slower than 3x EWMA -> flag


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor                # 0-dim int32, on the host


def _check_optimizer(tcfg: TrainConfig) -> None:
    if tcfg.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {tcfg.optimizer!r}; want one of "
                         f"{OPTIMIZERS}")


def init_state(cfg: ArchConfig, tcfg: TrainConfig, generator: torch.Generator,
               device: str | torch.device = DEFAULT_DEVICE,
               model_size_hint: int = 16) -> TrainState:
    """Random parameters from `generator` (on `device`; MoE experts padded
    to a multiple of `model_size_hint`) and a fresh optimizer state."""
    _check_optimizer(tcfg)
    params = T.init_params(cfg, generator, device, model_size_hint)
    opt = (adamw_init(params) if tcfg.optimizer == "adamw"
           else spin_shampoo_init(params, tcfg.shampoo))
    return TrainState(params, opt, torch.zeros((), dtype=torch.int32))


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig, rules=None
                    ) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """The step function. `rules` (the reference's sharding rules) is
    accepted and ignored until the port has `parallel/sharding.py`."""
    _check_optimizer(tcfg)
    nm = tcfg.microbatches

    def train_step(state: TrainState, batch: dict):
        flat = leaves(state.params)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in flat]
        sums = {k: torch.zeros((), dtype=torch.float32, device=flat[0].device)
                for k in ("loss", "aux", "z")}
        for i in range(nm):
            mb = {k: v.reshape(nm, v.shape[0] // nm, *v.shape[1:])[i]
                  for k, v in batch.items()}
            ps = [p.detach().requires_grad_() for p in flat]
            loss, parts = T.loss_fn(unflatten(state.params, ps), mb, cfg,
                                    remat=tcfg.remat, remat_policy=tcfg.remat_policy)
            # a leaf the family does not read (audio's token table) gets a zero gradient
            for a, g in zip(acc, torch.autograd.grad(loss, ps, allow_unused=True)):
                if g is not None:
                    a.add_(g.float())
            for k, v in (("loss", loss), ("aux", parts["aux"]), ("z", parts["z"])):
                sums[k] += v.detach()
        grads = unflatten(state.params,
                          [a.div_(nm).to(p.dtype) for a, p in zip(acc, flat)])
        del acc
        lr_scale = schedule.cosine_with_warmup(
            state.step, warmup=tcfg.warmup, total=tcfg.total_steps)
        update = adamw_update if tcfg.optimizer == "adamw" else spin_shampoo_update
        opt_cfg = tcfg.adamw if tcfg.optimizer == "adamw" else tcfg.shampoo
        new_params, new_opt, gnorm = update(opt_cfg, grads, state.opt, lr_scale)
        new_state = TrainState(new_params, new_opt,
                               torch.tensor(int(state.step) + 1, dtype=torch.int32))
        # aux and z: the MoE losses inside "loss" (zero for the other families)
        return new_state, {"loss": sums["loss"] / nm, "aux": sums["aux"] / nm,
                           "z": sums["z"] / nm, "grad_norm": gnorm,
                           "lr_scale": lr_scale}

    return train_step


class Trainer:
    """Operational loop: step timing, straggler watchdog, ckpt/restart."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainConfig, stream,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 rules=None):
        self.cfg, self.tcfg, self.stream = cfg, tcfg, stream
        self.ckpt_dir, self.ckpt_every = ckpt_dir, ckpt_every
        self.step_fn = make_train_step(cfg, tcfg, rules)
        self._ewma: Optional[float] = None
        self.straggler_events: list[dict] = []

    def maybe_restore(self, state: TrainState) -> TrainState:
        if not self.ckpt_dir:
            return state
        from ..checkpoint.ckpt import latest_step, restore
        step = latest_step(self.ckpt_dir)
        if step is None:
            return state
        state, extra = restore(self.ckpt_dir, step, state)
        if "stream" in extra:
            self.stream.load_state_dict(extra["stream"])
        return state

    def _watch(self, dt: float, step: int) -> None:
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.tcfg.straggler_factor * self._ewma:
            # One process has no host to evict: the event is recorded.
            self.straggler_events.append(
                {"step": step, "dt": dt, "ewma": self._ewma})
        a = self.tcfg.straggler_ewma
        self._ewma = a * self._ewma + (1 - a) * dt

    def run(self, state: TrainState, n_steps: int,
            log_every: int = 10) -> tuple[TrainState, list[dict]]:
        logs = []
        for i in range(n_steps):
            batch = self.stream.next()
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
            dt = time.perf_counter() - t0
            step = int(state.step)
            self._watch(dt, step)
            metrics.update(step=step, dt=dt)
            logs.append(metrics)
            if log_every and i % log_every == 0:
                moe = (f" aux {metrics['aux']:.4f} z {metrics['z']:.4f}"
                       if self.cfg.moe is not None else "")
                print(f"step {step:5d} loss {metrics['loss']:.4f}{moe} "
                      f"gnorm {metrics['grad_norm']:.3f} {dt*1e3:.0f}ms")
            if self.ckpt_dir and step % self.ckpt_every == 0:
                from ..checkpoint.ckpt import save
                save(self.ckpt_dir, step, state,
                     extra={"stream": self.stream.state_dict()})
        return state, logs
