"""Training step and loop: microbatch accumulation, remat, restart.

The port of `repro.runtime.trainer`, for every LM family. `make_train_step`
builds the step:
    state -> for each microbatch: loss and gradients by autograd (the
             layers checkpointed, attention through B6 and B6-bwd on the
             card), summed in f32 -> the mean -> the schedule -> AdamW or
             SPIN-Shampoo
The microbatches run one after another, so activation memory is one
microbatch deep whatever the global batch.

Under an ambient mesh (`launch.mesh.set_mesh`) the step runs the
sharded model: `rules` reaches `loss_fn`, the `shard` sites record their
layouts, and the embedding and MoE run per coordinate (expert-parallel
MoE, FSDP's gathers). `abstract_state` is the state on the `meta` device.

On a laid-out state (DistArray leaves: `state_shardings` gives the
reference's layouts, `parallel.sharding.lay_out` or
`checkpoint.ckpt.restore(shardings=)` apply them) the step is the
partitioned program, the counterpart of the reference's
`jax.jit(make_train_step, in_shardings=..., out_shardings=...)`: each
microbatch (rows [i·B/nm, (i+1)·B/nm) of the global batch, laid out by
the batch specs) runs `loss_fn` per coordinate inside
`collectives.laid_out_region`, the gradients come back laid out
(`collectives.grads`; a region several coordinates hold, such as the
norms' scales, the MoE router, the SSM's wxbc, wdt, conv_w and
per-head leaves and audio's `mask_embed`, gets the sum of their
gradients, and `global_norm` counts it once; a leaf no loss reads, audio's
token table, gets zeros, so AdamW's weight decay alone moves it, as the
reference's zero gradient does), the f32 sums are kept shard by shard, and
AdamW or SPIN-Shampoo updates shard by shard (Shampoo's Gram factors
and their inverses laid out by `optim.spin_shampoo.factor_spec`, the
refresh the mesh-resident SPIN inversion on the state's mesh); an MoE
body's aux and z enter each microbatch's loss as in the reference's
step. Across processes a process then holds only its own coordinates'
shards. The metrics come back as 0-dim tensors, the same in every
process.

Across processes with a whole state (a mesh that spans them) every
process runs the step on the same batch and holds the whole state; the
backward runs under `collectives.backward_context`, in one thread.

`Trainer` adds the operational layer: checkpoint / restart, a step-time
watchdog (EWMA), and a restartable data stream; only process 0 prints
and writes checkpoints (a laid-out state is gathered to the host first,
in every process, and restored into the template's layouts). The optimizer
state is
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
from ..launch.mesh import worker_info
from ..models import transformer as T
from ..optim import (AdamWConfig, AdamWState, SpinShampooConfig, SpinShampooState,
                     adamw_init, adamw_update, schedule, spin_shampoo_init,
                     spin_shampoo_update)
from ..optim.adamw import next_step, step_count
from ..optim.spin_shampoo import _Factor, factor_spec
from ..parallel import collectives as col
from ..parallel.collectives import DistArray
from ..parallel.sharding import (DEFAULT_RULES, NamedSharding, PartitionSpec, ShardingRules,
                                 logical_spec)
from ..tree import leaves, tree_map, unflatten

__all__ = ["TrainConfig", "TrainState", "make_train_step", "init_state",
           "abstract_state", "state_shardings", "Trainer"]

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


def abstract_state(cfg: ArchConfig, tcfg: TrainConfig,
                   model_size_hint: int = 16) -> TrainState:
    """`init_state`'s structure, shapes and dtypes on the `meta` device:
    nothing is allocated but the host's 0-dim step counters, which move to
    `meta` too."""
    _check_optimizer(tcfg)
    params = T.abstract_params(cfg, model_size_hint)
    opt = (adamw_init(params) if tcfg.optimizer == "adamw"
           else spin_shampoo_init(params, tcfg.shampoo))
    return TrainState(params, tree_map(lambda t: t.to("meta"), opt),
                      torch.empty((), dtype=torch.int32, device="meta"))


def state_shardings(cfg: ArchConfig, tcfg: TrainConfig, mesh,
                    rules: ShardingRules = DEFAULT_RULES,
                    model_size_hint: int = 16) -> TrainState:
    """The training state's layouts on `mesh`, a TrainState of
    `NamedSharding`s (for `parallel.sharding.lay_out`, `restore`): the
    parameters by `param_specs` and the step counters whole. AdamW's
    master, m and v by `param_specs`, the reference's
    `_param_state_specs`; SPIN-Shampoo's master, m and v (lists in leaf
    order) by their parameters' specs, and each factor's L, R, L⁻¹ and R⁻¹
    by `factor_spec` (None where the leaf is not a matrix)."""
    _check_optimizer(tcfg)
    specs = T.param_specs(cfg, rules, mesh, model_size_hint)

    def named(tree):
        return {k: named(v) if isinstance(v, dict) else NamedSharding(mesh, v)
                for k, v in tree.items()}

    whole = NamedSharding(mesh, PartitionSpec())
    if tcfg.optimizer == "adamw":
        return TrainState(named(specs), AdamWState(whole, named(specs), named(specs),
                                                   named(specs)), whole)
    flat = leaves(named(specs))
    factors = [None if f is None else _Factor(*(
        NamedSharding(mesh, PartitionSpec(*factor_spec(t.shape, mesh))) for t in f))
        for f in abstract_state(cfg, tcfg, model_size_hint).opt.factors]
    return TrainState(named(specs), SpinShampooState(whole, flat, factors, flat, flat),
                      whole)


def _microbatch(v, i: int, nm: int, rules: ShardingRules, mesh):
    """Rows [i·B/nm, (i+1)·B/nm) of a batch entry; a laid-out entry's rows
    are laid out anew by the batch specs (moving rows between
    coordinates, "reshard")."""
    rows = v.shape[0] // nm
    if not isinstance(v, DistArray):
        return v.reshape(nm, rows, *v.shape[1:])[i]
    region = ((i * rows, (i + 1) * rows),) + tuple((0, n) for n in v.shape[1:])
    shape = (rows, *v.shape[1:])
    return col.take(v, region, logical_spec(shape, ("batch",) + (None,) * (len(shape) - 1),
                                            rules, mesh))


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig,
                    rules: ShardingRules = DEFAULT_RULES
                    ) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """The step function; `rules` goes to `loss_fn` (it acts under an
    ambient mesh, and lays out the partitioned program on a laid-out
    state)."""
    _check_optimizer(tcfg)
    nm = tcfg.microbatches
    update = adamw_update if tcfg.optimizer == "adamw" else spin_shampoo_update
    opt_cfg = tcfg.adamw if tcfg.optimizer == "adamw" else tcfg.shampoo

    def laid_out_step(state: TrainState, batch: dict):
        flat = leaves(state.params)
        mesh = flat[0].mesh
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        acc = [col.zip_map(zeros, p) for p in flat]
        sums = {k: torch.zeros((), dtype=torch.float32, device=mesh.local_device())
                for k in ("loss", "aux", "z")}
        for i in range(nm):
            mb = {k: _microbatch(v, i, nm, rules, mesh) for k, v in batch.items()}
            (loss, parts), (entered,) = col.laid_out_region(
                lambda p: T.loss_fn(p, mb, cfg, rules, remat=tcfg.remat,
                                    remat_policy=tcfg.remat_policy))(state.params)
            grads_mb = col.grads(loss, entered)
            for a, g in zip(acc, leaves(grads_mb)):
                col.zip_map(lambda x, y: x.add_(y.float()), a, g)
            del grads_mb, entered       # not alive through the next microbatch
            for k, v in (("loss", loss), ("aux", parts["aux"]), ("z", parts["z"])):
                sums[k] += v.detach()
        grads = unflatten(state.params, [
            col.zip_map(lambda a, p: a.div_(nm).to(p.dtype), a, p) for a, p in zip(acc, flat)])
        del acc
        lr_scale = schedule.cosine_with_warmup(
            step_count(state.step), warmup=tcfg.warmup, total=tcfg.total_steps)
        new_params, new_opt, gnorm = update(opt_cfg, grads, state.opt, lr_scale)
        new_state = TrainState(new_params, new_opt,
                               next_step(state.step, step_count(state.step) + 1))
        return new_state, {"loss": sums["loss"] / nm, "aux": sums["aux"] / nm,
                           "z": sums["z"] / nm, "grad_norm": gnorm, "lr_scale": lr_scale}

    def train_step(state: TrainState, batch: dict):
        if T.is_laid_out(state.params):
            return laid_out_step(state, batch)
        flat = leaves(state.params)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in flat]
        sums = {k: torch.zeros((), dtype=torch.float32, device=flat[0].device)
                for k in ("loss", "aux", "z")}
        for i in range(nm):
            mb = {k: v.reshape(nm, v.shape[0] // nm, *v.shape[1:])[i]
                  for k, v in batch.items()}
            ps = [p.detach().requires_grad_() for p in flat]
            loss, parts = T.loss_fn(unflatten(state.params, ps), mb, cfg, rules,
                                    remat=tcfg.remat, remat_policy=tcfg.remat_policy)
            # a leaf the family does not read (audio's token table) gets a zero gradient
            with col.backward_context():
                grads_mb = torch.autograd.grad(loss, ps, allow_unused=True)
            for a, g in zip(acc, grads_mb):
                if g is not None:
                    a.add_(g.float())
            del grads_mb            # not alive through the next microbatch
            for k, v in (("loss", loss), ("aux", parts["aux"]), ("z", parts["z"])):
                sums[k] += v.detach()
        grads = unflatten(state.params,
                          [a.div_(nm).to(p.dtype) for a, p in zip(acc, flat)])
        del acc
        lr_scale = schedule.cosine_with_warmup(
            state.step, warmup=tcfg.warmup, total=tcfg.total_steps)
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
                 rules: ShardingRules = DEFAULT_RULES):
        self.cfg, self.tcfg, self.stream = cfg, tcfg, stream
        self.ckpt_dir, self.ckpt_every = ckpt_dir, ckpt_every
        self.rules = rules
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
        flat = leaves(state)
        shardings = None
        if flat and all(isinstance(t, DistArray) for t in flat):
            # a laid-out state comes back in the template's layouts, each
            # process copying only its own regions to the card
            shardings = unflatten(state, [NamedSharding(t.mesh, PartitionSpec(*t.spec))
                                          for t in flat])
        state, extra = restore(self.ckpt_dir, step, state, shardings=shardings)
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
            step = step_count(state.step)
            self._watch(dt, step)
            metrics.update(step=step, dt=dt)
            logs.append(metrics)
            if log_every and i % log_every == 0 and worker_info().is_coordinator:
                moe = (f" aux {metrics['aux']:.4f} z {metrics['z']:.4f}"
                       if self.cfg.moe is not None else "")
                print(f"step {step:5d} loss {metrics['loss']:.4f}{moe} "
                      f"gnorm {metrics['grad_norm']:.3f} {dt*1e3:.0f}ms")
            if self.ckpt_dir and step % self.ckpt_every == 0:
                from ..checkpoint.ckpt import save

                # a laid-out state is gathered to the host, leaf by leaf, in
                # every process (a collective)
                whole = tree_map(lambda x: col.gather(x, device="cpu")
                                 if isinstance(x, DistArray) else x, state)
                if worker_info().is_coordinator:
                    save(self.ckpt_dir, step, whole,
                         extra={"stream": self.stream.state_dict()})
                del whole
        return state, logs
