"""AdamW with f32 master weights (params stored bf16, math in f32).

The port of `repro.optim.adamw`. The state is updated in place, as the
reference's jitted train step donates it: `adamw_update` returns the
state it was given, with its tensors advanced. `step` is a 0-dim int32
tensor kept on the host: every use of it (bias correction, the schedule)
is a host scalar, so reading it costs no device synchronisation.

A laid-out parameter tree (`parallel.collectives.DistArray` leaves) gets a
laid-out state of the same layouts, and the update runs shard by shard,
in place, once a distinct tensor. `global_norm` then sums each distinct
region once (`collectives.region_values`: a region several coordinates or
processes hold counts once), in one order in every process, so every
process applies the same clip factor. A step counter may itself be laid
out (a 0-dim DistArray, as the reference's specs give it) and stays so.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..parallel import collectives as col
from ..parallel.collectives import DistArray
from ..tree import leaves, tree_map

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "global_norm", "clip_factor", "step_count", "next_step"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-dim int32, on the host
    master: object          # f32 copy of params
    m: object
    v: object


def _shardwise(fn, p, *rest):
    """`fn` on a tensor leaf, or shard by shard on DistArrays of one
    layout (once a distinct set of tensors), keeping the layout."""
    return col.zip_map(fn, p, *rest) if isinstance(p, DistArray) else fn(p, *rest)


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32),
        master=tree_map(lambda p: _shardwise(
            lambda t: t.detach().to(torch.float32, copy=True), p), params),
        m=tree_map(lambda p: _shardwise(zeros, p), params),
        v=tree_map(lambda p: _shardwise(zeros, p), params))


def step_count(step) -> int:
    """A step counter's value: a host tensor, or a laid-out 0-dim one."""
    return int(col.gather(step) if isinstance(step, DistArray) else step)


def next_step(step, value: int):
    """`value` as a counter of `step`'s kind: a host int32 tensor, or laid
    out as `step` is."""
    new = torch.tensor(value, dtype=torch.int32)
    if isinstance(step, DistArray):
        return col.distribute(new.to(step.mesh.local_device()), step.spec, step.mesh)
    return new


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, leaf by leaf; of
    each distinct region of a laid-out leaf, in plan order."""
    flat = leaves(tree)
    laid = [leaf for leaf in flat if isinstance(leaf, DistArray)]
    parts = col.region_values(laid, lambda t, _: torch.sum(t.float() ** 2)) if laid else []
    parts += [torch.sum(leaf.float() ** 2) for leaf in flat
              if not isinstance(leaf, DistArray)]
    return torch.sqrt(sum(parts))


def clip_factor(gnorm: torch.Tensor, grad_clip: float) -> torch.Tensor:
    """min(1, grad_clip / max(gnorm, 1e-9)), on gnorm's device."""
    return torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)


def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, lr_scale=1.0):
    """Returns (new_params in the grads' dtype, state, grad_norm)."""
    step = step_count(state.step) + 1
    gnorm = global_norm(grads)
    clip = clip_factor(gnorm, cfg.grad_clip)
    f32 = np.float32
    b1t = float(f32(1) - f32(cfg.b1) ** f32(step))
    b2t = float(f32(1) - f32(cfg.b2) ** f32(step))
    lr = float(f32(cfg.lr) * f32(lr_scale))

    def update(g, m, v, master):
        g = g.float() * col._on(clip, g.device)
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        upd = torch.div(m / b1t, torch.sqrt(v / b2t).add_(cfg.eps))
        return master.sub_(upd.add_(master, alpha=cfg.weight_decay), alpha=lr)

    for g, m, v, master in zip(leaves(grads), leaves(state.m), leaves(state.v),
                               leaves(state.master)):
        _shardwise(update, g, m, v, master)
    new_params = tree_map(lambda ma, g: _shardwise(lambda a, b: a.to(b.dtype), ma, g),
                          state.master, grads)
    state = state._replace(step=next_step(state.step, step))
    return new_params, state, gnorm
