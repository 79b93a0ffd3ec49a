"""AdamW with f32 master weights (params stored bf16, math in f32).

The port of `repro.optim.adamw`. The state is updated in place, as the
reference's jitted train step donates it: `adamw_update` returns the
state it was given, with its tensors advanced. `step` is a 0-dim int32
tensor kept on the host: every use of it (bias correction, the schedule)
is a host scalar, so reading it costs no device synchronisation.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..tree import leaves, tree_map

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "global_norm", "clip_factor"]


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


def adamw_init(params) -> AdamWState:
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, leaf by leaf."""
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2) for leaf in leaves(tree)))


def clip_factor(gnorm: torch.Tensor, grad_clip: float) -> torch.Tensor:
    """min(1, grad_clip / max(gnorm, 1e-9)), on gnorm's device."""
    return torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)


def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, lr_scale=1.0):
    """Returns (new_params in the grads' dtype, state, grad_norm)."""
    step = int(state.step) + 1
    gnorm = global_norm(grads)
    clip = clip_factor(gnorm, cfg.grad_clip)
    f32 = np.float32
    b1t = float(f32(1) - f32(cfg.b1) ** f32(step))
    b2t = float(f32(1) - f32(cfg.b2) ** f32(step))
    lr = float(f32(cfg.lr) * f32(lr_scale))

    for g, m, v, master in zip(leaves(grads), leaves(state.m), leaves(state.v),
                               leaves(state.master)):
        g = g.float() * clip
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        upd = torch.div(m / b1t, torch.sqrt(v / b2t).add_(cfg.eps))
        master.sub_(upd.add_(master, alpha=cfg.weight_decay), alpha=lr)
    new_params = tree_map(lambda ma, g: ma.to(g.dtype), state.master, grads)
    state = state._replace(step=torch.tensor(step, dtype=torch.int32))
    return new_params, state, gnorm
