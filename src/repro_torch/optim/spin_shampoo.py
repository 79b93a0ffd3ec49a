"""SPIN-Shampoo: a Kronecker-factored second-order optimizer whose factor
inversions run through the paper's SPIN inversion.

The port of `repro.optim.spin_shampoo`. For each matrix parameter W
(d_in × d_out) with gradient G:

    L ← β L + (1−β) G Gᵀ          (d_in × d_in  Gram factor)
    R ← β R + (1−β) Gᵀ G          (d_out × d_out)
    every `update_every` steps:  L⁻¹, R⁻¹ ← SPIN((L, R) + λI)
    precondition:  P = L⁻¹ G R⁻¹   (grafted onto Adam's step norm)

Stacked-layer parameters (L, d_in, d_out) keep (L, d, d) factors.

`invert_spd` takes the factor's whole plan from the port's planner (cost
model, no measurement): block size, leaf solver and multiply engine. The
reference passes only the planned block size and leaves the leaf and the
engine at their defaults, which in the port would be cuSOLVER and cuBLAS;
on the card the plan is the `cuda` leaf and the `cuda` engine, so every
refresh runs its inversions through the hand-written kernels B1 (Schur
updates), B2 (products) and B3 (blocked Gauss–Jordan leaves). The Gram
updates and the preconditioner products stay `torch.matmul` in f32, as
the reference leaves them to XLA.

The state is updated in place (the reference's jitted step donates it),
and a refresh inverts a stacked factor one layer at a time into the
inverse it replaces: bitwise `spin_inverse_batched` of the stack, with
one layer's workspace. `step` is a 0-dim int32 on the host, so whether a
step refreshes is decided there, with no device synchronisation.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core import spin_inverse_batched, spin_inverse_dense
from ..tree import leaves, unflatten
from .adamw import clip_factor, global_norm

__all__ = ["SpinShampooConfig", "SpinShampooState", "spin_shampoo_init",
           "spin_shampoo_update", "invert_spd", "refresh_inverses",
           "needs_refresh"]


@dataclasses.dataclass(frozen=True)
class SpinShampooConfig:
    lr: float = 1e-3
    beta: float = 0.95
    damping: float = 1e-3
    update_every: int = 10
    grad_clip: float = 1.0
    weight_decay: float = 0.0
    max_factor_dim: int = 8192      # fall back to diagonal beyond this
    grafting: bool = True           # graft step norm onto Adam's (stability)


def invert_spd(mat: torch.Tensor, damping: float) -> torch.Tensor:
    """(mat + λ·tr/n·I)⁻¹ by SPIN in f32, for (n, n) or stacked (L, n, n).

    The damping is scaled by the mean eigenvalue (trace / n), as in the
    reference. The plan for n comes from `planner.get_plan("inverse", n,
    f32, measure=False)` on the factor's device type; a stack goes through
    `spin_inverse_batched`, bitwise one `spin_inverse_dense` a layer."""
    from ..planner import get_plan

    n = mat.shape[-1]
    trace = torch.diagonal(mat, dim1=-2, dim2=-1).sum(-1)
    lam = damping * (trace / n + 1e-12)
    eye = torch.eye(n, dtype=mat.dtype, device=mat.device)
    damped = (mat + lam[..., None, None] * eye).to(torch.float32)
    plan = get_plan("inverse", n, torch.float32, measure=False,
                    backend=mat.device.type)
    invert = spin_inverse_dense if mat.ndim == 2 else spin_inverse_batched
    return invert(damped, plan.block_size, plan.leaf_solver,
                  engine=plan.multiply_engine, device=mat.device).to(mat.dtype)


class _Factor(NamedTuple):
    l: torch.Tensor
    r: torch.Tensor
    linv: torch.Tensor
    rinv: torch.Tensor


class SpinShampooState(NamedTuple):
    """Fields are lists aligned with the flattened parameter leaves (None
    in `factors` marks a non-matrix leaf, which takes the Adam direction)."""
    step: torch.Tensor      # 0-dim int32, on the host
    master: list
    factors: list
    m: list
    v: list


def _is_matrix(p: torch.Tensor, max_dim: int) -> bool:
    if p.ndim == 2:
        dims = p.shape
    elif p.ndim == 3:          # (layers, d_in, d_out) stacked
        dims = p.shape[1:]
    else:
        return False
    return all(16 <= d <= max_dim for d in dims)


def spin_shampoo_init(params, cfg: SpinShampooConfig) -> SpinShampooState:
    def factor(p):
        if not _is_matrix(p, cfg.max_factor_dim):
            return None
        lead = p.shape[:-2]
        din, dout = p.shape[-2:]

        def eye(d):
            return torch.eye(d, dtype=torch.float32, device=p.device).expand(
                *lead, d, d).contiguous()
        zl = torch.zeros((*lead, din, din), dtype=torch.float32, device=p.device)
        zr = torch.zeros((*lead, dout, dout), dtype=torch.float32, device=p.device)
        return _Factor(zl, zr, eye(din), eye(dout))

    flat = leaves(params)
    return SpinShampooState(
        step=torch.zeros((), dtype=torch.int32),
        master=[p.detach().to(torch.float32, copy=True) for p in flat],
        factors=[factor(p) for p in flat],
        m=[torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat],
        v=[torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat])


def needs_refresh(step: int, cfg: SpinShampooConfig) -> bool:
    """Whether step `step` (1-based) recomputes the inverses."""
    return step % cfg.update_every == 1 or step == 1


def refresh_inverses(state: SpinShampooState, cfg: SpinShampooConfig) -> None:
    """Invert every factor of `state` into its inverse, in place: a stacked
    factor one layer at a time."""
    for fac in state.factors:
        if fac is None:
            continue
        for f, inv in ((fac.l, fac.linv), (fac.r, fac.rinv)):
            if f.ndim == 2:
                inv.copy_(invert_spd(f, cfg.damping))
            else:
                for i in range(f.shape[0]):
                    inv[i].copy_(invert_spd(f[i], cfg.damping))


def _gram_(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, beta: float) -> None:
    """acc ← β·acc + (1−β)·a·b, in place, (stacked) matrix products."""
    if acc.ndim == 2:
        acc.addmm_(a, b, beta=beta, alpha=1 - beta)
    else:
        acc.baddbmm_(a, b, beta=beta, alpha=1 - beta)


def spin_shampoo_update(cfg: SpinShampooConfig, grads, state: SpinShampooState,
                        lr_scale=1.0):
    """Returns (new_params in the grads' dtype, state, grad_norm)."""
    step = int(state.step) + 1
    gnorm = global_norm(grads)
    clip = clip_factor(gnorm, cfg.grad_clip)
    lr = float(np.float32(cfg.lr) * np.float32(lr_scale))
    g_flat = leaves(grads)

    for g, fac, m, v in zip(g_flat, state.factors, state.m, state.v):
        g32 = g.float() * clip
        m.mul_(cfg.beta).add_(g32, alpha=1 - cfg.beta)
        v.mul_(cfg.beta).addcmul_(g32, g32, value=1 - cfg.beta)
        if fac is not None:
            _gram_(fac.l, g32, g32.mT, cfg.beta)
            _gram_(fac.r, g32.mT, g32, cfg.beta)
    if needs_refresh(step, cfg):
        refresh_inverses(state, cfg)

    for fac, m, v, master in zip(state.factors, state.m, state.v, state.master):
        direction = m / (torch.sqrt(v) + 1e-8)
        if fac is not None:
            pre = torch.matmul(torch.matmul(fac.linv, m), fac.rinv)
            if cfg.grafting:    # graft Adam's per-tensor step size
                pre_n = torch.linalg.vector_norm(pre)
                adam_n = torch.linalg.vector_norm(direction)
                pre.mul_(adam_n / torch.clamp(pre_n, min=1e-12))
            direction = pre
        master.sub_(direction.add_(master, alpha=cfg.weight_decay), alpha=lr)

    new_params = unflatten(grads, [ma.to(g.dtype) for ma, g in zip(state.master, g_flat)])
    state = state._replace(step=torch.tensor(step, dtype=torch.int32))
    return new_params, state, gnorm
