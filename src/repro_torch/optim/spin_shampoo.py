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

On laid-out gradients (`parallel.collectives.DistArray` leaves, the
partitioned step) the state is laid out too: master, m and v by their
parameters' specs, each factor (…, d, d) and its inverse by `factor_spec`
(`data` over the rows and `model` over the columns where they divide d).
The update keeps the reference's order. The clip counts each distinct
region once and m and v move shard by shard, as AdamW's do. Each distinct
region of L (rows R, columns C) is one local product of G's row panels R
and C, and R's of its column panels, fetched where the region lies
("gather"). A refresh damps each factor layer by its trace (the diagonal
tiles' sums, each once), lays it out as the plan's block grid (moving
what the grid's layout wants elsewhere, "reshard"), inverts it by the
mesh-resident recursion (`core.spin.spin_inverse_sharded` on the factor's
mesh, the sharded plan's engine and leaf: B1, B2 and B3 on the card) and
writes the result back into the inverse's regions: no factor is made
whole. The preconditioner L⁻¹·m·R⁻¹ is two products laid out as m, each
region from the panels it needs, and the grafting norms sum each
distinct region once, so every process applies the same scale.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core import spin_inverse_batched, spin_inverse_dense
from ..parallel import collectives as col
from ..parallel.collectives import DistArray
from ..tree import leaves, unflatten
from .adamw import clip_factor, global_norm, next_step, step_count

__all__ = ["SpinShampooConfig", "SpinShampooState", "spin_shampoo_init",
           "spin_shampoo_update", "invert_spd", "refresh_inverses",
           "needs_refresh", "factor_spec"]


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


def _is_matrix(shape, max_dim: int) -> bool:
    """Whether a leaf of `shape` gets Gram factors: (d_in, d_out) or
    stacked (layers, d_in, d_out), every d in [16, max_dim]."""
    return len(shape) in (2, 3) and all(16 <= d <= max_dim for d in shape[-2:])


def spin_shampoo_init(params, cfg: SpinShampooConfig) -> SpinShampooState:
    def factor(p):
        if not _is_matrix(p.shape, cfg.max_factor_dim):
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
    factor one layer at a time (a laid-out one by `_invert_laid_out_`)."""
    for fac in state.factors:
        if fac is None:
            continue
        for f, inv in ((fac.l, fac.linv), (fac.r, fac.rinv)):
            if isinstance(f, DistArray):
                for i in ([None] if len(f.shape) == 2 else range(f.shape[0])):
                    _invert_laid_out_(_layer(f, i), _layer(inv, i), cfg.damping)
            elif f.ndim == 2:
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
    if any(isinstance(g, DistArray) for g in leaves(grads)):
        return _laid_out_update(cfg, grads, state, lr_scale)
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


# ---------------------------------------------------------------------------
# The laid-out state (the partitioned step)
# ---------------------------------------------------------------------------


def factor_spec(shape, mesh) -> tuple:
    """The layout of a (…lead, d, d) Gram factor or its inverse on `mesh`:
    the rows over `data` and the columns over `model` where the axis
    divides d, else whole; the leading dims whole. The block grid's rule
    of `parallel.sharded_blockmatrix` on the dense factor: it reads only
    the mesh's shape (no rules set, no planner), and a mesh's other axes
    (`pod`) hold it whole."""
    sizes = dict(mesh.shape)
    d = shape[-1]

    def axis(name):
        return name if name in sizes and d % sizes[name] == 0 else None

    return (None,) * (len(shape) - 2) + (axis("data"), axis("model"))


def _layer(x: DistArray, i):
    """Layer `i` of a stacked (L, …) array as an array of its own, views
    of x's shards (a shard several coordinates share stays shared); x
    itself for i None."""
    if i is None:
        return x
    views: dict = {}
    shards = {c: views.setdefault(id(t), t[i]) for c, t in x.shards.items()}
    return DistArray(x.shape[1:], x.spec[1:], x.mesh, shards)


def _by_region(shape, spec, mesh, parts, fn, dtype) -> DistArray:
    """An array of `shape` laid out by `spec` whose region r at coordinate
    c is `fn(c, *panels)`, panel k the region `parts[k][1](r)` of the
    array `parts[k][0]`, fetched at c ("gather"; a panel asked for twice
    is fetched once). Made once a distinct region and place, as
    `collectives` makes any laid-out result."""
    def make(c, r):
        got, panels = {}, []
        for x, want in parts:
            reg = want(r)
            key = (id(x), reg)
            if key not in got:
                got[key] = col.fetch(x, reg, c, "gather")
            panels.append(got[key])
        return fn(c, *panels) if mesh.is_local(c) else None

    return col._layout(mesh, tuple(shape), tuple(spec), make, dtype)


def _copy_into_(dst: DistArray, src: DistArray) -> None:
    """dst's shards ← src's, once a distinct tensor, where they differ."""
    done = set()
    for c, t in dst.shards.items():
        s = src.shards[c]
        if s is not t and id(t) not in done:
            t.copy_(s)
            done.add(id(t))


def _gram_laid_out_(acc: DistArray, g: DistArray, beta: float, left: bool) -> None:
    """acc ← β·acc + (1−β)·G·Gᵀ (left) or Gᵀ·G, in place: each distinct
    region (rows R, columns C) from G's row panels R and C (left) or its
    column panels, one local product a region (a stacked leaf batched)."""
    *lead, rows, cols = g.shape

    def panel(span):
        return lambda r: r[:-2] + ((span(r), (0, cols)) if left else ((0, rows), span(r)))

    def fn(c, a, b):
        t = acc.shards[c]
        a, b = (a, b.mT) if left else (a.mT, b)
        _gram_(t, a, b, beta)
        return t

    out = _by_region(acc.shape, acc.spec, acc.mesh,
                     [(g, panel(lambda r: r[-2])), (g, panel(lambda r: r[-1]))], fn,
                     torch.float32)
    _copy_into_(acc, out)


def _matmul_laid_out(a: DistArray, b: DistArray, like: DistArray) -> DistArray:
    """A·B laid out as `like` (A's rows, B's columns): each region from A's
    row panel and B's column panel."""
    return _by_region(
        like.shape, like.spec, like.mesh,
        [(a, lambda r: r[:-1] + ((0, a.shape[-1]),)),
         (b, lambda r: r[:-2] + ((0, b.shape[-2]), r[-1]))],
        lambda c, x, y: torch.matmul(x, y), torch.float32)


def _diagonal_sum(t: torch.Tensor, region) -> torch.Tensor:
    """The sum of the global diagonal's entries inside a (rows, cols) tile."""
    (r0, r1), (c0, c1) = region
    lo, hi = max(r0, c0), min(r1, c1)
    if lo >= hi:
        return torch.zeros((), dtype=torch.float32, device=t.device)
    return torch.diagonal(t[lo - r0:hi - r0, lo - c0:hi - c0]).sum().float()


def _invert_laid_out_(f: DistArray, inv: DistArray, damping: float) -> None:
    """inv ← (f + λ·tr/n·I)⁻¹ for a laid-out (n, n) factor, in place: the
    damped factor laid out as the sharded plan's block grid, inverted by
    `spin_inverse_sharded` on its mesh, written back by inv's layout."""
    from ..core.spin import spin_inverse_sharded
    from ..parallel.sharded_blockmatrix import ShardedBlockMatrix
    from ..planner import get_plan

    mesh, n = f.mesh, f.shape[-1]
    trace = sum(col.region_values([f], _diagonal_sum))
    lam = damping * (trace / n + 1e-12)
    plan = get_plan("inverse", n, torch.float32, measure=False, placement="sharded",
                    backend=f.device.type)
    bs = plan.block_size
    grid = n // bs

    def damped(c, r):
        (g0, g1), (h0, h1) = r[0], r[1]
        dense = col.fetch(f, ((g0 * bs, g1 * bs), (h0 * bs, h1 * bs)), c, "reshard")
        if dense is None:
            return None
        d = dense.to(torch.float32, copy=True)
        lo, hi = max(g0, h0) * bs, min(g1, h1) * bs
        if lo < hi:
            torch.diagonal(d[lo - g0 * bs:hi - g0 * bs, lo - h0 * bs:hi - h0 * bs]).add_(
                col._on(lam, d.device))
        return d.view(g1 - g0, bs, h1 - h0, bs).permute(0, 2, 1, 3)

    blocks = col._layout(mesh, (grid, grid, bs, bs), col.grid_spec(grid, grid, mesh),
                         damped, torch.float32)
    out = spin_inverse_sharded(ShardedBlockMatrix(blocks), leaf_solver=plan.leaf_solver,
                               engine=plan.multiply_engine)
    _copy_into_(inv, col.grid_to_panel(out.dist, inv.spec))


def _laid_out_update(cfg: SpinShampooConfig, grads, state: SpinShampooState,
                     lr_scale=1.0):
    """`spin_shampoo_update` on laid-out gradients and state (the module
    docstring): the reference's order, each region at its coordinates."""
    step = step_count(state.step) + 1
    gnorm = global_norm(grads)
    clip = clip_factor(gnorm, cfg.grad_clip)
    lr = float(np.float32(cfg.lr) * np.float32(lr_scale))
    g_flat = leaves(grads)
    b = cfg.beta

    for g, fac, m, v in zip(g_flat, state.factors, state.m, state.v):
        g32 = col.zip_map(lambda t: t.float() * col._on(clip, t.device), g)
        col.zip_map(lambda mt, gt: mt.mul_(b).add_(gt, alpha=1 - b), m, g32)
        col.zip_map(lambda vt, gt: vt.mul_(b).addcmul_(gt, gt, value=1 - b), v, g32)
        if fac is not None:
            _gram_laid_out_(fac.l, g32, b, left=True)
            _gram_laid_out_(fac.r, g32, b, left=False)
        del g32
    if needs_refresh(step, cfg):
        refresh_inverses(state, cfg)

    def sum_sq(t, _region):
        return torch.sum(t ** 2)

    for fac, m, v, master in zip(state.factors, state.m, state.v, state.master):
        direction = col.zip_map(lambda mt, vt: mt / (torch.sqrt(vt) + 1e-8), m, v)
        if fac is not None:
            pre = _matmul_laid_out(_matmul_laid_out(fac.linv, m, m), fac.rinv, m)
            if cfg.grafting:    # graft Adam's per-tensor step size
                pre_n = torch.sqrt(sum(col.region_values([pre], sum_sq)))
                adam_n = torch.sqrt(sum(col.region_values([direction], sum_sq)))
                scale = adam_n / torch.clamp(pre_n, min=1e-12)
                col.zip_map(lambda t: t.mul_(col._on(scale, t.device)), pre)
            direction = pre
        col.zip_map(lambda ma, d: ma.sub_(d.add_(ma, alpha=cfg.weight_decay), alpha=lr),
                    master, direction)

    new_params = unflatten(grads, [col.zip_map(lambda ma, gt: ma.to(gt.dtype), ma, g)
                                   for ma, g in zip(state.master, g_flat)])
    state = state._replace(step=next_step(state.step, step))
    return new_params, state, gnorm
