"""Shared layer primitives: param declaration, norms, rotary, dense MLP.

The port of `repro.models.layers`. Norms, rotary angles and the MLP's
activation run in f32 and cast back, as the reference does; the
projections stay `torch.matmul` in the activation dtype (bf16 operands,
f32 accumulation on the card), as the reference leaves them to XLA.
`mlp_apply_laid_out` is the MLP of the partitioned program
(`parallel.sharding.Program`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..device import DEFAULT_DEVICE, resolve_device
from ..parallel import collectives as col
from ..parallel.sharding import DEFAULT_RULES, Program, ShardingRules, logical_spec, shard

__all__ = ["ParamDef", "init_tree", "abstract_tree", "spec_tree", "norm_apply",
           "norm_params", "rotary", "mlp_params", "mlp_apply", "mlp_apply_laid_out",
           "gathered", "DTYPE", "PARAM_DTYPE", "map_defs"]

DTYPE = torch.bfloat16        # activation dtype
PARAM_DTYPE = torch.bfloat16  # stored parameter dtype


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape + logical axes + initializer scale."""
    shape: tuple[int, ...]
    logical: tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones
    scale: float = 0.02
    dtype: object = None      # defaults to PARAM_DTYPE

    def materialize(self, generator: torch.Generator,
                    device: torch.device) -> torch.Tensor:
        dt = self.dtype or PARAM_DTYPE
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt, device=device)
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x.mul_(self.scale)).to(dt)


def map_defs(defs, fn):
    """Apply `fn` to every ParamDef of a nested dict, in sorted key order
    (the order `jax.tree.flatten` walks the reference's dicts)."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: map_defs(defs[k], fn) for k in sorted(defs)}


def init_tree(defs, generator: torch.Generator,
              device: str | torch.device = DEFAULT_DEVICE):
    """Materialize a nested dict of ParamDefs into tensors on `device`,
    drawing from `generator` (which must live on the same device)."""
    device = resolve_device(device)
    return map_defs(defs, lambda d: d.materialize(generator, device))


def abstract_tree(defs):
    """The tree as tensors on the `meta` device, at their dtypes: shapes
    and dtypes with no allocation (the reference's ShapeDtypeStructs)."""
    return map_defs(defs, lambda d: torch.empty(d.shape, dtype=d.dtype or PARAM_DTYPE,
                                                device="meta"))


def spec_tree(defs, rules: ShardingRules = DEFAULT_RULES, mesh=None):
    """The tree's PartitionSpecs resolved against `mesh`."""
    return map_defs(defs, lambda d: logical_spec(d.shape, d.logical, rules, mesh))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_params(kind: str, d: int) -> dict:
    if kind == "rmsnorm":
        return {"scale": ParamDef((d,), (None,), init="ones")}
    if kind == "layernorm":
        return {"scale": ParamDef((d,), (None,), init="ones"),
                "bias": ParamDef((d,), (None,), init="zeros")}
    if kind == "nonparam_ln":
        return {}
    raise ValueError(f"unknown norm {kind!r}")


def norm_apply(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        rms = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
        out = xf / rms * params["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + 1e-5)
        if kind == "layernorm":
            out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd) with positions (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    # angles: (..., S, 1, half), broadcast over the heads dim
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------


def mlp_params(d: int, f: int, activation: str) -> dict:
    p = {"wi": ParamDef((d, f), ("embed_w", "ffn")),
         "wo": ParamDef((f, d), ("ffn", "embed_w"))}
    if activation == "swiglu":
        p["wg"] = ParamDef((d, f), ("embed_w", "ffn"))
    return p


def mlp_apply(params: dict, x: torch.Tensor, activation: str,
              rules: ShardingRules = DEFAULT_RULES) -> torch.Tensor:
    h = torch.matmul(x, params["wi"])
    if activation == "swiglu":
        g = torch.matmul(x, params["wg"])
        h = F.silu(g.float()).to(x.dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    h = shard(h, "batch", "seq", "ffn", rules=rules)
    return torch.matmul(h, params["wo"])


def gathered(w: col.DistArray, want) -> dict:
    """A laid-out weight at every coordinate under the spec `want`: its
    shards all-gathered over the axes its own spec adds (FSDP's gathers,
    whose backward is the reduce-scatter), cut where `want` splits a dim
    the weight holds whole."""
    return col.to_spec(col.per_coord(w), w.spec, want, w.mesh)


def mlp_apply_laid_out(params: dict, x: dict, activation: str, prog: Program) -> dict:
    """`mlp_apply` in the partitioned program: `params` laid out
    (DistArrays), `x` a coordinate's rows (B_loc, S, d). `wi` and `wg`
    are gathered whole along d and keep the coordinate's `ffn` columns,
    SwiGLU runs in f32 on them, `wo` is gathered whole along d and keeps
    the same rows, and the partial products are summed over the `ffn`
    axis (`psum`: Megatron's row-parallel sum). Each phase runs over every
    coordinate before the next."""
    f = params["wi"].shape[1]
    hshape = (prog.batch, prog.seq, f)
    f_ax = prog.spec(hshape, ("batch", "seq", "ffn"))[2]
    wi = gathered(params["wi"], (None, f_ax))
    h = {c: torch.matmul(t, wi[c]) for c, t in x.items()}
    del wi
    if activation == "swiglu":
        wg = gathered(params["wg"], (None, f_ax))
        g = {c: torch.matmul(t, wg[c]) for c, t in x.items()}
        del wg
        h = {c: F.silu(g[c].float()).to(x[c].dtype) * t for c, t in h.items()}
        del g
    else:
        h = {c: F.gelu(t.float(), approximate="tanh").to(x[c].dtype) for c, t in h.items()}
    h = prog.shard(h, hshape, "batch", "seq", "ffn")
    wo = gathered(params["wo"], (f_ax, None))
    y = {c: torch.matmul(t, wo[c]) for c, t in h.items()}
    return col.psum(y, f_ax, prog.mesh) if f_ax else y
