"""Shared layer primitives: param declaration, norms, rotary, dense MLP.

The port of `repro.models.layers`. Norms, rotary angles and the MLP's
activation run in f32 and cast back, as the reference does; the
projections stay `torch.matmul` in the activation dtype (bf16 operands,
f32 accumulation on the card), as the reference leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["ParamDef", "init_tree", "norm_apply", "norm_params", "rotary",
           "mlp_params", "mlp_apply", "DTYPE", "PARAM_DTYPE", "map_defs"]

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


def mlp_apply(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    h = torch.matmul(x, params["wi"])
    if activation == "swiglu":
        g = torch.matmul(x, params["wg"])
        h = F.silu(g.float()).to(x.dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return torch.matmul(h, params["wo"])
