"""Plain PyTorch versions of the flash attention kernels."""

from __future__ import annotations

import torch

__all__ = ["attention_ref", "attention_bwd_ref"]

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Naive full-softmax attention in f32, cast to q's dtype.
    q: (B, H, Sq, hd); k, v: (B, KV, Skv, hd), H a multiple of KV."""
    hd = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * hd ** -0.5
    if causal:
        i = torch.arange(q.shape[2], device=q.device)[:, None]
        j = torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(i >= j, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, *, causal: bool = True):
    """(dq, dk, dv) of `attention_ref` at (q, k, v) against the output
    gradient `do`: `torch.autograd.grad` through the plain version, in the
    operands' dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_ref(*leaves, causal=causal)
        return torch.autograd.grad(out, leaves, do)
