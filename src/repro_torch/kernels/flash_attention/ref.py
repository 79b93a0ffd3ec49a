"""Plain PyTorch versions of the flash attention kernels."""

from __future__ import annotations

import torch

__all__ = ["attention_ref", "attention_mask", "attention_bwd_ref",
           "attention_bwd_rounded_ref"]

NEG_INF = -1e30


def attention_mask(sq: int, skv: int, causal: bool, window: int,
                   device) -> torch.Tensor | None:
    """(Sq, Skv) bool, True where query i sees key j: i >= j when causal,
    and i - j < window when window > 0 (the reference's `_chunk_mask`);
    None when every pair is live."""
    if not causal and not window:
        return None
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(skv, device=device)[None, :]
    ok = i >= j if causal else torch.ones((sq, skv), dtype=torch.bool, device=device)
    return ok & (i - j < window) if window else ok


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """Naive full-softmax attention in f32, cast to q's dtype.
    q: (B, H, Sq, hd); k, v: (B, KV, Skv, hd), H a multiple of KV. A
    `window` > 0 keeps the pairs 0 <= i - j < window; masked scores are
    -1e30, as in the reference."""
    hd = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * hd ** -0.5
    mask = attention_mask(q.shape[2], k.shape[2], causal, window, q.device)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, *, causal: bool = True, window: int = 0):
    """(dq, dk, dv) of `attention_ref` at (q, k, v) against the output
    gradient `do`: `torch.autograd.grad` through the plain version, in the
    operands' dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_ref(*leaves, causal=causal, window=window)
        return torch.autograd.grad(out, leaves, do)


def attention_bwd_rounded_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              do: torch.Tensor, *, causal: bool = True,
                              out: torch.Tensor | None = None):
    """(dq, dk, dv) as the tensor-core backward kernels compute them, in
    plain torch: P = exp(S - lse) and dS = P o (dP - D) in f32, rounded to
    the operands' dtype before the dV += Pᵀ dO, dK += dSᵀ Q and dQ += dS K
    products; D = rowsum(dO o O) of the rounded output O; every sum in f32.
    `out` is that O, the forward's output as the kernels are handed it (by
    default `attention_ref`'s). Returned in f32, before the kernels' one
    rounding of each gradient, so that a comparison sees that rounding
    alone. In f32 it is the exact gradient, as `attention_bwd_ref`."""
    dtype, hd = q.dtype, q.shape[-1]
    b, n_kv, skv = k.shape[:3]
    group = q.shape[1] // n_kv
    scale = hd ** -0.5
    qf, dof = q.float(), do.float()
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kk) * scale
    if causal:
        i = torch.arange(q.shape[2], device=q.device)[:, None]
        j = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(i < j, float("-inf"))
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    if out is None:
        out = attention_ref(q, k, v, causal=causal)
    d = (dof * out.float()).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vv) - d)
    p, ds = p.to(dtype).float(), ds.to(dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    # the group's query heads sum into their kv head
    dk = dk.view(b, n_kv, group, skv, hd).sum(2)
    dv = dv.view(b, n_kv, group, skv, hd).sum(2)
    return dq, dk, dv
