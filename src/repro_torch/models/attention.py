"""Attention: GQA over the full sequence (prefill) and against a KV cache
(decode), full or sliding-window.

The port of `repro.models.attention`. The reference's online-softmax scan
over KV chunks (`_attend_chunked`) becomes one launch of the flash
attention kernel (`kernels/flash_attention`), which walks the KV tiles
inside each block, and with a sliding window only the band's tiles, as
the reference's `_kv_band` walks only the band's chunks; on the CPU the
same call runs the kernel's plain version. When autograd needs the
gradient on the card the call goes through `FlashAttentionFn`, whose
backward is the B6-bwd kernel (no window yet: it raises); on the CPU
autograd differentiates the plain version. Decode stays plain PyTorch,
as in the reference: one query token against the (B, S, KV, hd) cache,
which rolls (slot pos % S) when it is no longer than the window.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.registry import ArchConfig
from ..kernels.flash_attention.ops import flash_attention
from .layers import ParamDef, rotary

__all__ = ["attn_params", "attn_apply", "attn_decode"]

NEG_INF = -1e30


def attn_params(cfg: ArchConfig) -> dict:
    d, q = cfg.d_model, cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    return {
        "wq": ParamDef((d, q), ("embed_w", "heads")),
        "wk": ParamDef((d, kv), ("embed_w", "kv_heads")),
        "wv": ParamDef((d, kv), ("embed_w", "kv_heads")),
        "wo": ParamDef((q, d), ("heads", "embed_w")),
    }


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1)


def _project(params: dict, x: torch.Tensor, cfg: ArchConfig,
             positions: torch.Tensor):
    """Rotated q (B, S, H, hd), rotated k and plain v (B, S, KV, hd)."""
    q = _split_heads(torch.matmul(x, params["wq"]), cfg.n_heads)
    k = _split_heads(torch.matmul(x, params["wk"]), cfg.n_kv_heads)
    v = _split_heads(torch.matmul(x, params["wv"]), cfg.n_kv_heads)
    return (rotary(q, positions, cfg.rope_theta),
            rotary(k, positions, cfg.rope_theta), v)


def attn_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
               positions: Optional[torch.Tensor] = None,
               q_chunk: int = 0, kv_chunk: int = 0, *, want_kv: bool = False):
    """Full-sequence attention (train / prefill). x: (B, S, d) -> (B, S, d).

    `q_chunk` and `kv_chunk` are the reference scan's tiling hints, taken
    for signature parity; the kernel tiles itself. With `want_kv` it also
    returns the rotated k and the v it attended over, (B, S, KV, hd)
    each: the prefill cache, the same bits the reference recomputes.
    """
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project(params, x, cfg, positions)
    # (B, S, H, hd) -> (B, H, S, hd) views: the kernel takes the strides.
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=cfg.causal,
                          window=cfg.sliding_window)
    y = torch.matmul(out.transpose(1, 2).reshape(b, s, -1), params["wo"])
    return (y, k, v) if want_kv else y


def attn_decode(params: dict, x: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos: torch.Tensor, cfg: ArchConfig):
    """One-token decode. x: (B, 1, d); cache_{k,v}: (B, S, KV, hd); pos:
    (B,) current position. Returns (out, cache_k, cache_v).

    The new k, v row is written into the cache in place (the reference
    returns new arrays, which its jitted callers donate): at slot
    pos % S when the config has a sliding window and S <= window (a
    rolling cache), else at slot pos. Where pos >= S every slot counts as
    valid, and a cache that does not roll is not written, as the
    reference's one-hot write and mask do. A cache longer than the window
    attends to every written slot, without the window, as the reference
    does (`init_cache` never builds one).
    """
    b = x.shape[0]
    s_max = cache_k.shape[1]
    q, k, v = _project(params, x, cfg, pos[:, None])

    rows = torch.arange(b, device=x.device)
    if cfg.sliding_window and s_max <= cfg.sliding_window:
        slot = pos.long() % s_max                        # rolling cache
        cache_k[rows, slot] = k[:, 0]
        cache_v[rows, slot] = v[:, 0]
    else:
        slot = pos.long().clamp(max=s_max - 1)
        fits = (pos < s_max)[:, None, None]
        cache_k[rows, slot] = torch.where(fits, k[:, 0], cache_k[rows, slot])
        cache_v[rows, slot] = torch.where(fits, v[:, 0], cache_v[rows, slot])

    n_kv, hd = cfg.n_kv_heads, cfg.head_dim
    group = cfg.n_heads // n_kv
    qg = q.reshape(b, n_kv, group, hd).float()
    s = torch.einsum("bgrd,bkgd->bgrk", qg, cache_k.float()) * hd ** -0.5
    kv_idx = torch.arange(s_max, device=x.device)
    valid = (kv_idx[None] <= pos[:, None]) | (pos[:, None] >= s_max)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p, cache_v.float())
    out = out.reshape(b, 1, cfg.n_heads * hd).to(x.dtype)
    return torch.matmul(out, params["wo"]), cache_k, cache_v
