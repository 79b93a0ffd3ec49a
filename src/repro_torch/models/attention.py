"""Attention: GQA over the full sequence (prefill) and against a KV cache
(decode), full or sliding-window.

The port of `repro.models.attention`. The reference's online-softmax scan
over KV chunks (`_attend_chunked`) becomes one launch of the flash
attention kernel (`kernels/flash_attention`), which walks the KV tiles
inside each block, and with a sliding window only the band's tiles, as
the reference's `_kv_band` walks only the band's chunks; on the CPU the
same call runs the kernel's plain version. When autograd needs the
gradient on the card the call goes through `FlashAttentionFn`, whose
backward is the B6-bwd kernel, which walks the same band; on the CPU
autograd differentiates the plain version. Decode stays plain PyTorch,
as in the reference: one query token against the (B, S, KV, hd) cache,
which rolls (slot pos % S) when it is no longer than the window.

`attn_apply_laid_out` is the attention of the partitioned program
(`parallel.sharding.Program`): each coordinate projects its rows onto its
own heads, attends over them (B6 and B6-bwd on the card at B_loc x
H_loc) and sums its part of the output projection over the heads' axis.
`attn_decode_laid_out` is its decode, plain PyTorch as `attn_decode`,
over a cache laid out by `transformer.cache_specs` (rolling, as
`attn_decode`'s, under a sliding window): where the cache is
split along its sequence, each coordinate scores every query head against
its slice and the slices' softmax combines over that axis (a pmax of the
running max, one psum of the weighted sums).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.registry import ArchConfig
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import attention_ref
from ..parallel import collectives as col
from ..parallel.sharding import DEFAULT_RULES, Program, ShardingRules, shard
from .layers import ParamDef, gathered, rotary

__all__ = ["attn_params", "attn_apply", "attn_apply_laid_out", "attn_decode",
           "attn_decode_laid_out"]

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
               rules: ShardingRules = DEFAULT_RULES,
               q_chunk: int = 0, kv_chunk: int = 0, *, want_kv: bool = False):
    """Full-sequence attention (train / prefill). x: (B, S, d) -> (B, S, d).

    `q_chunk` and `kv_chunk` are the reference scan's tiling hints, taken
    for signature parity; the kernel tiles itself. `rules` resolves the
    reference's sharding constraints on q, k and the output
    (`parallel.sharding.shard`: recorded, nothing moves). With `want_kv` it also
    returns the rotated k and the v it attended over, (B, S, KV, hd)
    each: the prefill cache, the same bits the reference recomputes.
    """
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project(params, x, cfg, positions)
    q = shard(q, "batch", "seq", "heads", None, rules=rules)
    k = shard(k, "batch", "seq", "kv_heads", None, rules=rules)
    # (B, S, H, hd) -> (B, H, S, hd) views: the kernel takes the strides.
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=cfg.causal,
                          window=cfg.sliding_window).transpose(1, 2)
    out = shard(out, "batch", "seq", "heads", None, rules=rules)
    y = torch.matmul(out.reshape(b, s, -1), params["wo"])
    return (y, k, v) if want_kv else y


def _kv_for_heads(k: torch.Tensor, v: torch.Tensor, first: int, n_heads: int,
                  group: int):
    """The KV heads that query heads first .. first + n_heads - 1 read
    (global head g reads KV head g // group), from the whole (B, S, KV,
    hd) k and v: a slice where each of them serves an equal run of those
    heads in order (GQA inside the slice), else one KV head a query head."""
    idx = [(first + h) // group for h in range(n_heads)]
    lo, n = idx[0], idx[-1] - idx[0] + 1
    if n_heads % n == 0 and idx == [lo + h // (n_heads // n) for h in range(n_heads)]:
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def _project_laid_out(params: dict, x: dict, cfg: ArchConfig, prog: Program,
                      positions: dict):
    """Each coordinate's rotated q (B_loc, S, H_loc, hd), rotated k and plain
    v (B_loc, S, KV_loc, hd) at `positions` (B_loc, S), and the heads' and
    KV heads' mesh axes: wq, wk, wv gathered whole along d (FSDP), a
    coordinate keeping the query heads and KV heads its layout gives it
    (the resolved specs of the reference's `shard` sites on q and k)."""
    n_h, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q_shape, k_shape = (prog.batch, prog.seq, n_h, hd), (prog.batch, prog.seq, n_kv, hd)
    h_ax = prog.spec(q_shape, ("batch", "seq", "heads", None))[2]
    kv_ax = prog.spec(k_shape, ("batch", "seq", "kv_heads", None))[2]
    h_loc = n_h // col.axis_size(h_ax, prog.mesh) if h_ax else n_h
    kv_loc = n_kv // col.axis_size(kv_ax, prog.mesh) if kv_ax else n_kv
    w = {name: gathered(params[name], (None, ax))
         for name, ax in (("wq", h_ax), ("wk", kv_ax), ("wv", kv_ax))}
    q, k, v = {}, {}, {}
    for c, t in x.items():
        pos = positions[c]
        q[c] = rotary(_split_heads(torch.matmul(t, w["wq"][c]), h_loc), pos, cfg.rope_theta)
        k[c] = rotary(_split_heads(torch.matmul(t, w["wk"][c]), kv_loc), pos, cfg.rope_theta)
        v[c] = _split_heads(torch.matmul(t, w["wv"][c]), kv_loc)
    del w
    q = prog.shard(q, q_shape, "batch", "seq", "heads", None)
    k = prog.shard(k, k_shape, "batch", "seq", "kv_heads", None)
    if kv_ax is not None and kv_ax != h_ax:
        raise ValueError(f"kv_heads over {kv_ax!r} with heads over {h_ax!r}: the "
                         "partitioned program splits KV heads with the query heads only")
    return q, k, v, h_ax, kv_ax


def attn_apply_laid_out(params: dict, x: dict, cfg: ArchConfig, prog: Program, *,
                        want_kv: bool = False):
    """`attn_apply` in the partitioned program: `params` laid out
    (DistArrays), `x` each coordinate's rows (B_loc, S, d). q, k and v as
    `_project_laid_out` makes them, KV heads that do not split with the
    query heads staying whole, so that each local query head reads its
    global KV head (m·H/M + h reads KV head (m·H/M + h) // (H/KV)).
    Attention: on the card B6 at (B_loc, H_loc, S, hd) (B6-bwd in the
    backward); on the CPU its plain version, for the other processes'
    coordinates too, so that every process records the same graph. The
    output projection's partial sums are summed over the heads' axis
    (`psum`). With `want_kv` it also returns each coordinate's rotated k
    and its v (B_loc, S, KV_loc, hd): the prefill cache."""
    mesh = prog.mesh
    b, s = prog.batch, prog.seq
    positions = {c: torch.arange(s, device=t.device).expand(t.shape[0], s)
                 for c, t in x.items()}
    q, k, v, h_ax, kv_ax = _project_laid_out(params, x, cfg, prog, positions)
    h_loc = cfg.n_heads // col.axis_size(h_ax, mesh) if h_ax else cfg.n_heads
    first = col.axis_index(h_ax, mesh) if h_ax and not kv_ax else None
    attend = attention_ref if mesh.local_device().type == "cpu" else flash_attention
    out = {}
    for c in x:
        kc, vc = k[c], v[c]
        if first is not None:
            kc, vc = _kv_for_heads(kc, vc, first[c] * h_loc, h_loc, cfg.n_heads // cfg.n_kv_heads)
        out[c] = attend(q[c].transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
                        causal=cfg.causal, window=cfg.sliding_window).transpose(1, 2)
    del q
    if not want_kv:
        del k, v
    out = prog.shard(out, (b, s, cfg.n_heads, cfg.head_dim), "batch", "seq", "heads", None)
    wo = gathered(params["wo"], (h_ax, None))
    y = {c: torch.matmul(t.reshape(t.shape[0], t.shape[1], -1), wo[c])
         for c, t in out.items()}
    y = col.psum(y, h_ax, mesh) if h_ax else y
    return (y, k, v) if want_kv else y


def _write_row(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor, lo: int) -> None:
    """Write each row's new entry `new` (B, 1, KV, hd) into `cache` (B,
    S_loc, KV, hd), the slots lo .. lo + S_loc - 1 of the sequence, at slot
    `slot` - lo of the rows whose slot lies among them; the others keep
    theirs."""
    s_loc = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    rel = slot.long() - lo
    at = rel.clamp(0, s_loc - 1)
    fits = ((rel >= 0) & (rel < s_loc))[:, None, None]
    cache[rows, at] = torch.where(fits, new[:, 0], cache[rows, at])


def _partial_softmax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                     lo: int, s_max: int):
    """One query token (B, 1, Hq, hd) against cache slots lo .. lo + S_loc -
    1 (k, v: (B, S_loc, KVq, hd), Hq // KVq query heads a KV head), masked
    by global slot index as `attn_decode` masks: the f32 running max m
    (B, KVq, group), l = Σ exp(s - m) and o = Σ exp(s - m)·v (B, KVq,
    group, hd). A slice whose slots all lie past pos scores NEG_INF
    everywhere: finite, so its m - M underflows to a weight of exactly 0
    where the slices combine (-inf would give NaN)."""
    b, s_loc, n_kv, hd = k.shape
    qg = q.reshape(b, n_kv, -1, hd).float()
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k.float()) * hd ** -0.5
    idx = lo + torch.arange(s_loc, device=q.device)
    valid = (idx[None] <= pos[:, None]) | (pos[:, None] >= s_max)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(-1)
    e = torch.exp(s - m[..., None])
    return m, e.sum(-1), torch.einsum("bgrk,bkgd->bgrd", e, v.float())


def attn_decode_laid_out(params: dict, x: dict, cache_k: col.DistArray,
                         cache_v: col.DistArray, pos: dict, cfg: ArchConfig,
                         prog: Program) -> dict:
    """`attn_decode` in the partitioned program: `params` laid out, `x`
    each coordinate's rows (B_loc, 1, d), `cache_k` / `cache_v` one layer
    of the cache (B, S_dec, KV, hd) laid out by `cache_specs` (written in
    place), `pos` each coordinate's rows' positions (B_loc,).

    q, k and v are projected as in `attn_apply_laid_out`, rotary at pos.
    Where `kv_seq` splits the cache over an axis, a coordinate's slice of
    the sequence holds every KV head, so every query head and the new k
    and v of every KV head are all-gathered over the heads' axis; the
    coordinate whose slice holds a row's slot writes it; each coordinate
    scores every head against its slots (global slot indices, the
    reference's mask), keeping the f32 max m_c, l_c = Σ exp(s - m_c) and
    o_c = Σ exp(s - m_c)·v, and the slices combine over the sequence's
    axis: M = pmax(m_c), then one psum of (o_c, l_c)·exp(m_c - M), o =
    o / l. Where the cache is whole along the sequence (its KV heads laid
    out as k's), the coordinate attends its own heads as `attn_decode`
    does. Each coordinate then takes its own query heads of o and its rows
    of wo, and the partial products are summed over the heads' axis.
    Under a sliding window a cache no longer than the window rolls, as
    `attn_decode`'s: the row goes to slot pos % S_dec, which the
    coordinate whose slice holds that slot writes, and the mask stays the
    reference's on global slot indices; a longer cache decodes without the
    window, as the reference's does."""
    mesh = prog.mesh
    n_h, hd = cfg.n_heads, cfg.head_dim
    s_max = cache_k.shape[1]
    if cfg.sliding_window and s_max <= cfg.sliding_window:
        slot = {c: p.long() % s_max for c, p in pos.items()}      # rolling cache
    else:
        slot = pos
    _, s_ax, kvh_ax, _ = cache_k.spec
    q, k, v, h_ax, kv_ax = _project_laid_out(params, x, cfg, prog,
                                             {c: p[:, None] for c, p in pos.items()})
    h_loc = n_h // col.axis_size(h_ax, mesh) if h_ax else n_h
    first = col.axis_index(h_ax, mesh) if h_ax else None
    if s_ax is not None:
        if kvh_ax is not None:
            raise ValueError(f"a cache split over {s_ax!r} along its sequence and over "
                             f"{kvh_ax!r} along its KV heads")
        if h_ax:
            q = col.all_gather(q, h_ax, 2, mesh)
        if kv_ax:
            k, v = col.all_gather(k, kv_ax, 2, mesh), col.all_gather(v, kv_ax, 2, mesh)
        n = col.axis_size(s_ax, mesh)
        lo = {c: i * (s_max // n) for c, i in col.axis_index(s_ax, mesh).items()}
    elif kvh_ax != kv_ax:
        raise ValueError(f"a cache with KV heads over {kvh_ax!r}, k's over {kv_ax!r}")
    else:
        lo = dict.fromkeys(x, 0)
    ck, cv = col.per_coord(cache_k), col.per_coord(cache_v)
    group = n_h // cfg.n_kv_heads
    parts = {}
    for c in x:
        if mesh.is_local(c):
            _write_row(ck[c], k[c], slot[c], lo[c])
            _write_row(cv[c], v[c], slot[c], lo[c])
        kc, vc = ck[c], cv[c]
        if s_ax is None and h_ax and not kv_ax:
            kc, vc = _kv_for_heads(kc, vc, first[c] * h_loc, h_loc, group)
        parts[c] = _partial_softmax(q[c], kc, vc, pos[c], lo[c], s_max)
    del q, k, v
    if s_ax is None:
        out = {c: o / l[..., None] for c, (_, l, o) in parts.items()}
    else:
        top = col.pmax({c: m for c, (m, _, _) in parts.items()}, s_ax, mesh)
        summed = {}
        for c, (m, l, o) in parts.items():
            w = torch.exp(m - top[c])
            summed[c] = torch.cat([o * w[..., None], (l * w)[..., None]], -1)
        summed = col.psum(summed, s_ax, mesh)
        out = {c: t[..., :hd] / t[..., hd:] for c, t in summed.items()}
        if h_ax:
            out = {c: t.reshape(t.shape[0], n_h, hd).narrow(1, first[c] * h_loc, h_loc)
                   for c, t in out.items()}
    out = {c: t.reshape(t.shape[0], 1, -1, hd).to(x[c].dtype) for c, t in out.items()}
    out = prog.shard(out, (prog.batch, 1, n_h, hd), "batch", "seq", "heads", None)
    wo = gathered(params["wo"], (h_ax, None))
    y = {c: torch.matmul(t.reshape(t.shape[0], 1, -1), wo[c]) for c, t in out.items()}
    return col.psum(y, h_ax, mesh) if h_ax else y


def attn_decode(params: dict, x: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos: torch.Tensor, cfg: ArchConfig,
                rules: ShardingRules = DEFAULT_RULES):
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
