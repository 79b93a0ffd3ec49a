"""Model assembly for all six families: a loop over stacked layers.

The port of `repro.models.transformer` for training and serving the LM
families: dense (granite, olmo, stablelm), MoE (qwen2-moe, dbrx), SSM
(mamba2), hybrid (hymba: attention with a sliding window and SSD heads in
parallel on one norm), audio (hubert: frame embeddings, encoder-only) and
VLM (phi-3-vision: patch embeddings before the text). Parameters are
declared and stacked (L, ...) per layer exactly as in the reference, so
weights carry across one to one (`repro_torch.bridge.lm_params_from_numpy`).
`forward` runs a Python loop over the layers; the reference's
`jax.lax.scan` exists for compile time, which PyTorch does not pay.

`forward` takes one of two paths, by what it is given:
  * training, when autograd is recording and a parameter requires grad:
    each layer under `torch.utils.checkpoint` (non-reentrant) with
    remat=True, saving only the residual stream ("full") or also the
    matrix products' outputs ("dots", selective checkpointing), as the
    reference's `jax.checkpoint` policies do; attention goes through
    `FlashAttentionFn` on the card (B6 forward, B6-bwd backward, both
    with the sliding window and at every config's head dim);
  * inference otherwise, under `torch.inference_mode()`, which `prefill`
    and `decode_step` always take; remat does not apply.
Both give the same logits for the same parameters.

Under an ambient mesh (`launch.mesh.set_mesh`) every entry point takes
the reference's `rules`: the activations keep the global view and each
`shard` site records its resolved layout (`parallel.sharding`), while
the embedding lookup and MoE run their per-coordinate programs. The
training forward carries the mesh into each checkpointed layer, since
its recompute runs on autograd's worker thread on the card, where the
ambient mesh is not set.

On a laid-out state (parameters that are `parallel.collectives.DistArray`s,
as `checkpoint.ckpt.restore(shardings=)` or `parallel.sharding.lay_out`
give them by `param_specs`) `forward` and `loss_fn` run the partitioned
program, the counterpart of the reference's `jax.jit(...,
in_shardings=...)` under its rules (`parallel.sharding.Program`): the
batch is laid out by its rows over the batch axes, and each coordinate
holds and computes only its own shards. The embedding and the layers'
weights are gathered along their FSDP dimension as a layer needs them
(`layers.gathered`), attention and the MLP run on the coordinate's heads
and ffn columns and sum their output projections over that axis, the
head makes the coordinate's vocabulary columns of the f32 logits, and
the cross-entropy is vocabulary-parallel: the row max a `pmax` of
detached logits, the sum of exponentials and the label's logit `psum`s
over the vocabulary's axis, the loss and token sums `psum`s over the
batch axes. `prefill` on laid-out parameters is the counterpart of the
reference's jitted `build_prefill`: its cache comes back laid out by
`cache_specs(cfg, B, S)` (`kv_seq` over `model`, so a coordinate holds
its rows and one slice of the sequence with every KV head), each layer's
k and v moved there from the KV heads' axis by one all_to_all where the
KV heads split with the query heads, cut where they are whole; where
`model` does not divide S the cache lies as k does. `pad_cache` takes it
to the decode length, region by region, as the reference's caller does.
`decode_step` on laid-out parameters and that cache (`build_decode`)
runs the lookup, each layer (`attention.attn_decode_laid_out`: the
cache written in place, a softmax split over the `kv_seq` slices) and
the head per coordinate. An MoE layer runs `moe.moe_apply_laid_out` (the
expert-parallel region on laid-out experts) where the dense one runs its
MLP, and its aux and z are summed over the layers into the loss, as the
reference's scan sums them. An SSM layer (mamba2) runs
`ssm.ssm_apply_laid_out` on `ssm_norm`, a hybrid one (hymba) attention
and the SSD heads in parallel on `attn_norm`, mean-combined; the prefill
writes each coordinate's `ssm_h` (its SSD heads) and `ssm_conv` regions,
and the decode updates them in place (`ssm.ssm_decode_laid_out`) beside a
rolling k and v cache under the sliding window. The audio body (hubert)
takes each coordinate's frame embeddings, `mask_embed` (held by every
coordinate) where its frames are masked, attends bidirectionally and
scores the masked frames alone; the VLM body (phi-3-vision) puts each
coordinate's patch stubs before its text's vocabulary-parallel lookup,
so the program's sequence, its prefill cache and the decode's positions
count the patches, whose positions carry no label. A decode step of any
family looks up its one token. Nothing is made whole but the joined
results: the loss, its metrics, and the logits. All six families.

Entry points:
  param_defs / init_params / abstract_params / param_specs
  forward(...)            logits, MoE aux losses (+ prefill cache)
  loss_fn(...)            next-token CE (masked-frame CE for audio) + aux
  prefill(...)            forward with the cache
  init_cache / abstract_cache / cache_specs / pad_cache / decode_step
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils import checkpoint as torch_checkpoint

from ..configs.registry import ArchConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..launch.mesh import current_mesh, set_mesh
from ..parallel import collectives as col
from ..parallel.collectives import DistArray
from ..parallel.sharding import DEFAULT_RULES, Program, ShardingRules, logical_spec, shard
from ..tree import leaves
from . import attention, moe as moe_mod, ssm as ssm_mod
from .embedding import embed_lookup, embed_lookup_laid_out
from .layers import (DTYPE, ParamDef, abstract_tree, gathered, init_tree, map_defs,
                     mlp_apply, mlp_apply_laid_out, mlp_params, norm_apply, norm_params,
                     spec_tree)

__all__ = ["param_defs", "init_params", "abstract_params", "param_specs",
           "forward", "loss_fn", "prefill", "init_cache", "abstract_cache",
           "cache_specs", "pad_cache", "decode_step", "is_laid_out", "REMAT_POLICIES"]


# ---------------------------------------------------------------------------
# Parameter declaration
# ---------------------------------------------------------------------------


def _layer_defs(cfg: ArchConfig, model_size_hint: int) -> dict:
    d = cfg.d_model
    p: dict = {}
    if not cfg.attn_free:
        p["attn"] = attention.attn_params(cfg)
        p["attn_norm"] = norm_params(cfg.norm, d)
    if cfg.ssm is not None:
        p["ssm"] = ssm_mod.ssm_params(cfg)
        if cfg.attn_free:
            p["ssm_norm"] = norm_params(cfg.norm, d)
    if cfg.d_ff:
        p["mlp"] = mlp_params(d, cfg.d_ff, cfg.activation)
        p["mlp_norm"] = norm_params(cfg.norm, d)
    if cfg.moe is not None:
        p["moe"] = moe_mod.moe_params(cfg, model_size_hint)
        p["moe_norm"] = norm_params(cfg.norm, d)
    return p


def param_defs(cfg: ArchConfig, model_size_hint: int = 16) -> dict:
    """The parameter tree, key for key and shape for shape the reference's;
    `model_size_hint` pads the MoE expert count to its multiple."""
    d = cfg.d_model

    def stack(p: ParamDef) -> ParamDef:
        return dataclasses.replace(p, shape=(cfg.n_layers, *p.shape),
                                   logical=("layers", *p.logical))

    defs: dict = {
        "embed": ParamDef((cfg.vocab, d), ("vocab", "embed_w")),
        "layers": map_defs(_layer_defs(cfg, model_size_hint), stack),
        "final_norm": norm_params(cfg.norm, d),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, cfg.vocab), ("embed_w", "vocab"))
    if cfg.family == "audio":
        defs["mask_embed"] = ParamDef((d,), (None,))
    return defs


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: str | torch.device = DEFAULT_DEVICE,
                model_size_hint: int = 16) -> dict:
    """Random weights from `generator` (a generator on `device`)."""
    return init_tree(param_defs(cfg, model_size_hint), generator, device)


def abstract_params(cfg: ArchConfig, model_size_hint: int = 16) -> dict:
    """The parameters as `meta` tensors: shapes and dtypes, no allocation."""
    return abstract_tree(param_defs(cfg, model_size_hint))


def param_specs(cfg: ArchConfig, rules: ShardingRules = DEFAULT_RULES,
                mesh=None, model_size_hint: int = 16) -> dict:
    """The parameters' PartitionSpecs on `mesh` (default: the ambient one)."""
    return spec_tree(param_defs(cfg, model_size_hint), rules, mesh)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer(tree: dict, i: int) -> dict:
    """Layer i's slice of the stacked (L, ...) parameters or cache."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _norm(cfg: ArchConfig, params: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return norm_apply(cfg.norm, params.get(name, {}), x)


def _logits(params: dict, x: torch.Tensor, cfg: ArchConfig,
            rules: ShardingRules = DEFAULT_RULES) -> torch.Tensor:
    """f32 logits of bf16 operands: upcast, multiply, keep f32 (the
    reference's `preferred_element_type=jnp.float32`)."""
    x = norm_apply(cfg.norm, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x.float(), head.float())
    return shard(logits, "batch", "seq", "vocab", rules=rules)


REMAT_POLICIES = ("full", "dots")

# Ops whose outputs the "dots" policy keeps: the projections, which the
# reference's `dots_with_no_batch_dims_saveable` keeps (a (B, S, d) @ (d, k)
# product is one 2-D `mm`; attention's batched products are not kept).
_SAVED_DOTS = (torch.ops.aten.mm.default,)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _unstack(tree: dict, n: int) -> list[dict]:
    """The stacked (L, ...) parameters as L per-layer dicts, by `unbind`,
    whose backward stacks the L gradients once."""
    out: list[dict] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
        for i in range(n):
            out[i][k] = parts[i]
    return out


def _zero(x) -> torch.Tensor:
    """A 0-dim f32 zero on `x`'s device (or on the device `x`)."""
    return torch.zeros((), dtype=torch.float32,
                       device=x.device if isinstance(x, torch.Tensor) else x)


def _layer_fwd(cfg: ArchConfig, lp: dict, x: torch.Tensor, positions: torch.Tensor,
               want_cache: bool = False, rules: ShardingRules = DEFAULT_RULES):
    """One layer of any family: (x, aux, z, cache slice). aux and z are the
    MoE losses (0-dim f32, zero without MoE); the cache slice holds the
    layer's k, v (B, S, KV, hd) and SSM state when `want_cache`."""
    aux = z = _zero(x)
    cache: dict = {}
    if not cfg.attn_free:
        h = _norm(cfg, lp, "attn_norm", x)
        a_out = attention.attn_apply(lp["attn"], h, cfg, positions, rules,
                                     want_kv=want_cache)
        if want_cache:
            a_out, cache["k"], cache["v"] = a_out
        if cfg.family == "hybrid":
            # attention and SSD heads in parallel on the same norm, mean-combined
            s_out, st = ssm_mod.ssm_apply(lp["ssm"], h, cfg, rules)
            x = x + 0.5 * (a_out + s_out)
            if want_cache:
                cache["ssm_h"], cache["ssm_conv"] = st.h, st.conv
        else:
            x = x + a_out
    if cfg.ssm is not None and cfg.family != "hybrid":
        h = _norm(cfg, lp, "ssm_norm", x)
        s_out, st = ssm_mod.ssm_apply(lp["ssm"], h, cfg, rules)
        x = x + s_out
        if want_cache:
            cache["ssm_h"], cache["ssm_conv"] = st.h, st.conv
    if cfg.d_ff:
        h = _norm(cfg, lp, "mlp_norm", x)
        x = x + mlp_apply(lp["mlp"], h, cfg.activation, rules)
    if cfg.moe is not None:
        h = _norm(cfg, lp, "moe_norm", x)
        m_out, aux, z = moe_mod.moe_apply(lp["moe"], h, cfg, rules)
        x = x + m_out
    x = shard(x, "batch", "seq", "embed", rules=rules)
    return x, aux, z, cache


def _train_layer(cfg: ArchConfig, rules: ShardingRules, mesh, lp: dict, x: torch.Tensor,
                 positions: torch.Tensor):
    # `mesh` comes in explicitly: a checkpointed layer's recompute runs on
    # autograd's worker thread on the card, which has no ambient mesh
    with set_mesh(mesh):
        return _layer_fwd(cfg, lp, x, positions, rules=rules)[:3]


def _embed_inputs(params: dict, batch: dict, cfg: ArchConfig,
                  rules: ShardingRules = DEFAULT_RULES):
    """Token or frontend embedding: (x (B, S, d) in DTYPE, positions)."""
    if cfg.family == "audio":
        x = batch["frame_embeds"].to(DTYPE)            # the frontend's stub output
        x = torch.where(batch["mask"][..., None], params["mask_embed"].to(DTYPE), x)
    elif cfg.family == "vlm":
        txt = embed_lookup(params["embed"], batch["tokens"]).to(DTYPE)
        img = batch["patch_embeds"].to(DTYPE)          # (B, P, d) patch stub
        x = torch.cat([img, txt], dim=1)
    else:
        x = embed_lookup(params["embed"], batch["tokens"]).to(DTYPE)
    b, s, _ = x.shape
    x = shard(x, "batch", "seq", "embed", rules=rules)
    return x, torch.arange(s, device=x.device).expand(b, s)


def _tracks_grad(params: dict) -> bool:
    return torch.is_grad_enabled() and any(
        any(s.requires_grad for s in t.shards.values()) if isinstance(t, DistArray)
        else t.requires_grad for t in leaves(params))


def _train_forward(params: dict, batch: dict, cfg: ArchConfig, rules: ShardingRules,
                   remat: bool, remat_policy: str):
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}; want one of "
                         f"{REMAT_POLICIES}")
    x, positions = _embed_inputs(params, batch, cfg, rules)
    mesh = current_mesh()
    context_fn = torch_checkpoint.noop_context_fn
    if remat_policy == "dots":
        context_fn = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, _dots_policy)
    aux = z = _zero(x)
    for lp in _unstack(params["layers"], cfg.n_layers):
        if remat:
            x, a, zz = torch_checkpoint.checkpoint(_train_layer, cfg, rules, mesh, lp, x,
                                                   positions, use_reentrant=False,
                                                   context_fn=context_fn)
        else:
            x, a, zz = _train_layer(cfg, rules, mesh, lp, x, positions)
        aux, z = aux + a, z + zz
    return _logits(params, x, cfg, rules), aux, z, None


def forward(params: dict, batch: dict, cfg: ArchConfig,
            rules: ShardingRules = DEFAULT_RULES, *,
            want_cache: bool = False, remat: bool = True,
            remat_policy: str = "full"):
    """Full-sequence forward. The batch holds "tokens" (B, S); audio gives
    "frame_embeds" (B, S, d) and "mask" (B, S) instead, VLM "patch_embeds"
    (B, P, d) before its tokens. Returns (logits (B, S, V) f32, aux, z,
    cache | None): aux and z are the MoE losses summed over the layers
    (zero for the other families). The cache holds k, v (L, B, S, KV, hd),
    the SSM state (ssm_h (L, B, H, N, P) f32, ssm_conv (L, B, k - 1,
    conv_dim)) where the family has them, and pos = S.

    With autograd recording and a parameter requiring grad this is the
    training forward (see the module docstring); `remat` and
    `remat_policy` ("full" | "dots") choose what the backward recomputes.
    Otherwise it runs under `torch.inference_mode()`.

    On laid-out parameters it runs the partitioned program and returns
    the logits joined whole (training when autograd records and the
    parameters' shards require grad, as `laid_out_region` enters them)."""
    if want_cache and _tracks_grad(params):
        raise ValueError("the prefill cache comes from the inference "
                         "forward; call prefill without grad")
    if is_laid_out(params):
        if want_cache:
            return _prefill_laid_out(params, batch, cfg, rules)
        train = _tracks_grad(params)
        with torch.set_grad_enabled(train):
            prog, parts = _program(params, batch, cfg, rules)
            logits, spec, aux, z = _forward_laid_out(params, parts, cfg, prog,
                                                     remat and train, remat_policy)
            return (col.join(logits, spec, prog.mesh), *_joined_losses(aux, z, prog.mesh),
                    None)
    if _tracks_grad(params):
        return _train_forward(params, batch, cfg, rules, remat, remat_policy)
    with torch.inference_mode():
        x, positions = _embed_inputs(params, batch, cfg, rules)
        b, s, _ = x.shape
        cache = _empty_cache(cfg, b, s, x.device, torch.empty) if want_cache else None
        aux = z = _zero(x)
        for i in range(cfg.n_layers):
            x, a, zz, layer_cache = _layer_fwd(cfg, _layer(params["layers"], i), x,
                                               positions, want_cache, rules)
            aux, z = aux + a, z + zz
            for key, val in layer_cache.items():
                cache[key][i] = val
        logits = _logits(params, x, cfg, rules)
        if want_cache:
            cache["pos"].fill_(s)
        return logits, aux, z, cache


def loss_fn(params: dict, batch: dict, cfg: ArchConfig,
            rules: ShardingRules = DEFAULT_RULES, *,
            aux_weight: float = 0.01, z_weight: float = 1e-3,
            remat: bool = True, remat_policy: str = "full"):
    """Next-token cross-entropy of the logits against batch["labels"] (B,
    S); labels < 0 carry no loss. VLM labels cover the text only (the image
    prefix takes -1); audio scores the masked frames only. Returns (total =
    ce + aux_weight·aux + z_weight·z, {"ce", "aux", "z", "tokens"}), 0-dim
    f32 tensors. The log-likelihood is picked by `gather`, one index a row,
    so its backward writes each entry once: on the card the gradient has
    the same bits on every run. On laid-out parameters the partitioned
    program computes it vocabulary-parallel (module docstring) and every
    value comes back joined."""
    if is_laid_out(params):
        return _loss_laid_out(params, batch, cfg, rules, aux_weight, z_weight, remat,
                              remat_policy)
    logits, aux, z, _ = forward(params, batch, cfg, rules, remat=remat,
                                remat_policy=remat_policy)
    labels = batch["labels"]
    if cfg.family == "vlm":
        pad = torch.full(batch["patch_embeds"].shape[:2], -1, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    mask = labels >= 0
    if cfg.family == "audio":
        mask = mask & batch["mask"]
    safe = labels.clamp(min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    token_ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    n_tokens = mask.sum()
    ce = -torch.where(mask, token_ll, 0.0).sum() / n_tokens.clamp(min=1)
    total = ce + aux_weight * aux + z_weight * z
    return total, {"ce": ce, "aux": aux, "z": z,
                   "tokens": n_tokens.to(torch.float32)}


def prefill(params: dict, batch: dict, cfg: ArchConfig,
            rules: ShardingRules = DEFAULT_RULES):
    """Prefill forward: logits + populated cache (inference). The k, v
    cache covers the whole prompt, also where a sliding window makes
    `init_cache` roll: to decode past the prompt, pad its S axis to the
    decode length first (a cache no longer than the window rolls; a longer
    one attends without the window, as in the reference).

    On laid-out parameters (a config of any family) the logits come back
    joined and the cache laid out by `cache_specs(cfg, B, S,
    rules)`, DistArrays each coordinate of which holds only its region;
    `pad_cache` takes it to the decode length, laid out by `cache_specs`
    at that length, which `decode_step` then runs over."""
    return forward(params, batch, cfg, rules, want_cache=True)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _empty_cache(cfg: ArchConfig, batch: int, kv_len: int, device: torch.device,
                 alloc) -> dict:
    """The cache's tensors, made by `alloc` (torch.zeros or torch.empty):
    pos (B,) int32; k, v (L, B, kv_len, KV, hd); ssm_h (L, B, H, N, P)
    f32 and ssm_conv (L, B, k - 1, conv_dim), as the reference's
    `_cache_defs` lays them out."""
    l = cfg.n_layers
    out = {"pos": alloc((batch,), dtype=torch.int32, device=device)}
    if not cfg.attn_free:
        shape = (l, batch, kv_len, cfg.n_kv_heads, cfg.head_dim)
        out["k"] = alloc(shape, dtype=DTYPE, device=device)
        out["v"] = alloc(shape, dtype=DTYPE, device=device)
    if cfg.ssm is not None:
        di, h, p, n, conv_dim = ssm_mod._dims(cfg)
        out["ssm_h"] = alloc((l, batch, h, n, p), dtype=torch.float32, device=device)
        out["ssm_conv"] = alloc((l, batch, cfg.ssm.d_conv - 1, conv_dim), dtype=DTYPE,
                                device=device)
    return out


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Zeroed decode cache, the reference's `init_cache`: pos (B,) int32;
    k and v (L, B, S, KV, hd) with S = min(seq_len, window) under a sliding
    window (a rolling cache); ssm_h and ssm_conv where the family has an
    SSM."""
    device = resolve_device(device)
    return _empty_cache(cfg, batch, _kv_len(cfg, seq_len), device, torch.zeros)


def _kv_len(cfg: ArchConfig, seq_len: int) -> int:
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len


def abstract_cache(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """`init_cache`'s tensors on the `meta` device: no allocation."""
    return _empty_cache(cfg, batch, _kv_len(cfg, seq_len), torch.device("meta"),
                        torch.empty)


_CACHE_LOGICAL = {"pos": ("batch",),
                  "k": ("layers", "batch", "kv_seq", "kv_heads", None),
                  "v": ("layers", "batch", "kv_seq", "kv_heads", None),
                  "ssm_h": ("layers", "batch", "ssm_inner", None, None),
                  "ssm_conv": ("layers", "batch", None, None)}


def cache_specs(cfg: ArchConfig, batch: int, seq_len: int,
                rules: ShardingRules = DEFAULT_RULES, mesh=None) -> dict:
    """The decode cache's PartitionSpecs on `mesh` (default: the ambient
    one), the reference's logical layout."""
    return _specs_of(abstract_cache(cfg, batch, seq_len), rules, mesh)


def _specs_of(cache: dict, rules: ShardingRules, mesh) -> dict:
    return {k: logical_spec(tuple(v.shape), _CACHE_LOGICAL[k], rules, mesh)
            for k, v in cache.items()}


def pad_cache(cache: dict, cfg: ArchConfig, seq_len: int,
              rules: ShardingRules = DEFAULT_RULES) -> dict:
    """A laid-out prefill cache (`prefill` on laid-out parameters) at the
    decode length `seq_len`, laid out by `cache_specs(cfg, B, seq_len,
    rules)`: what the reference's caller builds with `init_cache(cfg, B,
    seq_len)`, `.at[:, :, :S].set(...)` of the prompt's k and v, and a
    placement by `cache_specs`. Each coordinate makes only its own region,
    zero past the prompt, the prompt's entries copied in from the
    coordinates that hold them (`col.assemble`, counted as "reshard"); pos
    and the SSM state, whose layouts do not depend on the length, are kept.
    Under a sliding window the k and v cache has min(seq_len, window)
    slots (a rolling cache): a prompt longer than that raises ValueError,
    as the reference's caller cannot set one into `init_cache` either."""
    pos = cache["pos"]
    b, mesh = pos.shape[0], pos.mesh
    specs = cache_specs(cfg, b, seq_len, rules, mesh)
    shapes = abstract_cache(cfg, b, seq_len)
    if "k" in cache:
        s, slots = cache["k"].shape[2], shapes["k"].shape[2]
        if slots < seq_len and s > slots:
            raise ValueError(f"a prompt of {s} positions is longer than the rolling "
                             f"cache's {slots} slots (sliding window {cfg.sliding_window})")
        if seq_len < s:
            raise ValueError(f"a decode length {seq_len} below the prompt's {s}")
    return {k: _own_copy(col.assemble([((0,) * len(x.shape), x)], shapes[k].shape, specs[k],
                                      mesh, zero_fill=True), x)
            if k in ("k", "v") else col.relayout(x, specs[k]) for k, x in cache.items()}


def _own_copy(x: DistArray, source: DistArray) -> DistArray:
    """`x` with every shard that `assemble` kept as a view of one of
    `source`'s (a region that lies within one of the prompt's, where the
    prompt's cache lies whole along its sequence) copied to memory of its
    own: the decode writes the cache in place, and neither the prompt's
    cache nor the other regions of its tensor may move with it."""
    held = {t.untyped_storage().data_ptr() for t in source.shards.values()}
    return col.zip_map(lambda t: t.clone(memory_format=torch.contiguous_format)
                       if t.untyped_storage().data_ptr() in held else t, x)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ArchConfig, rules: ShardingRules = DEFAULT_RULES):
    """One decode step. tokens: (B,) ids. Returns (logits (B, V) f32,
    new_cache). The cache's k, v and SSM state are written in place (the
    reference's jitted callers donate them); new_cache shares them and has
    pos + 1. On laid-out parameters the cache must be laid out by
    `cache_specs` (as `pad_cache` gives it); the logits come back joined."""
    if is_laid_out(params):
        return _decode_laid_out(params, cache, tokens, cfg, rules)
    with torch.inference_mode():
        pos = cache["pos"]
        x = embed_lookup(params["embed"], tokens[:, None]).to(DTYPE)
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            if not cfg.attn_free:
                h = _norm(cfg, lp, "attn_norm", x)
                a_out, _, _ = attention.attn_decode(lp["attn"], h, cache["k"][i],
                                                    cache["v"][i], pos, cfg, rules)
                if cfg.family == "hybrid":
                    s_out = _ssm_decode(lp, h, cache, i, cfg)
                    x = x + 0.5 * (a_out + s_out)
                else:
                    x = x + a_out
            if cfg.ssm is not None and cfg.family != "hybrid":
                h = _norm(cfg, lp, "ssm_norm", x)
                x = x + _ssm_decode(lp, h, cache, i, cfg)
            if cfg.d_ff:
                h = _norm(cfg, lp, "mlp_norm", x)
                x = x + mlp_apply(lp["mlp"], h, cfg.activation, rules)
            if cfg.moe is not None:
                h = _norm(cfg, lp, "moe_norm", x)
                x = x + moe_mod.moe_apply(lp["moe"], h, cfg, rules)[0]
        logits = _logits(params, x, cfg, rules)[:, 0]
        new_cache = {k: v for k, v in cache.items() if k != "pos"}
        new_cache["pos"] = pos + 1
        return logits, new_cache


def _ssm_decode(lp: dict, h: torch.Tensor, cache: dict, i: int,
                cfg: ArchConfig) -> torch.Tensor:
    """Layer i's SSM step, its state written back into the cache."""
    out, st = ssm_mod.ssm_decode(lp["ssm"], h, ssm_mod.SSMState(
        cache["ssm_h"][i], cache["ssm_conv"][i]), cfg)
    cache["ssm_h"][i] = st.h
    cache["ssm_conv"][i] = st.conv
    return out


# ---------------------------------------------------------------------------
# The partitioned program: a laid-out state, per coordinate
# ---------------------------------------------------------------------------

def is_laid_out(params) -> bool:
    """True when the parameters are laid out over a mesh (DistArray leaves)."""
    return any(isinstance(t, DistArray) for t in leaves(params))


def _extent(batch: dict) -> tuple[int, int]:
    """The program's global (B, S) from the batch's model inputs: audio's
    frames, the tokens (decode's (B,) one position), the VLM's patch stubs
    before its text."""
    if "frame_embeds" in batch:
        return tuple(batch["frame_embeds"].shape[:2])
    shape = tuple(batch["tokens"].shape)
    if len(shape) == 1:
        return shape[0], 1
    patches = batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0
    return shape[0], patches + shape[1]


def _program(params: dict, batch: dict, cfg: ArchConfig, rules: ShardingRules):
    """The program's frame, and each batch entry's rows at every
    coordinate: laid out by the batch specs (a whole tensor is cut where
    it lies; a laid-out one keeps its layout, or moves to it)."""
    mesh = next(t for t in leaves(params) if isinstance(t, DistArray)).mesh
    parts = {}
    for key, v in batch.items():
        spec = logical_spec(tuple(v.shape), ("batch",) + (None,) * (len(v.shape) - 1),
                            rules, mesh)
        if isinstance(v, DistArray):
            v = col.relayout(v, spec)
        else:
            v = col.distribute(v.to(mesh.local_device()), spec, mesh)
        parts[key] = col.per_coord(v)
    return Program(mesh, rules, *_extent(batch)), parts


def _unstack_laid_out(tree: dict, n: int) -> list[dict]:
    """The stacked (L, ...) laid-out parameters as L per-layer trees of
    DistArrays, each coordinate's shard `unbind`-ed (whose backward stacks
    the L gradients once)."""
    out: list[dict] = [{} for _ in range(n)]
    for k, v in tree.items():
        if isinstance(v, dict):
            parts = _unstack_laid_out(v, n)
        else:
            if v.spec[0] is not None:
                raise ValueError(f"the partitioned program does not realise the logical "
                                 f"axis 'layers' over {v.spec[0]!r}")
            mesh = v.mesh
            cut = {c: torch.unbind(t) for c, t in col.per_coord(v).items()}
            parts = [DistArray(v.shape[1:], v.spec[1:], mesh,
                               {c: cut[c][i] for c in mesh.local_coords()},
                               {c: t[i] for c, t in cut.items() if not mesh.is_local(c)}
                               or None) for i in range(n)]
        for i in range(n):
            out[i][k] = parts[i]
    return out


def _norm_laid_out(cfg: ArchConfig, params: dict, name: str, x: dict) -> dict:
    p = {k: col.per_coord(v) for k, v in params.get(name, {}).items()}
    return {c: norm_apply(cfg.norm, {k: v[c] for k, v in p.items()}, t)
            for c, t in x.items()}


def _layer_laid_out(cfg: ArchConfig, prog: Program, lp: dict, x: dict,
                    attend=None, mix=None) -> tuple[dict, dict, dict]:
    """One layer of the partitioned program, `_layer_fwd`'s branches:
    (x, aux, z), dicts coordinate -> tensor, aux and z the layer's MoE
    losses (0-dim f32; None without MoE). Every phase runs over every
    coordinate before the next. `attend(params, h)` is the attention
    (default: `attn_apply_laid_out`), `mix(params, h)` the SSM block's
    output (default: `ssm_apply_laid_out`'s)."""
    if mix is None:
        mix = functools.partial(_ssm_out, cfg, prog)
    if not cfg.attn_free:
        h = _norm_laid_out(cfg, lp, "attn_norm", x)
        a = (attend(lp["attn"], h) if attend is not None
             else attention.attn_apply_laid_out(lp["attn"], h, cfg, prog))
        if cfg.family == "hybrid":
            # attention and SSD heads in parallel on the same norm, mean-combined
            m = mix(lp["ssm"], h)
            x = {c: t + 0.5 * (a[c] + m[c]) for c, t in x.items()}
            del m
        else:
            x = {c: t + a[c] for c, t in x.items()}
        del a, h
    if cfg.ssm is not None and cfg.family != "hybrid":
        h = _norm_laid_out(cfg, lp, "ssm_norm", x)
        m = mix(lp["ssm"], h)
        x = {c: t + m[c] for c, t in x.items()}
        del m, h
    if cfg.d_ff:
        h = _norm_laid_out(cfg, lp, "mlp_norm", x)
        m = mlp_apply_laid_out(lp["mlp"], h, cfg.activation, prog)
        x = {c: t + m[c] for c, t in x.items()}
        del m, h
    if cfg.moe is not None:
        h = _norm_laid_out(cfg, lp, "moe_norm", x)
        m, aux, z = moe_mod.moe_apply_laid_out(lp["moe"], h, cfg, prog)
        x = {c: t + m[c] for c, t in x.items()}
        del m, h
    else:
        aux = z = None
    x = prog.shard(x, (prog.batch, prog.seq, cfg.d_model), "batch", "seq", "embed")
    return x, aux, z


def _ssm_out(cfg: ArchConfig, prog: Program, params: dict, h: dict) -> dict:
    return ssm_mod.ssm_apply_laid_out(params, h, cfg, prog)[0]


def _embed_laid_out(params: dict, parts: dict, cfg: ArchConfig, prog: Program) -> dict:
    """Each coordinate's input embeddings (B_loc, S, d) in DTYPE from its
    batch `parts`, `_embed_inputs` per coordinate: audio's frames with
    `mask_embed` where masked (no lookup), the VLM's patch stubs before
    the lookup of its text, else the lookup of the tokens (a decode
    step's one token, of every family)."""
    if "frame_embeds" in parts:
        fill = col.per_coord(params["mask_embed"])
        x = {c: torch.where(parts["mask"][c][..., None], fill[c].to(DTYPE), t.to(DTYPE))
             for c, t in parts["frame_embeds"].items()}
    else:
        x = {c: t.to(DTYPE) for c, t in embed_lookup_laid_out(params["embed"],
                                                               parts["tokens"]).items()}
        if "patch_embeds" in parts:
            x = {c: torch.cat([parts["patch_embeds"][c].to(DTYPE), t], dim=1)
                 for c, t in x.items()}
    return prog.shard(x, (prog.batch, prog.seq, cfg.d_model), "batch", "seq", "embed")


def _head_laid_out(params: dict, x: dict, cfg: ArchConfig, prog: Program):
    """The final norm and the head on each coordinate's vocabulary columns:
    its f32 logits (B_loc, S, V_loc), and their spec."""
    x = _norm_laid_out(cfg, params, "final_norm", x)
    lshape = (prog.batch, prog.seq, cfg.vocab)
    spec = prog.spec(lshape, ("batch", "seq", "vocab"))
    if cfg.tie_embeddings:
        table = gathered(params["embed"], (spec[2], None))
        logits = {c: torch.matmul(t.float(), table[c].float().T) for c, t in x.items()}
    else:
        head = gathered(params["lm_head"], (None, spec[2]))
        logits = {c: torch.matmul(t.float(), head[c].float()) for c, t in x.items()}
    return prog.shard(logits, lshape, "batch", "seq", "vocab"), spec


def _forward_laid_out(params: dict, parts: dict, cfg: ArchConfig, prog: Program,
                      remat: bool, remat_policy: str, cache: dict | None = None):
    """Each coordinate's f32 logits (B_loc, S, V_loc) of its batch
    `parts` (`_embed_laid_out`), their spec, and its
    aux and z summed over the layers, as the reference's scan sums them
    (None without MoE).
    With remat each layer runs under `torch.utils.checkpoint`: the
    recompute gathers its weights again, as the reference's remat does.
    Given the laid-out arrays of a prefill `cache`, each layer writes its
    k and v (`_attend_and_cache`) and its SSM state (`_ssm_and_cache`)
    into them."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}; want one of "
                         f"{REMAT_POLICIES}")
    x = _embed_laid_out(params, parts, cfg, prog)
    context_fn = torch_checkpoint.noop_context_fn
    if remat_policy == "dots":
        context_fn = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, _dots_policy)
    aux = z = None
    for i, lp in enumerate(_unstack_laid_out(params["layers"], cfg.n_layers)):
        attend = mix = None
        if cache is not None:
            attend = functools.partial(_attend_and_cache, cfg, prog, cache, i)
            mix = functools.partial(_ssm_and_cache, cfg, prog, cache, i)
        if remat:
            x, a, zz = torch_checkpoint.checkpoint(_layer_laid_out, cfg, prog, lp, x, attend,
                                                   mix, use_reentrant=False,
                                                   context_fn=context_fn)
        else:
            x, a, zz = _layer_laid_out(cfg, prog, lp, x, attend, mix)
        if a is not None:
            aux = a if aux is None else {c: t + a[c] for c, t in aux.items()}
            z = zz if z is None else {c: t + zz[c] for c, t in z.items()}
    return (*_head_laid_out(params, x, cfg, prog), aux, z)


def _joined_losses(aux: dict | None, z: dict | None, mesh) -> tuple:
    """The MoE losses joined (0-dim, in every process), or zeros on this
    process's device without MoE."""
    if aux is None:
        zero = _zero(mesh.local_device())
        return zero, zero
    return col.join(aux, (), mesh), col.join(z, (), mesh)


def _cache_layout(kv: dict, kv_ax, spec, prog: Program) -> dict:
    """A layer's k or v at every coordinate, (B_loc, S, KV_loc, hd) as the
    attention made it, in the cache's layout `spec` (its entries after the
    layers'): moved from the KV heads' axis to the sequence's by one
    all_to_all where the KV heads split; cut to the coordinate's part of
    the sequence where they are whole; as it is where the sequence is
    whole (the cache's KV heads then lie as k's)."""
    _, s_ax, kvh_ax, _ = spec
    if s_ax is None and kvh_ax == kv_ax:
        return kv
    if s_ax is None or kvh_ax is not None or kv_ax not in (None, s_ax):
        raise ValueError(f"a cache laid out by {tuple(spec)} from k with its KV heads "
                         f"over {kv_ax!r}")
    if kv_ax is not None:
        return col.all_to_all(kv, kv_ax, 1, 2, prog.mesh)
    chunk = prog.seq // col.axis_size(s_ax, prog.mesh)
    idx = col.axis_index(s_ax, prog.mesh)
    return {c: t.narrow(1, idx[c] * chunk, chunk) for c, t in kv.items()}


def _attend_and_cache(cfg: ArchConfig, prog: Program, cache: dict, i: int, params: dict,
                      h: dict) -> dict:
    """Layer i's attention, its k and v written into the prefill cache's
    layer i at each of this process's coordinates."""
    y, k, v = attention.attn_apply_laid_out(params, h, cfg, prog, want_kv=True)
    shape = (prog.batch, prog.seq, cfg.n_kv_heads, cfg.head_dim)
    kv_ax = prog.spec(shape, ("batch", "seq", "kv_heads", None))[2]
    for key, parts in (("k", k), ("v", v)):
        parts = prog.shard(_cache_layout(parts, kv_ax, cache[key].spec[1:], prog), shape,
                           "batch", "kv_seq", "kv_heads", None)
        for c in prog.mesh.local_coords():
            cache[key].shards[c][i] = parts[c]
    return y


def _ssm_and_cache(cfg: ArchConfig, prog: Program, cache: dict, i: int, params: dict,
                   h: dict) -> dict:
    """Layer i's SSM block, its state written into the prefill cache's
    layer i at each of this process's coordinates: h on the coordinate's
    SSD heads, the conv state whole."""
    y, st = ssm_mod.ssm_apply_laid_out(params, h, cfg, prog)
    _, n_h, p, n, _ = ssm_mod._dims(cfg)
    prog.shard(st.h, (prog.batch, n_h, n, p), "batch", "ssm_inner", None, None)
    for key, parts in (("ssm_h", st.h), ("ssm_conv", st.conv)):
        for c in prog.mesh.local_coords():
            cache[key].shards[c][i] = parts[c]
    return y


def _ssm_step(cfg: ArchConfig, prog: Program, layer_cache: dict, params: dict,
              h: dict) -> dict:
    """One decode step of a layer's SSM block, its state (`layer_cache`'s
    ssm_h and ssm_conv, one layer of the laid-out cache) written in place
    at each of this process's coordinates."""
    h_in, conv_in = col.per_coord(layer_cache["ssm_h"]), col.per_coord(layer_cache["ssm_conv"])
    y, st = ssm_mod.ssm_decode_laid_out(params, h, ssm_mod.SSMState(h_in, conv_in), cfg, prog)
    for c in prog.mesh.local_coords():
        h_in[c].copy_(st.h[c])
        conv_in[c].copy_(st.conv[c])
    return y


def _prefill_laid_out(params: dict, batch: dict, cfg: ArchConfig, rules: ShardingRules):
    """`prefill` on laid-out parameters, under `torch.inference_mode()`:
    the joined logits and the cache laid out by `cache_specs(cfg, B, S)`
    (a prompt longer than a sliding window keeps its whole k and v, as the
    mesh-free prefill's; `pad_cache` refuses it)."""
    with torch.inference_mode():
        prog, parts = _program(params, batch, cfg, rules)
        shapes = _empty_cache(cfg, prog.batch, prog.seq, torch.device("meta"), torch.empty)
        specs = _specs_of(shapes, rules, prog.mesh)
        cache = {k: col.empty(t.shape, specs[k], prog.mesh, t.dtype)
                 for k, t in shapes.items()}
        for t in cache["pos"].shards.values():
            t.fill_(prog.seq)
        logits, spec, aux, z = _forward_laid_out(params, parts, cfg, prog, False, "full",
                                                 cache)
        return (col.join(logits, spec, prog.mesh), *_joined_losses(aux, z, prog.mesh),
                cache)


def _decode_laid_out(params: dict, cache: dict, tokens, cfg: ArchConfig,
                     rules: ShardingRules):
    """`decode_step` on laid-out parameters and a cache laid out by
    `cache_specs`, under `torch.inference_mode()`: the lookup, each layer
    (`attn_decode_laid_out`, writing the cache in place, and the MLP) and
    the head per coordinate; the logits (B, V) joined, and the cache with
    pos + 1."""
    with torch.inference_mode():
        prog, parts = _program(params, {"tokens": tokens}, cfg, rules)
        mesh = prog.mesh
        kv_len = cache["k"].shape[2] if "k" in cache else 1   # an SSM's state has no length
        specs = cache_specs(cfg, prog.batch, kv_len, rules, mesh)
        for key, x in cache.items():
            if not isinstance(x, DistArray) or x.spec != tuple(specs[key]):
                raise ValueError(f"the cache's {key!r} is not laid out by cache_specs: "
                                 f"want {tuple(specs[key])}")
        pos = col.per_coord(cache["pos"])
        x = _embed_laid_out(params, {"tokens": {c: t[:, None]
                                                for c, t in parts["tokens"].items()}},
                            cfg, prog)
        layers = zip(_unstack_laid_out(params["layers"], cfg.n_layers),
                     _unstack_laid_out({k: v for k, v in cache.items() if k != "pos"},
                                       cfg.n_layers))
        for lp, lc in layers:
            attend = mix = None
            if "k" in lc:
                attend = functools.partial(attention.attn_decode_laid_out, cache_k=lc["k"],
                                           cache_v=lc["v"], pos=pos, cfg=cfg, prog=prog)
            if "ssm_h" in lc:
                mix = functools.partial(_ssm_step, cfg, prog, lc)
            x = _layer_laid_out(cfg, prog, lp, x, attend, mix)[0]
        logits, spec = _head_laid_out(params, x, cfg, prog)
        new_cache = {**cache, "pos": col.zip_map(lambda p: p + 1, cache["pos"])}
        return col.join(logits, spec, mesh)[:, 0], new_cache


def _loss_laid_out(params: dict, batch: dict, cfg: ArchConfig, rules: ShardingRules,
                   aux_weight: float, z_weight: float, remat: bool, remat_policy: str):
    """`loss_fn` in the partitioned program: the vocabulary-parallel
    cross-entropy, in f32. The loss and metrics come back joined (0-dim,
    in every process); the backward starts at the first coordinate's
    loss, so every value replicated over an axis carries its cotangent as
    partial sums over the replicas, which the collectives' transposes
    (a psum's psum, an all-gather's reduce-scatter) sum."""
    prog, parts = _program(params, batch, cfg, rules)
    mesh = prog.mesh
    logits, spec, aux, z = _forward_laid_out(params, parts, cfg, prog,
                                             remat and _tracks_grad(params), remat_policy)
    b_ax, v_ax = spec[0], spec[2]
    with torch.no_grad():
        top = {c: t.amax(-1) for c, t in logits.items()}
    if v_ax:
        top = col.pmax(top, v_ax, mesh)
    sumexp = {c: torch.exp(t - top[c][..., None]).sum(-1) for c, t in logits.items()}
    v_loc = cfg.vocab // col.axis_size(v_ax, mesh) if v_ax else cfg.vocab
    first = col.axis_index(v_ax, mesh) if v_ax else None
    labels = parts["labels"]
    if cfg.family == "vlm":             # the patch positions carry no label
        labels = {c: torch.cat([torch.full(parts["patch_embeds"][c].shape[:2], -1,
                                           dtype=t.dtype, device=t.device), t], dim=1)
                  for c, t in labels.items()}
    picked = {}
    for c, t in logits.items():
        rel = labels[c].long() - (first[c] * v_loc if first else 0)
        ok = (rel >= 0) & (rel < v_loc)
        got = torch.gather(t, -1, rel.clamp(0, v_loc - 1)[..., None])[..., 0]
        picked[c] = torch.where(ok, got, 0.0)
    del logits
    if v_ax:
        sumexp, picked = col.psum(sumexp, v_ax, mesh), col.psum(picked, v_ax, mesh)
    sums, counts = {}, {}
    for c, lab in labels.items():
        mask = lab >= 0
        if cfg.family == "audio":       # the masked frames alone carry a loss
            mask = mask & parts["mask"][c]
        token_ll = picked[c] - (top[c] + torch.log(sumexp[c]))
        sums[c] = -torch.where(mask, token_ll, 0.0).sum()
        counts[c] = mask.sum().to(torch.float32)
    if b_ax:
        sums, counts = col.psum(sums, b_ax, mesh), col.psum(counts, b_ax, mesh)
    ce = {c: t / counts[c].clamp(min=1) for c, t in sums.items()}
    total = ce if aux is None else {c: t + aux_weight * aux[c] + z_weight * z[c]
                                    for c, t in ce.items()}
    aux, z = _joined_losses(aux, z, mesh)
    return col.join(total, (), mesh), {"ce": col.join(ce, (), mesh), "aux": aux, "z": z,
                                       "tokens": col.join(counts, (), mesh)}
