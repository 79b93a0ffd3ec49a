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
    `FlashAttentionFn` on the card (B6 forward, B6-bwd backward), which
    does not take a window or hd 80 yet and raises for them;
  * inference otherwise, under `torch.inference_mode()`, which `prefill`
    and `decode_step` always take; remat does not apply.
Both give the same logits for the same parameters.

Entry points:
  param_defs / init_params
  forward(...)            logits, MoE aux losses (+ prefill cache)
  loss_fn(...)            next-token CE (masked-frame CE for audio) + aux
  prefill(...)            forward with the cache
  init_cache / decode_step
The sharding helpers (`param_specs`, `abstract_*`, `cache_specs`) come with
the port of `parallel/sharding.py`.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils import checkpoint as torch_checkpoint

from ..configs.registry import ArchConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..tree import leaves
from . import attention, moe as moe_mod, ssm as ssm_mod
from .embedding import embed_lookup
from .layers import (DTYPE, ParamDef, init_tree, map_defs, mlp_apply,
                     mlp_params, norm_apply, norm_params)

__all__ = ["param_defs", "init_params", "forward", "loss_fn", "prefill",
           "init_cache", "decode_step", "REMAT_POLICIES"]


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


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer(tree: dict, i: int) -> dict:
    """Layer i's slice of the stacked (L, ...) parameters or cache."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _norm(cfg: ArchConfig, params: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return norm_apply(cfg.norm, params.get(name, {}), x)


def _logits(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """f32 logits of bf16 operands: upcast, multiply, keep f32 (the
    reference's `preferred_element_type=jnp.float32`)."""
    x = norm_apply(cfg.norm, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x.float(), head.float())


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


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _layer_fwd(cfg: ArchConfig, lp: dict, x: torch.Tensor, positions: torch.Tensor,
               want_cache: bool = False):
    """One layer of any family: (x, aux, z, cache slice). aux and z are the
    MoE losses (0-dim f32, zero without MoE); the cache slice holds the
    layer's k, v (B, S, KV, hd) and SSM state when `want_cache`."""
    aux = z = _zero(x)
    cache: dict = {}
    if not cfg.attn_free:
        h = _norm(cfg, lp, "attn_norm", x)
        a_out = attention.attn_apply(lp["attn"], h, cfg, positions, want_kv=want_cache)
        if want_cache:
            a_out, cache["k"], cache["v"] = a_out
        if cfg.family == "hybrid":
            # attention and SSD heads in parallel on the same norm, mean-combined
            s_out, st = ssm_mod.ssm_apply(lp["ssm"], h, cfg)
            x = x + 0.5 * (a_out + s_out)
            if want_cache:
                cache["ssm_h"], cache["ssm_conv"] = st.h, st.conv
        else:
            x = x + a_out
    if cfg.ssm is not None and cfg.family != "hybrid":
        h = _norm(cfg, lp, "ssm_norm", x)
        s_out, st = ssm_mod.ssm_apply(lp["ssm"], h, cfg)
        x = x + s_out
        if want_cache:
            cache["ssm_h"], cache["ssm_conv"] = st.h, st.conv
    if cfg.d_ff:
        h = _norm(cfg, lp, "mlp_norm", x)
        x = x + mlp_apply(lp["mlp"], h, cfg.activation)
    if cfg.moe is not None:
        h = _norm(cfg, lp, "moe_norm", x)
        m_out, aux, z = moe_mod.moe_apply(lp["moe"], h, cfg)
        x = x + m_out
    return x, aux, z, cache


def _train_layer(cfg: ArchConfig, lp: dict, x: torch.Tensor, positions: torch.Tensor):
    return _layer_fwd(cfg, lp, x, positions)[:3]


def _embed_inputs(params: dict, batch: dict, cfg: ArchConfig):
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
    return x, torch.arange(s, device=x.device).expand(b, s)


def _tracks_grad(params: dict) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in leaves(params))


def _train_forward(params: dict, batch: dict, cfg: ArchConfig, remat: bool,
                   remat_policy: str):
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}; want one of "
                         f"{REMAT_POLICIES}")
    x, positions = _embed_inputs(params, batch, cfg)
    context_fn = torch_checkpoint.noop_context_fn
    if remat_policy == "dots":
        context_fn = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, _dots_policy)
    aux = z = _zero(x)
    for lp in _unstack(params["layers"], cfg.n_layers):
        if remat:
            x, a, zz = torch_checkpoint.checkpoint(_train_layer, cfg, lp, x, positions,
                                                   use_reentrant=False,
                                                   context_fn=context_fn)
        else:
            x, a, zz = _train_layer(cfg, lp, x, positions)
        aux, z = aux + a, z + zz
    return _logits(params, x, cfg), aux, z, None


def forward(params: dict, batch: dict, cfg: ArchConfig, *,
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
    Otherwise it runs under `torch.inference_mode()`."""
    if _tracks_grad(params):
        if want_cache:
            raise ValueError("the prefill cache comes from the inference "
                             "forward; call prefill without grad")
        return _train_forward(params, batch, cfg, remat, remat_policy)
    with torch.inference_mode():
        x, positions = _embed_inputs(params, batch, cfg)
        b, s, _ = x.shape
        cache = _empty_cache(cfg, b, s, x.device, torch.empty) if want_cache else None
        aux = z = _zero(x)
        for i in range(cfg.n_layers):
            x, a, zz, layer_cache = _layer_fwd(cfg, _layer(params["layers"], i), x,
                                               positions, want_cache)
            aux, z = aux + a, z + zz
            for key, val in layer_cache.items():
                cache[key][i] = val
        logits = _logits(params, x, cfg)
        if want_cache:
            cache["pos"].fill_(s)
        return logits, aux, z, cache


def loss_fn(params: dict, batch: dict, cfg: ArchConfig, *,
            aux_weight: float = 0.01, z_weight: float = 1e-3,
            remat: bool = True, remat_policy: str = "full"):
    """Next-token cross-entropy of the logits against batch["labels"] (B,
    S); labels < 0 carry no loss. VLM labels cover the text only (the image
    prefix takes -1); audio scores the masked frames only. Returns (total =
    ce + aux_weight·aux + z_weight·z, {"ce", "aux", "z", "tokens"}), 0-dim
    f32 tensors. The log-likelihood is picked by `gather`, one index a row,
    so its backward writes each entry once: on the card the gradient has
    the same bits on every run."""
    logits, aux, z, _ = forward(params, batch, cfg, remat=remat,
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


def prefill(params: dict, batch: dict, cfg: ArchConfig):
    """Prefill forward: logits + populated cache (inference). The k, v
    cache covers the whole prompt, also where a sliding window makes
    `init_cache` roll: to decode past the prompt, pad its S axis to the
    decode length first (a cache no longer than the window rolls; a longer
    one attends without the window, as in the reference)."""
    return forward(params, batch, cfg, want_cache=True)


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
    s_eff = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    return _empty_cache(cfg, batch, s_eff, device, torch.zeros)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ArchConfig):
    """One decode step. tokens: (B,) ids. Returns (logits (B, V) f32,
    new_cache). The cache's k, v and SSM state are written in place (the
    reference's jitted callers donate them); new_cache shares them and has
    pos + 1."""
    with torch.inference_mode():
        pos = cache["pos"]
        x = embed_lookup(params["embed"], tokens[:, None]).to(DTYPE)
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            if not cfg.attn_free:
                h = _norm(cfg, lp, "attn_norm", x)
                a_out, _, _ = attention.attn_decode(lp["attn"], h, cache["k"][i],
                                                    cache["v"][i], pos, cfg)
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
                x = x + mlp_apply(lp["mlp"], h, cfg.activation)
            if cfg.moe is not None:
                h = _norm(cfg, lp, "moe_norm", x)
                x = x + moe_mod.moe_apply(lp["moe"], h, cfg)[0]
        logits = _logits(params, x, cfg)[:, 0]
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
