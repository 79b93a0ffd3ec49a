"""Model assembly for the dense family: a loop over stacked layers.

The port of `repro.models.transformer` for training and serving a dense
LM (granite, olmo, stablelm): parameters are declared and stacked (L, ...)
per layer exactly as in the reference, so weights carry across one to one
(`repro_torch.bridge.lm_params_from_numpy`). `forward` runs a Python loop
over the layers; the reference's `jax.lax.scan` exists for compile time,
which PyTorch does not pay.

`forward` takes one of two paths, by what it is given:
  * training, when autograd is recording and a parameter requires grad:
    each layer under `torch.utils.checkpoint` (non-reentrant) with
    remat=True, saving only the residual stream ("full") or also the
    matrix products' outputs ("dots", selective checkpointing), as the
    reference's `jax.checkpoint` policies do; attention goes through
    `FlashAttentionFn` on the card (B6 forward, B6-bwd backward);
  * inference otherwise, under `torch.inference_mode()`, which `prefill`
    and `decode_step` always take; remat does not apply.
Both give the same logits for the same parameters.

Entry points:
  param_defs / init_params
  forward(...)            logits (+ prefill cache)
  loss_fn(...)            next-token CE and its metrics
  prefill(...)            forward with the cache
  init_cache / decode_step
The MoE, SSM, hybrid, audio and VLM families and the sharding helpers come
with later slices; asking for another family raises.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils import checkpoint as torch_checkpoint

from ..configs.registry import ArchConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..tree import leaves
from . import attention
from .embedding import embed_lookup
from .layers import (DTYPE, ParamDef, init_tree, map_defs, mlp_apply,
                     mlp_params, norm_apply, norm_params)

__all__ = ["param_defs", "init_params", "forward", "loss_fn", "prefill",
           "init_cache", "decode_step", "REMAT_POLICIES"]

# The slice of the port that brings each family this one does not carry.
_LATER_FAMILIES = {"moe": "MoE", "ssm": "SSM", "hybrid": "hybrid (sliding-window)",
                   "audio": "audio", "vlm": "VLM"}


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        later = _LATER_FAMILIES.get(cfg.family, cfg.family)
        raise ValueError(f"{cfg.name}: the {cfg.family} family comes with the "
                         f"{later} slice of the port; this one serves the "
                         "dense family")


# ---------------------------------------------------------------------------
# Parameter declaration
# ---------------------------------------------------------------------------


def _layer_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {"attn": attention.attn_params(cfg),
            "attn_norm": norm_params(cfg.norm, d),
            "mlp": mlp_params(d, cfg.d_ff, cfg.activation),
            "mlp_norm": norm_params(cfg.norm, d)}


def param_defs(cfg: ArchConfig) -> dict:
    _check_dense(cfg)
    d = cfg.d_model

    def stack(p: ParamDef) -> ParamDef:
        return dataclasses.replace(p, shape=(cfg.n_layers, *p.shape),
                                   logical=("layers", *p.logical))

    defs: dict = {
        "embed": ParamDef((cfg.vocab, d), ("vocab", "embed_w")),
        "layers": map_defs(_layer_defs(cfg), stack),
        "final_norm": norm_params(cfg.norm, d),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, cfg.vocab), ("embed_w", "vocab"))
    return defs


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Random weights from `generator` (a generator on `device`)."""
    return init_tree(param_defs(cfg), generator, device)


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


def _layer_fwd(cfg: ArchConfig, lp: dict, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    h = _norm(cfg, lp, "attn_norm", x)
    x = x + attention.attn_apply(lp["attn"], h, cfg, positions)
    h = _norm(cfg, lp, "mlp_norm", x)
    return x + mlp_apply(lp["mlp"], h, cfg.activation)


def _tracks_grad(params: dict) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in leaves(params))


def _train_forward(params: dict, batch: dict, cfg: ArchConfig, remat: bool,
                   remat_policy: str):
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}; want one of "
                         f"{REMAT_POLICIES}")
    x = embed_lookup(params["embed"], batch["tokens"]).to(DTYPE)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    context_fn = torch_checkpoint.noop_context_fn
    if remat_policy == "dots":
        context_fn = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, _dots_policy)
    for lp in _unstack(params["layers"], cfg.n_layers):
        if remat:
            x = torch_checkpoint.checkpoint(_layer_fwd, cfg, lp, x, positions,
                                            use_reentrant=False,
                                            context_fn=context_fn)
        else:
            x = _layer_fwd(cfg, lp, x, positions)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, x, cfg), zero, zero, None


def forward(params: dict, batch: dict, cfg: ArchConfig, *,
            want_cache: bool = False, remat: bool = True,
            remat_policy: str = "full"):
    """Full-sequence forward over batch["tokens"] (B, S). Returns
    (logits (B, S, V) f32, aux, z, cache | None); aux and z, the MoE
    losses of the reference, are zero for the dense family. The cache
    holds k, v (L, B, S, KV, hd) and pos = S.

    With autograd recording and a parameter requiring grad this is the
    training forward (see the module docstring); `remat` and
    `remat_policy` ("full" | "dots") choose what the backward recomputes.
    Otherwise it runs under `torch.inference_mode()`."""
    _check_dense(cfg)
    if _tracks_grad(params):
        if want_cache:
            raise ValueError("the prefill cache comes from the inference "
                             "forward; call prefill without grad")
        return _train_forward(params, batch, cfg, remat, remat_policy)
    with torch.inference_mode():
        x = embed_lookup(params["embed"], batch["tokens"]).to(DTYPE)
        b, s, _ = x.shape
        dev = x.device
        positions = torch.arange(s, device=dev).expand(b, s)
        cache = None
        if want_cache:
            shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
            cache = {"k": torch.empty(shape, dtype=DTYPE, device=dev),
                     "v": torch.empty(shape, dtype=DTYPE, device=dev)}
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            h = _norm(cfg, lp, "attn_norm", x)
            if want_cache:
                a, cache["k"][i], cache["v"][i] = attention.attn_apply(
                    lp["attn"], h, cfg, positions, want_kv=True)
            else:
                a = attention.attn_apply(lp["attn"], h, cfg, positions)
            x = x + a
            h = _norm(cfg, lp, "mlp_norm", x)
            x = x + mlp_apply(lp["mlp"], h, cfg.activation)
        logits = _logits(params, x, cfg)
        if want_cache:
            cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return logits, zero, zero, cache


def loss_fn(params: dict, batch: dict, cfg: ArchConfig, *,
            aux_weight: float = 0.01, z_weight: float = 1e-3,
            remat: bool = True, remat_policy: str = "full"):
    """Next-token cross-entropy of batch["tokens"] against batch["labels"]
    (B, S); labels < 0 carry no loss. Returns (total, {"ce", "aux", "z",
    "tokens"}), 0-dim f32 tensors. The log-likelihood is picked by
    `gather`, one index a row, so its backward writes each entry once: on
    the card the gradient has the same bits on every run."""
    logits, aux, z, _ = forward(params, batch, cfg, remat=remat,
                                remat_policy=remat_policy)
    labels = batch["labels"]
    mask = labels >= 0
    safe = labels.clamp(min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    token_ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    n_tokens = mask.sum()
    ce = -torch.where(mask, token_ll, 0.0).sum() / n_tokens.clamp(min=1)
    total = ce + aux_weight * aux + z_weight * z
    return total, {"ce": ce, "aux": aux, "z": z,
                   "tokens": n_tokens.to(torch.float32)}


def prefill(params: dict, batch: dict, cfg: ArchConfig):
    """Prefill forward: logits + populated cache (inference). To decode
    past the prompt, pad the cache's S axis to the decode length first."""
    return forward(params, batch, cfg, want_cache=True)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Zeroed decode cache: pos (B,) int32, k and v (L, B, S, KV, hd)."""
    _check_dense(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "k": torch.zeros(shape, dtype=DTYPE, device=device),
            "v": torch.zeros(shape, dtype=DTYPE, device=device)}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ArchConfig):
    """One decode step. tokens: (B,) ids. Returns (logits (B, V) f32,
    new_cache). The cache's k and v are written in place (the reference's
    jitted callers donate them); new_cache shares them and has pos + 1."""
    _check_dense(cfg)
    with torch.inference_mode():
        pos = cache["pos"]
        x = embed_lookup(params["embed"], tokens[:, None]).to(DTYPE)
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            h = _norm(cfg, lp, "attn_norm", x)
            a, _, _ = attention.attn_decode(lp["attn"], h, cache["k"][i],
                                            cache["v"][i], pos, cfg)
            x = x + a
            h = _norm(cfg, lp, "mlp_norm", x)
            x = x + mlp_apply(lp["mlp"], h, cfg.activation)
        logits = _logits(params, x, cfg)[:, 0]
        return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
