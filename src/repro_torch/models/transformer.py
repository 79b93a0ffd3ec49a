"""Model assembly for the dense family: a loop over stacked layers.

The port of `repro.models.transformer` for serving a dense LM (granite,
olmo, stablelm): parameters are declared and stacked (L, ...) per layer
exactly as in the reference, so weights carry across one to one
(`repro_torch.bridge.lm_params_from_numpy`). `forward` runs a Python loop
over the layers under `torch.inference_mode()`, with no remat, since
nothing trains in this slice; the reference's `jax.lax.scan` exists for
compile time, which PyTorch does not pay.

Entry points:
  param_defs / init_params
  forward(...)            logits (+ prefill cache)
  prefill(...)            forward with the cache
  init_cache / decode_step
The MoE, SSM, hybrid, audio and VLM families, the loss and the sharding
helpers come with later slices; asking for another family raises.
"""

from __future__ import annotations

import dataclasses

import torch

from ..configs.registry import ArchConfig
from ..device import DEFAULT_DEVICE, resolve_device
from . import attention
from .embedding import embed_lookup
from .layers import (DTYPE, ParamDef, init_tree, map_defs, mlp_apply,
                     mlp_params, norm_apply, norm_params)

__all__ = ["param_defs", "init_params", "forward", "prefill", "init_cache",
           "decode_step"]

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


def forward(params: dict, batch: dict, cfg: ArchConfig, *,
            want_cache: bool = False):
    """Full-sequence forward over batch["tokens"] (B, S). Returns
    (logits (B, S, V) f32, aux, z, cache | None); aux and z, the MoE
    losses of the reference, are zero for the dense family. The cache
    holds k, v (L, B, S, KV, hd) and pos = S."""
    _check_dense(cfg)
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
