"""Architecture config registry: dataclasses + `--arch <id>` lookup.

A copy of the JAX package's registry, so that `get_arch(name)` and
`.reduced()` give the same fields in both packages. `attn_q_chunk` and
`attn_kv_chunk` are the JAX scan's tiling hints; the port's attention
kernel tiles itself and ignores them.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "register", "get_arch",
           "list_archs"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    shared_d_ff: int = 0              # total ffn width of the shared experts
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_size: int
    d_inner: int = 0                  # 0 -> 2*d_model
    head_dim: int = 64
    chunk: int = 256
    d_conv: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                      # 0 for attn-free
    n_kv_heads: int
    d_ff: int                         # dense-branch ffn width (0 if none)
    vocab: int
    head_dim: int = 128
    norm: str = "rmsnorm"             # rmsnorm | layernorm | nonparam_ln
    activation: str = "swiglu"        # swiglu | gelu
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    causal: bool = True               # False for encoder-only
    decode_capable: bool = True       # False for encoder-only
    subquadratic: bool = False        # eligible for long_500k
    sliding_window: int = 0           # 0 = full attention
    frontend: Optional[str] = None    # audio | vision (stub embeddings)
    n_frontend_tokens: int = 0        # e.g. CLIP patch tokens for VLM
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    source: str = ""                  # provenance note [paper; tier]
    # perf knobs (hillclimb targets; defaults = baseline)
    attn_q_chunk: int = 2048
    attn_kv_chunk: int = 2048

    @property
    def attn_free(self) -> bool:
        return self.n_heads == 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers), for 6ND math."""
        d, l = self.d_model, self.n_layers
        p = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if not self.attn_free:
            kv = self.n_kv_heads * self.head_dim
            q = self.n_heads * self.head_dim
            per_layer += d * q + 2 * d * kv + q * d
        if self.d_ff:
            mults = 3 if self.activation == "swiglu" else 2
            per_layer += mults * d * self.d_ff
        if self.moe:
            mults = 3 if self.activation == "swiglu" else 2
            per_layer += self.moe.num_experts * mults * d * self.moe.d_ff_expert
            per_layer += mults * d * self.moe.shared_d_ff
            per_layer += d * self.moe.num_experts          # router
        if self.ssm:
            di = self.ssm.d_inner or 2 * d
            n_h = di // self.ssm.head_dim
            # in_proj (z, x, B, C, dt) + out_proj + conv
            per_layer += d * (2 * di + 2 * self.ssm.state_size * n_h + n_h) + di * d
            per_layer += (di + 2 * self.ssm.state_size * n_h) * self.ssm.d_conv
        return p + l * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.param_count()
        d, l = self.d_model, self.n_layers
        mults = 3 if self.activation == "swiglu" else 2
        inactive = (self.moe.num_experts - self.moe.top_k) * mults * d * \
            self.moe.d_ff_expert
        return self.param_count() - l * inactive

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        changes: dict = dict(
            n_layers=2,
            d_model=64,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            head_dim=16,
            n_heads=0 if self.attn_free else 4,
            n_kv_heads=0 if self.attn_free else max(1, 4 * self.n_kv_heads
                                                    // max(self.n_heads, 1)),
            sliding_window=32 if self.sliding_window else 0,
            n_frontend_tokens=8 if self.frontend else 0,
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_ff_expert=64,
                shared_d_ff=64 if self.moe.num_shared_experts else 0)
        if self.ssm:
            changes["ssm"] = dataclasses.replace(
                self.ssm, state_size=16, d_inner=128, head_dim=32, chunk=16)
        return dataclasses.replace(self, **changes)


_REGISTRY: dict[str, ArchConfig] = {}

_ARCH_MODULES = [
    "granite_34b", "olmo_1b", "stablelm_12b", "granite_8b", "mamba2_130m",
    "dbrx_132b", "qwen2_moe_a2_7b", "hubert_xlarge", "hymba_1_5b",
    "phi3_vision_4_2b",
]


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all() -> None:
    for mod in _ARCH_MODULES:
        importlib.import_module(f"{__package__}.{mod}")


def get_arch(name: str) -> ArchConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)
