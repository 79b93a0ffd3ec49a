"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""

from .registry import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,          # GQA
    head_dim=128,
    d_ff=0,                # every FFN is MoE
    vocab=100352,
    norm="layernorm",
    activation="swiglu",
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752),
    source="[hf:databricks/dbrx-base; unverified]",
))
