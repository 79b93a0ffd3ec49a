"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]."""

from .registry import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,         # MHA
    head_dim=128,
    d_ff=0,
    vocab=151936,
    norm="rmsnorm",
    activation="swiglu",
    moe=MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408,
                  num_shared_experts=4, shared_d_ff=5632),
    source="[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]",
))
