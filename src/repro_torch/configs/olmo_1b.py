"""olmo-1b [dense] — non-parametric LN [arXiv:2402.00838; hf]."""

from .registry import ArchConfig, register

CONFIG = register(ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,         # MHA
    head_dim=128,
    d_ff=8192,
    vocab=50304,
    norm="nonparam_ln",    # OLMo's non-parametric LayerNorm
    activation="swiglu",
    tie_embeddings=True,
    source="[arXiv:2402.00838; hf]",
))
