"""granite-8b [dense] — llama-arch code model [arXiv:2405.04324; hf]."""

from .registry import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,          # GQA
    head_dim=128,
    d_ff=14336,
    vocab=49152,
    norm="rmsnorm",
    activation="swiglu",
    source="[arXiv:2405.04324; hf]",
))
