"""granite-34b [dense] — llama-arch code model [arXiv:2405.04324; hf]."""

from .registry import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,          # MQA
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    norm="rmsnorm",
    activation="swiglu",
    source="[arXiv:2405.04324; hf]",
))
