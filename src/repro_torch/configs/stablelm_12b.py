"""stablelm-12b [dense] — [hf:stabilityai/stablelm-2-1_6b family; hf]."""

from .registry import ArchConfig, register

CONFIG = register(ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,          # GQA
    head_dim=160,          # 5120 / 32
    d_ff=13824,
    vocab=100352,
    norm="layernorm",
    activation="swiglu",
    source="[hf:stabilityai/stablelm-2-12b; hf]",
))
