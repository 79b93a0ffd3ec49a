"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend stub
[hf:microsoft/Phi-3-vision-128k-instruct].

The CLIP image tower is a STUB per the brief: input_specs() provides
precomputed patch embeddings (batch, n_frontend_tokens, d_model) that are
prefixed to the text sequence; loss is computed on text positions only.
"""

from .registry import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,         # MHA
    head_dim=96,           # 3072 / 32
    d_ff=8192,
    vocab=32064,
    norm="rmsnorm",
    activation="swiglu",
    frontend="vision",
    n_frontend_tokens=576,     # 24x24 CLIP patch grid
    source="[hf:microsoft/Phi-3-vision-128k-instruct; hf]",
))
