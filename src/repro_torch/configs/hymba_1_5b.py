"""hymba-1.5b [hybrid] — parallel attention + mamba heads [arXiv:2411.13676].

Each layer runs attention heads and SSM heads in parallel on the same input
and mean-combines their (normalized) outputs. Attention is sliding-window in
all layers (the HF config uses SWA everywhere except 3 global layers; we use
SWA throughout and note the deviation in DESIGN.md — meta tokens omitted),
making the arch sub-quadratic and long_500k-eligible.
"""

from .registry import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,          # GQA
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    norm="rmsnorm",
    activation="swiglu",
    ssm=SSMConfig(state_size=16, d_inner=3200, head_dim=64, chunk=256,
                  d_conv=4),
    sliding_window=1024,
    subquadratic=True,
    source="[arXiv:2411.13676; hf]",
))
