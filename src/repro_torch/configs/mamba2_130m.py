"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060]."""

from .registry import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,             # attention-free
    n_kv_heads=0,
    d_ff=0,                # no separate FFN; the mamba block is the mixer
    vocab=50280,
    norm="rmsnorm",
    ssm=SSMConfig(state_size=128, d_inner=1536, head_dim=64, chunk=256,
                  d_conv=4),
    subquadratic=True,
    tie_embeddings=True,
    source="[arXiv:2405.21060; unverified]",
))
