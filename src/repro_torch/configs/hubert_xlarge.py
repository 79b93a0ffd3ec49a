"""hubert-xlarge [audio] — encoder-only, w2v2 arch [arXiv:2106.07447].

The conv waveform frontend is a STUB per the brief: input_specs() provides
precomputed frame embeddings (batch, frames, d_model). Training objective is
masked-frame prediction over the 504-class codebook.
"""

from .registry import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,           # 1280 / 16
    d_ff=5120,
    vocab=504,             # masked-prediction codebook classes
    norm="layernorm",
    activation="gelu",
    causal=False,          # bidirectional encoder
    decode_capable=False,  # no autoregressive step
    frontend="audio",
    source="[arXiv:2106.07447; unverified]",
))
