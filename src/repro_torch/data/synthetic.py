"""Synthetic, deterministic, host-sharded batches for every LM family.

The port of `repro.data.synthetic`. Every batch is a pure function of
(seed, step), drawn from ``numpy.random.default_rng([seed, step])``, so
any host can make its shard alone and a restored stream needs only its
step counter. The draws are not the reference's, which come from
`jax.random`: a comparison of the two packages feeds both one numpy batch.
The shapes are the reference's `_batch_shapes`: tokens (and labels) for
the token families; frame embeddings, a Bernoulli(0.15) frame mask and
codebook labels for audio; patch embeddings and max(seq - patches, 1)
text tokens for VLM. `input_specs` gives the same inputs as `meta`
tensors (shapes and dtypes, no allocation) at the reference's dtypes: ids
int32 (`make_batch` draws them int64; the model takes either), masks
bool, embeddings in the activation dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.registry import ArchConfig
from ..configs.shapes import ShapeConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..models.layers import DTYPE

__all__ = ["make_batch", "input_specs", "TokenStream", "host_shard"]

MASK_RATE = 0.15      # audio: the share of frames masked


def _batch_shapes(cfg: ArchConfig, batch: int, seq: int, kind: str) -> dict:
    """{name: (shape, kind of draw)} of the model inputs, the reference's
    `_batch_shapes`; a draw is "ids" (ints in [0, vocab)), "mask" or
    "embeds"."""
    if kind == "decode":
        return {"tokens": ((batch,), "ids")}
    if cfg.family == "audio":
        return {"frame_embeds": ((batch, seq, cfg.d_model), "embeds"),
                "mask": ((batch, seq), "mask"), "labels": ((batch, seq), "ids")}
    out = {}
    if cfg.family == "vlm":
        n_img = cfg.n_frontend_tokens
        out["patch_embeds"] = ((batch, n_img, cfg.d_model), "embeds")
        seq = max(seq - n_img, 1)
    out["tokens"] = ((batch, seq), "ids")
    if kind == "train":
        out["labels"] = ((batch, seq), "ids")
    return out


_SPEC_DTYPES = {"ids": torch.int32, "mask": torch.bool, "embeds": DTYPE}


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """One (arch x shape) cell's model inputs as `meta` tensors."""
    shapes = _batch_shapes(cfg, shape.global_batch, shape.seq_len, shape.kind)
    return {name: torch.empty(dims, dtype=_SPEC_DTYPES[what], device="meta")
            for name, (dims, what) in shapes.items()}


def _draw(rng: np.random.Generator, shape: tuple, what: str, vocab: int) -> torch.Tensor:
    if what == "ids":
        return torch.from_numpy(rng.integers(0, vocab, shape, dtype=np.int64))
    if what == "mask":
        return torch.from_numpy(rng.random(shape) < MASK_RATE)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(DTYPE)


def make_batch(cfg: ArchConfig, batch: int, seq: int, rng: np.random.Generator,
               kind: str = "train",
               device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """One batch of `_batch_shapes`: ids int64 in [0, vocab), masks bool,
    embeddings in the activation dtype (bf16). kind "train" adds labels,
    "prefill" leaves them out (audio keeps its labels), and "decode" gives
    "tokens" (B,). The draws come from `rng` in sorted name order, as the
    reference splits its key."""
    device = resolve_device(device)
    shapes = _batch_shapes(cfg, batch, seq, kind)
    return {name: _draw(rng, *shapes[name], cfg.vocab).to(device)
            for name in sorted(shapes)}


@dataclasses.dataclass
class TokenStream:
    """Stateful, restorable batch iterator (pure function of seed + step)."""
    cfg: ArchConfig
    batch: int
    seq: int
    seed: int = 0
    step: int = 0
    kind: str = "train"
    device: str = DEFAULT_DEVICE

    def next(self) -> dict:
        b = make_batch(self.cfg, self.batch, self.seq,
                       np.random.default_rng([self.seed, self.step]), self.kind,
                       self.device)
        self.step += 1
        return b

    def state_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, s: dict) -> None:
        self.seed, self.step = int(s["seed"]), int(s["step"])


def host_shard(batch: dict, host_index: int, n_hosts: int) -> dict:
    """Slice the global batch to one host's rows (data-loading sharding)."""
    def slice_one(x):
        per = x.shape[0] // n_hosts
        return x[host_index * per:(host_index + 1) * per]
    return {k: slice_one(v) for k, v in batch.items()}
