"""Synthetic, deterministic, host-sharded token batches for the dense family.

The port of `repro.data.synthetic`. Every batch is a pure function of
(seed, step), drawn from ``numpy.random.default_rng([seed, step])``, so
any host can make its shard alone and a restored stream needs only its
step counter. The draws are not the reference's, which come from
`jax.random`: a comparison of the two packages feeds both one numpy batch.
The dry run's `input_specs` comes with the port of the dry run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.registry import ArchConfig
from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["make_batch", "TokenStream", "host_shard"]


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name}: synthetic {cfg.family} inputs come with "
                         "that family's slice of the port")


def make_batch(cfg: ArchConfig, batch: int, seq: int, rng: np.random.Generator,
               kind: str = "train",
               device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """One batch: "tokens" (B, S) int64 in [0, vocab), and for kind "train"
    "labels" (B, S) drawn the same way; kind "decode" gives "tokens" (B,).
    The draws come from `rng` in sorted name order, as the reference
    splits its key."""
    _check_dense(cfg)
    device = resolve_device(device)
    shapes = ({"tokens": (batch,)} if kind == "decode" else
              {"tokens": (batch, seq), **({"labels": (batch, seq)}
                                          if kind == "train" else {})})
    return {name: torch.from_numpy(rng.integers(0, cfg.vocab, shapes[name],
                                                dtype=np.int64)).to(device)
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
