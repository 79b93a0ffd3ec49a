"""Embedding lookup: a plain row gather from the (V, d) table.

The port of `repro.models.embedding.embed_lookup` on one device. The
reference's vocab-sharded `shard_map` path waits for the port of
`repro.parallel` (ROADMAP A14).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["embed_lookup"]


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """embed: (V, d); tokens: (...) integer ids. Returns (..., d).

    `F.embedding` rather than `index_select`: the same gather, but its
    backward on the card sums a token's rows in one order (sorted), where
    `index_select`'s adds them with atomics, so a training step repeats
    its bits."""
    return F.embedding(tokens, embed)
