"""Embedding lookup: a plain row gather from the (V, d) table.

The port of `repro.models.embedding.embed_lookup` on one device. The
reference's vocab-sharded `shard_map` path waits for the port of
`repro.parallel` (ROADMAP A14).
"""

from __future__ import annotations

import torch

__all__ = ["embed_lookup"]


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """embed: (V, d); tokens: (...) integer ids. Returns (..., d)."""
    rows = embed.index_select(0, tokens.reshape(-1))
    return rows.reshape(*tokens.shape, embed.shape[1])
