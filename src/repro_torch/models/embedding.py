"""Embedding lookup: a row gather from the (V, d) table, and its sharded
form under a mesh.

The port of `repro.models.embedding.embed_lookup`. Without a mesh (or on
one whose axes split nothing) it is the plain gather. Under an ambient
mesh it runs the reference's `shard_map` program per coordinate
(`parallel.collectives.region`): the table is split with its vocabulary
over `model` and its width over `data` (where they divide), the tokens
over the batch axes. Each coordinate all-gathers its table slice over
`data`, gathers the ids that fall in its vocabulary range (the others
read row 0 and are zeroed), and the partial embeddings are summed with
`psum` over `model`. Exactly one coordinate of a `model` group holds each
id's row and the others add zeros, so the result is the mesh-free
lookup's bits. The backward is the local gather's scatter-add and the
all-gather's reduce-scatter.

`embed_lookup_laid_out` runs the same body in the partitioned program on
a table already laid out (its own spec: `vocab` over `model`, `embed_w`
over `data` under the default rules) and each coordinate's token rows;
its output stays per coordinate, (B_loc, S, d), whole over the vocab's
axis.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..launch.mesh import current_mesh
from ..parallel import collectives as col
from ..parallel.sharding import PartitionSpec as P

__all__ = ["embed_lookup", "embed_lookup_laid_out"]


def _lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """`F.embedding` rather than `index_select`: the same gather, but its
    backward on the card sums a token's rows in one order (sorted), where
    `index_select`'s adds them with atomics, so a training step repeats
    its bits."""
    return F.embedding(tokens, embed)


def _local_lookup(mesh, emb, tokens, *, model_axis, data_axis):
    if data_axis:
        emb = col.all_gather(emb, data_axis, 1, mesh)
    base = col.axis_index(model_axis, mesh) if model_axis else None
    out = {}
    for c in mesh.coords():
        table, tok = emb[c], tokens[c]
        v_loc = table.shape[0]
        rel = tok - base[c] * v_loc if model_axis else tok
        ok = (rel >= 0) & (rel < v_loc)
        x = _lookup(table, rel.clamp(0, v_loc - 1))
        out[c] = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                             device=x.device))
    if model_axis:
        out = col.psum(out, model_axis, mesh)
    return (out,)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """embed: (V, d); tokens: (...) integer ids. Returns (..., d)."""
    mesh = current_mesh()
    if mesh is None or not mesh.shape:
        return _lookup(embed, tokens)
    axes = dict(mesh.shape)
    model_axis = ("model" if axes.get("model", 1) > 1
                  and embed.shape[0] % axes["model"] == 0 else None)
    data_axis = ("data" if axes.get("data", 1) > 1
                 and embed.shape[1] % axes["data"] == 0 else None)
    batch_axes = tuple(a for a in ("pod", "data") if a in axes
                       and tokens.shape[0] % axes[a] == 0)
    if batch_axes and tokens.shape[0] % math.prod(axes[a] for a in batch_axes):
        batch_axes = batch_axes[:1]
    bspec = batch_axes if batch_axes else None
    tok_spec = P(bspec, *([None] * (tokens.ndim - 1)))
    out_spec = P(bspec, *([None] * tokens.ndim))

    def body(emb, tok):
        return _local_lookup(mesh, emb, tok, model_axis=model_axis, data_axis=data_axis)

    return col.region(body, mesh, (P(model_axis, data_axis), tok_spec),
                      (out_spec,))(embed, tokens)[0]


def embed_lookup_laid_out(embed: col.DistArray, tokens: dict) -> dict:
    """The lookup of each coordinate's `tokens` (B_loc, S) in the laid-out
    (V, d) table: its width gathered over the axes that split it, its
    vocabulary rows looked up where the coordinate holds them, summed over
    the vocabulary's axes (`_local_lookup`)."""
    vocab_axis, width_axis = embed.spec
    return _local_lookup(embed.mesh, col.per_coord(embed), tokens,
                         model_axis=vocab_axis, data_axis=width_axis)[0]
