"""Logical-axis sharding rules, resolved against the port's mesh.

The port of `repro.parallel.sharding`. Model code names each tensor's
dimensions with *logical* axes ("batch", "heads", "ffn", ...); a
`ShardingRules` table maps them to mesh axes. Resolution is
divisibility-aware, as the reference's: a mesh axis that does not divide
its dimension is dropped (mamba2's 24 SSM heads on a 16-way model axis
stay whole), and a mesh axis that an earlier dimension took is not used
again.

`logical_spec` returns a `PartitionSpec`, a tuple of per-dimension
entries (None, a mesh axis, or a tuple of mesh axes split row-major), so
a test compares it with ``tuple(jax_spec)``. `named_sharding` pairs it
with a mesh (`NamedSharding`), the layout `collectives.distribute` and
`checkpoint.ckpt.restore(shardings=)` take.

`shard(x, *logical)` is the reference's `with_sharding_constraint`. On a
whole tensor (the global view: under a mesh the activations stay whole
on the mesh's home device) the constraint moves nothing and `shard`
returns `x` itself. Under an ambient mesh it resolves the spec (checking
the rank) and records it in the layout ledger that
`sharded_blockmatrix.record_specs()` opens, as a `SpecRecord` with op
"shard", kind "logical" and the logical names in `axes`. Without a mesh
it costs one context-variable read.

Inside the partitioned program (`Program`: a laid-out state, each
coordinate computing on its own shards) `Program.shard` takes the
per-coordinate dict and the global shape and is a check: each
coordinate's tensor must be the global shape cut by the resolved spec,
which it records as above. A rules set that maps an activation axis the program does not
split (`seq` for Megatron's sequence parallelism, `ssm_chunk`, `embed`)
to a mesh axis raises ValueError naming that axis. `lay_out` places a
tree by a tree of `NamedSharding`s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..launch.mesh import Mesh, current_mesh
from .collectives import _sizes, distribute, region_of
from .sharded_blockmatrix import _record

__all__ = ["ShardingRules", "DEFAULT_RULES", "PartitionSpec", "NamedSharding",
           "logical_spec", "shard", "named_sharding", "mesh_axis_size", "Program",
           "REALISED", "lay_out"]

AxisRule = Union[None, str, tuple[str, ...]]


class PartitionSpec(tuple):
    """Per-dimension mesh axes: None (whole), a mesh axis name, or a tuple
    of names (split over their product, the first outermost). A tuple, so
    it compares equal to ``tuple(jax.sharding.PartitionSpec(...))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout on a mesh: the twin of `jax.sharding.NamedSharding`."""
    mesh: Mesh
    spec: PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (or tuple for multi-axis sharding)."""
    batch: AxisRule = ("pod", "data")
    seq: AxisRule = None              # 'model' enables Megatron-style SP
    kv_seq: AxisRule = "model"        # decode-time KV cache length
    heads: AxisRule = "model"
    kv_heads: AxisRule = "model"
    ffn: AxisRule = "model"
    vocab: AxisRule = "model"
    experts: AxisRule = "model"
    ssm_inner: AxisRule = "model"
    ssm_chunk: AxisRule = None        # SSD chunk-parallel sharding: opt-in
    embed: AxisRule = None            # activation embedding dim
    embed_w: AxisRule = "data"        # weight FSDP dim
    layers: AxisRule = None
    none: AxisRule = None

    def get(self, name: Optional[str]) -> AxisRule:
        if name is None:
            return None
        return getattr(self, name)


DEFAULT_RULES = ShardingRules()


def _mesh_axes(mesh) -> dict[str, int]:
    return dict(mesh.shape) if mesh is not None else {}


def _resolve_one(dim: int, rule: AxisRule, axes: dict[str, int], used: set[str]):
    """Keep only mesh axes that exist, are unused by earlier dims of this
    tensor, and whose product divides `dim`."""
    if rule is None:
        return None
    parts = (rule,) if isinstance(rule, str) else tuple(rule)
    kept: list[str] = []
    size = 1
    for pt in parts:
        if pt not in axes or pt in used:
            continue
        if dim % (size * axes[pt]) == 0:
            kept.append(pt)
            size *= axes[pt]
    used.update(kept)
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else tuple(kept)


def logical_spec(shape: tuple[int, ...], logical: tuple[Optional[str], ...],
                 rules: ShardingRules, mesh=None) -> PartitionSpec:
    """Resolve per-dim logical names into a PartitionSpec for `mesh`
    (default: the ambient one). Reads only ``mesh.shape``. Earlier dims
    win conflicting mesh axes; a rank mismatch raises."""
    if mesh is None:
        mesh = current_mesh()
    axes = _mesh_axes(mesh)
    if len(shape) != len(logical):
        raise ValueError(f"rank mismatch: shape {tuple(shape)} vs logical {logical}")
    used: set[str] = set()
    return PartitionSpec(*[_resolve_one(d, rules.get(name), axes, used)
                           for d, name in zip(shape, logical)])


# The logical axes the partitioned program splits: the batch rows, the
# heads, the ffn and vocab columns, the MoE experts, the SSD heads and
# their inner width, the weights' FSDP dimension, and the decode cache's
# sequence.
REALISED = ("batch", "heads", "kv_heads", "ffn", "vocab", "experts", "ssm_inner", "embed_w",
            "kv_seq")


def shard(x: torch.Tensor, *logical: Optional[str],
          rules: ShardingRules = DEFAULT_RULES) -> torch.Tensor:
    """The reference's sharding constraint: `x` itself, its resolved spec
    recorded in an open layout ledger (no-op without a mesh)."""
    mesh = current_mesh()
    if mesh is None or not mesh.shape:
        return x
    spec = logical_spec(tuple(x.shape), logical, rules, mesh)
    _record("shard", "logical", x.shape, spec, tuple(logical), mesh)
    return x


def named_sharding(mesh: Mesh, shape: tuple[int, ...],
                   logical: tuple[Optional[str], ...],
                   rules: ShardingRules = DEFAULT_RULES) -> NamedSharding:
    return NamedSharding(mesh, logical_spec(shape, logical, rules, mesh))


def mesh_axis_size(name: str) -> int:
    mesh = current_mesh()
    if mesh is None or name not in mesh.shape:
        return 1
    return mesh.shape[name]


def _check_parts(xs: dict, shape, logical, rules: ShardingRules, mesh: Mesh) -> dict:
    spec = logical_spec(tuple(shape), logical, rules, mesh)
    for name, entry in zip(logical, spec):
        if entry is not None and name not in REALISED:
            raise ValueError(f"the partitioned program does not realise the logical axis "
                             f"{name!r} over {entry!r}: it splits only {REALISED}")
    _record("shard", "logical", shape, spec, tuple(logical), mesh)
    for c, t in xs.items():
        want = _sizes(region_of(shape, spec, mesh, c))
        if tuple(t.shape) != want:
            raise ValueError(f"shard {logical}: coordinate {c} holds {tuple(t.shape)}, "
                             f"where {spec} cuts {tuple(shape)} to {want}")
    return xs


@dataclasses.dataclass(frozen=True)
class Program:
    """The frame of a partitioned program: its mesh, its rules, and the
    global (batch, seq) extent of its activations."""
    mesh: Mesh
    rules: ShardingRules
    batch: int
    seq: int

    def spec(self, shape: tuple[int, ...], logical) -> PartitionSpec:
        return logical_spec(tuple(shape), tuple(logical), self.rules, self.mesh)

    def shard(self, xs: dict, shape: tuple[int, ...], *logical) -> dict:
        """The sharding constraint inside the program: each coordinate's
        tensor of `xs` must be the global `shape` cut by the resolved spec
        (recorded as `shard` records it); a spec that splits an axis the
        program does not realise raises ValueError naming it."""
        return _check_parts(xs, tuple(shape), logical, self.rules, self.mesh)


def lay_out(tree, shardings):
    """Each tensor leaf of `tree` laid out by the matching `NamedSharding`
    of `shardings` (a tree of the same structure): a DistArray on that
    sharding's mesh whose shards own their memory (a copy of each distinct
    region a place, so the whole leaf can be freed: a process holds only
    its own coordinates' regions). A leaf on the host is copied region by
    region to the mesh's devices: no whole leaf reaches them."""
    from ..tree import leaves, unflatten
    from .collectives import zip_map

    flat, specs = leaves(tree), leaves(shardings)
    if len(specs) != len(flat):
        raise ValueError(f"shardings has {len(specs)} leaves, the tree {len(flat)}")
    out = []
    for t, sh in zip(flat, specs):
        t = torch.as_tensor(t)
        laid = distribute(t, sh.spec, sh.mesh)
        # a region on t's own device is a view of t; on another, a copy
        out.append(zip_map(lambda s: s.clone(memory_format=torch.contiguous_format)
                           if s.device == t.device else s, laid))
    return unflatten(tree, out)
