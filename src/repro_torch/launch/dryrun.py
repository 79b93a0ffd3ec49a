"""Dry run: every (arch × shape) cell, and the SPIN solver, on the
production meshes, with no storage and no card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --solver --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both   # the grid

The port of `repro.launch.dryrun`. The reference lowers and compiles each
cell on 512 fake host devices and reads the compiler's cost and memory
analysis. The port instead *runs* each cell's step once, on `meta`
tensors (shapes and dtypes, no storage), under the production mesh
(`launch.mesh.make_production_mesh(devices=["meta"])`: 256 or 512
coordinates, all on the meta device), inside one counting dispatch mode.
The names and record keys are the reference's, so each has its
counterpart: `build_train` / `build_prefill` / `build_decode` return (fn,
args, in_specs, out_specs, donate); `_trace_cell` is `_compile_cell`'s
counterpart, `_measure`, `_extrapolate`, `collective_stats`, `run_cell`,
`run_solver_cell` and `main()` keep their roles and flags; `lay_out_args`
is the counterpart of the jit's ``in_shardings``. Records land in
`experiments/dryrun_torch/` by default. The counts of the partitioned
program from the shapes (`partitioned_step_collectives`,
`partitioned_serve_collectives`, `shampoo_refresh_moves`) take a
(data, model) or a (pod, data, model) mesh shape.

What each record key means in the port:

* ``per_device.argument_bytes``: the sum of each argument leaf's local
  shard bytes under its spec (`param_specs`, the optimizer state's specs,
  `_batch_specs`, `cache_specs`; a replicated 0-dim counter counts whole).
  It equals the reference's `argument_size_in_bytes` on olmo-1b.
* ``per_device.output_bytes`` and ``alias_bytes``: the same rule for the
  outputs the reference gives specs to (train: the state, donated; the
  metric scalars are not counted) and for the donated cache (decode).
  Outputs whose layout the reference leaves to its compiler (prefill's
  logits and cache, decode's logits) take the spec the port's `shard`
  sites record (`record_specs()`); where none is recorded the key is null.
* ``per_device.temp_bytes`` is null: one controller holds no per-device
  intermediates. ``temp_bytes_global`` is the peak of the live
  intermediate bytes during the run: each output of an aten op that is
  not a view counts from when it is made until its tensor is freed.
* ``cost.flops``: the whole program's operations ÷ chips, with
  ``flops_global`` beside it: the matmul-class aten ops that
  `torch.utils.flop_counter`'s formulas count (composite ops decomposed
  first, as `FlopCounterMode` does), plus the work the kernels' meta
  branches book (`kernels.BOOKED`: B6 and B6-bwd, 4·hd and 10·hd a (q, k)
  pair their tiles visit).
* ``cost.bytes_accessed``: the tensor inputs plus outputs of each aten op
  that is not a view (an unfused count), plus the kernels' booked bytes,
  ÷ chips.
* ``cost.coll_bytes``, ``collectives_once`` and ``collectives_port``:
  the collectives of the partitioned program, the reference's placed
  jit's counterpart (``coll_scope`` "partitioned"): the cell's arguments
  laid out on the mesh as the reference's ``in_shardings`` lay them
  (`lay_out_args`: a DistArray a leaf, each coordinate computing on its
  own regions: FSDP's gathers and their reduce-scatters, tensor
  parallelism's psums, the held regions' gradient sums), run by the
  reference's method: probes at L = 1 and 2 with one microbatch (B/M rows
  of a train cell), `_extrapolate`d in depth and times M. They are the
  port's own counts (`parallel.collective_bytes()` and
  `collective_calls()`: bytes a coordinate receives, every layer), bytes
  ÷ chips, mapped onto the reference's five names: all_gather, gather,
  to_dense and replicate (0 in one process) -> all-gather; psum, pmean
  and pmax -> all-reduce; all_to_all and reshard -> all-to-all; ring ->
  collective-permute; the all_gather's backward (reduce_scatter) ->
  reduce-scatter. The reference counts HLO operand bytes, a loop body
  once, so the two compare only through a formula for each side.
* ``cost_partitioned``: the partitioned program's own flops,
  flops_global, bytes_accessed and coll_bytes a device, its booked
  kernels (B6 and B6-bwd a coordinate), its laid-out arguments' bytes a
  device (equal to ``per_device.argument_bytes``), the microbatch scale,
  its probes and their host seconds (``trace_s``). Its bytes_accessed
  counts the probe's optimizer update M times.
* ``analytic``: the bytes and calls by kind that
  `partitioned_step_collectives` or `partitioned_serve_collectives`
  count from the shapes, and ``analytic_match`` whether the partitioned
  program's equal them; both null for a rules set the counts do not
  cover.
* A rules set that the partitioned program refuses (`sp`, `fsdp_both`,
  `ssd_cp`, `sp_ssd_cp`: they split an axis it does not realise) keeps
  the global view's collectives, ``coll_scope`` "port regions" (only its
  per-coordinate regions: the embedding, MoE's expert parallelism), and
  records the refusal in ``partitioned_error``.
* ``cost`` equals ``cost_raw``: an eager run counts every loop iteration.
  Their flops and bytes_accessed are the global view's full run (the
  whole program ÷ chips), their coll_bytes the partitioned program's.
  ``cost_extrapolated`` is `_extrapolate` of the global view's probes at
  L = 1 and 2 (one microbatch, under `scan_util.unroll_scans()`), a
  cross-check; on a dense cell its FLOPs equal the full run's exactly.
* ``trace_s``: the host seconds of the global view's full run (the
  counterpart of ``lower_s``); every per-coordinate region runs once a
  coordinate, so it grows with the mesh, and so do the partitioned
  probes' (``cost_partitioned.trace_s``). ``method`` says how each number
  was taken. ``variant_effect`` says what a config variant changes in the
  port: the attention-chunk variants change nothing, as the kernel tiles
  itself.

The solver cell runs the laid-out `ShardedBlockMatrix` program, so its
``coll_scope`` is "partitioned" too.

The kernel launch counters do not move: the meta branches build and
launch nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import kernels
from ..configs import SHAPES, cell_status, get_arch, list_archs
from ..configs.registry import ArchConfig
from ..configs.shapes import ShapeConfig
from ..data.synthetic import input_specs
from ..models import ssm as ssm_mod, transformer as T
from ..models.layers import PARAM_DTYPE
from ..models.scan_util import unroll_scans
from ..optim.adamw import AdamWState
from ..optim.spin_shampoo import SpinShampooConfig, SpinShampooState, _is_matrix, factor_spec
from ..parallel.collectives import (DistArray, collective_bytes, collective_calls, grid_spec,
                                    region_of, reset_collective_bytes)
from ..parallel.sharded_blockmatrix import record_specs
from ..parallel.sharding import (DEFAULT_RULES, NamedSharding, PartitionSpec as P,
                                 ShardingRules, lay_out, logical_spec)
from ..runtime.trainer import (TrainConfig, TrainState, abstract_state, make_train_step,
                               state_shardings)
from ..tree import leaves, tree_map
from .mesh import Mesh, make_production_mesh, set_mesh

__all__ = ["RULES_VARIANTS", "CFG_VARIANTS", "collective_stats",
           "partitioned_step_collectives", "partitioned_serve_collectives",
           "shampoo_refresh_moves",
           "moe_block_collectives", "ssm_block_collectives", "build_train",
           "build_prefill", "build_decode", "lay_out_args", "trace_partitioned",
           "analytic_collectives", "run_cell", "run_solver_cell", "main"]

# Named sharding-rule variants (the reference's hillclimb knobs).
RULES_VARIANTS: dict[str, ShardingRules] = {
    "default": DEFAULT_RULES,
    "sp": ShardingRules(seq="model"),                   # Megatron-style SP
    "dp_only": ShardingRules(heads=None, kv_heads=None, ffn=None,
                             vocab=None, experts=None, ssm_inner=None,
                             embed_w=("data", "model")),
    "fsdp_both": ShardingRules(embed_w=("data", "model"), seq="model"),
    "ssd_cp": ShardingRules(ssm_chunk="model"),
    "sp_ssd_cp": ShardingRules(seq="model", ssm_chunk="model"),
}


def _hymba_tuned(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, attn_q_chunk=512, attn_kv_chunk=512,
                               ssm=dataclasses.replace(cfg.ssm, chunk=64))


def _hymba_tuned2(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, attn_q_chunk=512, attn_kv_chunk=512,
                               ssm=dataclasses.replace(cfg.ssm, chunk=32))


def _ssd_chunk(q: int):
    def f(cfg: ArchConfig) -> ArchConfig:
        return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=q))
    return f


def _attn_chunk(q: int):
    def f(cfg: ArchConfig) -> ArchConfig:
        return dataclasses.replace(cfg, attn_q_chunk=q, attn_kv_chunk=q)
    return f


# Named config transforms (the reference's hillclimb knobs).
CFG_VARIANTS = {
    "base": lambda cfg: cfg,
    "hymba_tuned": _hymba_tuned,
    "hymba_tuned2": _hymba_tuned2,
    "ssd_chunk_64": _ssd_chunk(64),
    "ssd_chunk_128": _ssd_chunk(128),
    "attn_chunk_512": _attn_chunk(512),
    "attn_chunk_1024": _attn_chunk(1024),
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# The port's collective kinds under the reference's HLO names.
_KIND_NAMES = {"all_gather": "all-gather", "gather": "all-gather",
               "to_dense": "all-gather", "psum": "all-reduce",
               "pmean": "all-reduce", "pmax": "all-reduce",
               "all_to_all": "all-to-all", "reshard": "all-to-all",
               "ring": "collective-permute", "reduce_scatter": "reduce-scatter",
               "replicate": "all-gather"}

# Config fields the port reads nowhere: the reference scan's tile sizes.
_UNREAD_FIELDS = ("attn_q_chunk", "attn_kv_chunk")

METHOD = ("one eager run of the cell's step on meta tensors under the production "
          "mesh of meta devices, inside one counting dispatch mode; FLOPs: the "
          "matmul-class aten ops torch.utils.flop_counter counts plus the kernels' "
          "booked work; bytes_accessed: inputs plus outputs of each non-view aten op "
          "plus the kernels' booked bytes; collectives: the port's per-coordinate "
          "regions (collective_bytes), per device = global / chips; argument, output "
          "and alias bytes: each leaf's local shard under its spec; temp_bytes_global: "
          "peak live bytes of non-view op outputs")

METHOD_PARTITIONED = (
    "the partitioned program: the cell's arguments laid out on the mesh of meta devices "
    "by their in-specs (lay_out_args, the reference's in_shardings), each coordinate "
    "computing on its own regions, run eagerly in the counting mode at L = 1 and 2 with "
    "one microbatch (B/M rows of a train cell), _extrapolate'd in depth and times M: "
    "collectives (collective_bytes / collective_calls, every layer, bytes a coordinate "
    "receives), FLOPs and booked kernels exact; bytes_accessed counts the probe's "
    "optimizer update M times")


def _method(scope: str) -> dict:
    """How each number of a cell's record was taken."""
    if scope != "partitioned":
        return {"global_view": METHOD, "collectives": "the global view's port regions: the "
                "partitioned program refuses this rules set (partitioned_error)"}
    return {"global_view": METHOD, "partitioned": METHOD_PARTITIONED,
            "collectives": "cost.coll_bytes, collectives_once and collectives_port: the "
            "partitioned program's; per_device, cost.flops, cost.bytes_accessed, "
            "temp_bytes_global, kernels_booked and probes: the global view's; "
            "cost_partitioned: the partitioned program's own per-device counts"}


def collective_stats(moved: dict, calls: dict, chips: int = 1) -> dict:
    """The port's collectives by kind (bytes and calls, as
    `collective_bytes()` and `collective_calls()` give them) under the
    reference's five names: {name: {"count", "operand_bytes"}} with the
    bytes ÷ `chips`, and "total_operand_bytes"."""
    stats: dict = {c: {"count": 0, "operand_bytes": 0} for c in _COLLECTIVES}
    for kind, nbytes in moved.items():
        name = _KIND_NAMES[kind]
        stats[name]["operand_bytes"] += nbytes / chips
        stats[name]["count"] += calls.get(kind, 0)
    stats["total_operand_bytes"] = sum(
        v["operand_bytes"] for k, v in stats.items() if isinstance(v, dict))
    return stats


class _Tally:
    """Bytes and calls by collective kind on a mesh of `n` coordinates, as
    `collective_bytes()` and `collective_calls()` count them. Every
    coordinate receives (size - 1) shards of an all-gather over `size`
    coordinates (and as many gradient pieces in its reduce-scatter) or
    (size - 1) chunks of an all_to_all; a psum or pmax over `size` brings
    (size - 1) inputs to the group's first coordinate and hands the
    result back to the other size - 1. A collective over one coordinate
    moves nothing and is not counted."""

    def __init__(self, n: int, kinds: tuple[str, ...]):
        self.n = n
        self.moved = dict.fromkeys(kinds, 0)
        self.calls = dict.fromkeys(kinds, 0)

    def _add(self, kind: str, nbytes: int, calls: int) -> None:
        self.moved[kind] += nbytes
        self.calls[kind] += calls

    def gather(self, shard: int, size: int, passes: int = 1, back: bool = False) -> None:
        if size > 1:
            self._add("all_gather", passes * self.n * (size - 1) * shard, passes)
            if back:
                self._add("reduce_scatter", self.n * (size - 1) * shard, 1)

    def all_to_all(self, chunk: int, size: int) -> None:
        if size > 1:
            self._add("all_to_all", self.n * (size - 1) * chunk, 1)

    def psum(self, nbytes: int, size: int, passes: int = 1, back: bool = False,
             kind: str = "psum") -> None:
        calls = passes + back
        if size > 1:
            self._add(kind, calls * (self.n // size) * 2 * (size - 1) * nbytes, calls)


def _moe_layer(t: _Tally, cfg: ArchConfig, lay: "_Layout", rules: str, b: int,
               seq: int, hint: int, passes: int, back: bool) -> None:
    """One MoE layer's collectives on `b` x `seq` tokens, a coordinate's
    rows of them (`models.moe.moe_apply_laid_out`), `passes` forwards (2 under remat)
    and with `back` the backward. Under `dp_only` each expert weight first
    moves its `model` part of the width to the expert axis (all_to_all).
    The experts are all-gathered over `data` (FSDP), the shared experts
    over `model` (the whole shared FFN at every coordinate). Where
    `model` divides the sequence (prefill, training) each coordinate
    routes rows x seq/M tokens, else (decode) rows x seq. Each forward
    sends its (M, cap, d) tokens and (M, cap) int64 expert indices and
    returns the rows (three all_to_all), cap = max(8, int(cf·t·k/M));
    the backward transposes the two bf16 ones. aux and z are pmean'd over
    `data` and the sequence's axis; the output is all-gathered over
    `model` along the sequence. The recompute stops at the layer's last
    saved tensor (the losses), so the pmeans and the output gather run
    once. With `model` 1 every coordinate gathers the batch and the
    experts whole over `data` and keeps its rows of the output. A `pod`
    axis splits the batch (and the pmeans' groups) with `data`."""
    d_n, m_n = lay.sizes["data"], lay.sizes["model"]
    ways = lay.ways(b)
    rows = b // ways
    moe, d, bf = cfg.moe, cfg.d_model, 2
    e_loc = -(-moe.num_experts // hint) * hint // m_n
    f, fs = moe.d_ff_expert, moe.shared_d_ff if moe.num_shared_experts else 0
    if m_n == 1:
        t.gather(rows * seq * d * bf, ways, passes, back)        # the batch
        for _ in range(3):                                         # wi, wg, wo
            t.gather(e_loc * (d // d_n) * f * bf, d_n, passes, back)
        return
    split = seq % m_n == 0
    tokens = rows * (seq // m_n if split else seq)
    cap = max(8, int(moe.capacity_factor * tokens * moe.top_k / m_n))
    for _ in range(3):                                         # wi, wg, wo
        if rules == "dp_only":
            for _ in range(passes + back):
                t.all_to_all(e_loc * (d // (d_n * m_n)) * f * bf, m_n)
        if d_n > 1:
            t.gather(e_loc * (d // d_n) * f * bf, d_n, passes, back)
        if fs:
            t.gather(d * (fs // m_n) * bf, m_n, passes, back)
    for chunk in (cap * d * bf, cap * 8, cap * d * bf):       # send_x, send_le, return
        for _ in range(passes):
            t.all_to_all(chunk, m_n)
    if back:
        for _ in range(2):
            t.all_to_all(cap * d * bf, m_n)
    for _ in range(2):                                         # aux, z
        t.psum(4, ways * (m_n if split else 1), 1, back, kind="pmean")
    if split:
        t.gather(rows * (seq // m_n) * d * bf, m_n, 1, back)


def moe_block_collectives(cfg: ArchConfig, shape: tuple[int, ...], rules: str, batch: int,
                          seq: int, model_size_hint: int = 16,
                          backward: bool = False) -> tuple[dict, dict]:
    """Bytes and calls of each collective kind (all_gather, all_to_all,
    reduce_scatter, pmean) of one `models.moe.moe_apply_laid_out` of an
    MoE `cfg` on `batch` x `seq` tokens on a (data, model) or (pod, data,
    model) mesh of `shape`, its forward, and with `backward` its backward
    too (`_moe_layer`'s terms)."""
    t = _Tally(math.prod(shape), ("all_gather", "all_to_all", "reduce_scatter", "pmean"))
    _moe_layer(t, cfg, _Layout(shape, rules), rules, batch, seq, model_size_hint, 1, backward)
    return t.moved, t.calls


class _Layout:
    """The resolved layouts of a config's weights and activations on a
    (data, model) or (pod, data, model) mesh of `shape` under a rules set
    of `RULES_VARIANTS`, and the collectives that realise them: `gather`
    counts what `models.layers.gathered` moves to bring a weight from its
    own spec to the spec a product wants (`collectives.to_spec`, dim by
    dim). `pod` splits the batch with `data` and no weight: every region
    it does not split has twice the holders."""

    def __init__(self, shape: tuple[int, ...], rules: str):
        if len(shape) not in (2, 3):
            raise ValueError(f"mesh shape {tuple(shape)}: (data, model) or (pod, data, model)")
        axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        self.sizes = dict(zip(axes, shape))
        self.n = math.prod(shape)
        self.rules = RULES_VARIANTS[rules]
        self.mesh = Mesh(_meta_grid(shape), axes)

    def ways(self, batch: int) -> int:
        """How many ways the resolved `batch` spec splits `batch` rows."""
        return self.size(self.spec((batch,), ("batch",))[0])

    def spec(self, shape, logical) -> P:
        return logical_spec(tuple(shape), tuple(logical), self.rules, self.mesh)

    def made(self, shape, spec) -> dict:
        """Each distinct region of an array laid out by `spec`, with the
        first coordinate holding it (where a laid-out op makes it)."""
        tiles = DistArray(shape, spec, self.mesh, {}).tiles()
        return {r: holders[0] for r, holders in tiles.items()}

    def fetch(self, shape, spec, want, at, itemsize: int = 4) -> int:
        """Bytes `collectives.fetch` copies to coordinate `at` for the region
        `want` of an array laid out by `spec`: nothing where `at`'s own
        region contains it, else each piece that another region holds."""
        own = region_of(shape, spec, self.mesh, at)
        if all(o0 <= w0 and w1 <= o1 for (o0, o1), (w0, w1) in zip(own, want)):
            return 0
        total = 0
        for tile in self.made(shape, spec):
            if tile != own:
                piece = [(max(a0, b0), min(a1, b1)) for (a0, a1), (b0, b1) in zip(tile, want)]
                if all(lo < hi for lo, hi in piece):
                    total += math.prod(hi - lo for lo, hi in piece)
        return total * itemsize

    def size(self, entry) -> int:
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        return math.prod(self.sizes[a] for a in names)

    def gather(self, t: _Tally, w, want, passes: int = 1, back: bool = False) -> None:
        """A layer's weight (its stacked ParamDef `w`) gathered to `want`."""
        shape, have = w.shape[1:], self.spec(w.shape[1:], w.logical[1:])
        cur = [n // self.size(a) for n, a in zip(shape, have)]
        for dim, (h, wnt) in enumerate(zip(have, want)):
            if h and h != wnt:
                t.gather(math.prod(cur) * _dtype_bytes(w), self.size(h), passes, back)
                cur[dim] = shape[dim]


def _meta_grid(shape: tuple[int, ...]):
    """Nested lists of the meta device, one a coordinate of `shape`."""
    return "meta" if not shape else [_meta_grid(shape[1:]) for _ in range(shape[0])]


def _dtype_bytes(w) -> int:
    return (w.dtype or PARAM_DTYPE).itemsize


def _lm_body(t: _Tally, cfg: ArchConfig, lay: _Layout, defs: dict, b: int, seq: int,
             passes: int, back: bool, decode_slots: int = 0) -> None:
    """One layer's collectives on `b` x `seq` tokens, a coordinate's rows
    of them:
    attention, the SSM block and the MLP (the MoE block is `_moe_layer`'s),
    `passes` forwards (2 under remat: a product's weight gathers run again
    in the recompute) and with `back` the backward. An output psum that no
    later product of the layer follows runs once (the recompute stops at
    the layer's last saved tensor). With `decode_slots` the attention is a
    decode step over a cache of that many slots."""
    bf, f32 = 2, 4
    rows, s = b // lay.ways(b), seq
    x = rows * seq * cfg.d_model * bf             # an activation (B_loc, S, d)
    follows = bool(cfg.d_ff or cfg.moe)           # a product after the mixers
    if not cfg.attn_free:
        a, h, kv, hd = defs["attn"], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q_ax = lay.spec((b, s, h, hd), ("batch", "seq", "heads", None))[2]
        kv_ax = lay.spec((b, s, kv, hd), ("batch", "seq", "kv_heads", None))[2]
        for name, ax in (("wq", q_ax), ("wk", kv_ax), ("wv", kv_ax)):
            lay.gather(t, a[name], (None, ax), passes, back)
        if decode_slots:
            slots = T._kv_len(cfg, decode_slots)
            s_ax = lay.spec((b, slots), ("batch", "kv_seq"))[1]
            if s_ax:                              # a softmax split over the cache's slices
                if q_ax:                          # q to every coordinate
                    t.gather(rows * (h // lay.size(q_ax)) * hd * bf, lay.size(q_ax))
                if kv_ax:                         # the new k and v
                    for _ in range(2):
                        t.gather(rows * (kv // lay.size(kv_ax)) * hd * bf, lay.size(kv_ax))
                t.psum(rows * h * f32, lay.size(s_ax), kind="pmax")
                t.psum(rows * h * (hd + 1) * f32, lay.size(s_ax))
        lay.gather(t, a["wo"], (q_ax, None), passes, back)
        if q_ax:
            t.psum(x, lay.size(q_ax), passes if (follows or cfg.ssm) else 1, back)
    if cfg.ssm is not None:
        _ssm_layer(t, cfg, lay, defs["ssm"], b, seq, passes, back, follows)
    if cfg.d_ff:
        m, f = defs["mlp"], cfg.d_ff
        f_ax = lay.spec((b, s, f), ("batch", "seq", "ffn"))[2]
        for name in ("wi", "wg"):
            if name in m:
                lay.gather(t, m[name], (None, f_ax), passes, back)
        lay.gather(t, m["wo"], (f_ax, None), passes, back)
        if f_ax:
            t.psum(x, lay.size(f_ax), 1, back)


def _ssm_layer(t: _Tally, cfg: ArchConfig, lay: _Layout, defs: dict, b: int, seq: int,
               passes: int, back: bool, follows: bool) -> None:
    """The SSM block's collectives (`models.ssm.ssm_apply_laid_out`): `wz`
    gathered to the SSD heads' axis, `wxbc` and `wdt` whole, and where
    `model` splits the heads the gated norm's f32 sum of squares and the
    output psum'd over it; `wo` gathered to (heads' axis, None). Its output
    psum runs once a layer unless a product `follows` it in the layer."""
    _, n_h, p, _, _ = ssm_mod._dims(cfg)
    rows = b // lay.ways(b)
    ax = lay.spec((b, seq, n_h, p), ("batch", "seq", "ssm_inner", None))[2]
    lay.gather(t, defs["wz"], (None, ax), passes, back)
    for name in ("wxbc", "wdt"):
        lay.gather(t, defs[name], (None, None), passes, back)
    if ax:                                        # the gated norm's sum of squares
        t.psum(rows * seq * 4, lay.size(ax), passes, back)
    lay.gather(t, defs["wo"], (ax, None), passes, back)
    if ax:
        t.psum(rows * seq * cfg.d_model * 2, lay.size(ax), passes if follows else 1, back)


def ssm_block_collectives(cfg: ArchConfig, shape: tuple[int, ...], rules: str, batch: int,
                          seq: int, backward: bool = False) -> tuple[dict, dict]:
    """Bytes and calls of each collective kind (all_gather,
    reduce_scatter, psum) of one `models.ssm.ssm_apply_laid_out` of an SSM
    or hybrid `cfg` on `batch` x `seq` tokens on a (data, model) or (pod,
    data, model) mesh of `shape`, its forward, and with `backward` its
    backward too (`_ssm_layer`'s terms)."""
    t = _Tally(math.prod(shape), ("all_gather", "reduce_scatter", "psum"))
    _ssm_layer(t, cfg, _Layout(shape, rules), T.param_defs(cfg)["layers"]["ssm"],
               batch, seq, 1, backward, False)
    return t.moved, t.calls


def _text(cfg: ArchConfig, seq: int) -> int:
    """The positions of a model sequence of `seq` that the lookup embeds:
    none of audio's frames, the VLM's text after its patch stubs."""
    if cfg.family == "audio":
        return 0
    return seq - cfg.n_frontend_tokens if cfg.family == "vlm" else seq


def _lookup_and_head(t: _Tally, cfg: ArchConfig, lay: _Layout, defs: dict, rows: int,
                     text: int, back: bool) -> tuple:
    """The lookup of `text` positions a row (the table's width gathered,
    the partial rows summed over the vocabulary's axis; none without text)
    and the head's table gather, once each; the vocabulary's axis."""
    v_ax, w_ax = lay.spec(defs["embed"].shape, defs["embed"].logical)
    table = cfg.vocab // lay.size(v_ax) * cfg.d_model // lay.size(w_ax) * 2
    if text:
        t.gather(table, lay.size(w_ax), 1, back)
        if v_ax:
            t.psum(rows * text * cfg.d_model * 2, lay.size(v_ax), 1, back)
    t.gather(table, lay.size(w_ax), 1, back)      # the head (tied, or lm_head alike)
    return v_ax


def _factored(shape) -> bool:
    """Whether the default SPIN-Shampoo gives a leaf of `shape` factors."""
    return _is_matrix(shape, SpinShampooConfig.max_factor_dim)


def _panel_fetches(t: _Tally, lay: _Layout, out, panels) -> None:
    """At each distinct region r of the array `out` = (shape, spec), its
    first holder fetches the panels `panels(r)` ((shape, spec) of an
    operand, region) as "gather", a panel asked for twice once."""
    for r, c in lay.made(*out).items():
        for x, want in dict.fromkeys(panels(r)):
            nbytes = lay.fetch(*x, want, c)
            if nbytes:
                t._add("gather", nbytes, 1)


def _shampoo_gathers(t: _Tally, lay: _Layout, defs: dict) -> None:
    """SPIN-Shampoo's "gather" in one laid-out update
    (`optim.spin_shampoo._laid_out_update`): for each factored leaf G
    (…, d_in, d_out) laid out by its spec, every distinct region of L (rows
    R, columns C; `factor_spec`) fetches G's row panels R and C, R's its
    column panels; then the products X = L⁻¹·m and X·R⁻¹, laid out as m,
    fetch at each distinct region of m the first operand's row panel and
    the second's column panel. All f32."""
    for w in leaves(defs):
        shape = tuple(w.shape)
        if not _factored(shape):
            continue
        g = (shape, lay.spec(shape, w.logical))
        *lead, din, dout = shape
        ends = tuple((0, n) for n in lead)
        fl = ((*lead, din, din), factor_spec((*lead, din, din), lay.mesh))
        fr = ((*lead, dout, dout), factor_spec((*lead, dout, dout), lay.mesh))

        def rows(x, r):
            return r[:-1] + ((0, x[0][-1]),)

        def cols(x, r):
            return r[:-2] + ((0, x[0][-2]), r[-1])

        _panel_fetches(t, lay, fl, lambda r: [(g, ends + (r[-2], (0, dout))),
                                              (g, ends + (r[-1], (0, dout)))])
        _panel_fetches(t, lay, fr, lambda r: [(g, ends + ((0, din), r[-2])),
                                              (g, ends + ((0, din), r[-1]))])
        _panel_fetches(t, lay, g, lambda r: [(fl, rows(fl, r)), (g, cols(g, r))])
        _panel_fetches(t, lay, g, lambda r: [(g, rows(g, r)), (fr, cols(fr, r))])


def shampoo_refresh_moves(cfg: ArchConfig, shape: tuple[int, ...], block_size,
                          model_size_hint: int = 16) -> tuple[int, int]:
    """Bytes and calls of "reshard" a SPIN-Shampoo refresh adds to its
    inversions on a (data, model) mesh of `shape`: each factor layer (n, n),
    laid out by `factor_spec`, is fetched region by region into the block
    grid of `block_size(n)` (its plan's) laid out by `grid_spec`, and the
    inverse grid back into the inverse's regions (`grid_to_panel`), at each
    distinct region's first holder. The layouts alone decide it: the rules
    do not."""
    lay = _Layout(shape, "default")
    moved = calls = 0
    for w in leaves(T.param_defs(cfg, model_size_hint)):
        if not _factored(tuple(w.shape)):
            continue
        layers = w.shape[0] if len(w.shape) == 3 else 1
        for n in w.shape[-2:]:
            bs = block_size(n)
            g = n // bs
            fspec = factor_spec((n, n), lay.mesh)
            gspec = grid_spec(g, g, lay.mesh)
            for r, c in lay.made((g, g, bs, bs), gspec).items():
                want = tuple((lo * bs, hi * bs) for lo, hi in r[:2])
                nbytes = lay.fetch((n, n), fspec, want, c)
                moved, calls = moved + layers * nbytes, calls + layers * bool(nbytes)
            for r, c in lay.made((n, n), fspec).items():
                want = tuple((lo // bs, -(-hi // bs)) for lo, hi in r) + ((0, bs), (0, bs))
                nbytes = lay.fetch((g, g, bs, bs), gspec, want, c)
                moved, calls = moved + layers * nbytes, calls + layers * bool(nbytes)
    return moved, calls


def partitioned_step_collectives(cfg: ArchConfig, shape: tuple[int, ...], rules: str,
                                 batch: int, seq: int, microbatches: int,
                                 model_size_hint: int = 16,
                                 optimizer: str = "adamw") -> tuple[dict, dict]:
    """Bytes and calls of each collective kind (all_gather,
    reduce_scatter, psum, pmax; all_to_all and pmean with MoE) in one
    partitioned step of `cfg`, of any family (experts padded to a multiple
    of `model_size_hint`), on `batch` x `seq` positions (`seq` the model's
    sequence, a VLM's patch stubs included) on a (data, model) or (pod,
    data, model) mesh of `shape` under the `default` or `dp_only` rules,
    from the shapes: what `collective_bytes()` and `collective_calls()`
    count for `runtime.trainer.make_train_step` on a laid-out state with
    full remat (`_Tally` says what each collective moves). `pod` splits
    the batch with `data` (the loss's sums run over both) and no weight.

    A microbatch runs the lookup (of the text alone: none of audio's
    frames, a VLM's tokens after its patches) and the head once; each
    layer's weight gathers (`_Layout.gather`: FSDP's over `data`, and over
    `model` where the weight splits its columns mid-head while the heads
    stay whole),
    the attention's and the SSM's psums twice (the forward, and the
    remat's recompute; with heads that `model` divides), the SSM's gated
    norm psum twice, the last psum of a layer once (the recompute stops at
    the last tensor the layer saves: the MLP's, or mamba2's SSM output);
    every gather's reduce-scatter and every psum's transpose once, the
    loss's too: autograd hands an output that no loss reads a zero
    cotangent, so every group's transpose moves its bytes. An MoE layer
    adds `_moe_layer`'s terms. A vocabulary that `model` divides runs the
    vocabulary-parallel lookup sum and the loss's pmax and two psums. The
    token count carries no gradient. A region several coordinates hold
    (the norms' scales and biases, the MoE router and shared experts, the
    SSM's wxbc, wdt, conv_w and per-head leaves, audio's `mask_embed`, a
    weight whose columns `model` does not divide) sums its holders'
    gradients ("psum", one call a leaf), also a leaf that no loss reads
    (audio's token table, where several coordinates hold its regions).
    optimizer="spin_shampoo" adds its update's "gather" (`_shampoo_gathers`:
    the Gram updates' and the preconditioner's panels), once a step; a
    refresh step adds its inversions and `shampoo_refresh_moves` besides.
    """
    if rules not in ("default", "dp_only"):
        raise ValueError(f"no count for the rules {rules!r}: default or dp_only")
    lay = _Layout(shape, rules)
    n, m_n = lay.n, lay.sizes["model"]
    defs = T.param_defs(cfg, model_size_hint)
    f32 = 4
    b = batch // microbatches                     # a microbatch's rows
    ways = lay.ways(b)
    row = b // ways * seq * f32                   # an f32 value a position, a coordinate's rows
    kinds = ("all_gather", "reduce_scatter", "psum", "pmax")
    t = _Tally(n, kinds + (("all_to_all", "pmean") if cfg.moe else ()))
    v_ax = _lookup_and_head(t, cfg, lay, defs, b // ways, _text(cfg, seq), True)
    for _ in range(cfg.n_layers):
        _lm_body(t, cfg, lay, defs["layers"], b, seq, 2, True)
        if cfg.moe:
            _moe_layer(t, cfg, lay, rules, b, seq, model_size_hint, 2, True)
    if v_ax:
        t.psum(row, m_n, kind="pmax")
        t.psum(row, m_n, 1, True)                                  # the sum of exponentials
        t.psum(row, m_n, 1, True)                                  # the label's logit
    t.psum(f32, ways, 1, True)                                     # the loss sum
    t.psum(f32, ways, 1)                                           # the token count
    for w in leaves(defs):                                         # held regions' gradients
        holders = n // math.prod(lay.size(a) for a in lay.spec(w.shape, w.logical))
        if holders > 1:
            t.moved["psum"] += 2 * (holders - 1) * math.prod(w.shape) * _dtype_bytes(w)
            t.calls["psum"] += 1
    moved = {k: microbatches * val for k, val in t.moved.items()}
    calls = {k: microbatches * val for k, val in t.calls.items()}
    if optimizer == "spin_shampoo":
        u = _Tally(n, ("gather",))
        _shampoo_gathers(u, lay, defs)
        moved.update(u.moved)
        calls.update(u.calls)
    elif optimizer != "adamw":
        raise ValueError(f"no count for the optimizer {optimizer!r}: adamw or spin_shampoo")
    return moved, calls


def partitioned_serve_collectives(cfg: ArchConfig, shape: tuple[int, ...], rules: str,
                                  batch: int, prompt: int, cache_len: int,
                                  model_size_hint: int = 16) -> dict:
    """Bytes and calls of each collective kind (all_gather, all_to_all,
    psum, pmax; pmean with MoE) in one partitioned `prefill` of `batch` x
    `prompt` tokens and in one `decode_step` at the decode length
    `cache_len` (min(cache_len, window) slots under a sliding window), of
    `cfg`, of any family (experts padded to a multiple of
    `model_size_hint`; `prompt` the model's sequence, a VLM's patch stubs
    included), on a (data, model) or (pod, data, model) mesh of `shape`
    under the `default` or `dp_only` rules, from the shapes: {"prefill": (bytes,
    calls), "decode": (bytes, calls)}, what `collective_bytes()` and
    `collective_calls()` count for each on laid-out parameters (`_Tally`
    says what each collective moves; no remat, no backward).

    Both run the lookup (the prefill's of the text alone: none of audio's
    frames, a VLM's tokens after its patches; a decode step's of its
    token), each layer's weight gathers and its psums (`_lm_body`; an MoE
    layer adds `_moe_layer`'s terms once), and the
    head once, as the step's forward does. Where the KV heads split over
    `model` and `model` divides the prompt, the prefill moves each layer's
    k and v from the heads' axis to the cache's sequence (`kv_seq`) by one
    all_to_all each. Where `model` divides the decode cache's slots the
    cache is split along its sequence: each layer all-gathers q over the
    heads' axis (where the heads split; and the new k and v where the KV
    heads split), then combines the slices' softmax by a pmax of the
    running max (B_loc, H) and one psum of the weighted (o, l) (B_loc, H,
    hd + 1), both f32. The SSM state stays where it is made.
    """
    if rules not in ("default", "dp_only"):
        raise ValueError(f"no count for the rules {rules!r}: default or dp_only")
    lay = _Layout(shape, rules)
    m_n = lay.sizes["model"]
    defs = T.param_defs(cfg, model_size_hint)
    rows = batch // lay.ways(batch)               # a coordinate's rows
    kinds = ("all_gather", "all_to_all", "psum", "pmax") + (("pmean",) if cfg.moe else ())
    out = {}
    for phase, seq in (("prefill", prompt), ("decode", 1)):
        t = _Tally(lay.n, kinds)
        _lookup_and_head(t, cfg, lay, defs, rows,
                         _text(cfg, seq) if phase == "prefill" else 1, False)
        for _ in range(cfg.n_layers):
            _lm_body(t, cfg, lay, defs["layers"], batch, seq, 1, False,
                     cache_len if phase == "decode" else 0)
            if phase == "prefill" and not cfg.attn_free:
                kv, hd = cfg.n_kv_heads, cfg.head_dim
                kv_ax = lay.spec((batch, prompt, kv, hd), ("batch", "seq", "kv_heads", None))[2]
                s_ax = lay.spec((batch, prompt), ("batch", "kv_seq"))[1]
                if kv_ax and s_ax:                 # k, v to kv_seq
                    for _ in range(2):
                        t.all_to_all(rows * (prompt // m_n) * (kv // m_n) * hd * 2, m_n)
            if cfg.moe:
                _moe_layer(t, cfg, lay, rules, batch, seq, model_size_hint, 1, False)
        out[phase] = (t.moved, t.calls)
    return out


# ---------------------------------------------------------------------------
# The counting mode
# ---------------------------------------------------------------------------

_SIMPLE = (int, float, bool, str, type(None), torch.dtype, torch.device,
           torch.layout, torch.memory_format)


def _flat(xs, out: list) -> bool:
    """Flatten args into `out`: tensors, lengths and plain values; False
    when a value can key no cache (it is left out)."""
    keyed = True
    for x in xs:
        if isinstance(x, torch.Tensor) or isinstance(x, _SIMPLE):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.append(len(x))
            keyed = _flat(x, out) and keyed
        else:
            keyed = False
    return keyed


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """Counts a run's aten ops: FLOPs by `flop_registry` (decomposing a
    composite op first, as `FlopCounterMode` does), the bytes each non-view
    op reads and writes, and the peak of the live bytes its non-view
    outputs hold (each dropped by `weakref.finalize` when freed).

    An op on meta tensors whose outputs are fresh tensors gives outputs
    whose shapes, strides and dtypes follow from its inputs' and its other
    arguments: the first run of each such signature is kept, and a repeat
    (one per mesh coordinate, mostly) makes empty outputs of the kept
    layout without running the meta kernel again. Counts are the same.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._kinds: dict = {}
        self._composite: dict = {}
        self._cache: dict = {}

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _kind(self, func) -> tuple[bool, bool]:
        """(fresh outputs only, a pure view)."""
        got = self._kinds.get(func)
        if got is None:
            rets = func._schema.returns
            aliased = [r.alias_info is not None for r in rets]
            writes = any(r.alias_info is not None and r.alias_info.is_write for r in rets)
            fresh = bool(rets) and not any(aliased) and not func._schema.is_mutable and all(
                str(r.type) in ("Tensor", "List[Tensor]") for r in rets)
            got = self._kinds[func] = (fresh, bool(rets) and all(aliased) and not writes)
        return got

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        composite = self._composite.get(func)
        if composite is None:
            composite = self._composite[func] = (
                func is not torch.ops.prim.device.default
                and torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), "CompositeImplicitAutograd"))
        if composite:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        self.ops += 1
        fresh, view = self._kind(func)
        flat: list = []
        keyed = _flat(args, flat) & _flat(kwargs.values(), flat)
        key = None
        if fresh and keyed and all(t.device.type == "meta" for t in flat
                                   if isinstance(t, torch.Tensor)):
            key = (func, tuple(kwargs), tuple(
                (tuple(t.shape), t.stride(), t.dtype) if isinstance(t, torch.Tensor) else t
                for t in flat))
        hit = self._cache.get(key) if key is not None else None
        if hit is not None:
            layouts, single, flops, nbytes = hit
            outs = [torch.empty_strided(s, st, dtype=dt, device="meta")
                    for s, st, dt in layouts]
            out = outs[0] if single else outs
        else:
            out = func(*args, **kwargs)
            outs = [out] if isinstance(out, torch.Tensor) else [
                o for o in (out if isinstance(out, (list, tuple)) else ())
                if isinstance(o, torch.Tensor)]
            formula = flop_registry.get(func._overloadpacket)
            flops = formula(*args, **kwargs, out_val=out) if formula is not None else 0
            nbytes = 0 if view else (
                sum(_nbytes(t) for t in flat if isinstance(t, torch.Tensor))
                + sum(_nbytes(o) for o in outs))
            if key is not None:
                self._cache[key] = ([(tuple(o.shape), o.stride(), o.dtype) for o in outs],
                                    isinstance(out, torch.Tensor), flops, nbytes)
        self.flops += flops
        self.bytes += nbytes
        if fresh:
            for o in outs:
                n = _nbytes(o)
                self.live += n
                weakref.finalize(o, self._free, n)
            self.peak = max(self.peak, self.live)
        return out


# ---------------------------------------------------------------------------
# Bytes a device holds under a spec
# ---------------------------------------------------------------------------


def _extent(spec, mesh) -> int:
    """How many ways `spec` splits a tensor over `mesh`."""
    if mesh is None or spec is None:
        return 1
    n = 1
    for entry in spec:
        for axis in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            n *= mesh.shape[axis]
    return n


def _local_bytes(x: DistArray) -> int:
    """A laid-out leaf's bytes at its first coordinate."""
    return _nbytes(x.shards[x.mesh.coords()[0]])


def _shard_bytes(tree, specs, mesh) -> int:
    """Σ over the leaves of `tree` of their local shard bytes under the
    matching leaf of `specs` (a PartitionSpec a tensor; a DistArray's own
    shard, whatever `specs` says)."""
    if tree is None:
        return 0
    if isinstance(tree, DistArray):
        return _local_bytes(tree)
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree) // _extent(specs, mesh)
    if isinstance(tree, dict):
        return sum(_shard_bytes(tree[k], specs[k], mesh) for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(_shard_bytes(t, s, mesh) for t, s in zip(tree, specs))
    return 0


def _tensors(tree) -> list:
    if isinstance(tree, (torch.Tensor, DistArray)):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _recorded_spec(records, shape: tuple):
    """The spec the last `shard` record of `shape` gives (a record whose
    shape has extra size-1 dims matches with their entries dropped)."""
    for r in reversed(records):
        if r.spec is None:
            continue
        if r.shape == shape:
            return r.spec
        kept = [(n, s) for n, s in zip(r.shape, r.spec) if n != 1]
        if tuple(n for n, _ in kept) == tuple(n for n in shape if n != 1) and len(r.shape) > len(shape):
            return tuple(s for _, s in kept)
    return None


def _recorded_bytes(outs, records, mesh):
    """Bytes a device holds of `outs` under the recorded specs, or None."""
    total = 0
    for t in _tensors(outs):
        if isinstance(t, DistArray):
            total += _local_bytes(t)
            continue
        spec = () if t.ndim == 0 else _recorded_spec(records, tuple(t.shape))
        if spec is None:
            return None
        total += _nbytes(t) // _extent(spec, mesh)
    return total


# ---------------------------------------------------------------------------
# Cell builders: (fn, args, in_specs, out_specs, donate)
# ---------------------------------------------------------------------------


def _hint(mesh, model_size_hint):
    if model_size_hint is not None:
        return model_size_hint
    return mesh.shape.get("model", 16) if mesh is not None else 16


def _param_state_specs(cfg: ArchConfig, rules: ShardingRules, mesh, hint: int):
    pspecs = T.param_specs(cfg, rules, mesh, model_size_hint=hint)
    opt_specs = AdamWState(step=P(), master=pspecs, m=pspecs, v=pspecs)
    return TrainState(params=pspecs, opt=opt_specs, step=P())


def _batch_specs(batch_abs: dict, rules: ShardingRules, mesh) -> dict:
    return {k: logical_spec(tuple(v.shape), ("batch",) + (None,) * (v.ndim - 1),
                            rules, mesh)
            for k, v in batch_abs.items()}


_REMAT_POLICY = "full"      # set by --remat-policy


def build_train(cfg: ArchConfig, shape: ShapeConfig, mesh, rules: ShardingRules,
                microbatches: int, model_size_hint: int | None = None,
                optimizer: str = "adamw"):
    """The train step (AdamW, or SPIN-Shampoo on a mesh: its factors take
    `factor_spec`). The state is `abstract_state`'s (on meta), with host
    0-dim step counters in place of its meta ones (`_host_counters`)."""
    hint = _hint(mesh, model_size_hint)
    tcfg = TrainConfig(microbatches=microbatches, optimizer=optimizer,
                       remat_policy=_REMAT_POLICY)
    state_abs = _host_counters(abstract_state(cfg, tcfg, model_size_hint=hint))
    batch_abs = input_specs(cfg, shape)
    state_specs = (_param_state_specs(cfg, rules, mesh, hint) if optimizer == "adamw" else
                   tree_map(lambda sh: sh.spec, state_shardings(cfg, tcfg, mesh, rules, hint)))
    batch_specs = _batch_specs(batch_abs, rules, mesh)
    fn = make_train_step(cfg, tcfg, rules)
    return (fn, (state_abs, batch_abs), (state_specs, batch_specs),
            (state_specs, None), (0,))


def build_prefill(cfg: ArchConfig, shape: ShapeConfig, mesh, rules: ShardingRules,
                  model_size_hint: int | None = None):
    hint = _hint(mesh, model_size_hint)
    params_abs = T.abstract_params(cfg, model_size_hint=hint)
    batch_abs = input_specs(cfg, shape)
    pspecs = T.param_specs(cfg, rules, mesh, model_size_hint=hint)
    batch_specs = _batch_specs(batch_abs, rules, mesh)

    def fn(params, batch):
        logits, aux, z, cache = T.prefill(params, batch, cfg, rules)
        return logits, cache

    return fn, (params_abs, batch_abs), (pspecs, batch_specs), None, ()


def build_decode(cfg: ArchConfig, shape: ShapeConfig, mesh, rules: ShardingRules,
                 model_size_hint: int | None = None):
    hint = _hint(mesh, model_size_hint)
    params_abs = T.abstract_params(cfg, model_size_hint=hint)
    cache_abs = T.abstract_cache(cfg, shape.global_batch, shape.seq_len)
    tokens_abs = torch.empty((shape.global_batch,), dtype=torch.int32, device="meta")
    pspecs = T.param_specs(cfg, rules, mesh, model_size_hint=hint)
    cspecs = T.cache_specs(cfg, shape.global_batch, shape.seq_len, rules, mesh)
    tspec = logical_spec(tuple(tokens_abs.shape), ("batch",), rules, mesh)

    def fn(params, cache, tokens):
        return T.decode_step(params, cache, tokens, cfg, rules)

    return (fn, (params_abs, cache_abs, tokens_abs), (pspecs, cspecs, tspec), None, (1,))


def _build(cfg: ArchConfig, shape: ShapeConfig, mesh, rules: ShardingRules,
           microbatches: int, model_size_hint: int | None = None) -> tuple:
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, rules, microbatches, model_size_hint)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, rules, model_size_hint)
    return build_decode(cfg, shape, mesh, rules, model_size_hint)


def _host_counters(state: TrainState) -> TrainState:
    """`state` with host 0-dim int32 step counters (the state's and its
    optimizer's) in place of its meta or laid-out ones: the schedule reads
    them (`optim.adamw.step_count` would read a meta counter's value), and
    their value changes neither shapes nor work, but for SPIN-Shampoo's
    refresh: its counters stand at 1, so the step traced is one that does
    not refresh (a refresh asks the planner, which plans no meta device)."""
    start = 1 if isinstance(state.opt, SpinShampooState) else 0
    return state._replace(step=torch.tensor(start, dtype=torch.int32),
                          opt=state.opt._replace(step=torch.tensor(start, dtype=torch.int32)))


def _shardings(specs, mesh):
    """A tree of PartitionSpecs (dicts, lists, NamedTuples, None) as the
    same tree of `NamedSharding`s on `mesh`."""
    if specs is None:
        return None
    if isinstance(specs, P):
        return NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: _shardings(v, mesh) for k, v in specs.items()}
    items = [_shardings(v, mesh) for v in specs]
    return type(specs)(*items) if hasattr(specs, "_fields") else type(specs)(items)


def lay_out_args(built: tuple, mesh) -> tuple:
    """The counterpart of the reference's `in_shardings`: the arguments of
    a `build_*` cell laid out on `mesh` by its in-specs, each leaf a
    DistArray whose coordinates hold their regions (on a meta mesh, shapes
    only): the train state by `_param_state_specs` (SPIN-Shampoo's by
    `runtime.trainer.state_shardings`, its factors by `factor_spec`), the
    batch by `_batch_specs`, the parameters by `param_specs`, the decode
    cache by `cache_specs` and its tokens by their `batch` spec. A train
    state keeps its step counters on the host (`_host_counters`)."""
    out = []
    for arg, specs in zip(built[1], built[2]):
        laid = lay_out(arg, _shardings(specs, mesh))
        out.append(_host_counters(laid) if isinstance(laid, TrainState) else laid)
    return tuple(out)


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------


def _chips(mesh) -> int:
    if mesh is None:
        return 1
    n = 1
    for s in mesh.shape.values():
        n *= s
    return n


def _trace(fn, args, mesh) -> dict:
    """Run `fn(*args)` once under `mesh` inside the counting mode: its
    outputs, the counter, the spec records, the collectives and the
    kernels' booked work."""
    reset_collective_bytes()
    kernels.reset_booked()
    counter = _Counter()
    t0 = time.perf_counter()
    with set_mesh(mesh), record_specs() as records, counter:
        outs = fn(*args)
    return {"outs": outs, "counter": counter, "records": records,
            "trace_s": time.perf_counter() - t0, "moved": collective_bytes(),
            "calls": collective_calls(), "booked": kernels.booked()}


def _io_bytes(traced: dict, kind: str, mesh) -> tuple:
    """(argument, output, alias) bytes a device holds for a traced cell:
    each leaf's local shard under its spec (see the module docstring)."""
    fn, args, in_specs, out_specs, donate = traced["built"]
    arg_bytes = sum(_shard_bytes(a, s, mesh) for a, s in zip(args, in_specs))
    outs = traced["outs"]
    if kind == "train":
        out_bytes = alias_bytes = _shard_bytes(outs[0], out_specs[0], mesh)
    elif kind == "decode":
        alias_bytes = _shard_bytes(outs[1], in_specs[1], mesh)
        logits = _recorded_bytes(outs[0], traced["records"], mesh)
        out_bytes = None if logits is None else logits + alias_bytes
    else:
        alias_bytes = 0
        out_bytes = _recorded_bytes(outs, traced["records"], mesh)
    return arg_bytes, out_bytes, alias_bytes


def _trace_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, rules: ShardingRules,
                microbatches: int, *, model_size_hint: int | None = None) -> dict:
    """Build one configuration and run it once on meta tensors (the
    counterpart of `_compile_cell`): `_trace`'s dict plus "built"."""
    built = _build(cfg, shape, mesh, rules, microbatches, model_size_hint)
    fn, args = built[0], built[1]
    traced = _trace(fn, args, mesh)
    traced["built"] = built
    return traced


def _measure(traced: dict) -> dict:
    """Whole-program counts of a traced run (global, not ÷ chips)."""
    c = traced["counter"]
    booked = traced["booked"]
    kflops = sum(b["flops"] for b in booked.values())
    kbytes = sum(b["bytes"] for b in booked.values())
    return dict(flops=c.flops + kflops, flops_aten=c.flops, flops_kernels=kflops,
                bytes_accessed=c.bytes + kbytes, coll_bytes=sum(traced["moved"].values()),
                moved=traced["moved"], calls=traced["calls"], booked=booked,
                temp_bytes_global=c.peak, aten_ops=c.ops, trace_s=traced["trace_s"])


def _extrapolate(f1: float, f2: float, n_layers: int) -> float:
    """Linear in depth from probes at L ∈ {1, 2}: f1 + (L - 1)·max(f2 - f1,
    0). The reference needs it because its compiler counts a loop body
    once; the port's eager run counts every layer, so here it is a
    cross-check. The delta is clamped at 0 as the reference's is."""
    c = max(f2 - f1, 0.0)
    return f1 + (n_layers - 1) * c


def trace_partitioned(cfg: ArchConfig, shape: ShapeConfig, mesh, rules: ShardingRules,
                      microbatches: int, *, model_size_hint: int | None = None,
                      lay_batch: bool = True) -> dict:
    """Run one configuration once on meta tensors as the partitioned
    program: the cell's arguments laid out on `mesh` (`lay_out_args`),
    each coordinate computing on its own regions, no ambient mesh.
    `_trace`'s dict plus "built". With `lay_batch` False the model inputs
    (the batch, decode's tokens) stay whole, as a stream or the last step
    hands them to the program; a laid-out train batch cut into
    microbatches moves rows between coordinates ("reshard"). A rules
    set that splits an axis the program does not realise raises
    ValueError (`parallel.sharding.Program.shard`)."""
    built = _build(cfg, shape, mesh, rules, microbatches, model_size_hint)
    args = lay_out_args(built, mesh)
    if not lay_batch:
        args = args[:-1] + built[1][-1:]
    traced = _trace(built[0], args, None)
    traced["built"] = built
    return traced


def _partitioned_probes(cfg: ArchConfig, shape: ShapeConfig, mesh, rules: ShardingRules,
                        microbatches: int) -> dict:
    """The partitioned program by the reference's method: probes at L ∈
    {1, 2} of the laid-out cell, one microbatch (B/M rows of a train
    cell, its batch laid out), `_extrapolate`d in depth and, for a train
    cell, times M. Exact for the collectives, FLOPs and booked kernels,
    which a microbatch repeats; the probe's optimizer update and gradient
    averaging count M times in bytes_accessed."""
    m = microbatches if shape.kind == "train" else 1
    one = dataclasses.replace(shape, global_batch=shape.global_batch // m)
    probes = {}
    with unroll_scans():
        for n_layers in (1, 2):
            probes[n_layers] = _measure(trace_partitioned(
                dataclasses.replace(cfg, n_layers=n_layers), one, mesh, rules, 1))

    def extrap(v1, v2):
        if isinstance(v1, dict):                  # by kind, by kernel
            return {k: extrap(v, v2.get(k, 0)) for k, v in v1.items()}
        got = m * _extrapolate(v1, v2, cfg.n_layers)
        return int(got) if isinstance(v1, int) and isinstance(v2, int) else got

    out = {key: extrap(probes[1][key], probes[2][key])
           for key in ("flops", "flops_aten", "flops_kernels", "bytes_accessed", "coll_bytes",
                       "moved", "calls", "booked")}
    out["probes"] = {f"L{n}": {key: p[key] for key in ("flops", "bytes_accessed", "coll_bytes",
                                                          "moved", "calls", "trace_s")}
                     for n, p in probes.items()}
    out["trace_s"] = sum(p["trace_s"] for p in probes.values())
    out["microbatch_scale"] = m
    return out


def analytic_collectives(cfg: ArchConfig, shape: ShapeConfig, mesh_shape: tuple[int, ...],
                         rules_name: str, microbatches: int,
                         model_size_hint: int = 16) -> tuple[dict, dict] | None:
    """The partitioned cell's bytes and calls by kind from the shapes
    (`partitioned_step_collectives`, or `partitioned_serve_collectives`'
    prefill or decode), or None for a rules set they do not count."""
    if rules_name not in ("default", "dp_only"):
        return None
    seq = T._extent(input_specs(cfg, shape))[1] if shape.kind != "decode" else 1
    if shape.kind == "train":
        return partitioned_step_collectives(cfg, mesh_shape, rules_name, shape.global_batch,
                                            seq, microbatches, model_size_hint)
    return partitioned_serve_collectives(cfg, mesh_shape, rules_name, shape.global_batch,
                                         seq, shape.seq_len, model_size_hint)[shape.kind]


def _nonzero(d: dict) -> dict:
    return {k: v for k, v in d.items() if v}


def _per_device(m: dict, chips: int) -> dict:
    return dict(flops=m["flops"] / chips, flops_global=m["flops"],
                bytes_accessed=m["bytes_accessed"] / chips,
                coll_bytes=m["coll_bytes"] / chips)


def _variant_effect(base: ArchConfig, cfg: ArchConfig) -> str:
    changed = [f.name for f in dataclasses.fields(cfg)
               if getattr(cfg, f.name) != getattr(base, f.name)]
    if not changed:
        return "none"
    unread = [f for f in changed if f in _UNREAD_FIELDS]
    read = [f for f in changed if f not in _UNREAD_FIELDS]
    parts = []
    if read:
        parts.append("changes " + ", ".join(read))
    if unread:
        parts.append(", ".join(unread) + " change nothing in the port: the flash "
                     "attention kernel tiles itself")
    return "; ".join(parts)


def _mesh_label(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
             rules_name: str = "default", variant: str = "base",
             microbatches: int = 8, verbose: bool = True) -> dict:
    base = get_arch(arch_name)
    cfg = CFG_VARIANTS[variant](base)
    shape = SHAPES[shape_name]
    mesh_label = _mesh_label(multi_pod)
    rec: dict = dict(arch=arch_name, shape=shape_name, mesh=mesh_label,
                     rules=rules_name, variant=variant, kind=shape.kind,
                     microbatches=microbatches if shape.kind == "train" else None)
    runnable, reason = cell_status(cfg, shape)
    if not runnable:
        rec.update(runnable=False, skip_reason=reason)
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"])
    rules = RULES_VARIANTS[rules_name]
    chips = _chips(mesh)
    rec.update(runnable=True, chips=chips)
    launches_before = kernels.launch_counts()

    # 1) the deliverable: the FULL config runs once
    traced = _trace_cell(cfg, shape, mesh, rules, microbatches)
    full = _measure(traced)
    arg_bytes, out_bytes, alias_bytes = _io_bytes(traced, shape.kind, mesh)
    del traced

    # 2) the cross-check: probes at L ∈ {1, 2}, one microbatch
    probes = {}
    with unroll_scans():
        for n_layers in (1, 2):
            probes[f"L{n_layers}"] = _measure(_trace_cell(
                dataclasses.replace(cfg, n_layers=n_layers), shape, mesh, rules, 1))

    def extrap(key):
        return _extrapolate(probes["L1"][key], probes["L2"][key], cfg.n_layers)

    # 3) the partitioned program: the arguments laid out as in_shardings lay
    # them, probes at L ∈ {1, 2}, one microbatch
    analytic = analytic_collectives(cfg, shape, tuple(mesh.shape.values()), rules_name,
                                    microbatches, _hint(mesh, None))
    try:
        part = _partitioned_probes(cfg, shape, mesh, rules, microbatches)
    except ValueError as e:
        if "does not realise" not in str(e):
            raise
        part, error = None, str(e)

    raw = _per_device(full, chips)
    if part is not None:
        raw["coll_bytes"] = part["coll_bytes"] / chips
        moved, calls = part["moved"], part["calls"]
        built = _build(cfg, shape, mesh, rules, microbatches)
        laid = lay_out_args(built, mesh)
        rec.update(
            coll_scope="partitioned",
            cost_partitioned=dict(
                _per_device(part, chips), kernels_booked=part["booked"],
                argument_bytes=sum(_shard_bytes(a, sp, mesh) for a, sp in zip(laid, built[2])),
                microbatch_scale=part["microbatch_scale"],
                trace_s=round(part["trace_s"], 2), probes=part["probes"]),
            analytic=None if analytic is None else dict(bytes=_nonzero(analytic[0]),
                                                        calls=_nonzero(analytic[1])),
            analytic_match=None if analytic is None else (
                (_nonzero(moved), _nonzero(calls))
                == (_nonzero(analytic[0]), _nonzero(analytic[1]))))
        del built, laid
    else:
        moved, calls = full["moved"], full["calls"]
        rec.update(coll_scope="port regions", partitioned_error=error, analytic=None,
                   analytic_match=None)
    rec.update(
        trace_s=round(full["trace_s"], 2),
        per_device=dict(argument_bytes=arg_bytes, output_bytes=out_bytes,
                        temp_bytes=None, alias_bytes=alias_bytes),
        temp_bytes_global=full["temp_bytes_global"],
        cost_raw=raw, cost=dict(raw),
        cost_extrapolated=dict(flops=extrap("flops") / chips,
                               flops_global=extrap("flops"),
                               bytes_accessed=extrap("bytes_accessed") / chips,
                               coll_bytes=extrap("coll_bytes") / chips),
        probes={k: {key: v[key] for key in ("flops", "flops_aten", "flops_kernels",
                                              "bytes_accessed", "coll_bytes")}
                for k, v in probes.items()},
        flops_aten_global=full["flops_aten"], flops_kernels_global=full["flops_kernels"],
        kernels_booked=full["booked"],
        collectives_once=collective_stats(moved, calls, chips),
        collectives_port=dict(bytes=moved, calls=calls), method=_method(rec["coll_scope"]),
        variant_effect=_variant_effect(base, cfg),
        launches_moved=kernels.launch_counts() != launches_before,
        aten_ops=full["aten_ops"],
    )
    if verbose:
        print(f"[{arch_name} × {shape_name} × {mesh_label} × {rules_name} × {variant}] "
              f"trace {rec['trace_s']}s  arg/dev {arg_bytes / 2**30:.2f}GiB  "
              f"temp(global) {rec['temp_bytes_global'] / 2**30:.1f}GiB  "
              f"flops/dev {raw['flops']:.3e}  coll/dev {raw['coll_bytes'] / 2**20:.1f}MiB "
              f"({rec['coll_scope']})  bytes_accessed/dev {raw['bytes_accessed'] / 2**30:.1f}GiB"
              + (f"  partitioned trace {rec['cost_partitioned']['trace_s']}s, analytic count "
                 f"{rec['analytic_match']}" if part is not None else ""), flush=True)
    return rec


def _trace_solver(n: int, block_size: int, mesh, *, engine: str = "einsum",
                  dtype: str = "float32", algo: str = "spin") -> dict:
    """The inversion program on a (grid, grid, bs, bs) grid of meta blocks:
    `algo="spin"` lays it out on `mesh` (`ShardedBlockMatrix`) and runs
    `inverse_program` under `engine` with the `linalg` leaf, the
    reference's choices; `algo="lu"` runs `core.lu_inverse.lu_inverse` on
    the global `BlockMatrix`, which has no port collectives. `_trace`'s
    dict plus "arg", the input laid out on `mesh` (whose local shard is
    the argument a device holds either way)."""
    from ..core.blockmatrix import BlockMatrix
    from ..core.lu_inverse import lu_inverse
    from ..core.multiply import multiply_engine
    from ..parallel.sharded_blockmatrix import ShardedBlockMatrix, inverse_program

    grid = n // block_size
    blocks = torch.empty((grid, grid, block_size, block_size),
                         dtype=getattr(torch, dtype), device="meta")
    a = ShardedBlockMatrix.from_blockmatrix(BlockMatrix(blocks), mesh=mesh)
    if algo == "spin":
        def invert(a):
            return inverse_program(a, leaf_solver="linalg", engine=engine)
    else:
        def invert(a):
            with multiply_engine(engine):
                return lu_inverse(BlockMatrix(blocks))
    traced = _trace(invert, (a,), mesh)
    traced["arg"] = a
    return traced


def run_solver_cell(n: int, block_size: int, *, multi_pod: bool,
                    engine: str = "einsum", dtype: str = "float32",
                    algo: str = "spin", out_dir: str | None = None,
                    verbose: bool = True) -> dict:
    """Dry-run the paper's technique itself: the inversion on the
    production mesh of meta devices. No layer loop, so no extrapolation.
    The argument and output bytes are the (data, model) layout's, as the
    reference's in and out shardings give them; `algo="lu"` computes on
    the global grid and moves nothing between coordinates."""
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"])
    mesh_label = _mesh_label(multi_pod)
    grid = n // block_size
    chips = _chips(mesh)
    rec = dict(arch=f"solver-{algo}", shape=f"n{n}_b{grid}_{dtype}_{engine}",
               mesh=mesh_label, rules=engine, kind="solver", runnable=True,
               chips=chips, n=n, grid=grid, block_size=block_size)
    launches_before = kernels.launch_counts()
    traced = _trace_solver(n, block_size, mesh, engine=engine, dtype=dtype, algo=algo)
    m = _measure(traced)
    a = traced["arg"]
    local = _nbytes(a.dist.shards[mesh.coords()[0]])
    raw = _per_device(m, chips)
    rec.update(
        trace_s=round(m["trace_s"], 2),
        per_device=dict(argument_bytes=local, output_bytes=local, temp_bytes=None,
                        alias_bytes=0),
        temp_bytes_global=m["temp_bytes_global"],
        cost=raw, cost_raw=dict(raw),
        flops_aten_global=m["flops_aten"], flops_kernels_global=m["flops_kernels"],
        collectives_once=collective_stats(m["moved"], m["calls"], chips),
        collectives_port=dict(bytes=m["moved"], calls=m["calls"]),
        coll_scope="partitioned" if algo == "spin" else "none: the global grid",
        method=METHOD, launches_moved=kernels.launch_counts() != launches_before,
        aten_ops=m["aten_ops"],
    )
    if verbose:
        print(f"[solver-{algo} n={n} grid={grid} {dtype} {engine} × {mesh_label}] "
              f"trace {rec['trace_s']}s  flops/dev {raw['flops']:.3e}  "
              f"coll/dev {raw['coll_bytes'] / 2**20:.1f}MiB", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        label = f"solver-{algo}__{rec['shape']}__{mesh_label}"
        with open(os.path.join(out_dir, label + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--solver", action="store_true",
                    help="dry-run the SPIN solver itself instead of LM cells")
    ap.add_argument("--solver-n", type=int, default=65536)
    ap.add_argument("--solver-block", type=int, default=4096)
    ap.add_argument("--solver-engine", default="einsum",
                    choices=["einsum", "allgather", "ring"])
    ap.add_argument("--solver-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--solver-algo", default="spin", choices=["spin", "lu"])
    ap.add_argument("--arch", default="all", help="arch id or 'all' (see configs/)")
    ap.add_argument("--shape", default="all", help="shape id or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--rules", default="default", choices=sorted(RULES_VARIANTS))
    ap.add_argument("--variant", default="base", choices=sorted(CFG_VARIANTS))
    ap.add_argument("--remat-policy", default="full", choices=["full", "dots"])
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    global _REMAT_POLICY
    _REMAT_POLICY = args.remat_policy
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    t_grid = time.perf_counter()

    if args.solver:
        for mp in meshes:
            run_solver_cell(args.solver_n, args.solver_block, multi_pod=mp,
                            engine=args.solver_engine, dtype=args.solver_dtype,
                            algo=args.solver_algo, out_dir=args.out)
        print(f"grid_s {time.perf_counter() - t_grid:.1f}")
        return

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                label = f"{arch}__{shape}__{_mesh_label(mp)}__{args.rules}"
                if args.variant != "base":
                    label += f"__{args.variant}"
                path = os.path.join(args.out, label + ".json")
                try:
                    rec = run_cell(arch, shape, multi_pod=mp, rules_name=args.rules,
                                   variant=args.variant,
                                   microbatches=args.microbatches)
                except Exception as e:  # noqa: BLE001 — record, keep going
                    rec = dict(arch=arch, shape=shape, mesh=_mesh_label(mp),
                               rules=args.rules, runnable=True,
                               error=f"{type(e).__name__}: {e}")
                    failures.append(label)
                    print(f"[{label}] FAILED: {e}")
                    traceback.print_exc()
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    print(f"grid_s {time.perf_counter() - t_grid:.1f}")
    if failures:
        print(f"\n{len(failures)} FAILED cells: {failures}")
        raise SystemExit(1)
    print("\nall requested cells ran on the meta device")


if __name__ == "__main__":
    main()
