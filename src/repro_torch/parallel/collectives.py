"""Arrays laid out over a `Mesh`, and the copies that move them.

A `DistArray` is one global array held as one local tensor per mesh
coordinate, on that coordinate's device. Its `spec` names, per dimension,
the mesh axis the dimension is split over (evenly, in contiguous chunks)
or None when every coordinate holds the whole extent, the layout a JAX
`PartitionSpec` describes. A region that several coordinates hold (a
replicated axis) is held ONCE per distinct device: coordinates that share
a device share the tensor.

The collectives of the JAX package's shard_map programs are explicit
copies between coordinates here, `Tensor.copy_` into a buffer on the
destination's device:

  * `fetch` assembles any region of an array at one coordinate: a view of
    the coordinate's own shard when the region lies inside it, else a
    buffer filled from the shards that hold the pieces. An all-gather
    along an axis is the fetch of a row or column panel;
  * `summa` is the SUMMA product (gather A's row panel along `model` and
    B's column panel along `data`, then one local product a shard);
  * `ring` gathers A once, then passes B's k-panels around the `data`
    ring, each copy issued on a side stream before the local product that
    overlaps it, and waited on by an event before its use.

A copy between two coordinates is a copy even when both lie on one device,
so a mesh that repeats one card pays, and counts, the data movement its
layout implies. `collective_bytes()` reports the bytes copied between
coordinates since the last reset, by kind: "gather" (product operands),
"ring" (the ring's panel passes), "reshard" (quadrant views, arrange, a
change of layout, a region's inputs sent to another device) and
"to_dense" (densifying a result).

The reference's `shard_map` regions (MoE's expert-parallel dispatch, the
sharded embedding, `compressed_psum`) run here per coordinate, as dicts
coordinate -> local tensor: `split` slices an input by its spec onto each
coordinate's device, the body runs one phase over every coordinate, then
a collective between them, then the next phase, and `join` reassembles
an output by its spec on the mesh's home device. The collectives act
over a named mesh axis (or a tuple of axes, row-major), group by group:
`all_to_all`, tiled `all_gather`, `psum`, `pmean`, `pmax`, with
`axis_index` and `axis_size`. Each is a `torch.autograd.Function` whose
backward is the transposed collective (all_to_all with its dims swapped,
a reduce-scatter, a psum), so a training step differentiates through a
region. Each counts, forward and backward, the bytes a coordinate takes
from another under its own kind: an all_to_all the chunks it receives, an
all_gather the pieces, its backward ("reduce_scatter") the gradient
pieces, a psum / pmean / pmax the inputs read by the group's first
coordinate plus the result handed back to the others. No threads:
autograd and the ambient mesh do not cross into them. Each collective
runs inside a profiler range "collective:<kind>" (its backward too, the
all_gather's under "collective:all_gather"), which `profile_lm --train
--mesh` reads.

`collective_calls()` counts the operations by the same kinds: one a call
of a per-coordinate collective over the whole mesh, and one a backward of
it; one a `fetch` or ring pass that took bytes from another coordinate.
A piece that already lies on its destination's device is used as it is
(`_on`), which costs the host nothing on a mesh of one device; the bytes
it would cross between coordinates are counted all the same.

A mesh that spans processes (`launch.mesh.init_distributed`) runs the same
program in every process. A `DistArray` holds the shards of this
process's coordinates only, and every process walks every coordinate's
plan: where a coordinate is another process's, its `fetch` only sends
what this process holds of the pieces it needs, and a copy between
coordinates of two processes is one matched transfer
(`parallel.transport`). A region that places of several processes hold
(a replicated value) is made once, by the process of its first holder
in coordinate order, as one process would make it; the others receive it
("replicate"). The work a single process does once a device (the
leaves, the grid-1 products, a solve's panel products) runs once, on one
process, the processes taking each kind of it in turn, and the others
receive the result.
The per-coordinate programs hold every coordinate in their dicts: a
coordinate of another process as a *ghost*, a tensor on ``meta`` with its
shape and dtype, so every process runs every coordinate's program (the
ghosts at no cost) and every collective, forward and backward, and the
autograd graph is the same in every process. `join` hands the whole
output to every process, and `split`'s backward the whole gradient,
both counted as "replicate". A backward through such a region runs its
nodes in one thread (`backward_context`), so that every process meets
the collectives in one order.

Counting is by the destination: a process books the bytes and the
operations its own coordinates take from others (one process books a
call over the whole mesh). Summed over the processes, every kind but
"replicate" equals the count of a single process's mesh of the same
shape on one device, and "to_dense" that count once a process, since
every process gets the whole result; `summed_counts()` sums over them.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
from typing import Callable, Sequence

import torch
from torch.autograd.profiler import record_function

from ..core.blockmatrix import suspend_counts
from ..launch.mesh import Mesh, current_mesh
from . import transport

__all__ = ["DistArray", "Region", "grid_spec", "panel_spec", "region_of",
           "fetch", "take", "assemble", "distribute", "empty", "zip_map",
           "once_per_device", "summa", "ring", "grid_to_panel", "panel_to_grid", "row_apply",
           "map_regions",
           "gather", "relayout", "collective_bytes", "collective_calls",
           "reset_collective_bytes", "summed_counts", "split", "join", "region",
           "all_to_all", "all_gather", "psum", "pmean", "pmax", "axis_index",
           "axis_size", "backward_context", "enter", "per_coord", "laid_out_region",
           "grads", "to_spec", "region_values"]

Region = tuple[tuple[int, int], ...]          # (lo, hi) a dimension

_KINDS = ("gather", "ring", "reshard", "to_dense", "all_to_all", "all_gather",
          "reduce_scatter", "psum", "pmean", "pmax", "replicate")
_BYTES: dict[str, int] = dict.fromkeys(_KINDS, 0)
_CALLS: dict[str, int] = dict.fromkeys(_KINDS, 0)
_LOCK = threading.Lock()


def collective_bytes() -> dict[str, int]:
    """Bytes copied between mesh coordinates since the last reset."""
    with _LOCK:
        return dict(_BYTES)


def collective_calls() -> dict[str, int]:
    """Collective operations since the last reset, by the same kinds."""
    with _LOCK:
        return dict(_CALLS)


def reset_collective_bytes() -> None:
    """Zero the bytes and the calls (and the transfers' host seconds)."""
    with _LOCK:
        for k in _KINDS:
            _BYTES[k] = _CALLS[k] = 0
    transport.reset_stats()


def summed_counts() -> tuple[dict[str, int], dict[str, int]]:
    """(bytes, calls) by kind summed over the processes of the group: a
    collective, every process calls it. One process: its own counts."""
    import torch.distributed as dist

    moved, calls = collective_bytes(), collective_calls()
    if not (dist.is_available() and dist.is_initialized()):
        return moved, calls
    t = torch.tensor([moved[k] for k in _KINDS] + [calls[k] for k in _KINDS],
                     dtype=torch.int64)
    dist.all_reduce(t)
    v = t.tolist()
    n = len(_KINDS)
    return dict(zip(_KINDS, v[:n])), dict(zip(_KINDS, v[n:]))


def _count(kind: str, nbytes: int) -> None:
    with _LOCK:
        _BYTES[kind] += nbytes


def _call(kind: str) -> None:
    with _LOCK:
        _CALLS[kind] += 1


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` on `device`: itself where it lies there already."""
    return t if t.device == device else t.to(device)


def _ghost(shape, dtype: torch.dtype) -> torch.Tensor:
    """A coordinate of another process in a per-coordinate program: its
    shape and dtype, no storage."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _exchanging(fn):
    """`fn` posts transfers: its sends are waited on when it ends."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with transport.exchange():
            return fn(*args, **kwargs)
    return run


def _move(t: torch.Tensor, mesh: Mesh, src, dst, *, copy: bool = False
          ) -> torch.Tensor:
    """`t`, held at coordinate `src` (a ghost where `src` is another
    process's), at coordinate `dst`: a tensor where `dst` is this
    process's, else a ghost. Between two processes, one matched transfer;
    inside one, `_on` (a copy with copy=True)."""
    ps, pd = mesh.process(src), mesh.process(dst)
    if ps == pd:
        if not mesh.is_local(dst):
            return t
        dev = mesh.device(dst)
        return t.to(dev, copy=True) if copy else _on(t, dev)
    tag = transport.next_tag()
    if mesh.is_local(src):
        transport.send(t, pd, tag)
        return _ghost(t.shape, t.dtype)
    if mesh.is_local(dst):
        return transport.recv(t.shape, t.dtype, ps, tag, mesh.device(dst))
    return t


# ---------------------------------------------------------------------------
# Regions
# ---------------------------------------------------------------------------


def grid_spec(grid_rows: int, grid_cols: int, mesh,
              axes: tuple[str, str] = ("data", "model")) -> tuple:
    """Divisibility-aware layout of a (g_r, g_c, bs, bs) grid: a grid axis
    is split over its mesh axis when the mesh axis divides it, else whole.
    Reads only ``dict(mesh.shape)``, as the JAX package's does."""
    shape = dict(mesh.shape)
    d, m = axes
    row = d if d in shape and grid_rows % shape[d] == 0 else None
    col = m if m in shape and grid_cols % shape[m] == 0 else None
    return (row, col, None, None)


def panel_spec(rows: int, mesh, axes: tuple[str, str] = ("data", "model")
               ) -> tuple:
    """Layout of a dense (rows, k) solve panel: rows over `data` when the
    axis divides them."""
    d = axes[0]
    shape = dict(mesh.shape)
    return (d if d in shape and rows % shape[d] == 0 else None, None)


def _names(axis) -> tuple[str, ...]:
    """A spec entry or collective axis as a tuple of mesh axis names."""
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _extent(mesh: Mesh, axis) -> int:
    n = 1
    for a in _names(axis):
        n *= mesh.shape[a]
    return n


def _position(mesh: Mesh, axis, coord: tuple[int, ...]) -> int:
    """`coord`'s index along `axis`: row-major over a tuple of axes, the
    first outermost, as JAX splits a dimension over several axes."""
    i = 0
    for a in _names(axis):
        i = i * mesh.shape[a] + coord[mesh.axis_index(a)]
    return i


def region_of(shape: Sequence[int], spec: Sequence, mesh: Mesh,
              coord: tuple[int, ...]) -> Region:
    """The global region coordinate `coord` holds under `spec`; an entry
    may be a tuple of mesh axes (split over their product, row-major)."""
    out = []
    for n, ax in zip(shape, spec):
        if ax is None:
            out.append((0, n))
            continue
        chunk = n // _extent(mesh, ax)
        i = _position(mesh, ax, coord)
        out.append((i * chunk, (i + 1) * chunk))
    return tuple(out)


def _whole(shape: Sequence[int]) -> Region:
    return tuple((0, n) for n in shape)


def _contains(outer: Region, inner: Region) -> bool:
    return all(o0 <= i0 and i1 <= o1 for (o0, o1), (i0, i1) in zip(outer, inner))


def _intersect(a: Region, b: Region) -> Region | None:
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def _slices(region: Region, base: Region) -> tuple[slice, ...]:
    return tuple(slice(r0 - b0, r1 - b0) for (r0, r1), (b0, _) in zip(region, base))


def _sizes(region: Region) -> tuple[int, ...]:
    return tuple(hi - lo for lo, hi in region)


def _shift(region: Region, offset: Sequence[int]) -> Region:
    return tuple((lo + o, hi + o) for (lo, hi), o in zip(region, offset))


# ---------------------------------------------------------------------------
# DistArray
# ---------------------------------------------------------------------------


class DistArray:
    """A global array of `shape` laid out over `mesh` by `spec`.

    `shards` maps each of this process's mesh coordinates to its local
    tensor (every coordinate in a single process). Build one with
    `distribute`, `take` or `assemble`; the constructor does not check the
    shards against the layout. `ghosts` (set by `enter`) holds the other
    processes' coordinates as autograd leaves on ``meta``.
    """

    __slots__ = ("shape", "spec", "mesh", "shards", "ghosts", "_tiles")

    def __init__(self, shape: Sequence[int], spec: Sequence[str | None],
                 mesh: Mesh, shards: dict[tuple[int, ...], torch.Tensor],
                 ghosts: dict[tuple[int, ...], torch.Tensor] | None = None):
        self.shape = tuple(int(s) for s in shape)
        self.spec = tuple(spec)
        self.mesh = mesh
        self.shards = shards
        self.ghosts = ghosts
        self._tiles = None

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.shards.values())).dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.local_device()

    def region(self, coord: tuple[int, ...]) -> Region:
        return region_of(self.shape, self.spec, self.mesh, coord)

    def tiles(self) -> dict[Region, list[tuple[int, ...]]]:
        """Each distinct region of the layout, with the coordinates holding
        it in coordinate order."""
        if self._tiles is None:
            tiles: dict[Region, list] = {}
            for c in self.mesh.coords():
                tiles.setdefault(self.region(c), []).append(c)
            self._tiles = tiles
        return self._tiles


def _buffer(shape: tuple[int, ...], dtype: torch.dtype, device: torch.device,
            zero: bool = False) -> torch.Tensor:
    """A fresh buffer for a region. A (g_r, g_c, bs, bs) block grid is laid
    out densely, as the (g_r·bs, g_c·bs) matrix viewed as blocks, so the
    GEMM kernel's flattening (`blocks_to_dense`) of a gathered panel is a
    view, not a second copy."""
    alloc = torch.zeros if zero else torch.empty
    if len(shape) == 4 and shape[2] == shape[3]:
        gr, gc, bs, _ = shape
        dense = alloc((gr * bs, gc * bs), dtype=dtype, device=device)
        return dense.view(gr, bs, gc, bs).permute(0, 2, 1, 3)
    return alloc(shape, dtype=dtype, device=device)


_ELSEWHERE = object()   # `fetch(out=...)`: the buffer lies in another process


def _holder(mesh: Mesh, holders: list, coord) -> tuple:
    """The coordinate a piece is taken from: `coord` itself, else a holder
    at its place, else one in its process, else the first holder."""
    if coord in holders:
        return coord
    place = mesh.place(coord)
    for h in holders:
        if mesh.place(h) == place:
            return h
    for h in holders:
        if mesh.process(h) == place[0]:
            return h
    return holders[0]


@_exchanging
def fetch(x: DistArray, region: Region, coord: tuple[int, ...], kind: str,
          out: torch.Tensor | None = None) -> torch.Tensor | None:
    """`region` of `x`, on coordinate `coord`'s device.

    A view of the coordinate's own shard when the region lies inside it;
    otherwise (or when `out` is given) the pieces are copied into `out` (a
    fresh buffer by default) from the holders of each piece (`_holder`).
    Bytes from other coordinates are counted under `kind`. Where `coord`
    is another process's, this process sends the pieces it holds and
    returns None (`out=_ELSEWHERE` stands for that process's buffer).
    """
    mesh = x.mesh
    own = x.region(coord)
    here = mesh.is_local(coord) and out is not _ELSEWHERE
    if out is None and _contains(own, region):
        return x.shards[coord][_slices(region, own)] if here else None
    if here and out is None:
        out = _buffer(_sizes(region), x.dtype, mesh.device(coord))
    moved = False
    for tile, holders in x.tiles().items():
        piece = _intersect(tile, region)
        if piece is None:
            continue
        src = _holder(mesh, holders, coord)
        remote = mesh.process(src) != mesh.process(coord)
        tag = transport.next_tag() if remote else None
        if here:
            dst = out[_slices(piece, region)]
            if remote:
                dst.copy_(transport.recv(_sizes(piece), x.dtype, mesh.process(src), tag,
                                         dst.device), non_blocking=True)
            else:
                dst.copy_(x.shards[src][_slices(piece, tile)], non_blocking=True)
            if src != coord:
                _count(kind, dst.numel() * dst.element_size())
                moved = True
        elif remote and mesh.is_local(src):
            transport.send(x.shards[src][_slices(piece, tile)], mesh.process(coord), tag)
    if moved:
        _call(kind)
    return out if here else None


@_exchanging
def _layout(mesh: Mesh, shape, spec, make, dtype: torch.dtype | None = None, *,
            everywhere: bool = False,
            source: Callable[[Region], tuple[int, ...]] | None = None
            ) -> DistArray:
    """Build a DistArray coordinate by coordinate; `make(coord, region)`
    runs once per distinct (place, region), so replicas at one place
    share a tensor.

    Across processes a region is made by the process of its first holder
    (in coordinate order), or of the coordinate `source(region)` names
    (where one piece of work serves several regions); for a coordinate of
    another process `make` runs its fetches only (they send) and returns
    None. A coordinate of a later process receives the region from that
    coordinate ("replicate"; of `dtype`). everywhere=True: every process
    makes its own coordinates' regions (what `make` reads is in every
    process) and nothing moves.
    """
    shards, cache, first = {}, {}, {}
    for c in mesh.coords():
        r = region_of(shape, spec, mesh, c)
        key = (mesh.place(c), r)
        if key not in cache:
            src = source(r) if source is not None else first.setdefault(r, c)
            if everywhere:
                cache[key] = make(c, r) if mesh.is_local(c) else None
            elif mesh.process(src) == mesh.process(c):
                cache[key] = make(c, r)
            else:
                skey = (mesh.place(src), r)
                if skey not in cache:             # `source` need not hold r
                    cache[skey] = make(src, r)
                cache[key] = _replica(cache[skey], mesh, src, c, _sizes(r), dtype)
        if mesh.is_local(c):
            shards[c] = cache[key]
    return DistArray(shape, spec, mesh, shards)


def _replica(t, mesh: Mesh, src, dst, shape, dtype) -> torch.Tensor | None:
    """A region made at `src`, received at `dst` of another process
    ("replicate"); None where `dst` is not this process's."""
    if mesh.is_local(src) and t.dtype != dtype:
        raise TypeError(f"a replicated region of {t.dtype}, declared {dtype}")
    out = _move(t if mesh.is_local(src) else _ghost(shape, dtype), mesh, src, dst)
    if not mesh.is_local(dst):
        return None
    _count("replicate", out.numel() * out.element_size())
    _call("replicate")
    return out


def take(x: DistArray, region: Region, spec: Sequence[str | None]
         ) -> DistArray:
    """The sub-array `region` of `x`, laid out anew by `spec`."""
    offset = [lo for lo, _ in region]
    return _layout(x.mesh, _sizes(region), spec,
                   lambda c, r: fetch(x, _shift(r, offset), c, "reshard"), x.dtype)


def relayout(x: DistArray, spec: Sequence[str | None]) -> DistArray:
    """`x` under another layout (itself when the spec is unchanged)."""
    if tuple(spec) == x.spec:
        return x
    return take(x, _whole(x.shape), spec)


def assemble(parts: Sequence[tuple[Sequence[int], DistArray]],
             shape: Sequence[int], spec: Sequence[str | None], mesh: Mesh,
             zero_fill: bool = False) -> DistArray:
    """One array from parts placed at offsets (the quadrants of `arrange`,
    the row blocks of a stacked panel), laid out by `spec`; zero_fill=True
    zeroes what no part covers (a padded grid)."""
    boxes = [(_shift(_whole(p.shape), off), off, p) for off, p in parts]
    dtype = parts[0][1].dtype

    def make(c, r):
        for box, off, p in boxes:
            if _contains(box, r):
                return fetch(p, _shift(r, [-o for o in off]), c, "reshard")
        here = mesh.is_local(c)
        out = _buffer(_sizes(r), dtype, mesh.device(c), zero_fill) if here else None
        for box, off, p in boxes:
            piece = _intersect(box, r)
            if piece is not None:
                fetch(p, _shift(piece, [-o for o in off]), c, "reshard",
                      out=out[_slices(piece, r)] if here else _ELSEWHERE)
        return out

    return _layout(mesh, shape, spec, make, dtype)


def distribute(t: torch.Tensor, spec: Sequence[str | None],
               mesh: Mesh) -> DistArray:
    """Lay a global tensor out over `mesh`: views of it on its own device,
    copies on the others. A dimension its axes do not divide raises.
    Across processes every process holds `t` and slices its own
    coordinates' shards: nothing moves."""
    _check_spec(t.shape, spec, mesh)
    whole = _whole(t.shape)

    def make(c, r):
        piece = t[_slices(r, whole)]
        dev = mesh.device(c)
        return piece if piece.device == dev else piece.to(dev)

    return _layout(mesh, t.shape, spec, make, everywhere=True)


def empty(shape: Sequence[int], spec: Sequence[str | None], mesh: Mesh,
          dtype: torch.dtype) -> DistArray:
    """An uninitialised array laid out by `spec`: each process allocates
    its own coordinates' regions, one tensor a distinct region a place."""
    _check_spec(shape, spec, mesh)
    return _layout(mesh, tuple(shape), spec,
                   lambda c, r: torch.empty(_sizes(r), dtype=dtype, device=mesh.device(c)),
                   everywhere=True)


@_exchanging
def zip_map(fn: Callable[..., torch.Tensor], *xs: DistArray,
            whole: Sequence[DistArray] = ()) -> DistArray:
    """Apply `fn` shard by shard to arrays of one layout (equal extents
    along the split dimensions); shards shared by replicas are computed
    once. Each array of `whole` is passed in full after the shards,
    gathered once a place (at the places of the first process; the other
    processes receive it, "replicate")."""
    first = xs[0]
    for x in xs[1:]:
        if x.spec != first.spec or any(
                n != m for n, m, ax in zip(x.shape, first.shape, x.spec)
                if ax is not None):
            raise ValueError(f"layouts differ: {first.shape}/{first.spec} vs "
                             f"{x.shape}/{x.spec}")
    mesh = first.mesh
    fulls = {}
    if whole:
        c0 = mesh.coords()[0]
        for c in mesh.coords():
            place = mesh.place(c)
            if place in fulls:
                continue
            if mesh.process(c) == mesh.process(c0):
                fulls[place] = [fetch(w, _whole(w.shape), c, "gather") for w in whole]
            else:
                fulls[place] = [
                    _replica(f, mesh, c0, c, w.shape, w.dtype)
                    for f, w in zip(fulls[mesh.place(c0)] or [None] * len(whole), whole)]
    shards, cache = {}, {}
    for c in mesh.local_coords():
        args = [x.shards[c] for x in xs] + fulls.get(mesh.place(c), [])
        key = tuple(id(a) for a in args)
        if key not in cache:
            cache[key] = fn(*args)
        shards[c] = cache[key]
    return _rebuild(first, shards)


def _rebuild(like: DistArray, shards: dict) -> DistArray:
    # The global shape follows from a shard's shape and the layout (`fn`
    # may change the extent of a dimension the layout leaves whole).
    local = shards[like.mesh.local_coords()[0]].shape
    shape = []
    for n, ax in zip(local, like.spec):
        shape.append(n * _extent(like.mesh, ax))
    return DistArray(shape, like.spec, like.mesh, shards)


# Replicated work across processes goes to them in turn, each kind of work
# (a leaf, a product, a panel apply: the function's name) on its own turn:
# every process makes the calls in one order, so the k-th call of a kind
# picks the same process everywhere.
_TURNS: dict[str, itertools.count] = {}


def _turn(kind: str, n: int) -> int:
    with _LOCK:
        counter = _TURNS.setdefault(kind, itertools.count())
        return next(counter) % n


@_exchanging
def once_per_device(fn: Callable[..., torch.Tensor], xs: Sequence[DistArray],
                    spec: Sequence[str | None], mesh: Mesh, *,
                    shape: Sequence[int] | None = None,
                    dtype: torch.dtype | None = None) -> DistArray:
    """Run `fn` on the whole operands once on each distinct device and lay
    the result out by `spec`: the mesh's replicated work, computed once a
    device. Op counts are booked by the first device's run only. Across
    processes it runs at the places of one process, the processes taking
    the calls in turn (a leaf's kernel runs once, on one rank), and the
    others receive their parts of the result ("replicate"): they learn
    its `shape` and `dtype` (default the first operand's) from the
    arguments, which a mesh that spans processes needs."""
    procs = mesh.processes
    maker = procs[_turn(fn.__qualname__, len(procs))] if len(procs) > 1 else procs[0]
    full = {}
    for place in mesh.places():
        if place[0] != maker:
            continue
        c = mesh.home(place)
        args = [fetch(x, _whole(x.shape), c, "gather") for x in xs]
        if mesh.is_local(c):
            with (contextlib.nullcontext() if not full else suspend_counts()):
                full[place] = fn(*args)
    if shape is None:
        if mesh.spans_processes:
            raise ValueError("once_per_device on a mesh that spans processes needs "
                             "the result's shape")
        shape = next(iter(full.values())).shape
    whole = _whole(shape)
    home = next(c for c in mesh.coords() if mesh.process(c) == maker)
    return _layout(mesh, tuple(shape), spec,
                   lambda c, r: full[mesh.place(c)][_slices(r, whole)]
                   if mesh.is_local(c) else None,
                   dtype or xs[0].dtype, source=lambda r: home)


@_exchanging
def gather(x: DistArray, device: torch.device | None = None) -> torch.Tensor:
    """The whole array as one tensor on `device` (default: the mesh's first
    device of this process). Across processes every process gets it,
    assembled at its first coordinate ("to_dense" once a process)."""
    device = x.device if device is None else torch.device(device)
    mesh = x.mesh
    if mesh.spans_processes:
        out = None
        for p in mesh.processes:
            c = next(c for c in mesh.coords() if mesh.process(c) == p)
            got = fetch(x, _whole(x.shape), c, "to_dense")
            out = got if got is not None else out
    else:
        coords = mesh.coords()
        c = next((c for c in coords if mesh.device(c) == device), coords[0])
        out = fetch(x, _whole(x.shape), c, "to_dense")
    return out if out.device == device else out.to(device)


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------


def summa(a: DistArray, b: DistArray, axes: tuple[str, str],
          local: Callable[..., torch.Tensor],
          c: DistArray | None = None) -> DistArray:
    """SUMMA over (b_i, b_k, bs, bs) × (b_k, b_j, bs, bs) grids laid out
    (data, model): each shard (i, j) gathers A's row panel i along `model`
    and B's column panel j along `data`, then runs `local(a_panel,
    b_panel)`, or `local(c_shard, a_panel, b_panel)` when `c` is given (the
    fused Schur update on C's own shard). The panels are freed before the
    next shard's product."""
    spec = (axes[0], axes[1], None, None)
    a, b = relayout(a, spec), relayout(b, spec)
    if c is not None:
        c = relayout(c, spec)
    mesh = a.mesh
    out_shape = (a.shape[0], b.shape[1]) + a.shape[2:]

    def make(coord, r):
        a_panel = fetch(a, (r[0], (0, a.shape[1])) + r[2:], coord, "gather")
        b_panel = fetch(b, ((0, b.shape[0]), r[1]) + r[2:], coord, "gather")
        if not mesh.is_local(coord):
            return None
        if c is None:
            return local(a_panel, b_panel)
        return local(c.shards[coord], a_panel, b_panel)

    return _layout(mesh, out_shape, spec, make, a.dtype)


_SIDE_STREAMS: dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device):
    # One copy stream a device, shared by the threads of a worker pool.
    with _LOCK:
        s = _SIDE_STREAMS.get(device)
        if s is None:
            s = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
        return s


def _send(panel: torch.Tensor, dst: torch.device):
    """Start copying `panel` to `dst`; returns (buffer, event or None).

    On the card the copy runs on `dst`'s side stream once the work queued
    so far on the panel's stream is done; `record_stream` keeps the
    source alive until the copy has read it.
    """
    nbytes = panel.numel() * panel.element_size()
    _count("ring", nbytes)
    _call("ring")
    if panel.device.type != "cuda":
        return panel.to(dst, copy=True), None
    side = _side_stream(dst)
    side.wait_stream(torch.cuda.current_stream(panel.device))
    with torch.cuda.stream(side):
        buf = torch.empty(panel.shape, dtype=panel.dtype, device=dst)
        buf.copy_(panel, non_blocking=True)
        event = torch.cuda.Event()
        event.record(side)
    panel.record_stream(side)
    return buf, event


def _receive(buf: torch.Tensor, event) -> torch.Tensor:
    """Make the consumer's stream wait for the copy; the buffer, allocated
    on the side stream, is then in use on the consumer's."""
    if event is not None:
        current = torch.cuda.current_stream(buf.device)
        current.wait_event(event)
        buf.record_stream(current)
    return buf


def _pass(panel, mesh: Mesh, src, dst, shape, dtype):
    """Start passing `panel` from coordinate `src` to `dst`; returns a
    callable that finishes the pass and gives the panel at `dst`, or None
    where `dst` is another process's. Inside a process it is `_send`'s
    copy; between two, a matched transfer (its receive posted now,
    waited on by the callable)."""
    ps, pd = mesh.process(src), mesh.process(dst)
    if ps == pd:
        if not mesh.is_local(dst):
            return None
        buf, event = _send(panel, mesh.device(dst))
        return lambda: _receive(buf, event)
    tag = transport.next_tag()
    if mesh.is_local(src):
        transport.send(panel, pd, tag)
        return None
    if not mesh.is_local(dst):
        return None
    n = 1
    for k in shape:
        n *= k
    _count("ring", n * torch.empty((), dtype=dtype).element_size())
    _call("ring")
    return transport.post_recv(shape, dtype, ps, tag, mesh.device(dst)).wait


@_exchanging
def ring(a: DistArray, b: DistArray, axes: tuple[str, str],
         local: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
         ) -> DistArray:
    """SUMMA with B's gather unrolled into a ring along `data`.

    A's row panels are gathered once along `model`. At step t coordinate
    (i, j) holds the k-panel of B that started at data rank (i − t) mod D,
    multiplies it against the matching k-columns of its A panel, and
    forwards it to rank i + 1: the forward is issued before the product,
    so the copy overlaps it (double buffering: the panel in use and the
    one in flight). Between processes the forward is a matched transfer,
    whose receive is waited on after the product; gloo stages a card's
    panel on the host before the product is issued, so the overlap is lost
    there.
    """
    data_axis, model_axis = axes
    spec = (data_axis, model_axis, None, None)
    a, b = relayout(a, spec), relayout(b, spec)
    mesh = a.mesh
    n_data = mesh.shape[data_axis]
    if n_data == 1:
        return summa(a, b, axes, local)
    di = mesh.axis_index(data_axis)
    coords, mine = mesh.coords(), mesh.local_coords()
    bk = b.shape[0] // n_data

    def nxt(c):
        c = list(c)
        c[di] = (c[di] + 1) % n_data
        return tuple(c)

    a_rows, acc = {}, {}
    for c in coords:
        r = a.region(c)
        row = fetch(a, (r[0], (0, a.shape[1])) + r[2:], c, "gather")
        if mesh.is_local(c):
            a_rows[c] = row
            br = b.region(c)
            acc[c] = torch.zeros((r[0][1] - r[0][0], br[1][1] - br[1][0])
                                 + a.shape[2:], dtype=a.dtype,
                                 device=mesh.device(c))
    panels = {c: b.shards[c] for c in mine}
    pshape = _sizes(b.region(coords[0]))
    for t in range(n_data):
        passes = ({nxt(c): _pass(panels.get(c), mesh, c, nxt(c), pshape, b.dtype)
                   for c in coords} if t < n_data - 1 else None)
        for c in mine:
            src = (c[di] - t) % n_data
            a_cols = a_rows[c][:, src * bk:(src + 1) * bk]
            acc[c] = acc[c] + local(a_cols, panels[c])
        if passes is not None:
            panels = {c: passes[c]() for c in mine}
    return DistArray((a.shape[0], b.shape[1]) + a.shape[2:], spec, mesh, acc)


# ---------------------------------------------------------------------------
# Block grids and dense panels
# ---------------------------------------------------------------------------


def _block_span(lo: int, hi: int, bs: int) -> tuple[int, int]:
    return lo // bs, -(-hi // bs)


def grid_to_panel(g: DistArray, spec: Sequence[str | None]) -> DistArray:
    """A (g_r, g_c, bs, bs) block grid as its dense (g_r·bs, g_c·bs) panel,
    laid out by `spec`."""
    bs = g.shape[2]
    shape = (g.shape[0] * bs, g.shape[1] * bs)

    def make(c, r):
        (r0, r1), (c0, c1) = r
        br, bc = _block_span(r0, r1, bs), _block_span(c0, c1, bs)
        blocks = fetch(g, (br, bc, (0, bs), (0, bs)), c, "reshard")
        if blocks is None:
            return None
        nb_r, nb_c = blocks.shape[0], blocks.shape[1]
        dense = blocks.permute(0, 2, 1, 3).reshape(nb_r * bs, nb_c * bs)
        return dense[r0 - br[0] * bs:r1 - br[0] * bs,
                     c0 - bc[0] * bs:c1 - bc[0] * bs]

    return _layout(g.mesh, shape, spec, make, g.dtype)


def panel_to_grid(p: DistArray, bs: int, spec: Sequence[str | None]
                  ) -> DistArray:
    """A dense (rows, cols) panel as its block grid, laid out by `spec`."""
    shape = (p.shape[0] // bs, p.shape[1] // bs, bs, bs)

    def make(c, r):
        (g0, g1), (h0, h1) = r[0], r[1]
        dense = fetch(p, ((g0 * bs, g1 * bs), (h0 * bs, h1 * bs)), c,
                      "reshard")
        if dense is None:
            return None
        return dense.reshape(g1 - g0, bs, h1 - h0, bs).permute(0, 2, 1, 3)

    return _layout(p.mesh, shape, spec, make, p.dtype)


def row_apply(a: DistArray, x: DistArray, spec: Sequence[str | None],
              fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], *,
              by_cols: bool = False) -> DistArray:
    """A·X for a block grid A and a dense panel X, laid out by `spec` (rows
    over `data`): each row shard gathers A's block rows it covers (its
    block columns with by_cols=True, for Aᵀ·X) and the whole of X, and
    runs `fn(blocks, x)` (of X's dtype). A product over whole block rows
    is computed once a place and sliced by the shards inside it."""
    bs = a.shape[2]
    shape = ((a.shape[1] if by_cols else a.shape[0]) * bs, x.shape[1])
    products: dict = {}

    def make(c, r):
        (r0, r1), _ = r
        br = _block_span(r0, r1, bs)
        key = (a.mesh.place(c), br)
        if key not in products:
            span = ((0, a.shape[0]), br) if by_cols else (br, (0, a.shape[1]))
            blocks = fetch(a, span + ((0, bs), (0, bs)), c, "gather")
            xf = fetch(x, _whole(x.shape), c, "gather")
            products[key] = fn(blocks, xf) if a.mesh.is_local(c) else None
        if products[key] is None:
            return None
        return products[key][r0 - br[0] * bs:r1 - br[0] * bs]

    # across processes a product is made at one of the shards that need
    # it, in turn, and the shards of other processes receive their rows
    needers: dict = {}
    for c in a.mesh.coords():
        (r0, r1), _ = region_of(shape, spec, a.mesh, c)
        needers.setdefault(_block_span(r0, r1, bs), []).append(c)
    makers = {span: cs[_turn("row_apply", len(cs))] if a.mesh.spans_processes else cs[0]
              for span, cs in needers.items()}
    return _layout(a.mesh, shape, spec, make, x.dtype,
                   source=lambda r: makers[_block_span(*r[0], bs)])


def map_regions(x: DistArray,
                fn: Callable[[torch.Tensor, Region, tuple[int, ...]],
                             torch.Tensor]) -> DistArray:
    """A new array of x's layout from `fn(shard, region, coord)`, run once
    per distinct (device, region); on one process's mesh only."""
    if x.mesh.spans_processes:
        raise NotImplementedError("map_regions runs on one process's mesh: `fn` reads "
                                  "the shard of every coordinate")
    return _layout(x.mesh, x.shape, x.spec,
                   lambda c, r: fn(x.shards[c], r, c))


# ---------------------------------------------------------------------------
# Per-coordinate programs: the reference's shard_map regions
# ---------------------------------------------------------------------------


def _the_mesh(mesh: Mesh | None) -> Mesh:
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or not mesh.axes:
        raise ValueError("a per-coordinate collective needs a mesh with axes")
    return mesh


def _check_coords(xs: dict, mesh: Mesh) -> None:
    if set(xs) != set(mesh.coords()):
        raise ValueError(f"per-coordinate values for {sorted(xs)} do not match the "
                         f"mesh's coordinates {mesh.coords()}")


def _groups(mesh: Mesh, axis) -> list[list[tuple[int, ...]]]:
    """The coordinates that a collective over `axis` joins, group by group
    (the other axes fixed), each ordered by its index along `axis`."""
    names = _names(axis)
    for a in names:
        if a not in mesh.shape:
            raise ValueError(f"mesh {mesh.descriptor()} has no axis {a!r}")
    groups: dict = {}
    for c in mesh.coords():
        key = tuple(i for i, n in zip(c, mesh.axis_names) if n not in names)
        groups.setdefault(key, []).append(c)
    return [sorted(g, key=lambda c: _position(mesh, names, c)) for g in groups.values()]


def axis_size(axis, mesh: Mesh | None = None) -> int:
    """The number of coordinates along `axis` (a name or tuple of names)."""
    return _extent(_the_mesh(mesh), axis)


def axis_index(axis, mesh: Mesh | None = None) -> dict:
    """Each coordinate's index along `axis` (row-major over a tuple)."""
    mesh = _the_mesh(mesh)
    return {c: _position(mesh, axis, c) for c in mesh.coords()}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Once:
    """Counts one call of a collective's backward over the whole mesh: the
    groups' autograd Functions share it, and the first backward books it
    (in the process that books the forward's call)."""

    __slots__ = ("kind", "done", "books", "mesh")

    def __init__(self, kind: str, books: bool, mesh: Mesh):
        self.kind, self.done, self.books, self.mesh = kind, False, books, mesh

    def backward(self) -> None:
        if (self.mesh.spans_processes and torch._C._is_multithreading_enabled()
                and any(self.mesh.device(c).type == "cuda"
                        for c in self.mesh.local_coords())):
            raise RuntimeError(
                "a backward through per-coordinate collectives of a mesh that spans "
                "processes runs under collectives.backward_context(): autograd's "
                "device threads would meet the collectives in another order in each "
                "process")
        if not self.done:
            self.done = True
            if self.books:
                _call(self.kind)


def backward_context(mesh: Mesh | None = None):
    """The context for a backward through per-coordinate collectives of
    `mesh` (default: the ambient one). Where it spans processes autograd
    runs every node in the calling thread, in the same order in every
    process (its device threads would take the nodes of this process's
    tensors and of the ghosts apart); else nothing."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is not None and mesh.spans_processes:
        return torch.autograd.set_multithreading_enabled(False)
    return contextlib.nullcontext()


def _dev(mesh: Mesh, c) -> torch.device:
    return mesh.device(c) if mesh.is_local(c) else torch.device("meta")


def _zeros_for(gs, shapes, dtypes, mesh, group):
    return [torch.zeros(s, dtype=d, device=_dev(mesh, c)) if g is None else g
            for g, s, d, c in zip(gs, shapes, dtypes, group)]


@record_function("collective:all_to_all")
def _all_to_all(xs, split_dim: int, concat_dim: int, mesh: Mesh, group) -> list:
    n = len(xs)
    for x in xs:
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does "
                             f"not split {n} ways")
    chunks = [torch.tensor_split(x, n, dim=split_dim) for x in xs]
    outs = []
    for i, ci in enumerate(group):
        parts = []
        for j, cj in enumerate(group):
            if j != i and mesh.is_local(ci):
                _count("all_to_all", _nbytes(chunks[j][i]))
            parts.append(_move(chunks[j][i], mesh, cj, ci))
        outs.append(torch.cat(parts, concat_dim))
    return outs


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, once, split_dim, concat_dim, mesh, group, *xs):
        outs = _all_to_all(xs, split_dim, concat_dim, mesh, group)
        ctx.args = (once, split_dim, concat_dim, mesh, group,
                    [o.shape for o in outs], [o.dtype for o in outs])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        once, split_dim, concat_dim, mesh, group, shapes, dtypes = ctx.args
        once.backward()
        gs = _zeros_for(gs, shapes, dtypes, mesh, group)
        with transport.exchange():
            back = _all_to_all(gs, concat_dim, split_dim, mesh, group)
        return (None, None, None, None, None, *back)


@record_function("collective:all_gather")
def _all_gather(xs, dim: int, mesh: Mesh, group) -> list:
    outs = []
    for i, ci in enumerate(group):
        if mesh.is_local(ci):
            for j, x in enumerate(xs):
                if j != i:
                    _count("all_gather", _nbytes(x))
        outs.append(torch.cat([_move(x, mesh, cj, ci) for cj, x in zip(group, xs)], dim))
    return outs


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, once, dim, mesh, group, *xs):
        ctx.args = (once, dim, mesh, group, [x.shape[dim] for x in xs])
        return tuple(_all_gather(xs, dim, mesh, group))

    @staticmethod
    @record_function("collective:all_gather")
    def backward(ctx, *gs):
        # the transpose of a tiled all-gather: a reduce-scatter
        once, dim, mesh, group, sizes = ctx.args
        once.backward()
        out, lo = [], 0
        with transport.exchange():
            for j, (cj, size) in enumerate(zip(group, sizes)):
                acc = None
                for i, (ci, g) in enumerate(zip(group, gs)):
                    if g is None:
                        continue
                    piece = g.narrow(dim, lo, size)
                    if i != j and mesh.is_local(cj):
                        _count("reduce_scatter", _nbytes(piece))
                    piece = _move(piece, mesh, ci, cj)
                    acc = piece.clone() if acc is None else acc.add_(piece)
                out.append(acc)
                lo += size
        return (None, None, None, None, *out)


def _reduce(xs, mesh: Mesh, group, kind: str):
    """Σ xs in group order, at the group's first coordinate."""
    c0 = group[0]
    total = xs[0]
    for c, x in zip(group[1:], xs[1:]):
        if mesh.is_local(c0):
            _count(kind, _nbytes(x))
        total = total + _move(x, mesh, c, c0)
    return total


def _sum_to(xs, mesh: Mesh, group, kind: str):
    """Σ xs in group order on the first coordinate, handed back to every
    coordinate (a copy each; the first keeps the sum)."""
    total = _reduce(xs, mesh, group, kind)
    outs = [total]
    for c in group[1:]:
        if mesh.is_local(c):
            _count(kind, _nbytes(total))
        outs.append(_move(total, mesh, group[0], c, copy=True))
    return outs


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, once, kind, mesh, group, *xs):
        ctx.args = (once, kind, mesh, group)
        with record_function(f"collective:{kind}"):
            return tuple(_sum_to(list(xs), mesh, group, kind))

    @staticmethod
    def backward(ctx, *gs):
        # every output is the sum of every input: each input's gradient is
        # the sum of the outputs' gradients
        once, kind, mesh, group = ctx.args
        live = [i for i, g in enumerate(gs) if g is not None]
        if not live:
            return (None, None, None, None, *([None] * len(group)))
        once.backward()
        order = [group[i] for i in live]
        out = []
        with record_function(f"collective:{kind}"), transport.exchange():
            total = _reduce([gs[i] for i in live], mesh, order, kind)
            for c in group:
                if c != order[0] and mesh.is_local(c):
                    _count(kind, _nbytes(total))
                out.append(_move(total, mesh, order[0], c))
        return (None, None, None, None, *out)


@_exchanging
def _by_group(xs: dict, axis, mesh: Mesh | None, run, kind: str,
              backward_kind: str | None = None) -> dict:
    """`run(mesh, group, tensors, once)` on each group of the collective
    over `axis`; one call of `kind` is booked when a group has more than
    one coordinate (by the process of the first such group's first
    coordinate), and `once` books one of `backward_kind` (default `kind`)
    at the first group's backward."""
    mesh = _the_mesh(mesh)
    _check_coords(xs, mesh)
    groups = _groups(mesh, axis)
    joined = [g for g in groups if len(g) > 1]
    books = bool(joined) and mesh.is_local(joined[0][0])
    once = _Once(backward_kind or kind, books, mesh)
    out = {}
    for group in groups:
        if len(group) == 1:
            out[group[0]] = xs[group[0]]
            continue
        out.update(zip(group, run(mesh, tuple(group), [xs[c] for c in group], once)))
    if books:
        _call(kind)
    return {c: out[c] for c in mesh.coords()}


def all_to_all(xs: dict, axis, split_dim: int, concat_dim: int,
               mesh: Mesh | None = None) -> dict:
    """`jax.lax.all_to_all` over `axis`: each coordinate splits its tensor
    into n chunks along `split_dim`, sends chunk i to the group's i-th
    coordinate, and concatenates what it receives along `concat_dim` in
    the senders' order."""
    return _by_group(xs, axis, mesh, lambda m, g, ts, once: _AllToAll.apply(
        once, split_dim, concat_dim, m, g, *ts), "all_to_all")


def all_gather(xs: dict, axis, dim: int, mesh: Mesh | None = None) -> dict:
    """`jax.lax.all_gather(..., tiled=True)` over `axis`: every coordinate
    gets the group's tensors concatenated along `dim`, a copy each."""
    return _by_group(xs, axis, mesh,
                     lambda m, g, ts, once: _AllGather.apply(once, dim, m, g, *ts),
                     "all_gather", "reduce_scatter")


def _sum(xs: dict, axis, mesh: Mesh | None, kind: str) -> dict:
    return _by_group(xs, axis, mesh,
                     lambda m, g, ts, once: _Psum.apply(once, kind, m, g, *ts), kind)


def psum(xs: dict, axis, mesh: Mesh | None = None) -> dict:
    """`jax.lax.psum` over `axis` (a name or tuple of names)."""
    return _sum(xs, axis, mesh, "psum")


def pmean(xs: dict, axis, mesh: Mesh | None = None) -> dict:
    """`jax.lax.pmean` over `axis`."""
    n = axis_size(axis, mesh)
    return {c: t / n for c, t in _sum(xs, axis, mesh, "pmean").items()}


def pmax(xs: dict, axis, mesh: Mesh | None = None) -> dict:
    """`jax.lax.pmax` over `axis` (no gradient: it picks a scale)."""
    def run(mesh, group, ts, once):
        c0 = group[0]
        with torch.no_grad(), record_function("collective:pmax"):
            moved = [ts[0]]
            for c, t in zip(group[1:], ts[1:]):
                if mesh.is_local(c0):
                    _count("pmax", _nbytes(t))
                moved.append(_move(t, mesh, c, c0))
            top = torch.stack(moved).amax(0)
            outs = [top]
            for c in group[1:]:
                if mesh.is_local(c):
                    _count("pmax", _nbytes(top))
                outs.append(_move(top, mesh, c0, c, copy=True))
            return outs
    return _by_group(xs, axis, mesh, run, "pmax")


def _check_spec(shape, spec, mesh: Mesh) -> None:
    if len(spec) != len(shape):
        raise ValueError(f"spec {tuple(spec)} does not match the rank of {tuple(shape)}")
    for n, ax in zip(shape, spec):
        if ax is not None and n % _extent(mesh, ax):
            raise ValueError(f"dim {n} of {tuple(shape)} does not split over "
                             f"{ax} ({_extent(mesh, ax)} ways) on {mesh.descriptor()}")


def _to_every_process(t: torch.Tensor, mesh: Mesh, c, device: torch.device
                      ) -> torch.Tensor:
    """`t`, coordinate `c`'s tensor (a ghost where `c` is another
    process's), in every process of the mesh: its process sends it to the
    others, which receive it on `device` ("replicate")."""
    owner = mesh.process(c)
    out = t
    for p in mesh.processes:
        if p == owner:
            continue
        tag = transport.next_tag()
        if mesh.is_local(c):
            transport.send(t, p, tag)
        elif p == mesh.rank:
            out = transport.recv(t.shape, t.dtype, owner, tag, device)
            _count("replicate", _nbytes(out))
            _call("replicate")
    return out


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh):
        whole = _whole(x.shape)
        regions = [region_of(x.shape, spec, mesh, c) for c in mesh.coords()]
        outs, moved = [], False
        for c, r in zip(mesh.coords(), regions):
            if not mesh.is_local(c):
                outs.append(_ghost(_sizes(r), x.dtype))
                continue
            piece, dev = x[_slices(r, whole)], mesh.device(c)
            if piece.device != dev:
                _count("reshard", _nbytes(piece))
                piece, moved = piece.to(dev), True
            outs.append(piece)
        if moved:
            _call("reshard")
        ctx.args = (x.shape, x.dtype, x.device, regions, mesh)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        # the sum of the shards' gradients, in coordinate order, in every
        # process: x is the same in every process
        shape, dtype, device, regions, mesh = ctx.args
        whole = _whole(shape)
        g = torch.zeros(shape, dtype=dtype, device=device)
        with transport.exchange():
            for c, r, gr in zip(mesh.coords(), regions, gs):
                if gr is None:
                    continue
                if mesh.spans_processes:
                    gr = _to_every_process(gr, mesh, c, device)
                g[_slices(r, whole)] += _on(gr, device)
        return g, None, None


def split(x: torch.Tensor, spec: Sequence, mesh: Mesh) -> dict:
    """Each coordinate's shard of the global `x` under `spec`, on its
    device (a view where it lies there already; a ghost where the
    coordinate is another process's). A dimension that its axes do not
    divide raises, as `shard_map` does. Differentiable: the backward sums
    the shards' gradients into one tensor of x's shape."""
    _check_spec(x.shape, spec, mesh)
    return dict(zip(mesh.coords(), _Split.apply(x, tuple(spec), mesh)))


class _Join(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, mesh, *xs):
        coords = mesh.coords()
        home = mesh.local_device()
        first = xs[0]
        shape = [n * _extent(mesh, ax) for n, ax in zip(first.shape, spec)]
        whole = _whole(shape)
        out = torch.empty(shape, dtype=first.dtype, device=home)
        seen, holders, moved = set(), [], False
        with transport.exchange():
            for c, x in zip(coords, xs):
                r = region_of(shape, spec, mesh, c)
                holders.append(r not in seen)
                if r in seen:
                    continue
                seen.add(r)
                if mesh.is_local(c) and x.device != home:
                    _count("reshard", _nbytes(x))
                    moved = True
                if mesh.spans_processes:
                    x = _to_every_process(x, mesh, c, home)
                out[_slices(r, whole)].copy_(x)
        if moved:
            _call("reshard")
        ctx.args = (spec, mesh, shape, holders)
        return out

    @staticmethod
    def backward(ctx, g):
        spec, mesh, shape, holders = ctx.args
        whole = _whole(shape)
        out = []
        for c, first in zip(mesh.coords(), holders):
            r = region_of(shape, spec, mesh, c)
            if not first:
                out.append(None)
            elif mesh.is_local(c):
                out.append(_on(g[_slices(r, whole)], mesh.device(c)))
            else:
                out.append(_ghost(_sizes(r), g.dtype))
        return (None, None, *out)


def join(xs: dict, spec: Sequence, mesh: Mesh) -> torch.Tensor:
    """The global tensor whose shards under `spec` are `xs`, on the mesh's
    home device (this process's first coordinate's), in every process; a
    region several coordinates hold is taken from the first (the
    reference's out_specs, unchecked)."""
    _check_coords(xs, mesh)
    return _Join.apply(tuple(spec), mesh, *[xs[c] for c in mesh.coords()])


def region(fn: Callable, mesh: Mesh, in_specs: Sequence, out_specs: Sequence):
    """`shard_map` for a body written over coordinates: the returned
    callable splits each argument by its spec (a tensor; a dict of tensors
    with a dict of specs; None), calls `fn` with the per-coordinate dicts,
    and joins each output by its spec."""
    def split_arg(arg, spec):
        if arg is None:
            return None
        if isinstance(arg, dict):
            return {k: split_arg(v, spec[k]) for k, v in arg.items()}
        return split(arg, spec, mesh)

    def run(*args):
        outs = fn(*[split_arg(a, s) for a, s in zip(args, in_specs)])
        return tuple(join(o, s, mesh) for o, s in zip(outs, out_specs))

    return run


# ---------------------------------------------------------------------------
# Per-coordinate programs over laid-out arrays: the partitioned step
# ---------------------------------------------------------------------------


def enter(x: DistArray, *, grad: bool = False) -> DistArray:
    """`x` entering a per-coordinate program: the same layout, each of this
    process's coordinates holding its shard as a leaf of its own (a
    detached view, requiring grad with grad=True), also where several
    coordinates share one tensor, and every other process's coordinate a
    ghost on ``meta`` that requires grad alike, so that every process
    records the same autograd graph."""
    mesh = x.mesh
    shards, ghosts = {}, {}
    for c in mesh.coords():
        if mesh.is_local(c):
            shards[c] = x.shards[c].detach().requires_grad_(grad)
        else:
            ghosts[c] = _ghost(_sizes(x.region(c)), x.dtype).requires_grad_(grad)
    return DistArray(x.shape, x.spec, mesh, shards, ghosts or None)


def per_coord(x: DistArray) -> dict:
    """Every coordinate's tensor of `x`, in coordinate order: this
    process's shards, the other processes' coordinates as ghosts (those of
    `enter`, else fresh ones)."""
    mesh = x.mesh
    out = {}
    for c in mesh.coords():
        if mesh.is_local(c):
            out[c] = x.shards[c]
        elif x.ghosts is not None:
            out[c] = x.ghosts[c]
        else:
            out[c] = _ghost(_sizes(x.region(c)), x.dtype)
    return out


def laid_out_region(fn: Callable):
    """`region` for arguments already laid out over a mesh: the returned
    callable enters every DistArray leaf of its arguments (`enter`; a
    floating leaf requires grad) and calls `fn` with the entered trees,
    whose body reads each coordinate's shard (`per_coord`). Nothing is
    split and nothing joined: it returns fn's outputs as they are, with
    the entered arguments, from which `grads` takes a scalar joined from
    the body's outputs back to each coordinate's shard."""
    from ..tree import tree_map

    def run(*args):
        entered = tuple(tree_map(lambda x: enter(x, grad=x.dtype.is_floating_point)
                                 if isinstance(x, DistArray) else x, a) for a in args)
        return fn(*entered), entered

    return run


def grads(loss: torch.Tensor, tree):
    """The gradient of the scalar `loss` (a joined output) with respect to
    every DistArray leaf of `tree` (entered with grad), as DistArrays of
    the same layouts; another leaf gets None, a shard the loss does not
    reach zeros. The backward runs under `backward_context`, every
    coordinate's leaf (ghosts too) an input. A region that several
    coordinates hold gets the sum of their gradients, each of which covers
    only its own coordinate's use: summed in coordinate order at its
    first holder, which hands the sum back to the others ("psum", one
    call a leaf)."""
    from ..tree import leaves, unflatten

    flat = leaves(tree)
    dists = [x for x in flat if isinstance(x, DistArray)]
    inputs = [t for x in dists for t in per_coord(x).values()]
    with backward_context(dists[0].mesh):
        gs = iter(torch.autograd.grad(loss, inputs, allow_unused=True))
    out = []
    for x in flat:
        if isinstance(x, DistArray):
            out.append(_sum_holders(x, {c: next(gs) for c in x.mesh.coords()}))
        else:
            out.append(None)
    return unflatten(tree, out)


@_exchanging
def _sum_holders(x: DistArray, g: dict) -> DistArray:
    """The DistArray of x's layout whose region is the sum of its
    holders' gradients `g` (None: zeros), one tensor a place."""
    mesh = x.mesh
    shards, booker = {}, None
    with torch.no_grad():
        for tile, holders in x.tiles().items():
            parts = [g[c] if g[c] is not None else
                     torch.zeros(_sizes(tile), dtype=x.dtype, device=_dev(mesh, c))
                     for c in holders]
            if len(holders) == 1:
                if mesh.is_local(holders[0]):
                    shards[holders[0]] = parts[0]
                continue
            booker = booker or holders[0]
            h0 = holders[0]
            total = _reduce(parts, mesh, holders, "psum")
            at = {mesh.place(h0): total}
            for c in holders[1:]:
                if mesh.is_local(c):
                    _count("psum", _nbytes(total))
                if mesh.place(c) not in at:
                    at[mesh.place(c)] = _move(total, mesh, h0, c, copy=True)
            for c in holders:
                if mesh.is_local(c):
                    shards[c] = at[mesh.place(c)]
    if booker is not None and mesh.is_local(booker):
        _call("psum")
    return DistArray(x.shape, x.spec, mesh, shards)


def to_spec(xs: dict, have: Sequence, want: Sequence, mesh: Mesh) -> dict:
    """Per-coordinate tensors laid out by the spec `have`, laid out by
    `want`: an axis that `have` splits one dim by last and `want` splits
    another dim by last instead moves there by one all_to_all over it;
    then every other dim that `have` splits over other axes than `want`
    is all-gathered over them (its backward the reduce-scatter), and last
    each dim that `want` splits is cut to the coordinate's part."""
    have, want = [_names(h) for h in have], [_names(w) for w in want]
    for i, h in enumerate(have):
        if h and h[:-1] == want[i]:
            j = next((j for j, w in enumerate(want) if w == have[j] + h[-1:]), None)
            if j is not None:
                xs = all_to_all(xs, h[-1], j, i, mesh)
                have[i], have[j] = want[i], want[j]
    for dim, (h, w) in enumerate(zip(have, want)):
        if h and h != w:
            xs = all_gather(xs, h, dim, mesh)
    for dim, (h, w) in enumerate(zip(have, want)):
        if w and h != w:
            n = _extent(mesh, w)
            xs = {c: t.narrow(dim, _position(mesh, w, c) * (t.shape[dim] // n),
                              t.shape[dim] // n) for c, t in xs.items()}
    return xs


@_exchanging
def region_values(xs: Sequence[DistArray], fn: Callable[[torch.Tensor, Region], torch.Tensor]
                  ) -> list[torch.Tensor]:
    """`fn(shard, region)`, a 0-dim f32 tensor, of each distinct region
    (global) of each array, in plan order (array by array, region by
    region in `tiles()` order), made once, at the region's first holder,
    and known to every process: each process sends the values its
    coordinates made to every other in one exchange ("replicate"). The
    values lie on this process's first device."""
    mesh = xs[0].mesh
    device = mesh.local_device()
    plan = [(x, r, holders[0]) for x in xs for r, holders in x.tiles().items()]
    mine = [_on(fn(x.shards[h], r), device) for x, r, h in plan if mesh.is_local(h)]
    if not mesh.spans_processes:
        return mine
    made = {p: [i for i, (_, _, h) in enumerate(plan) if mesh.process(h) == p]
            for p in mesh.processes}
    got = {mesh.rank: torch.stack(mine) if mine else None}
    for p in mesh.processes:
        for q in mesh.processes:
            if p == q or not made[p]:
                continue
            tag = transport.next_tag()
            if p == mesh.rank:
                transport.send(got[p], q, tag)
            elif q == mesh.rank:
                got[p] = transport.recv((len(made[p]),), torch.float32, p, tag, device)
                _count("replicate", _nbytes(got[p]))
                _call("replicate")
    out = [None] * len(plan)
    for p, idx in made.items():
        for j, i in enumerate(idx):
            out[i] = got[p][j]
    return out
