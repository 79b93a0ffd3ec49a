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
change of layout) and "to_dense" (densifying a result).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Sequence

import torch

from ..core.blockmatrix import suspend_counts
from ..launch.mesh import Mesh

__all__ = ["DistArray", "Region", "grid_spec", "panel_spec", "region_of",
           "fetch", "take", "assemble", "distribute", "from_replicas", "zip_map", "once_per_device",
           "summa", "ring", "grid_to_panel", "panel_to_grid", "row_apply",
           "map_regions",
           "gather", "relayout", "collective_bytes",
           "reset_collective_bytes"]

Region = tuple[tuple[int, int], ...]          # (lo, hi) a dimension

_BYTES: dict[str, int] = {"gather": 0, "ring": 0, "reshard": 0,
                          "to_dense": 0}
_LOCK = threading.Lock()


def collective_bytes() -> dict[str, int]:
    """Bytes copied between mesh coordinates since the last reset."""
    with _LOCK:
        return dict(_BYTES)


def reset_collective_bytes() -> None:
    with _LOCK:
        for k in _BYTES:
            _BYTES[k] = 0


def _count(kind: str, nbytes: int) -> None:
    with _LOCK:
        _BYTES[kind] += nbytes


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


def region_of(shape: Sequence[int], spec: Sequence[str | None], mesh: Mesh,
              coord: tuple[int, ...]) -> Region:
    """The global region coordinate `coord` holds under `spec`."""
    out = []
    for n, ax in zip(shape, spec):
        if ax is None:
            out.append((0, n))
            continue
        size = mesh.shape[ax]
        chunk = n // size
        i = coord[mesh.axis_index(ax)]
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

    `shards` maps every mesh coordinate to its local tensor. Build one with
    `distribute`, `from_replicas`, `take` or `assemble`; the constructor
    does not check the shards against the layout.
    """

    __slots__ = ("shape", "spec", "mesh", "shards", "_tiles")

    def __init__(self, shape: Sequence[int], spec: Sequence[str | None],
                 mesh: Mesh, shards: dict[tuple[int, ...], torch.Tensor]):
        self.shape = tuple(int(s) for s in shape)
        self.spec = tuple(spec)
        self.mesh = mesh
        self.shards = shards
        self._tiles = None

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.shards.values())).dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.device(self.mesh.coords()[0])

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


def fetch(x: DistArray, region: Region, coord: tuple[int, ...], kind: str,
          out: torch.Tensor | None = None) -> torch.Tensor:
    """`region` of `x`, on coordinate `coord`'s device.

    A view of the coordinate's own shard when the region lies inside it;
    otherwise (or when `out` is given) the pieces are copied into `out` (a
    fresh buffer by default) from the holders of each piece: the
    coordinate itself, else a holder on the same device, else the first
    holder. Bytes from other coordinates are counted under `kind`.
    """
    dev = x.mesh.device(coord)
    own = x.region(coord)
    if out is None and _contains(own, region):
        return x.shards[coord][_slices(region, own)]
    if out is None:
        out = _buffer(_sizes(region), x.dtype, dev)
    for tile, holders in x.tiles().items():
        piece = _intersect(tile, region)
        if piece is None:
            continue
        if coord in holders:
            src = coord
        else:
            src = next((h for h in holders if x.mesh.device(h) == dev),
                       holders[0])
        part = x.shards[src][_slices(piece, tile)]
        out[_slices(piece, region)].copy_(part, non_blocking=True)
        if src != coord:
            _count(kind, part.numel() * part.element_size())
    return out


def _layout(mesh: Mesh, shape, spec, make) -> DistArray:
    """Build a DistArray coordinate by coordinate; `make(coord, region)`
    runs once per distinct (device, region), so replicas share a tensor."""
    shards, cache = {}, {}
    for c in mesh.coords():
        r = region_of(shape, spec, mesh, c)
        key = (mesh.device(c), r)
        if key not in cache:
            cache[key] = make(c, r)
        shards[c] = cache[key]
    return DistArray(shape, spec, mesh, shards)


def take(x: DistArray, region: Region, spec: Sequence[str | None]
         ) -> DistArray:
    """The sub-array `region` of `x`, laid out anew by `spec`."""
    offset = [lo for lo, _ in region]
    return _layout(x.mesh, _sizes(region), spec,
                   lambda c, r: fetch(x, _shift(r, offset), c, "reshard"))


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
        out = _buffer(_sizes(r), dtype, mesh.device(c), zero_fill)
        for box, off, p in boxes:
            piece = _intersect(box, r)
            if piece is not None:
                fetch(p, _shift(piece, [-o for o in off]), c, "reshard",
                      out=out[_slices(piece, r)])
        return out

    return _layout(mesh, shape, spec, make)


def distribute(t: torch.Tensor, spec: Sequence[str | None],
               mesh: Mesh) -> DistArray:
    """Lay a global tensor out over `mesh`: views of it on its own device,
    copies on the others."""
    whole = _whole(t.shape)

    def make(c, r):
        piece = t[_slices(r, whole)]
        dev = mesh.device(c)
        return piece if piece.device == dev else piece.to(dev)

    return _layout(mesh, t.shape, spec, make)


def from_replicas(full: dict[torch.device, torch.Tensor],
                  spec: Sequence[str | None], mesh: Mesh) -> DistArray:
    """Lay out a value computed whole on every distinct device: each
    coordinate views its part of its device's copy."""
    shape = next(iter(full.values())).shape
    whole = _whole(shape)
    return _layout(mesh, shape, spec,
                   lambda c, r: full[mesh.device(c)][_slices(r, whole)])


def zip_map(fn: Callable[..., torch.Tensor], *xs: DistArray,
            whole: Sequence[DistArray] = ()) -> DistArray:
    """Apply `fn` shard by shard to arrays of one layout (equal extents
    along the split dimensions); shards shared by replicas are computed
    once. Each array of `whole` is passed in full after the shards,
    gathered once a device."""
    first = xs[0]
    for x in xs[1:]:
        if x.spec != first.spec or any(
                n != m for n, m, ax in zip(x.shape, first.shape, x.spec)
                if ax is not None):
            raise ValueError(f"layouts differ: {first.shape}/{first.spec} vs "
                             f"{x.shape}/{x.spec}")
    shards, cache, fulls = {}, {}, {}
    for c in first.mesh.coords():
        dev = first.mesh.device(c)
        if whole and dev not in fulls:
            fulls[dev] = [fetch(w, _whole(w.shape), c, "gather") for w in whole]
        args = [x.shards[c] for x in xs] + fulls.get(dev, [])
        key = tuple(id(a) for a in args)
        if key not in cache:
            cache[key] = fn(*args)
        shards[c] = cache[key]
    return _rebuild(first, shards)


def _rebuild(like: DistArray, shards: dict) -> DistArray:
    # The global shape follows from a shard's shape and the layout (`fn`
    # may change the extent of a dimension the layout leaves whole).
    c0 = like.mesh.coords()[0]
    local = shards[c0].shape
    shape = []
    for n, ax in zip(local, like.spec):
        shape.append(n if ax is None else n * like.mesh.shape[ax])
    return DistArray(shape, like.spec, like.mesh, shards)


def once_per_device(fn: Callable[..., torch.Tensor], xs: Sequence[DistArray],
                    spec: Sequence[str | None], mesh: Mesh) -> DistArray:
    """Run `fn` on the whole operands once on each distinct device and lay
    the result out by `spec`: the mesh's replicated work, computed once a
    device. Op counts are booked by the first device's run only."""
    full = {}
    for i, dev in enumerate(mesh.distinct_devices):
        c = mesh.home(dev)
        args = [fetch(x, _whole(x.shape), c, "gather") for x in xs]
        with (contextlib.nullcontext() if i == 0 else suspend_counts()):
            full[dev] = fn(*args)
    return from_replicas(full, spec, mesh)


def gather(x: DistArray, device: torch.device | None = None) -> torch.Tensor:
    """The whole array as one tensor on `device` (default: the mesh's first
    device)."""
    device = x.device if device is None else torch.device(device)
    coords = x.mesh.coords()
    c = next((c for c in coords if x.mesh.device(c) == device), coords[0])
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
        if c is None:
            return local(a_panel, b_panel)
        return local(c.shards[coord], a_panel, b_panel)

    return _layout(mesh, out_shape, spec, make)


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


def ring(a: DistArray, b: DistArray, axes: tuple[str, str],
         local: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
         ) -> DistArray:
    """SUMMA with B's gather unrolled into a ring along `data`.

    A's row panels are gathered once along `model`. At step t coordinate
    (i, j) holds the k-panel of B that started at data rank (i − t) mod D,
    multiplies it against the matching k-columns of its A panel, and
    forwards it to rank i + 1: the forward is issued before the product,
    so the copy overlaps it (double buffering: the panel in use and the
    one in flight).
    """
    data_axis, model_axis = axes
    spec = (data_axis, model_axis, None, None)
    a, b = relayout(a, spec), relayout(b, spec)
    mesh = a.mesh
    n_data = mesh.shape[data_axis]
    if n_data == 1:
        return summa(a, b, axes, local)
    di = mesh.axis_index(data_axis)
    coords = mesh.coords()
    bk = b.shape[0] // n_data

    def nxt(c):
        c = list(c)
        c[di] = (c[di] + 1) % n_data
        return tuple(c)

    a_rows, acc = {}, {}
    for c in coords:
        r = a.region(c)
        a_rows[c] = fetch(a, (r[0], (0, a.shape[1])) + r[2:], c, "gather")
        br = b.region(c)
        acc[c] = torch.zeros((r[0][1] - r[0][0], br[1][1] - br[1][0])
                             + a.shape[2:], dtype=a.dtype,
                             device=mesh.device(c))
    panels = {c: b.shards[c] for c in coords}
    for t in range(n_data):
        sends = ({nxt(c): _send(panels[c], mesh.device(nxt(c)))
                  for c in coords} if t < n_data - 1 else None)
        for c in coords:
            src = (c[di] - t) % n_data
            a_cols = a_rows[c][:, src * bk:(src + 1) * bk]
            acc[c] = acc[c] + local(a_cols, panels[c])
        if sends is not None:
            panels = {c: _receive(*sends[c]) for c in coords}
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
        nb_r, nb_c = blocks.shape[0], blocks.shape[1]
        dense = blocks.permute(0, 2, 1, 3).reshape(nb_r * bs, nb_c * bs)
        return dense[r0 - br[0] * bs:r1 - br[0] * bs,
                     c0 - bc[0] * bs:c1 - bc[0] * bs]

    return _layout(g.mesh, shape, spec, make)


def panel_to_grid(p: DistArray, bs: int, spec: Sequence[str | None]
                  ) -> DistArray:
    """A dense (rows, cols) panel as its block grid, laid out by `spec`."""
    shape = (p.shape[0] // bs, p.shape[1] // bs, bs, bs)

    def make(c, r):
        (g0, g1), (h0, h1) = r[0], r[1]
        dense = fetch(p, ((g0 * bs, g1 * bs), (h0 * bs, h1 * bs)), c,
                      "reshard")
        return dense.reshape(g1 - g0, bs, h1 - h0, bs).permute(0, 2, 1, 3)

    return _layout(p.mesh, shape, spec, make)


def row_apply(a: DistArray, x: DistArray, spec: Sequence[str | None],
              fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], *,
              by_cols: bool = False) -> DistArray:
    """A·X for a block grid A and a dense panel X, laid out by `spec` (rows
    over `data`): each row shard gathers A's block rows it covers (its
    block columns with by_cols=True, for Aᵀ·X) and the whole of X, and
    runs `fn(blocks, x)`. A product over whole block rows is computed once
    a device and sliced by the shards inside it."""
    bs = a.shape[2]
    shape = ((a.shape[1] if by_cols else a.shape[0]) * bs, x.shape[1])
    products: dict = {}

    def make(c, r):
        (r0, r1), _ = r
        br = _block_span(r0, r1, bs)
        key = (a.mesh.device(c), br)
        if key not in products:
            span = ((0, a.shape[0]), br) if by_cols else (br, (0, a.shape[1]))
            blocks = fetch(a, span + ((0, bs), (0, bs)), c, "gather")
            xf = fetch(x, _whole(x.shape), c, "gather")
            products[key] = fn(blocks, xf)
        return products[key][r0 - br[0] * bs:r1 - br[0] * bs]

    return _layout(a.mesh, shape, spec, make)


def map_regions(x: DistArray,
                fn: Callable[[torch.Tensor, Region, tuple[int, ...]],
                             torch.Tensor]) -> DistArray:
    """A new array of x's layout from `fn(shard, region, coord)`, run once
    per distinct (device, region)."""
    return _layout(x.mesh, x.shape, x.spec,
                   lambda c, r: fn(x.shards[c], r, c))
