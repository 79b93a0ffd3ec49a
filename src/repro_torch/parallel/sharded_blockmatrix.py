"""ShardedBlockMatrix: the mesh-resident distributed SPIN data structure.

The (b, b, bs, bs) block grid is laid out over a `Mesh` (`launch.mesh`),
one local tensor per mesh coordinate (`parallel.collectives.DistArray`),
and every producing operation (quadrant views, the multiplies and Schur
updates, subtracts, scalarMul, arrange, the leaf inversions) lays its
result out again by the divisibility rule of the JAX package:

    grid (g_r, g_c) blocks -> (data if g_r % |data| == 0 else None,
                               model if g_c % |model| == 0 else None,
                               None, None)

A level stays split over both mesh axes while its grid covers them; a
grid that no longer divides an axis is held whole along it. A single
leaf block is the only fully replicated object, and it is one block,
never the matrix. Dense solve panels split their rows over `data` by the
same rule. A replicated value is computed once per distinct device and
held once there, so a mesh that repeats one card does its leaves and its
grid-1 products once.

Every layout an operation asserts is recorded in the *spec ledger*
(`record_specs`), where the JAX package records its sharding constraints;
`assert_mesh_resident` reads it to show that no intermediate that could
stay distributed was replicated. Outside any mesh the layout has one
shard, nothing moves, and every operation is bitwise the `BlockMatrix`
path's.

The recursion (`sharded_spin_inverse`) runs Algorithm 2 with the dense
recursion's fused Schur updates (`V = A21·III − A22`, `C11 = I − III·C21`
as one op each, booked as a multiply and a subtract), so that on a 1×1
mesh the `cuda` engine runs the dense path's launches bit for bit. The
sharded solve keeps its panels split by rows over `data` between levels.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Iterator

import torch

from ..core.blockmatrix import BlockMatrix, _bump
from ..core.multiply import (current_engine, multiply_dist, multiply_engine,
                             schur_update_dist)
from ..launch.mesh import Mesh, current_mesh
from . import collectives as col
from .collectives import DistArray, grid_spec, panel_spec

__all__ = [
    "ShardedBlockMatrix", "SpecRecord", "record_specs",
    "assert_mesh_resident", "grid_spec", "panel_spec", "mesh_fingerprint",
    "sharded_spin_inverse", "sharded_spin_solve",
    "inverse_program", "solve_program",
]


# ---------------------------------------------------------------------------
# Spec ledger: the layouts the sharded ops asserted.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpecRecord:
    """One layout asserted by the sharded recursion."""

    op: str                                  # producing op ("split", ...)
    kind: str                                # "grid" (b,b,bs,bs) | "panel" (n,k)
    shape: tuple[int, ...]                   # global shape
    spec: tuple | None                       # layout, None off the mesh
    axes: tuple[str, str]                    # intended (data, model) names
    mesh_axes: tuple[tuple[str, int], ...]   # mesh shape at the op

    @property
    def grid_sharded(self) -> bool:
        """Both grid axes split over mesh axes (nothing replicated)."""
        return (self.spec is not None and self.spec[0] is not None
                and self.spec[1] is not None)


_LEDGER: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "repro_torch_spec_ledger", default=None)


@contextlib.contextmanager
def record_specs() -> Iterator[list[SpecRecord]]:
    """Collect every layout the sharded ops assert inside the block."""
    records: list[SpecRecord] = []
    token = _LEDGER.set(records)
    try:
        yield records
    finally:
        _LEDGER.reset(token)


def _record(op: str, kind: str, shape, spec, axes: tuple[str, str],
            mesh: Mesh | None) -> None:
    ledger = _LEDGER.get()
    if ledger is None:
        return
    mesh_axes = (tuple(sorted(dict(mesh.shape).items()))
                 if mesh is not None else ())
    ledger.append(SpecRecord(op=op, kind=kind, shape=tuple(shape),
                             spec=None if spec is None else tuple(spec),
                             axes=tuple(axes), mesh_axes=mesh_axes))


def assert_mesh_resident(records: list[SpecRecord],
                         min_records: int = 1) -> dict[str, int]:
    """Assert the ledger shows a mesh-resident recursion; return a tally.

    Every grid record whose grid axes divide the mesh must be split over
    both mesh axes, and every panel record whose rows divide `data` must
    be row-split. Returns {"total", "grid_sharded", "panel_sharded",
    "partial"} counts.
    """
    if len(records) < min_records:
        raise AssertionError(
            f"expected >= {min_records} layout records, got {len(records)}")
    bad = []
    tally = {"total": len(records), "grid_sharded": 0, "panel_sharded": 0,
             "partial": 0}
    for r in records:
        sizes = dict(r.mesh_axes)
        d_size = sizes.get(r.axes[0], 0)
        m_size = sizes.get(r.axes[1], 0)
        if r.kind == "grid":
            resident = r.grid_sharded
            expect = (d_size and m_size and r.shape[0] % d_size == 0
                      and r.shape[1] % m_size == 0)
            bucket = "grid_sharded"
        else:                                   # panel: rows over data only
            resident = r.spec is not None and r.spec[0] is not None
            expect = bool(d_size) and r.shape[0] % d_size == 0
            bucket = "panel_sharded"
        tally[bucket if resident else "partial"] += 1
        if expect and not resident:
            bad.append(r)
    if bad:
        raise AssertionError(
            "mesh-divisible intermediates were not grid-sharded "
            f"(replication leak): {bad[:5]}")
    return tally


def mesh_fingerprint(mesh: Mesh | None = None, *, devices: bool = False) -> str:
    """Canonical string for a mesh (default: the ambient one), e.g.
    "data2:model2" ("" = none); devices=True appends the devices, each
    after its process ("p1/cuda:0") where the mesh spans processes."""
    if mesh is None:
        mesh = current_mesh()
    if mesh is None or not mesh.axes:
        return ""
    fp = mesh.descriptor()
    if devices:
        fp += "@" + ",".join(
            f"p{mesh.process(c)}/{mesh.device(c)}" if mesh.spans_processes
            else str(mesh.device(c)) for c in mesh.coords())
    return fp


@functools.lru_cache(maxsize=None)
def _solo(device: torch.device) -> Mesh:
    return Mesh.solo(device)


def _layout_mesh(device: torch.device, mesh: Mesh | None = None) -> Mesh:
    mesh = mesh if mesh is not None else current_mesh()
    return mesh if mesh is not None else _solo(torch.device(device))


def _grid_layout(rows: int, cols: int, mesh: Mesh,
                 axes: tuple[str, str]) -> tuple:
    return grid_spec(rows, cols, mesh, axes) if mesh.axes else (None,) * 4


def _panel_layout(rows: int, mesh: Mesh, axes: tuple[str, str]) -> tuple:
    return panel_spec(rows, mesh, axes) if mesh.axes else (None, None)


def _constrain(x: DistArray, op: str, axes: tuple[str, str]) -> DistArray:
    """Lay a freshly produced grid out by the rule and record it."""
    mesh = x.mesh
    if not mesh.axes:
        _record(op, "grid", x.shape, None, axes, None)
        return x
    spec = grid_spec(x.shape[0], x.shape[1], mesh, axes)
    x = col.relayout(x, spec)
    _record(op, "grid", x.shape, spec, axes, mesh)
    return x


def _constrain_panel(x: DistArray, op: str,
                     axes: tuple[str, str]) -> DistArray:
    mesh = x.mesh
    if not mesh.axes:
        _record(op, "panel", x.shape, None, axes, None)
        return x
    spec = panel_spec(x.shape[0], mesh, axes)
    x = col.relayout(x, spec)
    _record(op, "panel", x.shape, spec, axes, mesh)
    return x


# ---------------------------------------------------------------------------
# ShardedBlockMatrix
# ---------------------------------------------------------------------------


class ShardedBlockMatrix:
    """A block grid laid out over a mesh, with the paper's method API.

    Holds the global layout (grid, block size, the spec of `grid_spec`)
    and one local tensor per mesh coordinate of this process (`shards`). The mesh is the
    ambient one when the matrix is built (`from_dense`,
    `from_blockmatrix`) and stays with the matrix: its operations run on
    its own mesh wherever they are called. Off the mesh (`mesh` None) it
    has one shard and is bitwise a BlockMatrix.
    """

    def __init__(self, dist: DistArray, axes: tuple[str, str] = ("data", "model")):
        if len(dist.shape) != 4:
            raise ValueError(f"expected a (b, b, bs, bs) grid, got {dist.shape}")
        self.dist = dist
        self.axes = tuple(axes)

    # -- shape accessors ----------------------------------------------------
    @property
    def grid(self) -> int:
        return self.dist.shape[0]

    @property
    def block_size(self) -> int:
        return self.dist.shape[2]

    @property
    def n(self) -> int:
        return self.grid * self.block_size

    @property
    def dtype(self) -> torch.dtype:
        return self.dist.dtype

    @property
    def device(self) -> torch.device:
        """The device of this process's first coordinate of the mesh."""
        return self.dist.device

    @property
    def mesh(self) -> Mesh | None:
        """The mesh the grid is laid out over (None off the mesh)."""
        return self.dist.mesh if self.dist.mesh.axes else None

    @property
    def spec(self) -> tuple | None:
        return self.dist.spec if self.dist.mesh.axes else None

    @property
    def shards(self) -> dict[tuple[int, ...], torch.Tensor]:
        """This process's coordinates' local tensors."""
        return self.dist.shards

    def _wrap(self, dist: DistArray, op: str) -> "ShardedBlockMatrix":
        return ShardedBlockMatrix(_constrain(dist, op, self.axes), self.axes)

    def constrain(self, op: str = "input") -> "ShardedBlockMatrix":
        """Re-assert this matrix's own layout (entry-point anchor)."""
        return self._wrap(self.dist, op)

    # -- conversions ----------------------------------------------------------
    @classmethod
    def from_dense(cls, dense: torch.Tensor, block_size: int,
                   axes: tuple[str, str] = ("data", "model"), *,
                   mesh: Mesh | None = None) -> "ShardedBlockMatrix":
        """Lay a dense (n, n) tensor out over `mesh` (default: the ambient
        mesh, else none)."""
        bm = BlockMatrix.from_dense(dense, block_size)
        return cls._from_blocks(bm.blocks, axes, mesh, "from_dense")

    @classmethod
    def from_blockmatrix(cls, bm: BlockMatrix,
                         axes: tuple[str, str] = ("data", "model"), *,
                         mesh: Mesh | None = None) -> "ShardedBlockMatrix":
        return cls._from_blocks(bm.blocks, axes, mesh, "from_blockmatrix")

    @classmethod
    def _from_blocks(cls, blocks: torch.Tensor, axes, mesh, op: str
                     ) -> "ShardedBlockMatrix":
        mesh = _layout_mesh(blocks.device, mesh)
        dist = col.distribute(
            blocks, _grid_layout(blocks.shape[0], blocks.shape[1], mesh,
                                 tuple(axes)), mesh)
        return cls(dist, axes).constrain(op)

    def to_blockmatrix(self, device=None) -> BlockMatrix:
        """The whole grid on `device` (default: this process's first device
        of the mesh), in every process."""
        return BlockMatrix(col.gather(self.dist, device))

    def to_dense(self, device=None) -> torch.Tensor:
        """The dense (n, n) matrix on one device: the result may be
        densified; the layout contract covers the levels in between."""
        return self.to_blockmatrix(device).to_dense()

    # -- paper methods -------------------------------------------------------
    def split(self) -> tuple["ShardedBlockMatrix", "ShardedBlockMatrix",
                             "ShardedBlockMatrix", "ShardedBlockMatrix"]:
        """breakMat + the quadrant views, each laid out by the rule."""
        b = self.grid
        if b % 2:
            raise ValueError(f"cannot split odd grid b={b}")
        h, bs = b // 2, self.block_size
        _bump("splits")
        spec = _grid_layout(h, h, self.dist.mesh, self.axes)
        out = []
        for r0, c0 in ((0, 0), (0, h), (h, 0), (h, h)):
            q = col.take(self.dist, ((r0, r0 + h), (c0, c0 + h), (0, bs),
                                     (0, bs)), spec)
            out.append(self._wrap(q, "split"))
        return tuple(out)

    @staticmethod
    def arrange(c11: "ShardedBlockMatrix", c12: "ShardedBlockMatrix",
                c21: "ShardedBlockMatrix", c22: "ShardedBlockMatrix"
                ) -> "ShardedBlockMatrix":
        """Quadrants -> matrix, laid out by the rule for the doubled grid."""
        _bump("arranges")
        h, bs, mesh = c11.grid, c11.block_size, c11.dist.mesh
        spec = _grid_layout(2 * h, 2 * h, mesh, c11.axes)
        out = col.assemble(
            [((0, 0, 0, 0), c11.dist), ((0, h, 0, 0), c12.dist),
             ((h, 0, 0, 0), c21.dist), ((h, h, 0, 0), c22.dist)],
            (2 * h, 2 * h, bs, bs), spec, mesh)
        _record("arrange", "grid", out.shape, spec if mesh.axes else None,
                c11.axes, mesh if mesh.axes else None)
        return ShardedBlockMatrix(out, c11.axes)

    def subtract(self, other: "ShardedBlockMatrix") -> "ShardedBlockMatrix":
        _bump("subtracts")
        return self._wrap(col.zip_map(torch.sub, self.dist, other.dist),
                          "subtract")

    def scalar_mul(self, scalar: float) -> "ShardedBlockMatrix":
        _bump("scalar_muls")
        return self._wrap(col.zip_map(lambda t: t * scalar, self.dist),
                          "scalar_mul")

    def neg(self) -> "ShardedBlockMatrix":
        return self.scalar_mul(-1.0)

    def _check(self, *others: "ShardedBlockMatrix") -> None:
        for o in others:
            if o.grid != self.grid or o.block_size != self.block_size:
                raise ValueError(f"grid mismatch: {self.dist.shape} vs "
                                 f"{o.dist.shape}")
            if o.dist.mesh is not self.dist.mesh:
                raise ValueError("operands lie on different meshes")

    def multiply(self, other: "ShardedBlockMatrix") -> "ShardedBlockMatrix":
        """Distributed multiply through the engine dispatch
        (`core.multiply.multiply_dist`): SUMMA, the ring, or the GEMM kernel
        on each shard's gathered panels."""
        self._check(other)
        _bump("multiplies")
        _bump("block_gemms", self.grid ** 3)
        return self._wrap(multiply_dist(self.dist, other.dist,
                                        axes=self.axes), "multiply")

    def schur_update(self, other: "ShardedBlockMatrix",
                     c: "ShardedBlockMatrix", *, negate_c: bool
                     ) -> "ShardedBlockMatrix":
        """self·other − c (negate_c=True, the paper's V) or c − self·other
        (C11): one op, booked as 1 multiply + 1 subtract. Under the `cuda`
        engine the subtract folds into the GEMM kernel on C's own shard."""
        self._check(other, c)
        _bump("multiplies")
        _bump("block_gemms", self.grid ** 3)
        _bump("subtracts")
        return self._wrap(schur_update_dist(c.dist, self.dist, other.dist,
                                            negate_c=negate_c,
                                            axes=self.axes), "schur_update")

    def leaf_inverse(self, solver: str = "linalg") -> "ShardedBlockMatrix":
        """Algorithm-2 `if` branch: invert the single block, once on each
        distinct device of the mesh."""
        from ..core.spin import LEAF_SOLVERS   # late: spin imports this layer

        if self.grid != 1:
            raise ValueError(f"leaf_inverse expects grid==1, got {self.grid}")
        if solver not in LEAF_SOLVERS:
            raise ValueError(f"unknown leaf solver {solver!r}; this package "
                             f"has {tuple(LEAF_SOLVERS)}")
        _bump("leaf_inversions")
        fn = LEAF_SOLVERS[solver]
        inv = col.once_per_device(lambda blk: fn(blk[0, 0])[None, None],
                                  [self.dist], self.dist.spec, self.dist.mesh,
                                  shape=self.dist.shape)
        return self._wrap(inv, "leaf_inverse")

    def __repr__(self) -> str:
        return (f"ShardedBlockMatrix(grid={self.grid}, bs={self.block_size}, "
                f"dtype={self.dtype}, spec={self.spec}, mesh={self.mesh})")


# ---------------------------------------------------------------------------
# The mesh-resident recursion (paper Algorithm 2)
# ---------------------------------------------------------------------------


def sharded_spin_inverse(a: ShardedBlockMatrix, leaf_solver: str = "linalg"
                         ) -> ShardedBlockMatrix:
    """Algorithm-2 recursion with every intermediate laid out on the mesh.

    The op sequence of `core.spin.spin_inverse`, fused Schur updates
    included, so the op-count oracle holds level for level.
    """
    b = a.grid
    if b & (b - 1):
        raise ValueError(f"grid must be a power of two, got {b}")
    if b == 1:
        return a.leaf_inverse(leaf_solver)

    a11, a12, a21, a22 = a.split()
    i_ = sharded_spin_inverse(a11, leaf_solver)           # I   = A11^-1
    ii = a21.multiply(i_)                                 # II  = A21 I
    iii = i_.multiply(a12)                                # III = I A12
    v = a21.schur_update(iii, a22, negate_c=True)         # V   = A21 III - A22
    vi = sharded_spin_inverse(v, leaf_solver)             # VI  = V^-1
    c12 = iii.multiply(vi)
    c21 = vi.multiply(ii)
    c11 = iii.schur_update(c21, i_, negate_c=False)       # C11 = I - III C21
    c22 = vi.neg()                                        # scalarMul(VI, -1)
    return ShardedBlockMatrix.arrange(c11, c12, c21, c22)


def _apply_blocks_sharded(a: ShardedBlockMatrix, x: DistArray) -> DistArray:
    """A·X for the sharded grid and a row-split dense panel X (one
    `solve_applies`): each row shard multiplies A's block rows by the
    gathered X, under the `cuda` engine in the GEMM kernel."""
    from ..core.solve import _apply_blocks_raw

    _bump("solve_applies")
    spec = _panel_layout(a.n, a.dist.mesh, a.axes)
    out = col.row_apply(a.dist, x, spec, _apply_blocks_raw)
    return _constrain_panel(out, "solve_apply", a.axes)


def _stack_panel_rows(x1: DistArray, x2: DistArray, op: str,
                      axes: tuple[str, str]) -> DistArray:
    """[X1; X2], laid out by the panel rule for the stacked rows."""
    mesh = x1.mesh
    rows = x1.shape[0] + x2.shape[0]
    spec = _panel_layout(rows, mesh, axes)
    out = col.assemble([((0, 0), x1), ((x1.shape[0], 0), x2)],
                       (rows, x1.shape[1]), spec, mesh)
    _record(op, "panel", out.shape, spec if mesh.axes else None, axes,
            mesh if mesh.axes else None)
    return out


def _rows(x: DistArray, lo: int, hi: int, axes) -> DistArray:
    spec = _panel_layout(hi - lo, x.mesh, axes)
    return col.take(x, ((lo, hi), (0, x.shape[1])), spec)


def _cols(x: DistArray, lo: int, hi: int) -> DistArray:
    return col.zip_map(lambda t: t[:, lo:hi], x)


def _sharded_solve(a: ShardedBlockMatrix, b: DistArray,
                   leaf_solver: str) -> DistArray:
    """The inverse-free Schur recursion of `core.solve._solve` with every
    panel split by rows over `data` between levels."""
    from ..core.solve import _leaf_solve_raw

    mesh = a.dist.mesh
    if a.grid == 1:
        _bump("leaf_solves")
        x = col.once_per_device(
            lambda blk, r: _leaf_solve_raw(blk[0, 0], r, leaf_solver),
            [a.dist, b], _panel_layout(b.shape[0], mesh, a.axes), mesh,
            shape=b.shape, dtype=b.dtype)
        return _constrain_panel(x, "leaf_solve", a.axes)

    bs = a.block_size
    a11, a12, a21, a22 = a.split()
    half = a11.n
    b1, b2 = _rows(b, 0, half, a.axes), _rows(b, half, a.n, a.axes)
    layout = _panel_layout(half, mesh, a.axes)

    # One recursive solve covers both III (= A11⁻¹A12) and Y1 (= A11⁻¹B1):
    # the B1 columns ride along; both halves are row-split alike, so the
    # column concatenation is shard by shard.
    rhs = col.zip_map(
        lambda p, q: torch.cat([p, q], dim=1),
        _constrain_panel(col.grid_to_panel(a12.dist, layout), "solve_rhs",
                         a.axes),
        _constrain_panel(b1, "solve_rhs", a.axes))
    z = _sharded_solve(a11, _constrain_panel(rhs, "solve_rhs", a.axes),
                       leaf_solver)
    iii, y1 = _cols(z, 0, half), _cols(z, half, z.shape[1])

    a22_dense = col.grid_to_panel(a22.dist, iii.spec)
    v = col.zip_map(torch.sub, _apply_blocks_sharded(a21, iii), a22_dense)
    _bump("subtracts")                                    # −Schur complement
    rhs2 = col.zip_map(torch.sub, _apply_blocks_sharded(a21, y1),
                       col.relayout(b2, y1.spec))
    _bump("subtracts")
    vgrid = ShardedBlockMatrix(
        col.panel_to_grid(v, bs, _grid_layout(a11.grid, a11.grid, mesh,
                                              a.axes)), a.axes
    ).constrain("from_dense")
    x2 = _sharded_solve(vgrid, _constrain_panel(rhs2, "solve_rhs", a.axes),
                        leaf_solver)

    _bump("solve_applies")                                # III·X2 panel GEMM
    x1 = col.zip_map(
        lambda y, t, xf: y - torch.matmul(t.float(), xf.float()).to(y.dtype),
        y1, iii, whole=(x2,))
    _bump("subtracts")
    return _stack_panel_rows(x1, x2, "solve_panel", a.axes)


def sharded_spin_solve(a: ShardedBlockMatrix, b: torch.Tensor, *,
                       leaf_solver: str = "linalg") -> torch.Tensor:
    """Solve A X = B with the mesh-resident recursion; B (n, k) or (n,).
    Returns X with b's shape, gathered onto b's device."""
    from ..core.spin import LEAF_SOLVERS

    grid = a.grid
    if grid & (grid - 1):
        raise ValueError(f"grid must be a power of two, got {grid}")
    if b.shape[0] != a.n:
        raise ValueError(f"rhs rows {b.shape[0]} != matrix dim {a.n}")
    if leaf_solver not in LEAF_SOLVERS:
        raise ValueError(f"unknown leaf solver {leaf_solver!r}; this package "
                         f"has {tuple(LEAF_SOLVERS)}")
    vector = b.ndim == 1
    rhs = b[:, None] if vector else b
    mesh = a.dist.mesh
    # every process holds b: each lays out its own coordinates' rows
    panel = col.distribute(rhs, _panel_layout(a.n, mesh, a.axes), mesh)
    x = _sharded_solve(a, _constrain_panel(panel, "solve_rhs", a.axes),
                       leaf_solver)
    out = col.gather(x, b.device if b.device.type == a.device.type
                     else a.device)
    return out[:, 0] if vector else out


# ---------------------------------------------------------------------------
# Program entry points: the recursion under an engine. PyTorch runs
# eagerly, so there is no compiled program to key on the mesh.
# ---------------------------------------------------------------------------


def _engine_ctx(engine: str | None):
    return multiply_engine(engine) if engine else contextlib.nullcontext()


def inverse_program(a: ShardedBlockMatrix, *, leaf_solver: str = "linalg",
                    engine: str | None = None) -> ShardedBlockMatrix:
    """The whole recursion under `engine` (None: the ambient engine); the
    blocks stay laid out on the matrix's mesh."""
    with _engine_ctx(engine or current_engine()):
        return sharded_spin_inverse(a.constrain("input"), leaf_solver)


def solve_program(a: ShardedBlockMatrix, b: torch.Tensor, *,
                  leaf_solver: str = "linalg",
                  engine: str | None = None) -> torch.Tensor:
    """The mesh-resident multi-RHS solve under `engine`."""
    with _engine_ctx(engine or current_engine()):
        return sharded_spin_solve(a.constrain("input"), b,
                                  leaf_solver=leaf_solver)
