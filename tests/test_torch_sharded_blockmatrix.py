"""ShardedBlockMatrix in the PyTorch port, against the JAX package.

The counterparts of `tests/test_sharded_blockmatrix.py` (round trips,
split/arrange, quadrant views, the odd grid, residuals across grids and
dtypes, bitwise parity with the dense path off the mesh, the op-count
oracle, vector right-hand sides, the spec ledger off the mesh, the
divisibility rule, the off-mesh conformance sweep), then the same checks
on CPU meshes of 1×1, 2×2 and 4×2 (the JAX harness's 4dev-2x2 and
8dev-4x2 shapes), where the JAX package's own mesh tests cannot run: the
port's sharded inverse and solve are held to the JAX single-device path
on the same numpy inputs (within `residual_tolerance`, with equal op
counts), the ledger must pass `assert_mesh_resident`, and every record's
spec must be the JAX package's `grid_spec` or `panel_spec` for its shape
(those read only ``dict(mesh.shape)``, so a stand-in with a `shape` dict
stands for the mesh).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlockMatrix as JBlockMatrix
from repro.core import count_ops as j_count_ops
from repro.core import spin_inverse as j_spin_inverse
from repro.core import spin_inverse_dense as j_spin_inverse_dense
from repro.core import spin_solve as j_spin_solve
from repro.core import spin_solve_dense as j_spin_solve_dense
from repro.parallel import ShardedBlockMatrix as JSharded
from repro.parallel import grid_spec as j_grid_spec
from repro.parallel import panel_spec as j_panel_spec
from repro.parallel import record_specs as j_record_specs
from repro.parallel import sharded_spin_inverse as j_sharded_spin_inverse
from repro_torch import bridge
from repro_torch.core import (BlockMatrix, count_ops, multiply_engine,
                              spin_inverse_dense, spin_inverse_sharded,
                              spin_solve_dense, spin_solve_sharded, testing,
                              verify)
from repro_torch.launch.mesh import make_worker_mesh, set_mesh
from repro_torch.parallel import (ShardedBlockMatrix, assert_mesh_resident,
                                  collective_bytes, grid_spec, panel_spec,
                                  record_specs, reset_collective_bytes,
                                  sharded_spin_inverse, sharded_spin_solve)

GRIDS = [(2, 8), (2, 16), (4, 8), (4, 16), (8, 4)]
MESHES = [pytest.param((1, 1), id="1x1"), pytest.param((2, 2), id="4dev-2x2"),
          pytest.param((4, 2), id="8dev-4x2")]
TOL = verify.residual_tolerance(torch.float32)


def _mesh(shape):
    return make_worker_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))


class _ShapeOnly:
    """The JAX spec helpers read only ``dict(mesh.shape)``."""

    def __init__(self, shape):
        self.shape = {"data": shape[0], "model": shape[1]}


def _spd(n: int, seed: int = 0, dtype=torch.float32) -> torch.Tensor:
    return testing.make_spd(n, np.random.default_rng([seed, n]), dtype=dtype,
                            device="cpu")


def _normal(shape, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32))


def _jax(t: torch.Tensor):
    return jnp.asarray(bridge.to_numpy(t))


# ---------------------------------------------------------------- round trips


@pytest.mark.parametrize("mesh", [None, (2, 2), (4, 2)])
@pytest.mark.parametrize("b,bs", GRIDS)
def test_from_dense_roundtrip(b, bs, mesh):
    n = b * bs
    dense = _normal((n, n), b * bs)
    with set_mesh(_mesh(mesh) if mesh else None):
        sbm = ShardedBlockMatrix.from_dense(dense, bs)
        assert sbm.grid == b and sbm.block_size == bs and sbm.n == n
        assert torch.equal(sbm.to_dense(), dense)
        bm = BlockMatrix.from_dense(dense, bs)
        back = ShardedBlockMatrix.from_blockmatrix(bm).to_blockmatrix()
    assert torch.equal(back.blocks, bm.blocks)
    assert (sbm.mesh is None) == (mesh is None)


@pytest.mark.parametrize("mesh", [None, (2, 2), (4, 2)])
@pytest.mark.parametrize("b,bs", GRIDS)
def test_split_arrange_identity(b, bs, mesh):
    dense = _normal((b * bs, b * bs), b + bs)
    with set_mesh(_mesh(mesh) if mesh else None):
        sbm = ShardedBlockMatrix.from_dense(dense, bs)
        back = ShardedBlockMatrix.arrange(*sbm.split())
    assert torch.equal(back.to_dense(), dense)
    assert back.spec == sbm.spec


@pytest.mark.parametrize("mesh", [None, (2, 2), (4, 2)])
@pytest.mark.parametrize("b,bs", GRIDS)
def test_quadrant_views_match_dense_slices(b, bs, mesh):
    n = b * bs
    h = n // 2
    dense = _normal((n, n), 3 * b + bs)
    with set_mesh(_mesh(mesh) if mesh else None):
        q = ShardedBlockMatrix.from_dense(dense, bs).split()
    slices = [(slice(0, h), slice(0, h)), (slice(0, h), slice(h, None)),
              (slice(h, None), slice(0, h)), (slice(h, None), slice(h, None))]
    for quad, (r, c) in zip(q, slices):
        assert torch.equal(quad.to_dense(), dense[r, c])


def test_split_odd_grid_raises():
    sbm = ShardedBlockMatrix.from_dense(torch.eye(48), 16)    # grid 3
    with pytest.raises(ValueError):
        sbm.split()


def test_axes_are_kept_and_name_the_layout():
    # The counterpart of the reference's pytree round trip: the axes ride
    # every op, and axes a mesh does not have leave the grid whole.
    sbm = ShardedBlockMatrix.from_dense(torch.eye(16), 4, axes=("x", "y"))
    out = sbm.scalar_mul(2.0)
    assert out.axes == ("x", "y")
    assert torch.equal(out.to_dense(), 2 * torch.eye(16))
    with set_mesh(_mesh((2, 2))):
        other = ShardedBlockMatrix.from_dense(torch.eye(16), 4,
                                              axes=("x", "y"))
        named = ShardedBlockMatrix.from_dense(torch.eye(16), 4)
    assert other.spec == (None, None, None, None)
    assert named.spec == ("data", "model", None, None)


# ------------------------------------------------ residuals / parity off mesh


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,bs", [(2, 16), (4, 16), (8, 8)])
def test_sharded_inverse_residual_across_grids_dtypes(b, bs, dtype):
    a = _spd(b * bs, 1, dtype)
    inv = sharded_spin_inverse(ShardedBlockMatrix.from_dense(a, bs))
    assert verify.inverse_residual(a, inv.to_dense()) < \
        verify.residual_tolerance(dtype)


@pytest.mark.parametrize("engine", ["einsum", "cuda", "allgather", "ring"])
@pytest.mark.parametrize("b,bs", [(2, 32), (4, 16)])
def test_sharded_matches_dense_bitwise_off_mesh(b, bs, engine):
    """Without a mesh the layout has one shard and the op sequence is the
    dense recursion's: the results agree bit for bit."""
    n = b * bs
    a = _spd(n, 2)
    rhs = _normal((n, 3), 3)
    for leaf in ("linalg", "cuda"):
        assert torch.equal(
            spin_inverse_sharded(a, bs, leaf_solver=leaf, engine=engine,
                                 device="cpu"),
            spin_inverse_dense(a, bs, leaf, engine=engine, device="cpu"))
        assert torch.equal(
            spin_solve_sharded(a, rhs, bs, leaf_solver=leaf, engine=engine,
                               device="cpu"),
            spin_solve_dense(a, rhs, bs, leaf, engine=engine, device="cpu"))


@pytest.mark.parametrize("mesh", [None, (1, 1), (2, 2), (4, 2)])
def test_sharded_op_counts_match_paper_oracle(mesh):
    """The sharded recursion bumps the counters once a logical op, however
    many shards run it: the Algorithm-2 oracle holds on every mesh."""
    grid, bs = 8, 8
    a = _spd(grid * bs, 4)
    with set_mesh(_mesh(mesh) if mesh else None):
        with count_ops() as counts:
            sharded_spin_inverse(ShardedBlockMatrix.from_dense(a, bs))
    verify.assert_paper_op_counts(grid, counts)
    assert counts.as_dict() == verify.expected_spin_counts(grid).as_dict()


def test_sharded_solve_vector_rhs_and_validation():
    n, bs = 64, 16
    a = ShardedBlockMatrix.from_dense(_spd(n, 5), bs)
    rhs = _normal((n,), 6)
    x = sharded_spin_solve(a, rhs)
    assert x.shape == (n,)
    assert float(torch.linalg.norm(a.to_dense() @ x - rhs)
                 / torch.linalg.norm(rhs)) < 1e-4
    with pytest.raises(ValueError):
        sharded_spin_solve(a, torch.ones(n + 1, 2))     # rhs rows mismatch
    with pytest.raises(ValueError):
        sharded_spin_solve(a, torch.ones(n, 2), leaf_solver="pallas")
    odd = ShardedBlockMatrix.from_dense(_spd(48, 7), 16)  # grid 3
    with pytest.raises(ValueError):
        sharded_spin_inverse(odd)


# ---------------------------------------------------------------- spec ledger


def test_ledger_records_skipped_constraints_off_mesh():
    a = _spd(64, 8)
    with record_specs() as recs:
        sharded_spin_inverse(ShardedBlockMatrix.from_dense(a, 16))
    assert recs and all(r.spec is None for r in recs)   # no ambient mesh
    ops = {r.op for r in recs}
    assert {"split", "multiply", "schur_update", "scalar_mul",
            "leaf_inverse", "arrange"} <= ops
    # Where the reference records a multiply and then a subtract for a Schur
    # update (V, C11), the port records one fused op: op for op, the two
    # ledgers hold the same layouts.
    with j_record_specs() as jrecs:
        j_sharded_spin_inverse(JSharded.from_dense(_jax(a), 16))

    def tally(rs):
        out = {}
        for r in rs:
            out[r.op] = out.get(r.op, 0) + 1
        return out

    port, ref = tally(recs), tally(jrecs)
    assert port["multiply"] + port["schur_update"] == ref["multiply"]
    assert port["schur_update"] == ref["subtract"]
    for op in ("split", "scalar_mul", "leaf_inverse", "arrange",
               "from_dense"):
        assert port[op] == ref[op], op
    assert {r.shape for r in recs if r.kind == "grid"} == \
        {r.shape for r in jrecs}


@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (1, 1), (2, 4), (8, 1)])
def test_grid_and_panel_specs_are_divisibility_aware(shape):
    fake = _ShapeOnly(shape)
    for rows in (1, 2, 3, 4, 8, 16):
        for cols in (1, 2, 4, 8):
            assert grid_spec(rows, cols, fake) == \
                tuple(j_grid_spec(rows, cols, fake))
        assert panel_spec(rows * 16, fake) == tuple(j_panel_spec(rows * 16,
                                                                 fake))
    if shape == (4, 2):
        assert grid_spec(8, 8, fake) == ("data", "model", None, None)
        assert grid_spec(2, 8, fake) == (None, "model", None, None)
        assert grid_spec(1, 1, fake) == (None, None, None, None)
        assert panel_spec(64, fake) == ("data", None)
        assert panel_spec(2, fake) == (None, None)


def test_conformance_sweep_sharded_off_mesh_parity_is_exact():
    """sharded=True without a mesh: parity_vs_dense is exactly 0 (the same
    op sequence), and every report green."""
    reports = verify.run_conformance(grids=(2, 4), block_size=16,
                                     sharded=True, device="cpu")
    assert all(r.ok for r in reports), [r.as_dict() for r in reports
                                        if not r.ok]
    assert all(r.path == "sharded" for r in reports)
    assert all(r.parity_vs_dense == 0.0 for r in reports)


# ------------------------------------------------------------------ on meshes


def _assert_ledger_is_the_reference(recs, shape):
    fake = _ShapeOnly(shape)
    assert recs
    for r in recs:
        assert r.mesh_axes == tuple(sorted(fake.shape.items())), r
        if r.kind == "grid":
            assert r.spec == tuple(j_grid_spec(r.shape[0], r.shape[1], fake)), r
        else:
            assert r.spec == tuple(j_panel_spec(r.shape[0], fake)), r
    return assert_mesh_resident(recs)


@pytest.mark.parametrize("engine", ["einsum", "allgather", "ring", "cuda"])
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_inverse_on_mesh_matches_the_reference(shape, engine):
    n, bs = 128, 16
    grid = n // bs
    a = _spd(n, 9)
    ref = np.asarray(j_spin_inverse_dense(_jax(a), bs))
    with j_count_ops() as jcounts:
        j_spin_inverse(JBlockMatrix.from_dense(_jax(a), bs))
    reset_collective_bytes()
    with set_mesh(_mesh(shape)), record_specs() as recs, \
            count_ops() as counts:
        x = spin_inverse_sharded(a, bs, engine=engine)
    assert verify.inverse_residual(a, x) < TOL
    assert float(np.abs(x.numpy() - ref).max()) < TOL
    assert counts.as_dict() == bridge.op_counts_from_dict(
        jcounts.as_dict()).as_dict() == \
        verify.expected_spin_counts(grid).as_dict()
    tally = _assert_ledger_is_the_reference(recs, shape)
    assert tally["grid_sharded"] > 0
    moved = collective_bytes()
    if shape == (1, 1):
        assert sum(moved.values()) == 0          # nothing crosses a 1×1 mesh
    else:
        assert moved["gather"] + moved["ring"] > 0
        assert (moved["ring"] > 0) == (engine == "ring")


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_solve_on_mesh_matches_the_reference(shape):
    n, bs = 128, 16
    a, rhs = _spd(n, 10), _normal((n, 4), 11)
    ref = np.asarray(j_spin_solve_dense(_jax(a), _jax(rhs), bs))
    with j_count_ops() as jcounts:
        j_spin_solve(JBlockMatrix.from_dense(_jax(a), bs), _jax(rhs))
    for leaf in ("linalg", "cuda"):
        with set_mesh(_mesh(shape)), record_specs() as recs, \
                count_ops() as counts, multiply_engine("cuda"):
            x = spin_solve_sharded(a, rhs, bs, leaf_solver=leaf)
        assert verify.solve_residual(a, x, rhs) < TOL
        assert float(np.abs(x.numpy() - ref).max()) < TOL * float(
            np.abs(ref).max())
        assert counts.as_dict() == bridge.op_counts_from_dict(
            jcounts.as_dict()).as_dict()
        tally = _assert_ledger_is_the_reference(recs, shape)
        assert tally["panel_sharded"] > 0


@pytest.mark.parametrize("shape", [pytest.param((2, 2), id="4dev-2x2"),
                                   pytest.param((4, 2), id="8dev-4x2")])
def test_sharded_conformance_sweep_on_mesh(shape):
    with set_mesh(_mesh(shape)):
        reports = verify.run_conformance(grids=(2, 4, 8), block_size=16,
                                         sharded=True)
    assert len(reports) == 12
    assert not [r for r in reports if not r.ok]
    for r in reports:
        assert r.path == "sharded" and r.op_counts_ok
        assert r.parity_vs_dense is not None and r.parity_vs_dense < r.tolerance


def test_shards_follow_the_layout_and_replicas_are_held_once():
    n, bs = 64, 8
    with set_mesh(_mesh((2, 2))):
        sbm = ShardedBlockMatrix.from_dense(_spd(n, 12), bs)
        leaf = ShardedBlockMatrix.from_dense(_spd(bs, 13), bs)   # grid 1
    assert sbm.spec == ("data", "model", None, None)
    for (i, j), t in sbm.shards.items():
        assert tuple(t.shape) == (4, 4, bs, bs)
        assert torch.equal(t, sbm.to_blockmatrix().blocks[4 * i:4 * i + 4,
                                                          4 * j:4 * j + 4])
    # a replicated value lies once on the one device of this mesh
    assert leaf.spec == (None, None, None, None)
    assert len({id(t) for t in leaf.shards.values()}) == 1
    inv = leaf.leaf_inverse("linalg")
    assert len({id(t) for t in inv.shards.values()}) == 1
