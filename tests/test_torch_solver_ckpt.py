"""Checkpointed SPIN and service snapshots: the PyTorch port against the
JAX package.

Inversions are killed mid-recursion from the `on_op` hook and resumed by a
fresh object on the same directory: the result must equal an
uninterrupted run bit for bit. f32 node files written by either package
are replayed by the other without recomputing a node. The port stores
bf16 nodes as raw uint16 views and reads the reference's bf16 nodes, which
numpy loads as a void dtype. Snapshots and spills round-trip in both
packages' readers.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlockMatrix as JBlockMatrix
from repro.core.solver_ckpt import CheckpointedSpin as JCheckpointedSpin
from repro.core.solver_ckpt import load_service_snapshot as j_load_snapshot
from repro.core.solver_ckpt import save_service_snapshot as j_save_snapshot
from repro_torch import bridge
from repro_torch.core import (BlockMatrix, CheckpointedSpin, multiply_engine,
                              testing, verify)
from repro_torch.core.matrix_io import load_blockmatrix
from repro_torch.core.solver_ckpt import (load_matrix_spill,
                                          load_service_snapshot,
                                          save_matrix_spill,
                                          save_service_snapshot)


class _Kill(RuntimeError):
    pass


def _spd(n: int, seed: int = 0, dtype=torch.float32) -> torch.Tensor:
    a = testing.make_spd(n, np.random.default_rng([seed, n]), device="cpu")
    return a.to(dtype)


def _bomb_at(node: str):
    def hook(name: str) -> None:
        if name == node:
            raise _Kill(name)
    return hook


def _bomb_after(count: int):
    seen = {"n": 0}

    def hook(name: str) -> None:
        seen["n"] += 1
        if seen["n"] == count:
            raise _Kill(name)
    return hook


@pytest.mark.parametrize("engine", ["einsum", "cuda"])
def test_resume_after_crash_is_bit_identical(tmp_path, engine):
    a = _spd(256)
    bm = BlockMatrix.from_dense(a, 32)              # grid 8, 3 levels
    with multiply_engine(engine):
        solver = CheckpointedSpin(str(tmp_path / "run"), on_op=_bomb_after(7))
        with pytest.raises(_Kill):
            solver.inverse(bm)
        assert solver.computed_ops >= 5
        resumed = CheckpointedSpin(str(tmp_path / "run"))
        inv = resumed.inverse(bm)
        scratch = CheckpointedSpin(str(tmp_path / "scratch"))
        want = scratch.inverse(bm)
        assert resumed.loaded_ops > 0
        assert resumed.computed_ops < scratch.computed_ops
        assert torch.equal(inv.blocks, want.blocks)
        assert verify.inverse_residual(a, inv.to_dense()) < 1e-3
        replay = CheckpointedSpin(str(tmp_path / "run"))
        assert torch.equal(replay.inverse(bm).blocks, inv.blocks)
        assert replay.computed_ops == 0


def test_interrupt_at_vi_resumes_with_the_same_bits(tmp_path):
    a = _spd(256, seed=1)
    bm = BlockMatrix.from_dense(a, 32)
    solver = CheckpointedSpin(str(tmp_path / "run"), leaf_solver="cuda",
                              on_op=_bomb_at("0/VI"))
    with pytest.raises(_Kill):
        solver.inverse(bm)
    resumed = CheckpointedSpin(str(tmp_path / "run"), leaf_solver="cuda")
    inv = resumed.inverse(bm)
    want = CheckpointedSpin(str(tmp_path / "scratch"), leaf_solver="cuda").inverse(bm)
    assert resumed.loaded_ops > 0
    assert torch.equal(inv.blocks, want.blocks)


def test_inverse_matches_reference_and_node_files_cross_packages(tmp_path):
    a = _spd(256, seed=2)
    bm = BlockMatrix.from_dense(a, 32)
    jbm = JBlockMatrix.from_dense(jnp.asarray(bridge.to_numpy(a)), 32)
    port = CheckpointedSpin(str(tmp_path / "port")).inverse(bm)
    ref = JCheckpointedSpin(str(tmp_path / "ref")).inverse(jbm)
    want = bridge.to_torch(np.asarray(ref.blocks), "cpu")
    scale = float(want.abs().max())
    assert float((port.blocks - want).abs().max()) <= 1e-4 * scale
    # the port replays the reference's f32 nodes, and the reference the port's
    replay = CheckpointedSpin(str(tmp_path / "ref"))
    assert torch.equal(replay.inverse(bm).blocks, want)
    assert replay.computed_ops == 0 and replay.loaded_ops == 1
    jreplay = JCheckpointedSpin(str(tmp_path / "port"))
    assert np.array_equal(np.asarray(jreplay.inverse(jbm).blocks),
                          port.blocks.numpy())
    assert jreplay.computed_ops == 0


def test_bf16_nodes_are_raw_views_and_the_references_are_read(tmp_path):
    a = _spd(128, seed=3, dtype=torch.bfloat16)
    bm = BlockMatrix.from_dense(a, 32)
    solver = CheckpointedSpin(str(tmp_path / "port"), on_op=_bomb_after(5))
    with pytest.raises(_Kill):
        solver.inverse(bm)
    nodes = [f for f in os.listdir(tmp_path / "port") if f.endswith(".npy")]
    assert nodes
    assert all(np.load(str(tmp_path / "port" / f)).dtype == np.uint16 for f in nodes)
    inv = CheckpointedSpin(str(tmp_path / "port")).inverse(bm)
    want = CheckpointedSpin(str(tmp_path / "scratch")).inverse(bm)
    assert inv.dtype == torch.bfloat16 and torch.equal(inv.blocks, want.blocks)
    assert verify.inverse_residual(a, inv.to_dense()) < verify.residual_tolerance(
        torch.bfloat16)
    # the reference stores bf16 nodes as numpy's void dtype; the port reads them
    jbm = JBlockMatrix.from_dense(jnp.asarray(bridge.to_numpy(a)), 32)
    ref = JCheckpointedSpin(str(tmp_path / "ref")).inverse(jbm)
    assert np.load(str(tmp_path / "ref" / "0.npy")).dtype.kind == "V"
    replay = CheckpointedSpin(str(tmp_path / "ref"))
    got = replay.inverse(bm)
    assert replay.computed_ops == 0 and got.dtype == torch.bfloat16
    assert torch.equal(got.blocks, bridge.to_torch(np.asarray(ref.blocks), "cpu"))


def test_min_grid_limits_io(tmp_path):
    a = _spd(128, seed=4)
    solver = CheckpointedSpin(str(tmp_path), min_grid=8)    # top level only
    inv = solver.inverse(BlockMatrix.from_dense(a, 16))     # grid 8
    files = [f for f in os.listdir(tmp_path) if f.endswith(".npy")]
    assert 0 < len(files) <= 10
    assert verify.inverse_residual(a, inv.to_dense()) < 1e-3


# ---------------------------------------------------------------------------
# Online-service snapshots
# ---------------------------------------------------------------------------


def _snapshot_inputs():
    a = _spd(128, seed=5)
    b16 = _spd(64, seed=6, dtype=torch.bfloat16)
    meta = {"slots": 4, "matrices": {"m": {"placement": "dense"},
                                     "w": {"placement": "dense"}}}
    matrices = {"m": {"a": BlockMatrix.from_dense(a, 32),
                      "inv": BlockMatrix.from_dense(torch.linalg.inv(a), 32)},
                "w": {"a": BlockMatrix.from_dense(b16, 32)}}
    return meta, matrices


def _equal_bits(x: torch.Tensor, y) -> bool:
    y = y if isinstance(y, torch.Tensor) else bridge.to_torch(np.asarray(y), "cpu")
    return x.dtype == y.dtype and torch.equal(x, y)


def test_service_snapshot_round_trips_in_both_packages(tmp_path):
    meta, matrices = _snapshot_inputs()
    save_service_snapshot(str(tmp_path / "port"), meta=meta, matrices=matrices)
    meta2, back = load_service_snapshot(str(tmp_path / "port"), device="cpu")
    assert meta2 == meta and sorted(back) == ["m", "w"]
    for mid, named in matrices.items():
        for name, bm in named.items():
            assert _equal_bits(back[mid][name].blocks, bm.blocks)
    # the reference reads the port's snapshot, and the port the reference's
    jmeta, jback = j_load_snapshot(str(tmp_path / "port"))
    assert jmeta == meta
    assert _equal_bits(matrices["w"]["a"].blocks, jback["w"]["a"].blocks)
    jmatrices = {mid: {name: JBlockMatrix(jnp.asarray(bridge.to_numpy(bm.blocks)))
                       for name, bm in named.items()}
                 for mid, named in matrices.items()}
    j_save_snapshot(str(tmp_path / "ref"), meta=meta, matrices=jmatrices)
    meta3, back3 = load_service_snapshot(str(tmp_path / "ref"), device="cpu")
    assert meta3 == meta
    assert _equal_bits(back3["m"]["inv"].blocks, matrices["m"]["inv"].blocks)
    assert _equal_bits(back3["w"]["a"].blocks, matrices["w"]["a"].blocks)


def test_service_snapshot_rejects_bad_inputs(tmp_path):
    bm = BlockMatrix.from_dense(_spd(64, seed=7), 32)
    d = str(tmp_path)
    with pytest.raises(TypeError):
        save_service_snapshot(d, meta={}, matrices={"m": {"a": torch.zeros(4, 4)}})
    for bad in ("m__a", "m/x", "..", ""):
        with pytest.raises(ValueError):
            save_service_snapshot(d, meta={}, matrices={bad: {"a": bm}})
    with pytest.raises(ValueError):
        save_service_snapshot(d, meta={}, matrices={"m": {"a__inv": bm}})
    with pytest.raises(FileNotFoundError):                 # a torn snapshot
        load_service_snapshot(d, device="cpu")


def test_service_snapshot_version_gate(tmp_path):
    bm = BlockMatrix.from_dense(_spd(64, seed=8), 32)
    save_service_snapshot(str(tmp_path), meta={}, matrices={"m": {"a": bm}})
    path = tmp_path / "meta.json"
    payload = json.loads(path.read_text())
    payload["version"] = 999
    path.write_text(json.dumps(payload))
    with pytest.raises(ValueError):
        load_service_snapshot(str(tmp_path), device="cpu")


def test_service_snapshot_blocks_load_elastically(tmp_path):
    bm = BlockMatrix.from_dense(_spd(128, seed=9), 32)
    save_service_snapshot(str(tmp_path), meta={}, matrices={"m": {"inv": bm}})
    blocks_dir = json.loads((tmp_path / "meta.json").read_text())["blocks_dir"]
    part = load_blockmatrix(str(tmp_path / blocks_dir / "m__inv"), host_index=1,
                            n_hosts=2, full=False, device="cpu")
    assert torch.equal(part.blocks[2:], bm.blocks[2:])
    assert float(part.blocks[:2].abs().max()) == 0.0


def test_service_snapshot_overwrite_is_crash_safe(tmp_path):
    a1 = BlockMatrix.from_dense(_spd(64, seed=10), 32)
    a2 = BlockMatrix.from_dense(_spd(64, seed=11), 32)
    d = str(tmp_path)
    save_service_snapshot(d, meta={"gen": 1}, matrices={"m": {"a": a1}})
    save_service_snapshot(d, meta={"gen": 2}, matrices={"m": {"a": a2}})
    meta, back = load_service_snapshot(d, device="cpu")
    assert meta == {"gen": 2} and torch.equal(back["m"]["a"].blocks, a2.blocks)
    assert len([e for e in os.listdir(d) if e.startswith("blocks-")]) == 1


def test_matrix_spill_round_trips(tmp_path):
    meta, matrices = _snapshot_inputs()
    spill = save_matrix_spill(str(tmp_path), "m", meta=meta["matrices"]["m"],
                              pair=matrices["m"])
    assert spill == os.path.join(str(tmp_path), "m")
    got_meta, pair = load_matrix_spill(str(tmp_path), "m", device="cpu")
    assert got_meta == meta["matrices"]["m"]
    assert all(torch.equal(pair[k].blocks, matrices["m"][k].blocks) for k in pair)
    with pytest.raises(ValueError):
        save_matrix_spill(str(tmp_path), "m__x", meta={}, pair=matrices["m"])
