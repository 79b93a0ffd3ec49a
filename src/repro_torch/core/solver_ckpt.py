"""Checkpointed SPIN: fault-tolerant execution of Algorithm 2.

Spark gets fault tolerance from RDD lineage: a lost executor recomputes
only its partitions. PyTorch has no lineage, so for long inversions the
recursion runs as an explicit DAG of named intermediates (``0/I``,
``0/II``, …, ``0/I/V`` …) and each completed node is written to disk. On
restart, completed nodes load from disk and the computation resumes at the
first missing one: the unit of recomputation is one block-matrix op.

``min_grid`` stops checkpointing below a grid size: deep levels are cheap
to recompute, and persisting them would be all I/O. Node files are .npy
arrays of the (grid, grid, bs, bs) blocks, f32 in the JAX package's
layout; bf16 and fp8 nodes are stored as their raw integer views
(`matrix_io.RAW_VIEWS`) and read back at the dtype of the matrix being
inverted.

The module also holds the online service's snapshot format
(`save_service_snapshot` / `load_service_snapshot`): one meta.json plus a
`matrix_io` block directory per (matrix, role) pair, and the per-matrix
spills built on it.
"""

from __future__ import annotations

import json
import os
import shutil
import uuid
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from .blockmatrix import BlockMatrix
from .matrix_io import (from_stored, load_blockmatrix, save_blockmatrix,
                        to_storable)
from .multiply import multiply
from .precision import _dtype_name
from .spin import leaf_inverse

__all__ = ["CheckpointedSpin", "save_service_snapshot",
           "load_service_snapshot", "validate_snapshot_key",
           "save_matrix_spill", "load_matrix_spill"]


class CheckpointedSpin:
    """Algorithm 2 with every node of grid ≥ `min_grid` persisted in
    `ckpt_dir`. Products run through the ambient multiply engine on the
    device of the matrix; `on_op(name)` is called before each node is
    computed (a hook for progress and for injected faults).
    `loaded_ops` and `computed_ops` count the nodes read and computed."""

    def __init__(self, ckpt_dir: str, *, leaf_solver: str = "linalg",
                 min_grid: int = 2,
                 on_op: Optional[Callable[[str], None]] = None):
        self.dir = ckpt_dir
        self.leaf_solver = leaf_solver
        self.min_grid = min_grid
        self.on_op = on_op or (lambda name: None)
        self.loaded_ops = 0
        self.computed_ops = 0
        os.makedirs(ckpt_dir, exist_ok=True)

    # -- persistence --------------------------------------------------------
    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name.replace("/", "_") + ".npy")

    def _have(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    def _load(self, name: str, like: BlockMatrix) -> BlockMatrix:
        self.loaded_ops += 1
        arr = np.load(self._path(name))
        return BlockMatrix(from_stored(arr, _dtype_name(like.dtype), like.device))

    def _store(self, name: str, value: BlockMatrix) -> BlockMatrix:
        tmp = self._path(name) + ".tmp"
        with open(tmp, "wb") as f:               # atomic: write, then rename
            np.save(f, to_storable(value.blocks))
        os.replace(tmp, self._path(name))
        return value

    def _memo(self, name: str, thunk: Callable[[], BlockMatrix], grid: int,
              like: BlockMatrix) -> BlockMatrix:
        if grid >= self.min_grid and self._have(name):
            return self._load(name, like)
        self.on_op(name)
        value = thunk()
        self.computed_ops += 1
        if grid >= self.min_grid:
            self._store(name, value)
        return value

    # -- the recursion (paper Algorithm 2, nodes named by DAG path) ----------
    def inverse(self, a: BlockMatrix, path: str = "0") -> BlockMatrix:
        g = a.grid
        if g >= self.min_grid and self._have(path):
            return self._load(path, a)
        if g == 1:
            return self._memo(path, lambda: leaf_inverse(
                a, solver=self.leaf_solver), g, a)

        a11, a12, a21, a22 = a.split()

        def memo(name: str, thunk: Callable[[], BlockMatrix]) -> BlockMatrix:
            return self._memo(path + name, thunk, g, a)

        i_ = self.inverse(a11, path + "/I")
        ii = memo("/II", lambda: multiply(a21, i_))
        iii = memo("/III", lambda: multiply(i_, a12))
        iv = memo("/IV", lambda: multiply(a21, iii))
        v = memo("/V", lambda: BlockMatrix(iv.blocks - a22.blocks))
        vi = self.inverse(v, path + "/VI")
        c12 = memo("/C12", lambda: multiply(iii, vi))
        c21 = memo("/C21", lambda: multiply(vi, ii))
        vii = memo("/VII", lambda: multiply(iii, c21))
        c11 = memo("/C11", lambda: BlockMatrix(i_.blocks - vii.blocks))
        c22 = BlockMatrix(-vi.blocks)
        c = BlockMatrix.arrange(c11, c12, c21, c22)
        return self._memo(path, lambda: c, g, a)


# ---------------------------------------------------------------------------
# Online-service snapshots
# ---------------------------------------------------------------------------

_SNAPSHOT_VERSION = 1


def validate_snapshot_key(key: str) -> None:
    """Reject ids that would collide or escape in `<mid>__<name>` dirs.

    The block directory name is the plain join of matrix id and role, so
    ids containing the separator would collide ("m__a"/"inv" against
    "m"/"a__inv") and path characters would nest or escape the snapshot
    directory.
    """
    if (not key or "__" in key or "/" in key or "\\" in key
            or os.sep in key or key in (".", "..")):
        raise ValueError(
            f"snapshot key {key!r} must be non-empty and contain no "
            "'__', path separators, or dot-dirs")


def save_service_snapshot(directory: str, *, meta: dict,
                          matrices: dict[str, dict[str, BlockMatrix]]
                          ) -> None:
    """Persist service state: `meta` (JSON-serializable) and named block
    matrices per matrix id (e.g. {"ridge": {"a": bm, "inv": bm}}).

    Safe under re-snapshotting into the same directory: every save writes
    its blocks into a fresh subdirectory (``blocks-<nonce>/<mid>__<name>``,
    through `matrix_io.save_blockmatrix`), then atomically swings
    meta.json to it, then removes older block directories. A crash at any
    point leaves meta.json naming a complete snapshot.
    """
    os.makedirs(directory, exist_ok=True)
    nonce = f"blocks-{uuid.uuid4().hex[:12]}"
    arrays: dict[str, list[str]] = {}
    for mid, named in matrices.items():
        validate_snapshot_key(mid)
        arrays[mid] = sorted(named)
        for name, bm in named.items():
            validate_snapshot_key(name)
            if not isinstance(bm, BlockMatrix):
                raise TypeError(
                    f"snapshot matrix {mid!r}/{name!r} must be a "
                    f"BlockMatrix, got {type(bm).__name__}")
            save_blockmatrix(
                os.path.join(directory, nonce, f"{mid}__{name}"), bm)
    payload = {"version": _SNAPSHOT_VERSION, "meta": meta, "arrays": arrays,
               "blocks_dir": nonce}
    tmp = os.path.join(directory, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, os.path.join(directory, "meta.json"))
    for entry in os.listdir(directory):         # remove superseded snapshots
        if entry.startswith("blocks-") and entry != nonce:
            shutil.rmtree(os.path.join(directory, entry), ignore_errors=True)


def load_service_snapshot(directory: str, *,
                          device: str | torch.device = DEFAULT_DEVICE
                          ) -> tuple[dict, dict[str, dict[str, BlockMatrix]]]:
    """Inverse of `save_service_snapshot`: (meta, {mid: {name: bm}}), the
    blocks on `device`."""
    with open(os.path.join(directory, "meta.json")) as f:
        payload = json.load(f)
    if payload.get("version") != _SNAPSHOT_VERSION:
        raise ValueError(f"service snapshot version {payload.get('version')} "
                         f"!= {_SNAPSHOT_VERSION}")
    bdir = os.path.join(directory, payload["blocks_dir"])
    matrices = {
        mid: {name: load_blockmatrix(os.path.join(bdir, f"{mid}__{name}"),
                                     device=device)
              for name in names}
        for mid, names in payload["arrays"].items()}
    return payload["meta"], matrices


def save_matrix_spill(directory: str, matrix_id: str, *, meta: dict,
                      pair: dict[str, BlockMatrix]) -> str:
    """Persist ONE matrix's serving state (a residency eviction) as a
    single-matrix service snapshot under ``directory/<matrix_id>``;
    returns that directory."""
    validate_snapshot_key(matrix_id)
    spill_dir = os.path.join(directory, matrix_id)
    save_service_snapshot(spill_dir, meta={"matrices": {matrix_id: meta}},
                          matrices={matrix_id: pair})
    return spill_dir


def load_matrix_spill(directory: str, matrix_id: str, *,
                      device: str | torch.device = DEFAULT_DEVICE
                      ) -> tuple[dict, dict[str, BlockMatrix]]:
    """Inverse of `save_matrix_spill`: (per-matrix meta, {name: bm})."""
    meta, matrices = load_service_snapshot(os.path.join(directory, matrix_id),
                                           device=device)
    return meta["matrices"][matrix_id], matrices[matrix_id]
