"""Sharded BlockMatrix I/O: the HDFS side of the paper's system.

The paper's matrices live in HDFS as RDD partitions; each Spark executor
reads its blocks. Here each host writes and reads only the grid rows it
owns (`host_index` / `n_hosts`). The layout on disk is the JAX package's,
bit for bit, so either package reads what the other wrote:

    <dir>/meta.json                         n, block_size, grid, dtype
    <dir>/row_<i>.npy                       one (grid, bs, bs) row of blocks

Reads can target another host count than the writes: rows are keyed by
grid index, not by writer.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .blockmatrix import BlockMatrix
from .precision import _dtype_name, torch_dtype

__all__ = ["save_blockmatrix", "load_blockmatrix", "load_meta", "RAW_VIEWS",
           "to_storable", "from_stored"]

# Dtypes numpy's .npy format cannot carry natively: stored as a raw
# integer view of the same width, reinterpreted on load from the dtype
# the reader knows (meta.json's, for a block directory).
RAW_VIEWS = {"bfloat16": (np.uint16, torch.uint16),
             "float8_e4m3fn": (np.uint8, torch.uint8)}


def to_storable(t: torch.Tensor) -> np.ndarray:
    """A tensor as the numpy array written to disk: bf16 and fp8 as their
    raw integer views, every other dtype as itself."""
    t = t.detach().cpu().contiguous()
    raw = RAW_VIEWS.get(_dtype_name(t.dtype))
    return t.view(raw[1]).numpy() if raw else t.numpy()


def from_stored(arr: np.ndarray, dtype: str,
                device: str | torch.device) -> torch.Tensor:
    """Inverse of `to_storable` for an array known to hold `dtype` (a
    name). A void array of the right width, as numpy loads a file that
    another writer saved from an ml_dtypes array, is read as the raw view."""
    raw = RAW_VIEWS.get(dtype)
    if raw is not None:
        if arr.dtype.kind == "V":
            arr = arr.view(raw[0])
        return torch.from_numpy(np.ascontiguousarray(arr)).view(
            torch_dtype(dtype)).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _rows_for(host_index: int, n_hosts: int, grid: int) -> range:
    per = (grid + n_hosts - 1) // n_hosts
    return range(host_index * per, min((host_index + 1) * per, grid))


def save_blockmatrix(directory: str, bm: BlockMatrix, *, host_index: int = 0,
                     n_hosts: int = 1) -> None:
    """Write this host's grid rows of `bm` (host 0 also writes meta.json);
    each row file is written to a temporary name, then renamed."""
    os.makedirs(directory, exist_ok=True)
    if host_index == 0:
        with open(os.path.join(directory, "meta.json"), "w") as f:
            json.dump({"n": bm.n, "block_size": bm.block_size,
                       "grid": bm.grid, "dtype": _dtype_name(bm.dtype)}, f)
    blocks = to_storable(bm.blocks)
    for i in _rows_for(host_index, n_hosts, bm.grid):
        tmp = os.path.join(directory, f"row_{i}.npy.tmp")
        with open(tmp, "wb") as f:
            np.save(f, blocks[i])
        os.replace(tmp, os.path.join(directory, f"row_{i}.npy"))


def load_meta(directory: str) -> dict:
    with open(os.path.join(directory, "meta.json")) as f:
        return json.load(f)


def load_blockmatrix(directory: str, *, host_index: int = 0,
                     n_hosts: int = 1, full: bool = True,
                     device: str | torch.device = DEFAULT_DEVICE
                     ) -> BlockMatrix:
    """Read a block directory onto `device`. full=True loads every row;
    full=False loads only this host's rows and leaves the rest zero."""
    dev = resolve_device(device)
    meta = load_meta(directory)
    grid, bs, dtype = meta["grid"], meta["block_size"], meta["dtype"]
    raw = RAW_VIEWS.get(dtype)
    rows = np.zeros((grid, grid, bs, bs), raw[0] if raw else dtype)
    wanted = range(grid) if full else _rows_for(host_index, n_hosts, grid)
    for i in wanted:
        row = np.load(os.path.join(directory, f"row_{i}.npy"))
        rows[i] = row.view(raw[0]) if raw and row.dtype.kind == "V" else row
    return BlockMatrix(from_stored(rows, dtype, dev))
