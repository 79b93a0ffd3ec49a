"""Block-matrix I/O: the PyTorch port against the JAX package.

The two packages share one on-disk layout (meta.json and one row_<i>.npy a
grid row, bf16 and fp8 as raw integer views). Files written by either are
compared byte for byte and loaded by the other bit for bit, for f32, bf16
and fp8.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat as j_compat
from repro.core import BlockMatrix as JBlockMatrix
from repro.core.matrix_io import load_blockmatrix as j_load
from repro.core.matrix_io import save_blockmatrix as j_save
from repro_torch import compat
from repro_torch.core import BlockMatrix, testing
from repro_torch.core.matrix_io import (load_blockmatrix, load_meta,
                                        save_blockmatrix)

DTYPES = ["float32", "bfloat16"] + (
    ["float8_e4m3fn"] if compat.supports_float8() and j_compat.supports_float8()
    else [])


def _bm(n: int, dtype: str, seed: int = 0) -> BlockMatrix:
    a = testing.make_spd(n, np.random.default_rng(seed), device="cpu")
    return BlockMatrix.from_dense(a.to(getattr(torch, dtype)), 32)


def _bits(x) -> np.ndarray:
    """The raw bits of a port or reference block array."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        width = {1: torch.uint8, 2: torch.uint16, 4: torch.int32}[x.element_size()]
        return x.view(width).numpy()
    arr = np.asarray(x)
    return arr.view({1: np.uint8, 2: np.uint16, 4: np.int32}[arr.itemsize])


def _tree(directory: str) -> dict[str, bytes]:
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_files_are_the_references_byte_for_byte_and_load_across(tmp_path, dtype):
    bm = _bm(128, dtype)
    jbm = JBlockMatrix(jnp.asarray(_bits(bm.blocks)).view(getattr(jnp, dtype)))
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    save_blockmatrix(port_dir, bm)
    j_save(ref_dir, jbm)
    assert _tree(port_dir) == _tree(ref_dir)
    assert load_meta(port_dir) == {"n": 128, "block_size": 32, "grid": 4,
                                   "dtype": dtype}
    # each package reads the other's files, same bits and dtype
    back = load_blockmatrix(ref_dir, device="cpu")
    assert back.dtype == bm.dtype
    assert np.array_equal(_bits(back.blocks), _bits(bm.blocks))
    jback = j_load(port_dir)
    assert jback.dtype == jnp.dtype(dtype)
    assert np.array_equal(_bits(jback.blocks), _bits(bm.blocks))


def test_multi_host_write_single_read(tmp_path):
    bm = _bm(128, "float32", seed=1)
    d = str(tmp_path)
    save_blockmatrix(d, bm, host_index=0, n_hosts=2)
    save_blockmatrix(d, bm, host_index=1, n_hosts=2)
    assert torch.equal(load_blockmatrix(d, device="cpu").blocks, bm.blocks)
    assert np.array_equal(np.asarray(j_load(d).blocks), bm.blocks.numpy())


def test_partial_read_covers_own_rows(tmp_path):
    bm = _bm(128, "bfloat16", seed=2)
    d = str(tmp_path)
    save_blockmatrix(d, bm)
    part = load_blockmatrix(d, host_index=0, n_hosts=2, full=False, device="cpu")
    assert torch.equal(part.blocks[:2], bm.blocks[:2])
    assert float(part.blocks[2:].float().abs().max()) == 0.0
    jpart = j_load(d, host_index=1, n_hosts=2, full=False)
    assert np.array_equal(_bits(jpart.blocks)[2:], _bits(bm.blocks)[2:])


def test_load_raises_without_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    save_blockmatrix(str(tmp_path), _bm(64, "float32"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        load_blockmatrix(str(tmp_path))
    assert load_blockmatrix(str(tmp_path), device="cpu").grid == 2
