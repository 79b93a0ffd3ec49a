"""Carry state between numpy (and so the JAX package) and the port.

The JAX package hands out arrays that `np.asarray` turns into numpy; these
helpers turn them into torch tensors bit for bit and back. bf16 crosses
through a ``uint16`` view, since `torch.from_numpy` does not take the
ml_dtypes bfloat16 that numpy arrays of bf16 carry.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.blockmatrix import BlockMatrix, OpCounts
from .device import DEFAULT_DEVICE, resolve_device

__all__ = ["to_torch", "to_numpy", "blockmatrix_from_numpy",
           "op_counts_from_dict", "port_name", "plan_from_reference",
           "lm_params_from_numpy", "lm_params_to_numpy"]

# The JAX package's names of a leaf solver or engine where the port's differ.
_PORT_NAMES = {"pallas": "cuda"}


def to_torch(x, device: str | torch.device = DEFAULT_DEVICE) -> torch.Tensor:
    """numpy (or anything `np.asarray` takes) -> torch, same bits."""
    device = resolve_device(device)
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy, same bits; bf16 comes back as ml_dtypes.bfloat16."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only this conversion needs it

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def blockmatrix_from_numpy(blocks, device: str | torch.device = DEFAULT_DEVICE
                           ) -> BlockMatrix:
    """A (b, b, bs, bs) block array -> BlockMatrix."""
    t = to_torch(blocks, device)
    if t.ndim != 4 or t.shape[0] != t.shape[1] or t.shape[2] != t.shape[3]:
        raise ValueError(f"expected (b, b, bs, bs) blocks, got {tuple(t.shape)}")
    return BlockMatrix(t)


def op_counts_from_dict(d: Mapping[str, int]) -> OpCounts:
    """An `OpCounts.as_dict()` record (from either package) -> OpCounts."""
    return OpCounts(**dict(d))


def port_name(name):
    """The port's name of a JAX-package leaf solver or engine ("pallas" ->
    "cuda"); other names, and None, pass through."""
    return _PORT_NAMES.get(name, name)


def plan_from_reference(d: Mapping):
    """A plan of the JAX package's planner (`Plan.to_dict()`) -> the port's
    `planner.Plan`: its Pallas leaf and engine become the port's CUDA
    ones. An engine the port does not have raises ValueError."""
    from .core.multiply import ENGINES
    from .planner import Plan

    d = dict(d)
    d["leaf_solver"] = port_name(d.get("leaf_solver"))
    engine = port_name(d.get("multiply_engine"))
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} is not ported; the port has {ENGINES}")
    d["multiply_engine"] = engine
    return Plan.from_dict(d)


def lm_params_from_numpy(tree: Mapping, device: str | torch.device = DEFAULT_DEVICE
                         ) -> dict:
    """The JAX package's LM parameter pytree, as nested dicts of numpy
    arrays (`jax.tree.map(np.asarray, params)`), -> the port's, same bits."""
    device = resolve_device(device)
    return {k: lm_params_from_numpy(v, device) if isinstance(v, Mapping)
            else to_torch(v, device) for k, v in tree.items()}


def lm_params_to_numpy(params: Mapping) -> dict:
    """The port's LM parameters -> nested dicts of numpy arrays, same bits."""
    return {k: lm_params_to_numpy(v) if isinstance(v, Mapping) else to_numpy(v)
            for k, v in params.items()}
