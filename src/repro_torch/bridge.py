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
           "sharded_from_numpy",
           "op_counts_from_dict", "port_name", "plan_from_reference",
           "lm_params_from_numpy", "lm_params_to_numpy",
           "lm_cache_from_numpy", "lm_cache_to_numpy",
           "train_state_from_numpy", "train_state_to_numpy"]

# The JAX package's names of a leaf solver or engine where the port's differ.
_PORT_NAMES = {"pallas": "cuda"}


def to_torch(x, device: str | torch.device = DEFAULT_DEVICE) -> torch.Tensor:
    """numpy (or anything `np.asarray` takes) -> torch, same bits."""
    device = resolve_device(device)
    arr = np.array(x, order="C")  # a copy; keeps 0-dim arrays 0-dim
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


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


def sharded_from_numpy(blocks, mesh=None,
                       axes: tuple[str, str] = ("data", "model"), *,
                       device: str | torch.device | None = None):
    """A (b, b, bs, bs) block array (the JAX package's BlockMatrix or
    ShardedBlockMatrix `.blocks`) -> a ShardedBlockMatrix laid out over
    `mesh` (default: the ambient mesh; without one, off the mesh on
    `device`, default the card)."""
    from .launch.mesh import current_mesh
    from .parallel.sharded_blockmatrix import ShardedBlockMatrix

    mesh = mesh if mesh is not None else current_mesh()
    if device is None:
        device = (mesh.local_device() if mesh is not None
                  else DEFAULT_DEVICE)
    bm = blockmatrix_from_numpy(blocks, device)
    return ShardedBlockMatrix.from_blockmatrix(bm, axes, mesh=mesh)


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


def lm_cache_from_numpy(cache: Mapping, device: str | torch.device = DEFAULT_DEVICE
                        ) -> dict:
    """The JAX package's decode cache as numpy (pos, k, v, ssm_h, ssm_conv,
    whichever the family has) -> the port's `decode_step` cache, same bits
    and dtypes."""
    device = resolve_device(device)
    return {k: to_torch(v, device) for k, v in cache.items()}


def lm_cache_to_numpy(cache: Mapping) -> dict:
    """The port's decode cache -> numpy arrays, same bits."""
    return {k: to_numpy(v) for k, v in cache.items()}


def _opt_from_numpy(opt, device: torch.device):
    """The JAX package's AdamWState or SpinShampooState (numpy leaves) ->
    the port's, by its fields."""
    from .optim.adamw import AdamWState
    from .optim.spin_shampoo import SpinShampooState, _Factor

    step = to_torch(opt.step, "cpu").to(torch.int32)  # the port keeps it on the host
    if "factors" not in opt._fields:
        return AdamWState(step, *(lm_params_from_numpy(getattr(opt, f), device)
                                  for f in ("master", "m", "v")))
    lists = {f: [to_torch(x, device) for x in getattr(opt, f)]
             for f in ("master", "m", "v")}
    factors = [None if f is None else _Factor(*(to_torch(x, device) for x in f))
               for f in opt.factors]
    return SpinShampooState(step, lists["master"], factors, lists["m"], lists["v"])


def train_state_from_numpy(state, device: str | torch.device = DEFAULT_DEVICE,
                           shardings=None):
    """The JAX package's TrainState as numpy (`jax.tree.map(np.asarray,
    state)`, AdamW or SPIN-Shampoo; None factors stay None) -> the port's,
    same bits; the step counters go to the host, as the port keeps them.
    With `shardings` (a TrainState of `NamedSharding`s, e.g.
    `runtime.trainer.state_shardings`, the reference's
    `_param_state_specs`) every leaf is then laid out by its own
    (`parallel.sharding.lay_out`): the laid-out state the partitioned step
    takes."""
    from .runtime.trainer import TrainState

    device = resolve_device(device)
    out = TrainState(lm_params_from_numpy(state.params, device),
                     _opt_from_numpy(state.opt, device),
                     to_torch(state.step, "cpu").to(torch.int32))
    if shardings is None:
        return out
    from .parallel.sharding import lay_out

    return lay_out(out, shardings)


def train_state_to_numpy(state):
    """The port's TrainState -> the same structure with numpy leaves, same
    bits. Its leaves come in the reference's flattening order, so
    ``jax.tree.unflatten(jax.tree.structure(ref_state),
    repro_torch.tree.leaves(out))`` builds the reference's TrainState."""
    from .tree import tree_map

    return tree_map(to_numpy, state)
