"""Checkpointing: atomic two-phase save, restore, in the reference's format.

The port of `repro.checkpoint.ckpt`, on the same files: one ``.npz`` a
checkpoint holding every leaf, keyed by its `|`-joined tree path (a dict
key as itself, a list index as its number, a NamedTuple field as
``.field``; `repro_torch.tree`), bf16 leaves as uint16 under a ``BF16:``
prefix, and a JSON sidecar with the step and extra state (the data
stream's position). A checkpoint written by either package restores in
the other into a state of the same structure.

Atomicity: write to ``<dir>/tmp.<step>/``, fsync, then rename to
``<dir>/step_<step>/``, so a crash mid-save never corrupts the latest
complete checkpoint. `async_save` copies the state to host memory first,
then writes on a background thread while training goes on.

Elastic rescale: leaves are saved whole (their logical layout; a leaf
laid out over a mesh, a DistArray, is gathered first), so
`restore(..., shardings=)` lays each one out across any mesh, of any
shape, from the same files: a pytree of `parallel.sharding.NamedSharding`
matching the template gives every leaf back as a
`parallel.collectives.DistArray` on its sharding's mesh, bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from .. import threads as _threads
from ..tree import leaves, leaves_with_path, unflatten

__all__ = ["save", "async_save", "restore", "latest_step", "list_steps"]


def _whole(leaf):
    """A leaf laid out over a mesh (a DistArray) as its whole tensor: the
    checkpoint holds the logical layout."""
    from ..parallel.collectives import DistArray, gather

    return gather(leaf) if isinstance(leaf, DistArray) else leaf


def _host(leaf) -> np.ndarray | torch.Tensor:
    """A leaf copied to host memory: a CPU tensor, or a numpy array."""
    leaf = _whole(leaf)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    out = {}
    for key, leaf in leaves_with_path(tree):
        leaf = _whole(leaf)
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            if t.dtype == torch.bfloat16:  # no numpy bf16: raw uint16 with a marker
                out["BF16:" + key] = t.contiguous().view(torch.uint16).numpy()
                continue
            out[key] = t.numpy()
        else:
            out[key] = np.asarray(leaf)
    return out


def _unflatten_into(template, blobs: dict[str, np.ndarray], on_host: bool = False):
    from ..parallel.collectives import DistArray

    vals = []
    for key, leaf in leaves_with_path(template):
        if key in blobs:
            t = torch.from_numpy(np.array(blobs[key]))
        elif "BF16:" + key in blobs:
            t = torch.from_numpy(np.array(blobs["BF16:" + key])).view(torch.bfloat16)
        else:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if isinstance(leaf, (torch.Tensor, DistArray)) and not on_host:
            t = t.to(leaf.device)
        vals.append(t)
    return unflatten(template, vals)


def save(directory: str, step: int, state, extra: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "leaves.npz"), **_flatten(state))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "extra": extra or {}}, f)
    # fsync the directory entry then atomically publish
    fd = os.open(tmp, os.O_RDONLY)
    os.fsync(fd)
    os.close(fd)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


_save_lock = threading.Lock()


def async_save(directory: str, step: int, state, extra: Optional[dict] = None
               ) -> threading.Thread:
    """Save on a background thread; join the returned thread. The state is
    copied to host memory before this returns, so the caller may update
    its tensors in place at once."""
    host = unflatten(state, [_host(leaf) for _, leaf in leaves_with_path(state)])

    def run():
        with _save_lock:
            save(directory, step, host, extra)

    return _threads.start(run, name="async-save")


def list_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                out.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, template,
            shardings=None) -> tuple[Any, dict]:
    """Restore into `template`'s structure: each leaf on its template
    leaf's device (the host for a non-tensor), at the dtype saved. With
    `shardings` (a matching pytree of NamedSharding), each leaf is laid
    out by its sharding instead: a DistArray on that mesh, whose shards
    lie on the mesh's devices (each process copies only its own
    coordinates' regions there, from the host)."""
    path = os.path.join(directory, f"step_{step}")
    with np.load(os.path.join(path, "leaves.npz"), allow_pickle=False) as f:
        blobs = dict(f)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    state = _unflatten_into(template, blobs, on_host=shardings is not None)
    if shardings is not None:
        from ..parallel.sharding import lay_out

        state = lay_out(state, shardings)
    return state, meta.get("extra", {})
