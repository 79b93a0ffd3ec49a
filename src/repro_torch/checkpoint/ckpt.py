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
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..tree import leaves_with_path, unflatten

__all__ = ["save", "async_save", "restore", "latest_step", "list_steps"]


def _host(leaf) -> np.ndarray | torch.Tensor:
    """A leaf copied to host memory: a CPU tensor, or a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    out = {}
    for key, leaf in leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            if t.dtype == torch.bfloat16:  # no numpy bf16: raw uint16 with a marker
                out["BF16:" + key] = t.contiguous().view(torch.uint16).numpy()
                continue
            out[key] = t.numpy()
        else:
            out[key] = np.asarray(leaf)
    return out


def _unflatten_into(template, blobs: dict[str, np.ndarray]):
    vals = []
    for key, leaf in leaves_with_path(template):
        if key in blobs:
            t = torch.from_numpy(np.array(blobs[key]))
        elif "BF16:" + key in blobs:
            t = torch.from_numpy(np.array(blobs["BF16:" + key])).view(torch.bfloat16)
        else:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if isinstance(leaf, torch.Tensor):
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

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


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


def restore(directory: str, step: int, template) -> tuple[Any, dict]:
    """Restore into `template`'s structure: each leaf on its template
    leaf's device (the host for a non-tensor), at the dtype saved."""
    path = os.path.join(directory, f"step_{step}")
    with np.load(os.path.join(path, "leaves.npz"), allow_pickle=False) as f:
        blobs = dict(f)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return _unflatten_into(template, blobs), meta.get("extra", {})
