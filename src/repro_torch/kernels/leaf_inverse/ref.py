"""Plain PyTorch versions of the Gauss-Jordan leaf-inverse kernels.

`gauss_jordan_ref` and `blocked_gauss_jordan_ref` are step-exact: the same
pivot-free sweeps in the same order of operations as the kernels, so a
difference between a kernel and its plain version is a kernel fault, and
a difference from `leaf_inverse_ref` is the error of unpivoted
Gauss-Jordan itself.
"""

from __future__ import annotations

import torch

__all__ = ["leaf_inverse_ref", "gauss_jordan_ref", "blocked_gauss_jordan_ref"]


def leaf_inverse_ref(blocks: torch.Tensor) -> torch.Tensor:
    """LAPACK-semantics oracle: batched torch.linalg.inv in f32."""
    return torch.linalg.inv(blocks.float()).to(blocks.dtype)


def _augmented(blocks: torch.Tensor) -> torch.Tensor:
    batch, bs, _ = blocks.shape
    eye = torch.eye(bs, dtype=torch.float32, device=blocks.device)
    return torch.cat([blocks.float(), eye.expand(batch, bs, bs)], dim=2)


def _sweep(m: torch.Tensor, j: int, col: int) -> torch.Tensor:
    """One pivot-free step on rows `m`: pivot row j, pivot column col."""
    row = m[:, j, :] / m[:, j, col:col + 1]
    fac = m[:, :, col].clone()
    fac[:, j] = 0.0
    m = m - fac[:, :, None] * row[:, None, :]
    m[:, j, :] = row
    return m


def gauss_jordan_ref(blocks: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Scalar pivot-free Gauss-Jordan on [A | I], one column a step."""
    bs = blocks.shape[1]
    m = _augmented(blocks)
    for k in range(bs):
        m = _sweep(m, k, k)
    return m[:, :, bs:].to(out_dtype or blocks.dtype)


def blocked_gauss_jordan_ref(blocks: torch.Tensor, panel: int,
                             out_dtype=None) -> torch.Tensor:
    """Blocked pivot-free Gauss-Jordan: a t-step mini-sweep inside each
    t-row panel, then one rank-t update of every other row."""
    bs = blocks.shape[1]
    t = panel
    m = _augmented(blocks)
    for base in range(0, bs, t):
        pan = m[:, base:base + t, :]
        for j in range(t):
            pan = _sweep(pan, j, base + j)
        factors = m[:, :, base:base + t].clone()
        factors[:, base:base + t, :] = 0.0
        m = m - factors @ pan
        m[:, base:base + t, :] = pan
    return m[:, :, bs:].to(out_dtype or blocks.dtype)
