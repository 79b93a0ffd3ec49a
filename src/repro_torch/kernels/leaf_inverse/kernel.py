"""Wrappers of the leaf kernels (csrc/leaf_inverse.cu).

`leaf_inverse_cuda` replaces `leaf_inverse_pallas` and
`blocked_leaf_inverse_cuda` replaces `blocked_leaf_inverse_pallas`
(src/repro/kernels/leaf_inverse/kernel.py). Both invert a contiguous
(batch, bs, bs) stack by pivot-free Gauss-Jordan swept in f32 and write
``out_dtype`` (default: the blocks' dtype). `triangular_solve_cuda`
replaces `triangular_solve_pallas`: T X = B for triangular or packed-LU T,
swept in f32, X in b's dtype. The wrappers allocate the f32 scratch the
kernels sweep in.
"""

from __future__ import annotations

import ctypes

import torch

from .. import DTYPE_CODES, LAUNCHES, check_operand, stream_of
from ..build import check, load
from .ref import (blocked_gauss_jordan_ref, blocked_triangular_solve_ref,
                  gauss_jordan_ref)

__all__ = ["leaf_inverse_cuda", "blocked_leaf_inverse_cuda",
           "triangular_solve_cuda", "default_panel", "MAX_PANEL",
           "GJ_INPLACE_MAX_BS", "gauss_jordan_attributes"]

MAX_PANEL = 64  # kPanelMax and kTriPanelMax in csrc/leaf_inverse.cu
# kGjRegMaxBs in csrc/leaf_inverse.cu: up to this bs the scalar sweep is one
# in-place launch with no scratch; above it [A | I] sweeps in device memory.
GJ_INPLACE_MAX_BS = 208


def default_panel(bs: int, cap: int = MAX_PANEL) -> int:
    """Largest panel width ≤ cap dividing bs (power-of-two bs -> cap)."""
    t = min(bs, cap)
    while bs % t:
        t -= 1
    return t


def _check(blocks: torch.Tensor, out_dtype) -> torch.dtype:
    check_operand(blocks, "blocks", 3)
    if blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"expected (batch, bs, bs), got {tuple(blocks.shape)}")
    out_dtype = out_dtype or blocks.dtype
    if out_dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    if blocks.device.type == "cuda" and not blocks.is_contiguous():
        raise ValueError("the leaf kernels need contiguous blocks")
    return out_dtype


def leaf_inverse_cuda(blocks: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Invert (batch, bs, bs) blocks by scalar Gauss-Jordan: one in-place
    launch up to bs = GJ_INPLACE_MAX_BS, an f32 [A | I] scratch above."""
    out_dtype = _check(blocks, out_dtype)
    if blocks.device.type == "cpu":
        return gauss_jordan_ref(blocks, out_dtype)
    batch, bs, _ = blocks.shape
    scratch = None if bs <= GJ_INPLACE_MAX_BS else torch.empty(
        (batch, bs, 2 * bs), dtype=torch.float32, device=blocks.device)
    out = torch.empty(blocks.shape, dtype=out_dtype, device=blocks.device)
    with torch.cuda.device(blocks.device):
        err = load("leaf_inverse").repro_gauss_jordan(
            blocks.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), batch, bs,
            DTYPE_CODES[blocks.dtype], DTYPE_CODES[out_dtype],
            stream_of(blocks))
    check(err, "gauss_jordan kernel")
    LAUNCHES["gauss_jordan"] += 1
    return out


def gauss_jordan_attributes(bs: int) -> dict:
    """Registers a thread, static shared memory a block and spilled bytes of
    the kernel the scalar sweep launches for `bs`, as the CUDA runtime
    reports them. Needs the card's toolkit: it builds the kernels."""
    out = (ctypes.c_int * 3)()
    check(load("leaf_inverse").repro_gauss_jordan_attributes(bs, out),
          "gauss_jordan attributes")
    return {"registers": out[0], "static_smem": out[1], "local_bytes": out[2]}


def blocked_leaf_inverse_cuda(blocks: torch.Tensor, panel: int | None = None,
                              out_dtype=None) -> torch.Tensor:
    """Invert (batch, bs, bs) blocks by blocked Gauss-Jordan, panel width
    `panel` (default `default_panel(bs)`; at most 64 on the card)."""
    out_dtype = _check(blocks, out_dtype)
    batch, bs, _ = blocks.shape
    t = panel or default_panel(bs)
    if bs % t:
        raise ValueError(f"panel={t} must divide block size {bs}")
    if blocks.device.type == "cpu":
        return blocked_gauss_jordan_ref(blocks, t, out_dtype)
    if t > MAX_PANEL:
        raise ValueError(f"panel={t} exceeds the kernel's {MAX_PANEL}")
    dev = blocks.device
    m = torch.empty((batch, bs, 2 * bs), dtype=torch.float32, device=dev)
    pan = torch.empty((batch, t, 2 * bs), dtype=torch.float32, device=dev)
    fac = torch.empty((batch, bs, t), dtype=torch.float32, device=dev)
    out = torch.empty(blocks.shape, dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        err = load("leaf_inverse").repro_blocked_gauss_jordan(
            blocks.data_ptr(), out.data_ptr(), m.data_ptr(), pan.data_ptr(),
            fac.data_ptr(), batch, bs, t, DTYPE_CODES[blocks.dtype],
            DTYPE_CODES[out_dtype], stream_of(blocks))
    check(err, "blocked_gauss_jordan kernel")
    LAUNCHES["blocked_gauss_jordan"] += 1
    return out


def triangular_solve_cuda(t: torch.Tensor, b: torch.Tensor,
                          panel: int | None = None, *, lower: bool = True,
                          unit_diagonal: bool = False) -> torch.Tensor:
    """Solve T X = B for (batch, bs, bs) T and (batch, bs, k) B, panel
    width `panel` (default `default_panel(bs)`; at most 64 on the card).

    Only the targeted triangle of T is read, and under `unit_diagonal` not
    its diagonal, so a packed LU serves both sweeps. T may have any
    strides (torch.linalg.lu_factor returns it column-major); B must be
    contiguous on the card. X has b's dtype.
    """
    check_operand(t, "t", 3)
    check_operand(b, "b", 3)
    if t.shape[1] != t.shape[2]:
        raise ValueError(f"expected (batch, bs, bs), got {tuple(t.shape)}")
    if b.shape[:2] != t.shape[:2]:
        raise ValueError(f"rhs {tuple(b.shape)} incompatible with {tuple(t.shape)}")
    if t.device != b.device:
        raise ValueError("t and b lie on different devices")
    batch, bs, _ = t.shape
    k = b.shape[2]
    tp = panel or default_panel(bs)
    if bs % tp:
        raise ValueError(f"panel={tp} must divide block size {bs}")
    if b.device.type == "cpu":
        return blocked_triangular_solve_ref(t, b, tp, lower=lower,
                                            unit_diagonal=unit_diagonal)
    if tp > MAX_PANEL:
        raise ValueError(f"panel={tp} exceeds the kernel's {MAX_PANEL}")
    if not b.is_contiguous():
        raise ValueError("the triangular-solve kernel needs a contiguous b")
    out = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    f32 = b.dtype == torch.float32
    work = out if f32 else torch.empty(b.shape, dtype=torch.float32,
                                       device=b.device)
    with torch.cuda.device(b.device):
        err = load("leaf_inverse").repro_triangular_solve(
            t.data_ptr(), b.data_ptr(), work.data_ptr(),
            None if f32 else out.data_ptr(), batch, bs, k, tp, t.stride(0),
            t.stride(1), t.stride(2), int(lower), int(unit_diagonal),
            DTYPE_CODES[t.dtype], DTYPE_CODES[b.dtype], stream_of(b))
    check(err, "triangular_solve kernel")
    LAUNCHES["triangular_solve"] += 1
    return out
