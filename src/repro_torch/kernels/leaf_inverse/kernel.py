"""Wrappers of the leaf kernels (csrc/leaf_inverse.cu).

`leaf_inverse_cuda` replaces `leaf_inverse_pallas` and
`blocked_leaf_inverse_cuda` replaces `blocked_leaf_inverse_pallas`
(src/repro/kernels/leaf_inverse/kernel.py). Both invert a contiguous
(batch, bs, bs) stack by pivot-free Gauss-Jordan swept in f32 and write
``out_dtype`` (default: the blocks' dtype). The blocked one works in place
on bs x bs: per panel a small launch inverts the pivot block and packs
W and Rᵀ, then M += W·R runs on the tensor cores (3xTF32).
`triangular_solve_cuda` replaces `triangular_solve_pallas`: T X = B for
triangular or packed-LU T, in f32, X in b's dtype. It inverts the diagonal
blocks first, packs P = [-D_p⁻¹·T[p, <p] | D_p⁻¹] and Bᵀ, and then each
panel is one 3xTF32 product X_p = P[p, :base+t]·[X; B_p]; a block owns
`tri_strip` right-hand-side columns. The wrappers allocate the scratch
the kernels work in.
"""

from __future__ import annotations

import ctypes

import torch

from .. import DTYPE_CODES, LAUNCHES, check_operand, sm_count, stream_of
from ..build import check, load
from .ref import (blocked_gauss_jordan_ref, blocked_triangular_solve_ref,
                  gauss_jordan_ref)

__all__ = ["leaf_inverse_cuda", "blocked_leaf_inverse_cuda",
           "triangular_solve_cuda", "default_panel", "MAX_PANEL",
           "GJ_INPLACE_MAX_BS", "gauss_jordan_attributes", "tri_strip",
           "TRI_STRIPS", "blocked_attributes"]

MAX_PANEL = 64  # kPanelMax in csrc/leaf_inverse.cu
# kGjRegMaxBs in csrc/leaf_inverse.cu: up to this bs the scalar sweep is one
# in-place launch with no scratch; above it [A | I] sweeps in device memory.
GJ_INPLACE_MAX_BS = 208
# Right-hand-side columns a block of the triangular solve may own: the
# widths of wgmma m64nNk8 the kernel is built for, widest first.
TRI_STRIPS = (64, 32, 16, 8)
_PLANE_ALIGN = 4  # f32 a 16-byte TMA granule: row stride of packed planes


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
    out = torch.empty(blocks.shape, dtype=out_dtype, device=dev)
    # The f32 working copy is the output itself when that is f32.
    m = out if out_dtype == torch.float32 else torch.empty(
        blocks.shape, dtype=torch.float32, device=dev)
    # W and Rᵀ, each (batch, 2, bs, ld): TF32 hi and lo planes.
    w = torch.empty(4 * batch * bs * _plane_ld(t), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = load("leaf_inverse").repro_blocked_gauss_jordan(
            blocks.data_ptr(), out.data_ptr(), m.data_ptr(), w.data_ptr(),
            batch, bs, t, DTYPE_CODES[blocks.dtype], DTYPE_CODES[out_dtype],
            stream_of(blocks))
    check(err, "blocked_gauss_jordan kernel")
    LAUNCHES["blocked_gauss_jordan"] += 1
    return out


def _plane_ld(cols: int) -> int:
    return -(-cols // _PLANE_ALIGN) * _PLANE_ALIGN


def tri_strip(k: int, batch: int, sms: int) -> int:
    """Right-hand-side columns a block of the triangular solve owns: the
    widest of `TRI_STRIPS` that still gives at least half as many blocks as
    the card has SMs (`sms`), else the narrowest. Wide strips read P fewer times;
    narrow ones put a narrow k on more SMs. On an H100 (132 SMs): k = 15616
    and 4352 take 64 (244 and 68 blocks), 1280 takes 16, 256 takes 8. A
    strip of 128 (122 blocks, one wave at 15616) ran slower than two waves
    of 64 there on an H100, so the kernel is not built for it."""
    for n in TRI_STRIPS:
        if -(-k // n) * batch >= sms // 2:
            return n
    return TRI_STRIPS[-1]


def blocked_attributes(kernel: str, strip: int = 64) -> dict:
    """Registers a thread, static and dynamic shared memory a block and
    spilled bytes of a kernel of the blocked routes: "tri_tc" (f32 right-hand
    sides, `strip` columns a block), "tri_dinv", "tri_pack", "bgj_panel" or
    "bgj_update", as the CUDA runtime reports them. Needs the card's
    toolkit: it builds the kernels."""
    index = ("tri_tc", "tri_dinv", "tri_pack", "bgj_panel", "bgj_update").index(kernel)
    out = (ctypes.c_int * 4)()
    check(load("leaf_inverse").repro_blocked_attributes(index, strip, out),
          f"{kernel} attributes")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "local_bytes"), out))


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
    strip = tri_strip(k, batch, sm_count(b.device.index or 0))
    out = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    # P (batch, 2, bs, ld), Zᵀ (batch, 2, k, ld) and the D_p⁻¹ (batch, bs, t).
    ld = _plane_ld(bs)
    scratch = torch.empty(batch * (2 * (bs + k) * ld + bs * tp), dtype=torch.float32,
                          device=b.device)
    with torch.cuda.device(b.device):
        err = load("leaf_inverse").repro_triangular_solve(
            t.data_ptr(), b.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            batch, bs, k, tp, t.stride(0), t.stride(1), t.stride(2), int(lower),
            int(unit_diagonal), DTYPE_CODES[t.dtype], DTYPE_CODES[b.dtype], strip,
            stream_of(b))
    check(err, "triangular_solve kernel")
    LAUNCHES["triangular_solve"] += 1
    return out
