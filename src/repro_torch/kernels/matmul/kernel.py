"""Wrappers of the tiled GEMM kernel (csrc/matmul.cu, csrc/gemm_tile.cuh).

`matmul_cuda` replaces `matmul_pallas` and `schur_update_cuda` replaces
`schur_update_pallas` (src/repro/kernels/matmul/kernel.py). Both take
operands of one dtype (f32, bf16 or f16) with unit column stride and any
row stride, accumulate in f32, and write ``out_dtype``: the operands'
dtype or f32. There are no tile arguments: the kernel masks ragged edges,
so any (m, n, k) is legal.
"""

from __future__ import annotations

import torch

from .. import DTYPE_CODES, LAUNCHES, check_operand, stream_of
from ..build import check, load
from .ref import matmul_ref, schur_update_ref

__all__ = ["matmul_cuda", "schur_update_cuda"]


def _check(c: torch.Tensor | None, a: torch.Tensor, b: torch.Tensor,
           out_dtype) -> torch.dtype:
    check_operand(a, "a", 2)
    check_operand(b, "b", 2)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} x {tuple(b.shape)}")
    operands = [a, b]
    if c is not None:
        check_operand(c, "c", 2)
        if tuple(c.shape) != (a.shape[0], b.shape[1]):
            raise ValueError(f"update operand {tuple(c.shape)} != product "
                             f"shape {(a.shape[0], b.shape[1])}")
        operands.append(c)
    if len({t.dtype for t in operands}) != 1:
        raise ValueError(f"operands must share one dtype, got "
                         f"{[str(t.dtype) for t in operands]}")
    if len({t.device for t in operands}) != 1:
        raise ValueError("operands lie on different devices")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in (a.dtype, torch.float32):
        raise ValueError(f"out_dtype {out_dtype} must be the operands' dtype "
                         "or float32")
    if a.device.type == "cuda":
        for name, t in zip("abc", operands):
            if t.shape[1] > 1 and t.stride(1) != 1:
                raise ValueError(f"{name} needs unit column stride, got "
                                 f"strides {t.stride()}")
    return out_dtype


def _launch(c, a, b, alpha: float, beta: float, out_dtype) -> torch.Tensor:
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    with torch.cuda.device(a.device):
        err = load("matmul").repro_gemm(
            a.data_ptr(), b.data_ptr(), None if c is None else c.data_ptr(),
            out.data_ptr(), m, n, k, a.stride(0), b.stride(0),
            0 if c is None else c.stride(0), out.stride(0), 0, 0, 0, 0, 1,
            alpha, beta, DTYPE_CODES[a.dtype], DTYPE_CODES[out_dtype],
            stream_of(a))
    check(err, "matmul kernel" if c is None else "schur_update kernel")
    return out


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """C = A @ B for (m, k) × (k, n), f32 accumulation, ``out_dtype`` out
    (default: a's dtype)."""
    out_dtype = _check(None, a, b, out_dtype)
    if a.device.type == "cpu":
        return matmul_ref(a, b, out_dtype)
    out = _launch(None, a, b, 1.0, 0.0, out_dtype)
    LAUNCHES["matmul"] += 1
    return out


def schur_update_cuda(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                      alpha: float = 1.0, beta: float = -1.0,
                      out_dtype=None) -> torch.Tensor:
    """Fused `β·C + α·(A@B)` for (m, n) C, (m, k) A, (k, n) B.

    α=1, β=−1 is the paper's `V = A21·III − A22`; α=−1, β=1 is
    `C11 = I − III·C21`. ``out_dtype`` defaults to C's dtype.
    """
    out_dtype = _check(c, a, b, out_dtype)
    if a.device.type == "cpu":
        return schur_update_ref(c, a, b, alpha, beta, out_dtype)
    out = _launch(c, a, b, float(alpha), float(beta), out_dtype)
    LAUNCHES["schur_update"] += 1
    return out
