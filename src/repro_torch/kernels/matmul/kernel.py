"""Wrappers of the port's GEMM (csrc/matmul.cu).

`matmul_cuda` replaces `matmul_pallas` and `schur_update_cuda` replaces
`schur_update_pallas` (src/repro/kernels/matmul/kernel.py). Both take
operands of one dtype (f32, bf16 or f16) with unit column stride and any
row stride, accumulate in f32, and write ``out_dtype``: the operands'
dtype or f32. There are no tile arguments: any (m, n, k) is legal.

Two bodies compute them; `gemm_route` is the rule that picks one:

* ``"tensor_core"`` (``gemm_tc``): every product with k >= 1. A pack
  pre-pass writes A and Bᵀ K-major into scratch (f32 as TF32 hi and lo
  planes), then ``wgmma`` runs on TMA-loaded tiles: f32 as three TF32
  products (lo·hi + hi·lo + hi·hi), bf16 and f16 as one. Outputs with
  fewer 128 x 128 tiles than the card has SMs take 64-row tiles.
* ``"ffma"`` (``gemm_kernel``): products with k == 0, whose output is
  β·C or zeros.

A product with m == 0 or n == 0 launches nothing. Each launch adds one to
its wrapper's count (``matmul`` or ``schur_update``) and one to its body's
(``gemm_tensor_core`` or ``gemm_ffma``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import DTYPE_CODES, LAUNCHES, check_operand, sm_count, stream_of
from ..build import check, load
from .ref import matmul_ref, schur_update_ref

__all__ = ["matmul_cuda", "schur_update_cuda", "gemm_route", "gemm_pack_cuda",
           "gemm_tc_attributes", "TC_BLOCK_N"]

TC_BLOCK_N = 128                # output columns a tensor-core block
_TC_ROW_ALIGN = 16              # bytes: TMA's row-stride granule


def gemm_route(m: int, n: int, k: int, dtype: torch.dtype,
               sm_count: int) -> tuple[str, int | None]:
    """(body, block_m) of an (m, k) x (k, n) product of ``dtype`` operands
    on a card with ``sm_count`` SMs: ("empty", None) when m or n is 0,
    ("ffma", None) when k is 0, else ("tensor_core", 128), or 64 when the
    output has fewer 128 x 128 tiles than the card has SMs. Row strides
    play no part: the pack pre-pass takes any."""
    if dtype not in DTYPE_CODES:
        raise ValueError(f"no GEMM body takes {dtype}")
    if m == 0 or n == 0:
        return "empty", None
    if k == 0:
        return "ffma", None
    tiles = -(-m // 128) * -(-n // TC_BLOCK_N)
    return "tensor_core", 64 if tiles < sm_count else 128


def _scratch(a: torch.Tensor, m: int, n: int, k: int):
    """One allocation for the pack pre-pass: A packed as (planes, m, ldp),
    then Bᵀ packed as (planes, n, ldp). Returns it, ldp, and the byte
    offset of Bᵀ, a multiple of 16 since ldp's rows are."""
    planes = 2 if a.dtype == torch.float32 else 1
    granule = _TC_ROW_ALIGN // a.element_size()
    ldp = -(-k // granule) * granule
    scratch = torch.empty(planes * (m + n) * ldp, dtype=a.dtype, device=a.device)
    return scratch, ldp, planes * m * ldp * a.element_size()


def gemm_pack_cuda(a: torch.Tensor, b: torch.Tensor):
    """The tensor-core body's pre-pass alone: (A packed, Bᵀ packed), each
    (planes, rows, ldp) with k valid columns a row; f32 as the TF32 hi and
    lo planes of `tf32_split_ref`, bf16 and f16 copied."""
    _check(None, a, b, None)
    if a.device.type != "cuda":
        raise ValueError("gemm_pack_cuda runs on the card only")
    (m, k), n = a.shape, b.shape[1]
    scratch, ldp, b_offset = _scratch(a, m, n, k)
    with torch.cuda.device(a.device):
        err = load("matmul").repro_gemm_pack(
            a.data_ptr(), b.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + b_offset,
            m, n, k, a.stride(0), b.stride(0), ldp, DTYPE_CODES[a.dtype], stream_of(a))
    check(err, "gemm pack pre-pass")
    split = b_offset // a.element_size()
    return scratch[:split].view(-1, m, ldp), scratch[split:].view(-1, n, ldp)


def gemm_tc_attributes(dtype: torch.dtype, block_m: int) -> dict:
    """Registers a thread, static and dynamic shared memory, local (spill)
    bytes and ring stages of the tensor-core main loop."""
    out = (ctypes.c_int * 5)()
    check(load("matmul").repro_gemm_tc_attributes(DTYPE_CODES[dtype], block_m, out),
          "gemm_tc attributes")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "local_bytes",
                     "stages"), out))


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
    (m, k), n = a.shape, b.shape[1]
    device = a.device
    out = torch.empty((m, n), dtype=out_dtype, device=device)
    body, block_m = gemm_route(m, n, k, a.dtype, sm_count(device.index or 0))
    if body == "empty":
        return out
    lib = load("matmul")
    c_ptr, ldc = (None, 0) if c is None else (c.data_ptr(), c.stride(0))
    codes = DTYPE_CODES[a.dtype], DTYPE_CODES[out_dtype]
    with torch.cuda.device(device):
        if body == "tensor_core":
            scratch, ldp, b_offset = _scratch(a, m, n, k)
            packed = scratch.data_ptr()
            err = lib.repro_gemm_tc(
                a.data_ptr(), b.data_ptr(), c_ptr, out.data_ptr(),
                packed, packed + b_offset, m, n, k,
                a.stride(0), b.stride(0), ldc, out.stride(0), ldp,
                alpha, beta, block_m, *codes, stream_of(a))
        else:
            err = lib.repro_gemm(
                a.data_ptr(), b.data_ptr(), c_ptr, out.data_ptr(), m, n, k,
                a.stride(0), b.stride(0), ldc, out.stride(0), alpha, beta, *codes,
                stream_of(a))
    check(err, "matmul kernel" if c is None else "schur_update kernel")
    LAUNCHES["gemm_" + body] += 1
    LAUNCHES["matmul" if c is None else "schur_update"] += 1
    return out


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """C = A @ B for (m, k) × (k, n), f32 accumulation, ``out_dtype`` out
    (default: a's dtype)."""
    out_dtype = _check(None, a, b, out_dtype)
    if a.device.type == "cpu":
        return matmul_ref(a, b, out_dtype)
    return _launch(None, a, b, 1.0, 0.0, out_dtype)


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
    return _launch(c, a, b, float(alpha), float(beta), out_dtype)
