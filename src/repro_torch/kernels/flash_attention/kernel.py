"""Wrapper of the flash attention kernel (csrc/flash_attention.cu).

`flash_attention_cuda` replaces `flash_attention_pallas`
(src/repro/kernels/flash_attention/kernel.py): causal or full softmax
attention with an online softmax and grouped-query heads, f32
accumulation, output in q's dtype. Unlike the Pallas kernel it takes any
sequence length (the last tile is masked) and any strides on the B, H
and S axes, with unit stride on hd, so the model's (B, S, H, hd)
activations pass as ``transpose(1, 2)`` views without a copy.

bf16 and f16 run on the tensor cores (wgmma, operands loaded by TMA,
which needs 16-byte aligned rows); f32 runs the FFMA kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .. import DTYPE_CODES, LAUNCHES, check_operand, stream_of
from ..build import check, load
from .ref import attention_ref

__all__ = ["flash_attention_cuda", "flash_attention_attributes",
           "SUPPORTED_HEAD_DIMS"]

SUPPORTED_HEAD_DIMS = (16, 32, 64, 96, 128, 160)  # launch_hd in the source


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KV, Skv, hd); H % KV == 0."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(t, name, 4)
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    b, h, sq, hd = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if n_kv == 0 or h % n_kv:
        raise ValueError(f"H={h} must be a multiple of KV={n_kv}")
    if skv == 0:
        raise ValueError("attention over an empty key sequence")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the kernel's {SUPPORTED_HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the flash attention kernel needs unit stride on hd")
    if q.dtype != torch.float32:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(t.stride(i) * t.element_size() % 16
                                        for i in range(3) if t.shape[i] > 1):
                raise ValueError(f"{name}: the tensor-core kernel loads by TMA, "
                                 "which needs a 16-byte aligned base and strides")
    out = torch.empty_like(q)  # keeps q's layout when q is dense
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        err = load("flash_attention").repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, n_kv, sq, skv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(causal), hd ** -0.5, DTYPE_CODES[q.dtype], stream_of(q))
    check(err, "flash_attention kernel")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_attributes(dtype: torch.dtype, hd: int) -> dict:
    """Registers a thread, shared memory a block (static and dynamic) and
    spilled bytes of the kernel that `dtype` and `hd` launch, as the CUDA
    runtime reports them. Needs the card's toolkit: it builds the kernels."""
    out = (ctypes.c_int * 4)()
    check(load("flash_attention").repro_flash_attention_attributes(
        DTYPE_CODES[dtype], hd, out), "flash_attention attributes")
    return {"registers": out[0], "static_smem": out[1], "dynamic_smem": out[2],
            "local_bytes": out[3]}
