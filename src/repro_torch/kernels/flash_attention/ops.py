"""Public entry point of the flash attention kernel."""

from __future__ import annotations

import torch

from .kernel import FlashAttentionFn, flash_attention_cuda

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Flash attention in the reference's layout: q (B, H, Sq, hd), k and v
    (B, KV, Skv, hd); `window` > 0 (causal only) keeps the pairs
    0 <= i - j < window. A CPU tensor goes to the plain version, which
    autograd differentiates; a CUDA tensor launches the kernel, or the call
    raises. On CUDA with grad enabled and q, k or v requiring it, the call
    goes through `FlashAttentionFn`, whose backward is the B6-bwd kernel."""
    if (q.device.type == "cuda" and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)
