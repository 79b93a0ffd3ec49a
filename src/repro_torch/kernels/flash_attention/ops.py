"""Public entry point of the flash attention kernel."""

from __future__ import annotations

import torch

from .kernel import flash_attention_cuda

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Flash attention forward in the reference's layout: q (B, H, Sq, hd),
    k and v (B, KV, Skv, hd). A CPU tensor goes to the plain version; a
    CUDA tensor launches the kernel, or the call raises."""
    return flash_attention_cuda(q, k, v, causal=causal)
