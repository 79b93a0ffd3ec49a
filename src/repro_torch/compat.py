"""Capability probes of the installed PyTorch."""

from __future__ import annotations

import functools

import torch

__all__ = ["supports_float8"]


@functools.lru_cache(maxsize=1)
def supports_float8() -> bool:
    """True when this PyTorch has a usable float8_e4m3fn storage dtype.

    The probe for the precision policy's fp8 storage hook
    (`core.precision`): the dtype must exist and a round-trip cast through
    it must run. It runs on the CPU, so that importing the package never
    touches the card.
    """
    dtype = getattr(torch, "float8_e4m3fn", None)
    if dtype is None:
        return False
    try:
        x = torch.ones((2, 2), dtype=torch.float32)
        return bool(torch.equal(x.to(dtype).to(torch.float32), x))
    except (RuntimeError, TypeError):
        return False
