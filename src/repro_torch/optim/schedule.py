"""LR schedules: host functions of the step, in f32 arithmetic as the
reference's (`repro.optim.schedule`)."""

from __future__ import annotations

import numpy as np

__all__ = ["cosine_with_warmup", "constant"]


def cosine_with_warmup(step, *, warmup: int = 100, total: int = 10_000,
                       floor: float = 0.1) -> float:
    """Linear warm-up to 1 over `warmup` steps, then a cosine to `floor` at
    `total`. `step` is an int or a 0-dim tensor; the result a float."""
    s = np.float32(int(step))
    warm = np.minimum(s / np.float32(max(warmup, 1)), np.float32(1.0))
    frac = np.clip((s - np.float32(warmup)) / np.float32(max(total - warmup, 1)),
                   np.float32(0.0), np.float32(1.0))
    cos = np.float32(floor) + np.float32(1 - floor) * np.float32(0.5) * (
        np.float32(1) + np.cos(np.float32(np.pi) * frac))
    return float(np.float32(warm * cos))


def constant(step) -> float:
    return 1.0
