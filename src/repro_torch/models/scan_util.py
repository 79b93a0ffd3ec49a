"""A scan over the leading axis, and the probe-mode unroll flag.

The port of `repro.models.scan_util`. The reference wraps `jax.lax.scan`
so that the dry run's roofline probes can trace every scan unrolled
(XLA's cost analysis counts a while loop's body once). PyTorch runs
eagerly, so `scan` is a Python loop that stacks the per-step outputs,
rolled or not; `unroll_scans` and `unrolling` are kept as the context
variable the dry run reads.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

__all__ = ["scan", "unroll_scans", "unrolling"]

_UNROLL: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_unroll_scans", default=False)


@contextlib.contextmanager
def unroll_scans():
    token = _UNROLL.set(True)
    try:
        yield
    finally:
        _UNROLL.reset(token)


def unrolling() -> bool:
    return _UNROLL.get()


def _index(xs, i: int):
    if isinstance(xs, (tuple, list)):
        return type(xs)(_index(x, i) for x in xs)
    if isinstance(xs, dict):
        return {k: _index(v, i) for k, v in xs.items()}
    return xs[i]


def _stack(ys: list):
    first = ys[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([y[j] for y in ys]) for j in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([y[k] for y in ys]) for k in first}
    return torch.stack(ys)


def _length(xs) -> int:
    if isinstance(xs, (tuple, list)):
        return _length(xs[0])
    if isinstance(xs, dict):
        return _length(next(iter(xs.values())))
    return xs.shape[0]


def scan(body, init, xs=None, length: int | None = None):
    """`jax.lax.scan`'s contract: carry, y = body(carry, x) for each x
    along the leading axis of `xs` (tensors, or tuples, lists and dicts of
    them); returns (final carry, the ys stacked along a new leading axis,
    or None when body returns None for y)."""
    n = length if xs is None else _length(xs)
    carry, ys = init, []
    for i in range(n):
        carry, y = body(carry, None if xs is None else _index(xs, i))
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, _stack(ys)
