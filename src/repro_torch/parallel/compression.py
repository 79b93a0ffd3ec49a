"""Gradient compression for the slow (DCN / pod) axis.

The port of `repro.parallel.compression`: int8 quantisation with a
per-tensor scale, an int8 all-reduce, and error feedback (the
quantisation residual is carried into the next step's gradient, which
keeps SGD unbiased in expectation). `torch.round` rounds half to even, as
`jnp.round` does, so `quantize_int8` and `error_feedback_update` give the
reference's bits on the same f32 input.

`compressed_psum` runs over per-coordinate tensors (`collectives`): the
scales' `pmax`, then each coordinate's int8 payload requantised against
the shared scale and all-gathered over the axis (one byte an element on
the wire), summed in int32 on every coordinate in the group's order, and
rescaled. The sum is exact for up to 2^23 summands, so every coordinate
holds the reference's value. Like the reference's, the trainer does not
call it.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import collectives as col

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum",
           "error_feedback_update"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale f32 0-dim) with scale = max|x| / 127 + 1e-12."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    return _quantize(x, scale), scale


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(xs: dict, axis_name, mesh=None) -> dict:
    """int8-compressed all-reduce over `axis_name` of per-coordinate
    tensors: {coord: f32 sum}, the reference's value on every coordinate."""
    xf = {c: x.to(torch.float32) for c, x in xs.items()}
    scales = {c: quantize_int8(x)[1] for c, x in xf.items()}
    scale_max = col.pmax(scales, axis_name, mesh)
    # requantise against the shared scale so that the integer sum is coherent
    q = {c: _quantize(x, scale_max[c]) for c, x in xf.items()}
    stacked = col.all_gather({c: t[None] for c, t in q.items()}, axis_name, 0, mesh)
    return {c: s.sum(0, dtype=torch.int32).to(torch.float32) * scale_max[c]
            for c, s in stacked.items()}


def error_feedback_update(grad: torch.Tensor, residual: Optional[torch.Tensor]
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the carried residual, quantise: (compensated, new residual)."""
    g = grad.to(torch.float32)
    if residual is not None:
        g = g + residual
    q, scale = quantize_int8(g)
    deq = dequantize_int8(q, scale)
    return deq, g - deq
