"""The assigned input-shape set (one per arch; 4 shapes × 10 archs = 40 cells).

`train_*` lowers train_step; `prefill_*` lowers the prefill forward;
`decode_*` / `long_*` lower serve_step (one new token against a KV cache of
seq_len). Eligibility rules (brief + DESIGN.md §8):
  - decode shapes need `decode_capable` (encoder-only archs skip),
  - long_500k needs `subquadratic` (pure full-attention archs skip).
"""

from __future__ import annotations

import dataclasses

from .registry import ArchConfig

__all__ = ["ShapeConfig", "SHAPES", "cell_status"]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_status(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for one (arch × shape) cell."""
    if shape.kind == "decode" and not arch.decode_capable:
        return False, "encoder-only arch has no autoregressive decode step"
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "pure full-attention arch; long_500k needs sub-quadratic"
    return True, ""
