"""BlockMatrix: the SPIN block data structure (paper §3.2) over one tensor.

An n×n matrix is a b×b grid of bs×bs blocks held as one ``(b, b, bs, bs)``
tensor, the layout of the JAX package's BlockMatrix. `from_dense` and
`to_dense` are permute+reshape: `from_dense` returns a strided view, and
`to_dense` copies only when the grid is not already laid out densely.
The paper's breakMat/xy is slicing, and `arrange` writes the four
quadrants into one preallocated output.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator

import torch

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["BlockMatrix", "OpCounts", "count_ops", "current_counts",
           "suspend_counts"]


# ---------------------------------------------------------------------------
# Operation accounting: the counters the paper's op-count oracle checks.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OpCounts:
    """The JAX package's counter set, field for field, so that the records
    of both packages compare as dicts. Fields of engines and solvers that
    are not ported yet stay 0."""

    multiplies: int = 0          # BlockMatrix-level multiply() calls
    block_gemms: int = 0         # bs×bs GEMMs implied by those multiplies
    subtracts: int = 0
    scalar_muls: int = 0
    leaf_inversions: int = 0
    leaf_lu: int = 0
    leaf_solves: int = 0
    solve_applies: int = 0
    smw_updates: int = 0
    arranges: int = 0
    splits: int = 0
    strassen_base_multiplies: int = 0
    strassen_adds: int = 0

    def as_dict(self) -> dict[str, int]:
        return dataclasses.asdict(self)


_COUNTS: contextvars.ContextVar[OpCounts | None] = contextvars.ContextVar(
    "repro_torch_op_counts", default=None)


@contextlib.contextmanager
def count_ops() -> Iterator[OpCounts]:
    """Record BlockMatrix op counts for the calls made inside the block."""
    counts = OpCounts()
    token = _COUNTS.set(counts)
    try:
        yield counts
    finally:
        _COUNTS.reset(token)


def current_counts() -> OpCounts | None:
    """The counters of the innermost `count_ops` block, or None outside one."""
    return _COUNTS.get()


@contextlib.contextmanager
def suspend_counts() -> Iterator[None]:
    """Count nothing inside the block: work that a mesh repeats on a second
    device is one logical op, booked once by the first device's run."""
    token = _COUNTS.set(None)
    try:
        yield
    finally:
        _COUNTS.reset(token)


def _bump(field: str, by: int = 1) -> None:
    counts = _COUNTS.get()
    if counts is not None:
        setattr(counts, field, getattr(counts, field) + by)


# ---------------------------------------------------------------------------
# BlockMatrix
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockMatrix:
    """A b×b grid of bs×bs blocks, stored as one (b, b, bs, bs) tensor."""

    blocks: torch.Tensor

    @property
    def grid(self) -> int:
        """Number of block rows (= block cols); the paper's ``b``."""
        return self.blocks.shape[0]

    @property
    def block_size(self) -> int:
        """Side of one block; the paper's ``n / b``."""
        return self.blocks.shape[2]

    @property
    def n(self) -> int:
        return self.grid * self.block_size

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    # -- conversions ----------------------------------------------------------
    @classmethod
    def from_dense(cls, dense: torch.Tensor, block_size: int) -> "BlockMatrix":
        if dense.ndim != 2 or dense.shape[0] != dense.shape[1]:
            raise ValueError(f"expected square matrix, got {tuple(dense.shape)}")
        n = dense.shape[0]
        if n % block_size:
            raise ValueError(f"n={n} not divisible by block_size={block_size}")
        b = n // block_size
        return cls(dense.reshape(b, block_size, b, block_size).permute(0, 2, 1, 3))

    def to_dense(self) -> torch.Tensor:
        b, _, bs, _ = self.blocks.shape
        return self.blocks.permute(0, 2, 1, 3).reshape(b * bs, b * bs)

    # -- paper methods --------------------------------------------------------
    def split(self) -> tuple["BlockMatrix", "BlockMatrix", "BlockMatrix", "BlockMatrix"]:
        """breakMat + _11/_12/_21/_22 of the paper: four quadrant views."""
        b = self.grid
        if b % 2:
            raise ValueError(f"cannot split odd grid b={b}")
        h = b // 2
        _bump("splits")
        blk = self.blocks
        return (BlockMatrix(blk[:h, :h]), BlockMatrix(blk[:h, h:]),
                BlockMatrix(blk[h:, :h]), BlockMatrix(blk[h:, h:]))

    @staticmethod
    def arrange(c11: "BlockMatrix", c12: "BlockMatrix", c21: "BlockMatrix",
                c22: "BlockMatrix") -> "BlockMatrix":
        """The paper's arrange: four quadrants -> one matrix (Algorithm 6)."""
        _bump("arranges")
        h = c11.grid
        src = c11.blocks
        out = torch.empty((2 * h, 2 * h) + tuple(src.shape[2:]),
                          dtype=src.dtype, device=src.device)
        out[:h, :h] = c11.blocks
        out[:h, h:] = c12.blocks
        out[h:, :h] = c21.blocks
        out[h:, h:] = c22.blocks
        return BlockMatrix(out)

    # -- arithmetic -----------------------------------------------------------
    def subtract(self, other: "BlockMatrix") -> "BlockMatrix":
        _bump("subtracts")
        return BlockMatrix(self.blocks - other.blocks)

    def add(self, other: "BlockMatrix") -> "BlockMatrix":
        _bump("subtracts")  # same cost class as subtract in the paper's model
        return BlockMatrix(self.blocks + other.blocks)

    def scalar_mul(self, scalar: float) -> "BlockMatrix":
        _bump("scalar_muls")
        return BlockMatrix(self.blocks * scalar)

    def neg(self) -> "BlockMatrix":
        return self.scalar_mul(-1.0)

    @classmethod
    def identity(cls, grid: int, block_size: int, dtype=torch.float32,
                 device: str | torch.device = DEFAULT_DEVICE) -> "BlockMatrix":
        """The n×n identity as a grid of blocks, laid out densely."""
        eye = torch.eye(grid * block_size, dtype=dtype,
                        device=resolve_device(device))
        return cls.from_dense(eye, block_size)

    @classmethod
    def zeros(cls, grid: int, block_size: int, dtype=torch.float32,
              device: str | torch.device = DEFAULT_DEVICE) -> "BlockMatrix":
        return cls(torch.zeros((grid, grid, block_size, block_size),
                               dtype=dtype, device=resolve_device(device)))
