"""SPIN: Strassen's block-recursive matrix inversion (paper Algorithm 1/2).

Per recursion level (paper §3.1):      leaf (grid == 1):
    I    <- Inverse(A11)                   invert the single block
    II   <- A21 . I                        (Gauss-Jordan kernels, or the
    III  <- I . A12                         torch.linalg.inv oracle)
    IV   <- A21 . III
    V    <- IV - A22
    VI   <- Inverse(V)
    C12  <- III . VI
    C21  <- VI . II
    VII  <- III . C21
    C11  <- I - VII
    C22  <- -VI

Exactly 6 multiplies + 2 subtracts + 1 scalarMul per level and one local
O(bs³) op per leaf. Valid for matrices whose leading principal blocks are
invertible (SPD in particular, the class the paper targets).

Under a low-precision policy (`core/precision.py`, e.g. ``precision="bf16"``)
the recursion runs at the policy's compute dtype, then Newton–Schulz
polishes the result in f32 (`core/newton_schulz.py`), then it is cast to
the policy's store dtype.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels.leaf_inverse import ops as gj_ops
from ..obs.trace import TRACER as _TRACER
from .blockmatrix import BlockMatrix, _bump
from .multiply import (current_engine, multiply, multiply_engine,
                       multiply_subtract, subtract_multiply, validate_engine)
from .newton_schulz import newton_schulz_polish
from .precision import (_dtype_name, resolve_precision,
                        resolve_with_legacy_kwarg, torch_dtype)

__all__ = ["spin_inverse", "spin_inverse_dense", "leaf_inverse",
           "LEAF_SOLVERS"]


# ---------------------------------------------------------------------------
# Leaf solvers: invert one bs×bs block.
# ---------------------------------------------------------------------------


def _leaf_linalg(block: torch.Tensor) -> torch.Tensor:
    # LAPACK-style getrf/getri in f32: the oracle the others are held to.
    return torch.linalg.inv(block.float()).to(block.dtype)


def _leaf_gauss_jordan(block: torch.Tensor) -> torch.Tensor:
    # Scalar Gauss-Jordan kernel.
    return gj_ops.leaf_inverse(block)


def _leaf_cuda(block: torch.Tensor) -> torch.Tensor:
    # Blocked Gauss-Jordan kernel: panel mini-sweeps with rank-t updates.
    return gj_ops.blocked_leaf_inverse(block)


def _leaf_qr(block: torch.Tensor) -> torch.Tensor:
    q, r = torch.linalg.qr(block.float())
    eye = torch.eye(block.shape[-1], dtype=torch.float32, device=block.device)
    rinv = torch.linalg.solve_triangular(r, eye, upper=True)
    return (rinv @ q.T).to(block.dtype)


LEAF_SOLVERS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "linalg": _leaf_linalg,
    "gauss_jordan": _leaf_gauss_jordan,
    "cuda": _leaf_cuda,
    "qr": _leaf_qr,
}


def leaf_inverse(a: BlockMatrix, solver: str = "linalg") -> BlockMatrix:
    """Paper Algorithm 2 `if` branch: grid==1, invert the block in place."""
    if a.grid != 1:
        raise ValueError(f"leaf_inverse expects grid==1, got {a.grid}")
    if solver not in LEAF_SOLVERS:
        raise ValueError(f"unknown leaf solver {solver!r}; this package has "
                         f"{tuple(LEAF_SOLVERS)}")
    _bump("leaf_inversions")
    inv = LEAF_SOLVERS[solver](a.blocks[0, 0])
    return BlockMatrix(inv[None, None])


# ---------------------------------------------------------------------------
# The recursion (paper Algorithm 2 `else` branch)
# ---------------------------------------------------------------------------


def _policy_active(policy, operand_dtype) -> bool:
    """True when `policy` changes the compute or storage dtype of this
    operand (an "auto" policy over a matching dtype changes nothing, and
    polishing anyway would change bits for nothing)."""
    name = _dtype_name(operand_dtype)
    return (policy.resolve_store(name) != name
            or policy.resolve_compute(name) != name)


def _lowp_inverse_blocks(a: BlockMatrix, leaf_solver: str,
                         policy) -> BlockMatrix:
    """Low-precision BlockMatrix inversion: recurse at the policy's compute
    dtype, Newton–Schulz-polish in f32, store at the policy's store dtype."""
    op = a.blocks.dtype
    cd = torch_dtype(policy.resolve_compute(op))
    x = spin_inverse(BlockMatrix(a.blocks.to(cd)), leaf_solver=leaf_solver)
    if policy.polish_sweeps:
        a32 = BlockMatrix(a.blocks.float())
        x32 = BlockMatrix(x.blocks.float())
        x = newton_schulz_polish(a32, x32, sweeps=policy.polish_sweeps)
    return BlockMatrix(x.blocks.to(torch_dtype(policy.resolve_store(op))))


def spin_inverse(a: BlockMatrix, *, leaf_solver: str = "linalg",
                 auto: bool = False, precision=None,
                 _level: int = 0) -> BlockMatrix:
    """Strassen inversion of a BlockMatrix (grid must be 2^m), on the
    device its blocks lie on, with the ambient multiply engine.

    auto=True asks the planner for the leaf solver (the grid is fixed by
    `a`), priced for the device the blocks lie on; the result is bitwise
    the call with that solver. precision (PrecisionPolicy | preset string |
    None) runs the recursion at the policy's compute dtype, polishes in
    f32 and returns blocks at the policy's store dtype; None and "exact"
    are bitwise the plain call.

    `_level` carries the recursion depth to the span tracer (`obs.trace`):
    under $SPIN_TRACE each internal node emits a "spin.level" span and
    each leaf a "spin.leaf" event, of kind "recursion_level", on every
    call. Off, a node pays one attribute read.
    """
    if auto:
        from ..planner import planned_leaf_solver

        leaf_solver = planned_leaf_solver(a.n, a.block_size, a.dtype,
                                          backend=a.device.type)
    if precision is not None:
        policy = resolve_precision(precision)
        if not policy.is_exact and _policy_active(policy, a.blocks.dtype):
            return _lowp_inverse_blocks(a, leaf_solver, policy)
    b = a.grid
    if b & (b - 1):
        raise ValueError(f"grid must be a power of two, got {b}")
    if b == 1:
        if _TRACER.enabled:
            _TRACER.event("spin.leaf", "recursion_level", level=_level,
                          grid=1, op="leaf", solver=leaf_solver,
                          block_size=a.block_size,
                          dtype=_dtype_name(a.blocks.dtype))
        return leaf_inverse(a, solver=leaf_solver)

    if _TRACER.enabled:
        span_ctx = _TRACER.span(
            "spin.level", "recursion_level", level=_level, grid=b,
            op="inverse_node", block_size=a.block_size,
            dtype=_dtype_name(a.blocks.dtype), engine=current_engine())
    else:
        span_ctx = contextlib.nullcontext()
    with span_ctx:
        a11, a12, a21, a22 = a.split()
        i_ = spin_inverse(a11, leaf_solver=leaf_solver,
                          _level=_level + 1)              # I   = A11^-1
        ii = multiply(a21, i_)                            # II  = A21 I
        iii = multiply(i_, a12)                           # III = I A12
        # IV = A21·III and V = IV − A22 as ONE fused Schur update: one
        # kernel under engine="cuda", multiply-then-subtract under
        # "einsum". Op counts book 1 multiply + 1 subtract either way.
        v = multiply_subtract(a21, iii, a22)
        vi = spin_inverse(v, leaf_solver=leaf_solver,
                          _level=_level + 1)              # VI  = V^-1
        c12 = multiply(iii, vi)
        c21 = multiply(vi, ii)
        # VII = III·C21 and C11 = I − VII, same fused contract.
        c11 = subtract_multiply(i_, iii, c21)
        c22 = vi.neg()                                    # scalarMul(VI, -1)
        return BlockMatrix.arrange(c11, c12, c21, c22)


def spin_inverse_dense(dense, block_size: int | None = None,
                       leaf_solver: str | None = None, *,
                       engine: str | None = None, auto: bool = False,
                       device: str | torch.device = DEFAULT_DEVICE,
                       precision=None, compute_dtype=None) -> torch.Tensor:
    """Dense (n, n) -> dense (n, n) inverse via SPIN, computed on `device`.

    `dense` is a tensor or anything `torch.as_tensor` takes; it is moved to
    `device` first. engine=None inherits the ambient `multiply_engine`;
    leaf_solver=None is "linalg".

    With block_size=None (or auto=True) the planner (`repro_torch.planner`)
    picks the block size, leaf solver and engine for `device`'s backend;
    a block size, leaf solver or engine given explicitly overrides its
    choice (it constrains the candidates). The planned call runs this
    function with the chosen arguments, so it is bitwise the explicit call
    for plans without a refinement stage.

    precision (PrecisionPolicy | preset string | None -> $SPIN_PRECISION or
    exact) runs the recursion at the policy's compute dtype, polishes in
    f32 with the same engine, and returns the policy's store dtype; under
    the planner the policy rides the signature, so the plan is priced and
    cached per policy. `compute_dtype=` is the deprecated spelling: it
    warns once and forwards to `policy_from_compute_dtype`.
    """
    validate_engine(engine)
    policy = resolve_with_legacy_kwarg("spin_inverse_dense", precision,
                                       compute_dtype)
    dev = resolve_device(device)
    dense = torch.as_tensor(dense).to(dev)
    if auto or block_size is None:
        from ..planner import plan_inverse

        return plan_inverse(dense, precision=policy,
                            **_explicit(block_size, leaf_solver, engine))
    ctx = multiply_engine(engine) if engine else contextlib.nullcontext()
    with ctx:
        a = BlockMatrix.from_dense(dense, block_size)
        return spin_inverse(a, leaf_solver=leaf_solver or "linalg",
                            precision=policy).to_dense()


def _explicit(block_size: int | None, leaf_solver: str | None,
              engine: str | None) -> dict:
    """The planner's candidate constraints from a call's explicit arguments."""
    kw = {}
    if block_size is not None:
        kw["block_sizes"] = (int(block_size),)
    if leaf_solver is not None:
        kw["leaf_solvers"] = (leaf_solver,)
    if engine is not None:
        kw["engines"] = (engine,)
    return kw
