"""Sherman–Morrison–Woodbury low-rank updates of a maintained SPIN inverse.

When the matrix changes by a rank-k correction A' = A + U Vᵀ, the
Woodbury identity revises the maintained inverse in O(n²k) instead of
re-running Algorithm 2:

    (A + U Vᵀ)⁻¹ = A⁻¹ − (A⁻¹U) (I_k + Vᵀ A⁻¹ U)⁻¹ (Vᵀ A⁻¹)

Three n×k panel products and one k×k "capacitance" solve touch the big
operand. `smw_update_solve` answers (A + U Vᵀ) x = b from the base
inverse without forming the updated one.

Every entry point dispatches on the maintained inverse's representation:
a dense (n, n) tensor, a `BlockMatrix`, whose panel products run block
by block (``ijab,jbk->iak``) and whose rank-k correction is scattered back
onto the grid without densifying it, or a `ShardedBlockMatrix`, whose
panels stay split by rows over the mesh and whose correction runs on each
shard. Sums accumulate in f32 (f64 stays
f64 where the JAX package keeps it), in plain PyTorch.

`block_update_factors` writes the replacement of symmetric block row and
column r by a delta W (bs × n, D its diagonal block) as a rank-2·bs
update:

    Δ = E_r W + (Wᵀ − E_r D) E_rᵀ  =  [E_r | Wᵀ − E_r D] [Wᵀ | E_r]ᵀ

`DriftTracker` carries what the refactor policy
(`repro_torch.planner.refactor_policy`) prices: the accumulated rank, the
update count and a probe estimate of the residual, bounded by the
conformance table's `verify.residual_tolerance`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.matmul import ops as mm_ops
from .blockmatrix import BlockMatrix, _bump
from .precision import resolve_precision, torch_dtype
from .verify import residual_tolerance

__all__ = [
    "smw_update_inverse", "smw_update_solve", "block_update_factors",
    "apply_inverse", "add_low_rank", "DriftTracker",
    "estimate_inverse_residual",
]


def _accum(dtype: torch.dtype) -> torch.dtype:
    return (torch.float32 if dtype in (torch.bfloat16, torch.float16, torch.float32)
            else dtype)


def _as_panel(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    return (x[:, None], True) if x.ndim == 1 else (x, False)


def _eye(k: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(k, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Dense path
# ---------------------------------------------------------------------------


def _smw_inverse_dense(inv: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                       ) -> torch.Tensor:
    f32 = inv.float()
    u32, v32 = u.float(), v.float()
    p = f32 @ u32                                   # A⁻¹ U          (n, k)
    q = (f32.T @ v32).T                             # Vᵀ A⁻¹         (k, n)
    cap = _eye(u.shape[1], inv) + v32.T @ p
    # A⁻¹ − P·(cap⁻¹Q) as one product with the subtract in its epilogue: one
    # pass over the resident inverse instead of a product, then a subtract.
    return torch.addmm(f32, p, torch.linalg.solve(cap, q), alpha=-1.0).to(inv.dtype)


def _smw_solve_dense(inv: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     rhs: torch.Tensor) -> torch.Tensor:
    f32 = inv.float()
    u32, v32 = u.float(), v.float()
    x0 = f32 @ rhs.float()                          # A⁻¹ b
    p = f32 @ u32                                   # A⁻¹ U
    cap = _eye(u.shape[1], inv) + v32.T @ p
    return (x0 - p @ torch.linalg.solve(cap, v32.T @ x0)).to(rhs.dtype)


# ---------------------------------------------------------------------------
# Block path
# ---------------------------------------------------------------------------


def _blocks_apply(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """X·x for a (b_r, b_c, bs, bs) grid and a (b_c·bs, k) panel, f32 out."""
    br, bc, bs, _ = blocks.shape
    out = torch.einsum("ijab,jbk->iak", blocks.float(),
                       x.float().reshape(bc, bs, x.shape[-1]))
    return out.reshape(br * bs, x.shape[-1])


def _blocks_apply_t(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Xᵀ·x without forming the transpose (grid and intra-block swap)."""
    br, bc, bs, _ = blocks.shape
    out = torch.einsum("ijab,iak->jbk", blocks.float(),
                       x.float().reshape(br, bs, x.shape[-1]))
    return out.reshape(bc * bs, x.shape[-1])


def _smw_correction_blocks(blocks: torch.Tensor, p: torch.Tensor,
                           m: torch.Tensor) -> torch.Tensor:
    """blocks − P·M scattered onto the block grid (P: (b_r·bs, k), M:
    (k, b_c·bs))."""
    br, bc, bs, _ = blocks.shape
    corr = torch.einsum("iak,kjb->ijab", p.float().reshape(br, bs, p.shape[-1]),
                        m.float().reshape(m.shape[0], bc, bs))
    return (blocks.float() - corr).to(blocks.dtype)


def _smw_inverse_blocks(blocks: torch.Tensor, u: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    p = _blocks_apply(blocks, u)                    # A⁻¹ U
    qt = _blocks_apply_t(blocks, v)                 # (Vᵀ A⁻¹)ᵀ
    cap = _eye(u.shape[1], blocks) + v.float().T @ p
    m = torch.linalg.solve(cap, qt.T)               # (k, n)
    return _smw_correction_blocks(blocks, p, m)


# ---------------------------------------------------------------------------
# Sharded path: the block path on a mesh-laid-out grid
# ---------------------------------------------------------------------------


def _sbm():
    # Late import: core must not import the parallel layer at module scope.
    from ..parallel import sharded_blockmatrix

    return sharded_blockmatrix


def _is_sharded(x) -> bool:
    return isinstance(x, _sbm().ShardedBlockMatrix)


def _replicated(t: torch.Tensor, mesh):
    from ..parallel import collectives as col

    return col.distribute(t, (None,) * t.ndim, mesh)


def _correction_sharded(a, p, m, op: str):
    """`_smw_correction_blocks` on each shard: P's rows of the shard's
    block rows, M's columns of its block columns, both gathered."""
    from ..parallel import collectives as col

    sbm, bs = _sbm(), a.block_size

    def corr(shard, r, c):
        (i0, i1), (j0, j1) = r[0], r[1]
        p_rows = col.fetch(p, ((i0 * bs, i1 * bs), (0, p.shape[1])), c,
                           "gather")
        m_cols = col.fetch(m, ((0, m.shape[0]), (j0 * bs, j1 * bs)), c,
                           "gather")
        return _smw_correction_blocks(shard, p_rows, m_cols)

    out = col.map_regions(a.dist, corr)
    return sbm.ShardedBlockMatrix(sbm._constrain(out, op, a.axes), a.axes)


def _smw_inverse_sharded(inv, u: torch.Tensor, v: torch.Tensor):
    """The block path's Woodbury revision with every panel laid out on the
    mesh: P = A⁻¹U and Q = (VᵀA⁻¹)ᵀ split by rows, the k×k capacitance
    solve once a device, and the correction on each shard."""
    from ..parallel import collectives as col

    sbm = _sbm()
    a = inv.constrain("smw_input")
    mesh, axes = a.dist.mesh, a.axes
    layout = sbm._panel_layout(a.n, mesh, axes)
    ud, vd = _replicated(u, mesh), _replicated(v, mesh)
    p = sbm._constrain_panel(col.row_apply(a.dist, ud, layout, _blocks_apply),
                             "smw_panel", axes)
    qt = sbm._constrain_panel(
        col.row_apply(a.dist, vd, layout, _blocks_apply_t, by_cols=True),
        "smw_panel", axes)
    m = col.once_per_device(
        lambda pf, qf, vf: torch.linalg.solve(
            _eye(u.shape[1], pf) + vf.float().T @ pf, qf.T),
        [p, qt, vd], (None, None), mesh)
    return _correction_sharded(a, p, m, "smw_update")


def _apply_inverse_sharded(inv, rhs: torch.Tensor) -> torch.Tensor:
    """X·B with the panel split by rows over `data`, gathered onto B's
    device."""
    from ..parallel import collectives as col

    sbm = _sbm()
    a = inv.constrain("apply_input")
    mesh = a.dist.mesh
    out = col.row_apply(a.dist, _replicated(rhs.to(a.device), mesh),
                        sbm._panel_layout(a.n, mesh, a.axes),
                        lambda blk, xf: _blocks_apply(blk, xf).to(rhs.dtype))
    out = sbm._constrain_panel(out, "apply_inverse", a.axes)
    return col.gather(out, rhs.device if rhs.device.type == a.device.type
                      else a.device)


def _add_low_rank_sharded(a, u: torch.Tensor, v: torch.Tensor):
    a = a.constrain("add_input")
    mesh = a.dist.mesh
    return _correction_sharded(a, _replicated(-u.float(), mesh),
                               _replicated(v.float().T, mesh), "add_low_rank")


# ---------------------------------------------------------------------------
# Public dispatchers
# ---------------------------------------------------------------------------


def smw_update_inverse(inv, u: torch.Tensor, v: torch.Tensor):
    """Woodbury-revise a maintained inverse of A for A' = A + U Vᵀ.

    `inv`: dense (n, n) tensor, `BlockMatrix` or `ShardedBlockMatrix`
    holding A⁻¹; returns the same representation holding (A + U Vᵀ)⁻¹ in
    O(n²k). U, V: (n, k), or (n,) vectors (Sherman–Morrison). The sharded
    path keeps every panel and the output grid laid out on the mesh (no
    gather to dense); off the mesh it is bitwise the BlockMatrix path.
    """
    u, _ = _as_panel(u)
    v, _ = _as_panel(v)
    _bump("smw_updates")
    if _is_sharded(inv):
        return _smw_inverse_sharded(inv, u.to(inv.device), v.to(inv.device))
    if isinstance(inv, BlockMatrix):
        return BlockMatrix(_smw_inverse_blocks(inv.blocks, u, v))
    return _smw_inverse_dense(inv, u, v)


def smw_update_solve(inv, u: torch.Tensor, v: torch.Tensor,
                     rhs: torch.Tensor) -> torch.Tensor:
    """Solve (A + U Vᵀ) x = b from the BASE inverse, never forming A'⁻¹.

    x = A⁻¹b − (A⁻¹U) (I + VᵀA⁻¹U)⁻¹ Vᵀ (A⁻¹b). Same `inv`
    representations as `smw_update_inverse`; `rhs` is (n, c) or (n,).
    """
    u, _ = _as_panel(u)
    v, _ = _as_panel(v)
    rhs2, vector = _as_panel(rhs)
    if isinstance(inv, BlockMatrix) or _is_sharded(inv):
        x0 = apply_inverse(inv, rhs2).float()
        p = apply_inverse(inv, u).float()
        v32 = v.float()
        cap = _eye(u.shape[1], p) + v32.T @ p
        x = (x0 - p @ torch.linalg.solve(cap, v32.T @ x0)).to(rhs.dtype)
    else:
        x = _smw_solve_dense(inv, u, v, rhs2)
    return x[:, 0] if vector else x


def apply_inverse(inv, rhs: torch.Tensor, *, precision=None) -> torch.Tensor:
    """X·B for a maintained inverse in any representation (dense,
    BlockMatrix, ShardedBlockMatrix); B (n, c) or (n,).

    The O(n²c) serving path: one panel product against the resident
    inverse. `precision` (PrecisionPolicy | preset string | None) selects
    the dense path's compute and accumulate dtypes: under the "bf16" policy
    a bf16-stored inverse multiplies at bf16 with an f32 accumulator, on
    the GEMM kernel's bf16 body on the card, instead of being upcast. The
    block representation accumulates in f32 and ignores it.
    """
    rhs2, vector = _as_panel(rhs)
    if _is_sharded(inv):
        _bump("solve_applies")
        x = _apply_inverse_sharded(inv, rhs2)
    elif isinstance(inv, BlockMatrix):
        _bump("solve_applies")
        x = _blocks_apply(inv.blocks, rhs2).to(rhs.dtype)
    else:
        policy = None if precision is None else resolve_precision(precision)
        if policy is not None and not policy.is_exact:
            x = _apply_inverse_dense_lowp(
                inv, rhs2, torch_dtype(policy.resolve_compute(inv.dtype)),
                torch_dtype(policy.accum_dtype))
        else:
            acc = _accum(inv.dtype)
            x = (inv.to(acc) @ rhs2.to(acc)).to(rhs.dtype)
    return x[:, 0] if vector else x


def _apply_inverse_dense_lowp(inv: torch.Tensor, rhs: torch.Tensor,
                              compute: torch.dtype, accum: torch.dtype
                              ) -> torch.Tensor:
    # The low-precision serve GEMM: operands stay at `compute`, the sum at
    # `accum`. An f32 accumulator is the GEMM kernel's own contract (its
    # plain version on the CPU); an f64 one upcasts.
    a, b = inv.to(compute), rhs.to(compute)
    if accum == torch.float32:
        out = mm_ops.matmul(a, b, out_dtype=torch.float32)
    else:
        out = a.to(accum) @ b.to(accum)
    return out.to(rhs.dtype)


def add_low_rank(a, u: torch.Tensor, v: torch.Tensor):
    """A + U Vᵀ in the operand's own representation (the matrix-side twin
    of `smw_update_inverse`)."""
    u, _ = _as_panel(u)
    v, _ = _as_panel(v)
    if _is_sharded(a):
        return _add_low_rank_sharded(a, u.to(a.device), v.to(a.device))
    if isinstance(a, BlockMatrix):
        return BlockMatrix(_smw_correction_blocks(a.blocks, -u.float(),
                                                  v.float().T))
    return (a.float() + u.float() @ v.float().T).to(a.dtype)


# ---------------------------------------------------------------------------
# Block row/column replacement as a rank-2·bs Woodbury update
# ---------------------------------------------------------------------------


def block_update_factors(delta_row: torch.Tensor, index: int, n: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Factor a symmetric block row+column replacement as (U, V), Δ = U Vᵀ.

    `delta_row` = new − old block row `index` (bs, n); the matching column
    delta is its transpose, and `delta_row[:, index·bs:(index+1)·bs]`,
    counted once, must itself be symmetric. Returns (n, 2bs) factors:

        Δ = E_r W + (Wᵀ − E_r D) E_rᵀ,  U = [E_r | Wᵀ − E_r D], V = [Wᵀ | E_r]
    """
    bs = delta_row.shape[0]
    if tuple(delta_row.shape) != (bs, n):
        raise ValueError(f"delta_row must be (bs, n), got {tuple(delta_row.shape)}")
    if not 0 <= index < n // bs:
        raise ValueError(f"block index {index} out of range for n={n}, bs={bs}")
    lo, hi = index * bs, (index + 1) * bs
    e = torch.zeros((n, bs), dtype=delta_row.dtype, device=delta_row.device)
    e[lo:hi] = torch.eye(bs, dtype=delta_row.dtype, device=delta_row.device)
    wt = delta_row.T
    corrected = wt.clone()
    corrected[lo:hi] -= delta_row[:, lo:hi]          # Wᵀ − E_r D
    return torch.cat([e, corrected], dim=1), torch.cat([wt, e], dim=1)


# ---------------------------------------------------------------------------
# Drift tracking
# ---------------------------------------------------------------------------


def estimate_inverse_residual(apply_a, inv, generator: torch.Generator | None,
                              n: int, probes: int = 2, *,
                              precision=None) -> float:
    """Probe estimate of ‖A X − I‖∞: max_z ‖A(Xz) − z‖∞ / ‖z‖∞, O(n²·probes).

    `apply_a(panel)` applies the CURRENT matrix A' to an (n, probes) panel;
    `inv` is the maintained inverse in either `apply_inverse`
    representation. The probes are standard normal draws from `generator`
    (a `torch.Generator` on inv's device, or None for the default one).
    A randomized lower bound on the true residual, and the drift signal the
    refactor policy compares with the dtype's tolerance. `precision`
    forwards to `apply_inverse`, so the probe measures the product the
    policy serves with.
    """
    device = inv.device
    z = torch.randn((n, probes), generator=generator, dtype=torch.float32,
                    device=device)
    x = apply_inverse(inv, z, precision=precision)
    r = apply_a(x).float() - z
    return float(r.abs().max() / z.abs().max())


@dataclasses.dataclass
class DriftTracker:
    """Accumulated-churn state of one maintained inverse.

    `tolerance` defaults from the conformance table's dtype-aware bound
    (`verify.residual_tolerance`); `exceeded` is the drift half of the
    refactor trigger (the cost half is the planner's refactor policy).
    """

    tolerance: float
    update_rank: int = 0
    updates: int = 0
    residual_est: float = 0.0

    @classmethod
    def for_dtype(cls, dtype, scale: float = 10.0) -> "DriftTracker":
        """Drift bound = `scale` × the dtype's conformance residual bound:
        a fresh factorization sits near the bound itself, so drift is only
        meaningful some way above it."""
        return cls(tolerance=scale * residual_tolerance(dtype))

    def note(self, rank: int) -> None:
        self.update_rank += int(rank)
        self.updates += 1

    @property
    def exceeded(self) -> bool:
        return self.residual_est > self.tolerance

    def reset(self) -> None:
        self.update_rank = 0
        self.updates = 0
        self.residual_est = 0.0
