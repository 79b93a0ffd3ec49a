"""Plain PyTorch versions of the leaf kernels: Gauss-Jordan inverses and
the blocked triangular solve.

`gauss_jordan_ref` and `blocked_gauss_jordan_ref` are step-exact: the same
pivot-free sweeps in the same order of operations as the kernels, so a
difference between a kernel and its plain version is a kernel fault, and
a difference from `leaf_inverse_ref` is the error of unpivoted
Gauss-Jordan itself. `blocked_triangular_solve_ref` takes the steps of the
JAX package's `triangular_solve_pallas` in its order; `triangular_solve_ref`
is the LAPACK-semantics oracle beside it.

`blocked_gauss_jordan_inplace_model` and `triangular_solve_dinv_model`
take the steps of the CUDA kernels' designs, in f32 and in their order, so
the CPU tests can hold that algebra (the in-place bookkeeping, the flip,
`unit_diagonal`, panels that do not divide 64) against the JAX kernels.
The wrappers never call them.
"""

from __future__ import annotations

import torch

__all__ = ["leaf_inverse_ref", "gauss_jordan_ref", "blocked_gauss_jordan_ref",
           "triangular_solve_ref", "blocked_triangular_solve_ref",
           "blocked_gauss_jordan_inplace_model", "triangular_solve_dinv_model"]


def leaf_inverse_ref(blocks: torch.Tensor) -> torch.Tensor:
    """LAPACK-semantics oracle: batched torch.linalg.inv in f32."""
    return torch.linalg.inv(blocks.float()).to(blocks.dtype)


def _augmented(blocks: torch.Tensor) -> torch.Tensor:
    batch, bs, _ = blocks.shape
    eye = torch.eye(bs, dtype=torch.float32, device=blocks.device)
    return torch.cat([blocks.float(), eye.expand(batch, bs, bs)], dim=2)


def _sweep(m: torch.Tensor, j: int, col: int) -> torch.Tensor:
    """One pivot-free step on rows `m`: pivot row j, pivot column col."""
    row = m[:, j, :] / m[:, j, col:col + 1]
    fac = m[:, :, col].clone()
    fac[:, j] = 0.0
    m = m - fac[:, :, None] * row[:, None, :]
    m[:, j, :] = row
    return m


def gauss_jordan_ref(blocks: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Scalar pivot-free Gauss-Jordan, one column a step, in place on bs x bs.

    Step k of the sweep on [A | I] turns column k of A into e_k and fills
    column bs + k of the right half, which was e_k until then. The in-place
    sweep stores that new column where column k of A was, so each step
    touches bs live columns: the pivot row is m[k] / piv with m[k, k] read
    as 1 (giving 1 / piv), and the new column k of the other rows is
    0 - fac_i * (1 / piv). The dead columns of the full sweep are exact
    0 / 1, so the result equals the full sweep's bit for bit.
    """
    bs = blocks.shape[1]
    m = blocks.float().clone()
    for k in range(bs):
        piv = m[:, k, k:k + 1]
        row = m[:, k, :] / piv
        row[:, k] = torch.ones_like(piv[:, 0]) / piv[:, 0]
        fac = m[:, :, k].clone()
        fac[:, k] = 0.0
        m[:, :, k] = 0.0
        m = m - fac[:, :, None] * row[:, None, :]
        m[:, k, :] = row
    return m.to(out_dtype or blocks.dtype)


def blocked_gauss_jordan_ref(blocks: torch.Tensor, panel: int,
                             out_dtype=None) -> torch.Tensor:
    """Blocked pivot-free Gauss-Jordan: a t-step mini-sweep inside each
    t-row panel, then one rank-t update of every other row."""
    bs = blocks.shape[1]
    t = panel
    m = _augmented(blocks)
    for base in range(0, bs, t):
        pan = m[:, base:base + t, :]
        for j in range(t):
            pan = _sweep(pan, j, base + j)
        factors = m[:, :, base:base + t].clone()
        factors[:, base:base + t, :] = 0.0
        m = m - factors @ pan
        m[:, base:base + t, :] = pan
    return m[:, :, bs:].to(out_dtype or blocks.dtype)


def triangular_solve_ref(t: torch.Tensor, b: torch.Tensor, *, lower: bool = True,
                         unit_diagonal: bool = False) -> torch.Tensor:
    """LAPACK-semantics oracle: batched solve_triangular in f32, reading only
    the targeted triangle of `t`."""
    x = torch.linalg.solve_triangular(t.float(), b.float(), upper=not lower,
                                      unitriangular=unit_diagonal)
    return x.to(b.dtype)


def blocked_triangular_solve_ref(t: torch.Tensor, b: torch.Tensor, panel: int, *,
                                 lower: bool = True,
                                 unit_diagonal: bool = False) -> torch.Tensor:
    """Solve T X = B for (batch, bs, bs) T and (batch, bs, k) B, panel by
    panel (bottom-up when not `lower`): a t-step Gauss-Jordan sweep on
    [D | rhs_p] for the t x t diagonal block D, built from the targeted
    triangle only (1 on its diagonal under `unit_diagonal`), then one
    rank-t update of the rows still pending. X has b's dtype."""
    bs = t.shape[1]
    npan = bs // panel
    tm = t.float()
    w = b.float().clone()
    eye = torch.eye(panel, dtype=torch.float32, device=t.device)
    for pi in range(npan):
        base = (pi if lower else npan - 1 - pi) * panel
        d = tm[:, base:base + panel, base:base + panel]
        if unit_diagonal:
            d = (torch.tril(d, -1) if lower else torch.triu(d, 1)) + eye
        else:
            d = torch.tril(d) if lower else torch.triu(d)
        aug = torch.cat([d, w[:, base:base + panel, :]], dim=2)
        for j in range(panel):
            aug = _sweep(aug, j, j)
        x_p = aug[:, :, panel:]
        rows = slice(base + panel, bs) if lower else slice(0, base)
        w[:, rows] -= tm[:, rows, base:base + panel] @ x_p
        w[:, base:base + panel] = x_p
    return w.to(b.dtype)


def _pivot_block_inverse(d: torch.Tensor) -> torch.Tensor:
    """D⁻¹ as the blocked kernel's panel launch forms it: up to t = 32 the
    in-place sweep; above, D padded to 64 x 64 with the identity and
    inverted as 2 x 2 blocks of 32 (A, B; C, E): A⁻¹ and S⁻¹ by the sweep,
    X = −A⁻¹B, Y = −CA⁻¹, S = E + CX, then [A⁻¹ + X·S⁻¹Y, XS⁻¹ ; S⁻¹Y, S⁻¹]."""
    batch, t, _ = d.shape
    if t <= 32:
        return gauss_jordan_ref(d, torch.float32)
    pad = torch.eye(64, dtype=torch.float32, device=d.device).repeat(batch, 1, 1)
    pad[:, :t, :t] = d
    a = gauss_jordan_ref(pad[:, :32, :32], torch.float32)
    x = -(a @ pad[:, :32, 32:])
    y = -(pad[:, 32:, :32] @ a)
    s = gauss_jordan_ref(pad[:, 32:, 32:] + pad[:, 32:, :32] @ x, torch.float32)
    bl = s @ y
    inv = torch.cat([torch.cat([a + x @ bl, x @ s], 2), torch.cat([bl, s], 2)], 1)
    return inv[:, :t, :t]


def blocked_gauss_jordan_inplace_model(blocks: torch.Tensor, panel: int,
                                       out_dtype=None) -> torch.Tensor:
    """The blocked kernel's step order, in place on bs x bs: for each panel
    P, D⁻¹ = `_pivot_block_inverse` of M_PP, W = [D⁻¹ ; −M_QP·D⁻¹] (bs x t),
    R = the panel rows with their P columns replaced by I (t x bs), then
    M ← (M with rows P and columns P zeroed) + W·R."""
    bs = blocks.shape[1]
    t = panel
    m = blocks.float().clone()
    eye = torch.eye(t, dtype=torch.float32, device=blocks.device)
    for base in range(0, bs, t):
        p = slice(base, base + t)
        dinv = _pivot_block_inverse(m[:, p, p])
        w = -(m[:, :, p] @ dinv)
        w[:, p] = dinv
        r = m[:, p, :].clone()
        r[:, :, p] = eye
        m[:, p, :] = 0.0
        m[:, :, p] = 0.0
        m = m + w @ r
    return m.to(out_dtype or blocks.dtype)


def _lower_inverse(d: torch.Tensor, unit: bool) -> torch.Tensor:
    """Inverse of a batch of lower-triangular t x t blocks, row by row, as
    each thread of the kernel substitutes its column of the identity."""
    t = d.shape[1]
    eye = torch.eye(t, dtype=torch.float32, device=d.device)
    x = torch.zeros_like(d)
    for r in range(t):
        s = eye[r] - (d[:, r, :r, None] * x[:, :r, :]).sum(1)
        x[:, r] = s if unit else s / d[:, r, r:r + 1]
    return x


def triangular_solve_dinv_model(t: torch.Tensor, b: torch.Tensor, panel: int, *,
                                lower: bool = True,
                                unit_diagonal: bool = False) -> torch.Tensor:
    """The triangular-solve kernel's step order: the upper sweep as the lower
    one on T flipped about both axes (B and X by rows); every D_p⁻¹ first;
    P = [−D_p⁻¹·T[p, <p] | D_p⁻¹] panel row by panel row; then for each
    panel X_p = P[p, :base+t]·Z[:base+t], where Z holds X in its first base
    rows and still B_p in the next t. X has b's dtype."""
    bs = t.shape[1]
    tm = t.float() if lower else t.float().flip(1, 2)
    z = b.float().clone() if lower else b.float().flip(1)
    tri = torch.tril(tm, -1)
    eye = torch.eye(panel, dtype=torch.float32, device=t.device)
    pk = torch.zeros_like(tm)
    for base in range(0, bs, panel):
        p = slice(base, base + panel)
        d = tri[:, p, p] + (eye if unit_diagonal else torch.diag_embed(
            torch.diagonal(tm[:, p, p], dim1=1, dim2=2)))
        dinv = _lower_inverse(d, unit_diagonal)
        pk[:, p, :base] = -(dinv @ tri[:, p, :base])
        pk[:, p, p] = dinv
    for base in range(0, bs, panel):
        z[:, base:base + panel] = pk[:, base:base + panel, :base + panel] @ z[:, :base + panel]
    return (z if lower else z.flip(1)).to(b.dtype)
