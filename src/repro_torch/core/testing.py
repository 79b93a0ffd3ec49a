"""Test-matrix generators (the conformance zoo).

The random draws come from a `numpy.random.Generator` that the caller
passes in, so the same seed gives the same matrix on every device; the
products that shape the matrix run in torch on `device`. They cannot give
`jax.random`'s draws, so a comparison with the JAX package builds its
matrix here (or with numpy) and feeds the same bits to both.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["make_spd", "make_spd_batch", "make_diag_dominant",
           "make_ill_conditioned_spd", "make_block_banded_spd", "MATRIX_FAMILIES"]


def _normal(rng: np.random.Generator, n: int, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal((n, n), dtype=np.float32)).to(dev)


def make_spd(n: int, rng: np.random.Generator, dtype=torch.float32,
             cond_boost: float = 1.0,
             device: str | torch.device = DEFAULT_DEVICE) -> torch.Tensor:
    """Well-conditioned SPD: B Bᵀ/n + boost·I (condition ~ O(10)/boost)."""
    dev = resolve_device(device)
    b = _normal(rng, n, dev)
    a = b @ b.T / n
    a.diagonal().add_(cond_boost)
    return a.to(dtype)


def make_diag_dominant(n: int, rng: np.random.Generator, dtype=torch.float32,
                       device: str | torch.device = DEFAULT_DEVICE
                       ) -> torch.Tensor:
    """Strictly diagonally dominant (invertible, unpivoted-LU safe)."""
    dev = resolve_device(device)
    m = torch.from_numpy(
        rng.uniform(-1.0, 1.0, (n, n)).astype(np.float32)).to(dev)
    d = m.abs().sum(dim=1) + 1.0
    return (m + torch.diag(d)).to(dtype)


def make_ill_conditioned_spd(n: int, rng: np.random.Generator,
                             dtype=torch.float32, cond: float = 1e6,
                             device: str | torch.device = DEFAULT_DEVICE
                             ) -> torch.Tensor:
    """SPD with a prescribed condition number: Q diag(λ) Qᵀ with λ
    log-spaced in [1/cond, 1]."""
    dev = resolve_device(device)
    q, _ = torch.linalg.qr(_normal(rng, n, dev))
    lam = torch.logspace(-float(np.log10(cond)), 0.0, n, dtype=torch.float32,
                         device=dev)
    return ((q * lam[None, :]) @ q.T).to(dtype)


def make_block_banded_spd(n: int, rng: np.random.Generator,
                          dtype=torch.float32, band: int = 32,
                          bandwidth: int = 1,
                          device: str | torch.device = DEFAULT_DEVICE
                          ) -> torch.Tensor:
    """Block-banded SPD: F Fᵀ of a block-banded factor, plus I."""
    if n % band:
        raise ValueError(f"n={n} not divisible by band={band}")
    dev = resolve_device(device)
    nb = n // band
    f = _normal(rng, n, dev) / n ** 0.5
    i = torch.arange(nb, device=dev)
    mask = ((i[:, None] - i[None, :]).abs() <= bandwidth).float()
    f = f * torch.kron(mask, torch.ones((band, band), device=dev))
    out = f @ f.T
    out.diagonal().add_(1.0)
    return out.to(dtype)


def make_spd_batch(batch: int, n: int, rng: np.random.Generator,
                   dtype=torch.float32, cond_boost: float = 1.0,
                   device: str | torch.device = DEFAULT_DEVICE) -> torch.Tensor:
    """(batch, n, n) stack of independent SPD matrices: `make_spd` drawn
    `batch` times in a row from `rng`."""
    return torch.stack([make_spd(n, rng, dtype=dtype, cond_boost=cond_boost,
                                 device=device) for _ in range(batch)])


# name -> generator(n, rng, dtype=..., device=...): the square zoo. Batched
# families have another arity and go through `make_spd_batch`.
MATRIX_FAMILIES = {
    "spd": make_spd,
    "diag_dominant": make_diag_dominant,
    "ill_conditioned_spd": make_ill_conditioned_spd,
    "block_banded_spd": make_block_banded_spd,
}
