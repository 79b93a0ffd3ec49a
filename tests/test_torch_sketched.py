"""The sketched (degraded-mode) approximate inverse: the PyTorch port
against the JAX package.

The matrices are made once on the CPU from a numpy seed and handed bit for
bit to both packages. The sketch's start vector and the residual probes
are random draws, a `torch.Generator` in the port and a `jax.random` key in
the reference, so the two runs differ by their draws: the parity is that
both converge, within ±1 Newton–Schulz sweep of each other, and that the
port's returned residual estimate is within the tolerance and near the
true residual.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sketched_approx_inverse as j_sketched
from repro_torch import bridge
from repro_torch.core import (SketchedInverse, count_ops, multiply_engine,
                              sketched_approx_inverse, testing, verify)

N = 128
WELL_POSED = ["spd", "diag_dominant", "block_banded_spd"]


def _matrix(family: str, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng([seed, WELL_POSED.index(family)])
    kwargs = {"band": 32} if family == "block_banded_spd" else {}
    return testing.MATRIX_FAMILIES[family](N, rng, device="cpu", **kwargs)


@pytest.mark.parametrize("family", WELL_POSED)
def test_sketched_inverse_converges_like_the_reference(family):
    a = _matrix(family)
    tol = verify.residual_tolerance(torch.float32)
    got = sketched_approx_inverse(a, torch.Generator().manual_seed(1))
    want = j_sketched(jnp.asarray(bridge.to_numpy(a)), jax.random.PRNGKey(1))
    assert isinstance(got, SketchedInverse)
    assert got.converged and want.converged
    assert got.residual_est <= tol
    assert abs(got.sweeps - want.sweeps) <= 1, (got.sweeps, want.sweeps)
    assert got.inverse.dtype == a.dtype and got.inverse.shape == a.shape
    # the estimate is a probe of the true residual, which the polished
    # inverse also meets
    assert verify.inverse_residual(a, got.inverse) <= 10 * tol
    fields = {f.name for f in dataclasses.fields(SketchedInverse)}
    assert fields == {"inverse", "residual_est", "sweeps", "converged"}


def test_sketched_inverse_under_the_kernel_engine_counts_its_sweeps():
    a = _matrix("spd")
    with multiply_engine("cuda"), count_ops() as counts:
        got = sketched_approx_inverse(a, torch.Generator().manual_seed(2),
                                      block_size=32)
    # two block multiplies a Newton–Schulz sweep, each over the 4x4 grid
    assert got.converged
    assert counts.multiplies == 2 * got.sweeps
    assert counts.block_gemms == 2 * got.sweeps * 4 ** 3
    einsum = sketched_approx_inverse(a, torch.Generator().manual_seed(2),
                                     block_size=32)
    assert einsum.sweeps == got.sweeps
    assert float((einsum.inverse - got.inverse).abs().max()) < 1e-4


def test_sketched_inverse_stops_at_max_sweeps_and_reports_it():
    a = _matrix("spd")
    got = sketched_approx_inverse(a, torch.Generator().manual_seed(3),
                                  max_sweeps=2)
    assert got.sweeps == 2 and not got.converged
    assert got.residual_est > verify.residual_tolerance(torch.float32)
