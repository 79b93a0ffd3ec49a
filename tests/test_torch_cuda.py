"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips where there
is none: a CUDA kernel has no CPU mode, and on the CPU the wrappers run
the plain versions, which `test_torch_kernels.py` holds to the JAX
package. This file imports only torch, numpy and the port, so it runs on
a machine without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import (count_ops, lu_inverse_dense, multiply_engine,
                              spin_inverse_dense, testing, verify)
from repro_torch.kernels.leaf_inverse import kernel as gj, ref as gj_ref
from repro_torch.kernels.matmul import kernel as mm, ref as mm_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spd_blocks(batch: int, bs: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng([seed, bs])
    return torch.stack([testing.make_spd(bs, rng, device=device)
                        for _ in range(batch)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (100, 37, 129), (256, 512, 384),
                                   (130, 17, 260)])
def test_gemm_kernels_match_plain(cuda_device, dtype, m, k, n):
    g = torch.Generator(device="cpu").manual_seed(m * k + n)
    a, b, c = (torch.randn(s, generator=g).to(cuda_device, dtype)
               for s in ((m, k), (k, n), (m, n)))
    kernels.reset_launch_counts()
    pairs = [(mm.matmul_cuda(a, b), mm_ref.matmul_ref(a, b)),
             (mm.schur_update_cuda(c, a, b, alpha=-1.0, beta=1.0),
              mm_ref.schur_update_ref(c, a, b, -1.0, 1.0)),
             (mm.schur_update_cuda(c, a, b, out_dtype=torch.float32),
              mm_ref.schur_update_ref(c, a, b, out_dtype=torch.float32))]
    assert kernels.launch_counts()["matmul"] == 1
    assert kernels.launch_counts()["schur_update"] == 2
    for got, want in pairs:
        assert got.dtype == want.dtype and got.shape == want.shape
        scale = float(want.float().abs().max()) + 1e-6
        # f32 out: summation order only; bf16/f16 out: one ulp of the
        # largest entry (2^-7 for bf16, 2^-10 for f16).
        tol = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7,
               torch.float16: 2.0 ** -10}[got.dtype]
        assert float((got.float() - want.float()).abs().max()) <= tol * scale


def test_gemm_takes_row_strided_views(cuda_device):
    g = torch.Generator(device="cpu").manual_seed(0)
    big = torch.randn(64, 96, generator=g).to(cuda_device)
    a, b = big[:, :40], big[:40, 50:90]          # row stride 96, unit columns
    got = mm.matmul_cuda(a, b)
    want = mm_ref.matmul_ref(a, b)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    with pytest.raises(ValueError):
        mm.matmul_cuda(a.T, b[:, :40].T)          # column-major operands


@pytest.mark.parametrize("batch,bs", [(1, 64), (3, 128), (1, 256), (2, 48)])
def test_leaf_kernels_match_plain(cuda_device, batch, bs):
    x = _spd_blocks(batch, bs, 6, cuda_device)
    kernels.reset_launch_counts()
    got = gj.leaf_inverse_cuda(x)
    want = gj_ref.gauss_jordan_ref(x)
    # The same rounding step for step: equal up to ~1 ulp.
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    got = gj.blocked_leaf_inverse_cuda(x)
    want = gj_ref.blocked_gauss_jordan_ref(x, gj.default_panel(bs))
    # The rank-t updates sum in another order.
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert kernels.launch_counts()["gauss_jordan"] == 1
    assert kernels.launch_counts()["blocked_gauss_jordan"] == 1
    got = gj.leaf_inverse_cuda(x.to(torch.bfloat16), out_dtype=torch.float32)
    assert got.dtype == torch.float32
    with pytest.raises(ValueError):
        gj.leaf_inverse_cuda(x.transpose(1, 2))      # not contiguous


@pytest.mark.parametrize("leaf", ["cuda", "gauss_jordan"])
def test_spin_on_the_card_matches_cpu(cuda_device, leaf):
    rng = np.random.default_rng(1)
    a = testing.make_spd(512, rng, device="cpu")
    kernels.reset_launch_counts()
    with count_ops() as counts:
        x = spin_inverse_dense(a, 64, leaf, engine="cuda")
    launches = kernels.launch_counts()
    assert x.device.type == "cuda"
    assert launches["matmul"] == 4 * 7 and launches["schur_update"] == 2 * 7
    key = "blocked_gauss_jordan" if leaf == "cuda" else "gauss_jordan"
    assert launches[key] == 8
    verify.assert_paper_op_counts(8, counts)
    assert verify.inverse_residual(a.to(cuda_device), x) < 1e-3
    x_cpu = spin_inverse_dense(a, 64, leaf, engine="cuda", device="cpu")
    assert float((x.cpu() - x_cpu).abs().max()) <= 1e-4 * float(x_cpu.abs().max())


def test_lu_and_conformance_on_the_card(cuda_device):
    rng = np.random.default_rng(2)
    a = testing.make_diag_dominant(256, rng)
    x = lu_inverse_dense(a, 32, engine="cuda")
    assert verify.inverse_residual(a, x) < 1e-3
    with multiply_engine("cuda"):
        reports = verify.run_conformance(grids=(1, 2, 4), block_size=32,
                                         leaf_solver="cuda")
    assert all(r.ok for r in reports), [r.as_dict() for r in reports]
