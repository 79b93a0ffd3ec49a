"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips where there
is none: a CUDA kernel has no CPU mode, and on the CPU the wrappers run
the plain versions, which `test_torch_kernels.py` holds to the JAX
package. This file imports only torch, numpy and the port, so it runs on
a machine without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import (PRECISION_PRESETS, count_ops, lu_inverse_dense,
                              multiply_engine, spin_inverse_dense,
                              spin_solve_dense, strassen_matmul, testing,
                              verify)
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import kernel as fa, ref as fa_ref
from repro_torch.kernels.leaf_inverse import kernel as gj, ref as gj_ref
from repro_torch.kernels.matmul import kernel as mm, ops as mm_ops, ref as mm_ref
from repro_torch.models import attention, transformer as T
from repro_torch.serving import Request, ServingEngine

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


# ---------------------------------------------------------------------------
# The tensor-core GEMM body (3xTF32 for f32)
# ---------------------------------------------------------------------------

_GEMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (100, 37, 129), (1024, 1024, 1024),
                                   (4096, 4096, 4096)])
def test_gemm_tensor_core_body_matches_plain(cuda_device, dtype, m, k, n):
    g = torch.Generator(device="cpu").manual_seed(m + k + n)
    a, b, c = (torch.randn(s, generator=g).to(cuda_device, dtype)
               for s in ((m, k), (k, n), (m, n)))
    kernels.reset_launch_counts()
    pairs = [(mm.matmul_cuda(a, b), mm_ref.matmul_ref(a, b)),
             (mm.schur_update_cuda(c, a, b), mm_ref.schur_update_ref(c, a, b)),
             (mm.schur_update_cuda(c, a, b, alpha=-1.0, beta=1.0, out_dtype=torch.float32),
              mm_ref.schur_update_ref(c, a, b, -1.0, 1.0, out_dtype=torch.float32))]
    launches = kernels.launch_counts()
    assert launches["gemm_tensor_core"] == 3 and launches["gemm_ffma"] == 0
    for got, want in pairs:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert bool(torch.isfinite(got.float()).all())
        scale = float(want.float().abs().max()) + 1e-6
        # f32: the split's 3·2^-22 a product and the summation order, far
        # under 1e-5 of the largest entry; bf16/f16 out: one ulp of it.
        err = float((got.float() - want.float()).abs().max())
        assert err <= _GEMM_TOL[got.dtype] * scale, (err, scale)


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (100, 37, 129), (1024, 1024, 1024),
                                   (4096, 4096, 4096)])
def test_gemm_tensor_core_body_matches_the_split(cuda_device, m, k, n):
    g = torch.Generator(device="cpu").manual_seed(7 * m + n)
    a, b = (torch.randn(s, generator=g).to(cuda_device) for s in ((m, k), (k, n)))
    got = mm.matmul_cuda(a, b).double()
    # matmul_split_ref's three products, summed in f64: what the kernel sums
    # in f32. They differ by the f32 summation error, about √k·2^-24 of the
    # partial sums (≈ 2^-23 of Σ|a||b| at k = 1024). One dropped lo·hi term
    # would move an entry by about √k·2^-12 of |a||b|: ≈ 2^-17 of Σ|a||b|.
    (a_hi, a_lo), (b_hi, b_lo) = (tuple(p.double() for p in mm_ref.tf32_split_ref(x))
                                  for x in (a, b))
    want = (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
    scale = a.double().abs() @ b.double().abs()
    assert float(((got - want).abs() / scale).max()) <= 2.0 ** -18
    # and matmul_split_ref itself, in f32, within the same bound
    split = mm_ref.matmul_split_ref(a, b).double()
    assert float(((split - want).abs() / scale).max()) <= 2.0 ** -18


def test_gemm_pack_is_the_tf32_split_bitwise(cuda_device):
    g = torch.Generator(device="cpu").manual_seed(3)
    a = torch.randn(70, 45, generator=g)
    a[0, :8] = torch.tensor([0.0, -0.0, 1e-40, -3e-39, 1.4e-45, 3e38, -1e38, 1.0 + 2 ** -11])
    b = torch.randn(45, 33, generator=g) * 1e-3
    a_packed, b_packed = mm.gemm_pack_cuda(a.to(cuda_device), b.to(cuda_device))
    assert a_packed.shape == (2, 70, 48) and b_packed.shape == (2, 33, 48)
    for packed, x in ((a_packed, a), (b_packed, b.T)):
        hi, lo = mm_ref.tf32_split_ref(x.contiguous())
        got = packed[:, :, :x.shape[1]].cpu()
        assert torch.equal(got[0].view(torch.int32), hi.view(torch.int32))
        assert torch.equal(got[1].view(torch.int32), lo.view(torch.int32))
    a16, b16 = mm.gemm_pack_cuda(a.to(cuda_device, torch.bfloat16), b.to(cuda_device, torch.bfloat16))
    assert a16.shape == (1, 70, 48)
    assert torch.equal(a16[0, :, :45].cpu(), a.to(torch.bfloat16))
    assert torch.equal(b16[0, :, :45].cpu(), b.T.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_tensor_core_body_takes_row_strided_views(cuda_device, dtype):
    # z[:, :half] as core/solve.py passes it, and an odd row stride that no
    # TMA map could take directly: the pack pre-pass takes both.
    g = torch.Generator(device="cpu").manual_seed(1)
    z = torch.randn(600, 1000, generator=g).to(cuda_device, dtype)
    odd = torch.randn(500, 301, generator=g).to(cuda_device, dtype)
    a, b, c = z[:, :500], odd[:, :300], z[:, 600:900]
    assert a.stride(0) == 1000 and b.stride(0) == 301
    kernels.reset_launch_counts()
    for got, want in ((mm.matmul_cuda(a, b), mm_ref.matmul_ref(a, b)),
                      (mm.schur_update_cuda(c, a, b), mm_ref.schur_update_ref(c, a, b))):
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= _GEMM_TOL[dtype] * scale
    assert kernels.launch_counts()["gemm_tensor_core"] == 2


@pytest.mark.parametrize("block_m", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_gemm_tensor_core_body_keeps_its_registers(cuda_device, dtype, block_m):
    attrs = mm.gemm_tc_attributes(dtype, block_m)
    assert attrs["local_bytes"] == 0, attrs
    assert attrs["dynamic_smem"] <= 232448 and attrs["stages"] >= 3, attrs


def test_gemm_route_on_the_card(cuda_device):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    g = torch.Generator(device="cpu").manual_seed(2)
    a, c = torch.randn(64, 0).to(cuda_device), torch.randn(64, 80, generator=g).to(cuda_device)
    b = torch.randn(0, 80).to(cuda_device)
    kernels.reset_launch_counts()
    got = mm.schur_update_cuda(c, a, b, alpha=2.0, beta=-0.5)      # k = 0: β·C
    assert torch.equal(got, -0.5 * c)
    assert torch.equal(mm.matmul_cuda(a, b), torch.zeros(64, 80, device=cuda_device))
    assert mm.matmul_cuda(torch.randn(0, 5).to(cuda_device),
                          torch.randn(5, 7).to(cuda_device)).shape == (0, 7)
    launches = kernels.launch_counts()
    assert launches["gemm_ffma"] == 2 and launches["gemm_tensor_core"] == 0
    assert launches["matmul"] + launches["schur_update"] == 2
    assert mm.gemm_route(1024, 1024, 1024, torch.float32, sms) == ("tensor_core", 64)


def test_spin_paths_take_the_tensor_core_body(cuda_device):
    rng = np.random.default_rng(4)
    a = testing.make_spd(512, rng, device="cpu")
    b = torch.from_numpy(rng.standard_normal((512, 8), dtype=np.float32))
    for run in (lambda: spin_inverse_dense(a, 64, "cuda", engine="cuda"),
                lambda: spin_inverse_dense(a, 64, "gauss_jordan", engine="cuda"),
                lambda: lu_inverse_dense(a, 64, engine="cuda"),
                lambda: spin_solve_dense(a, b, 64, "cuda", engine="cuda")):
        kernels.reset_launch_counts()
        run()
        launches = kernels.launch_counts()
        products = launches["matmul"] + launches["schur_update"]
        assert products > 0 and launches["gemm_tensor_core"] == products, launches
        assert launches["gemm_ffma"] == 0


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


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("batch,bs", [(1, 17), (2, 48), (1, 256), (1, 1024)])
def test_blocked_gauss_jordan_dtypes(cuda_device, batch, bs, in_dtype, out_dtype):
    x = _spd_blocks(batch, bs, 11, cuda_device).to(in_dtype)
    kernels.reset_launch_counts()
    got = gj.blocked_leaf_inverse_cuda(x, out_dtype=out_dtype)
    assert kernels.launch_counts()["blocked_gauss_jordan"] == 1
    want = gj_ref.blocked_gauss_jordan_ref(x, gj.default_panel(bs), out_dtype)
    assert got.dtype == want.dtype == (out_dtype or in_dtype)
    assert got.shape == want.shape and bool(torch.isfinite(got.float()).all())
    # f32 out: the sums of another order (1e-4, as above); a 16-bit out:
    # both round the f32 inverse once, one ulp of the largest entry (2^-7
    # for bf16, which has the fewer bits).
    tol = 1e-4 if got.dtype == torch.float32 else 2.0 ** -7
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("batch,bs,panel", [(1, 64, None), (2, 48, 16), (1, 1024, None),
                                            (1, 256, 32)])
def test_blocked_gauss_jordan_matches_its_model(cuda_device, batch, bs, panel):
    """The kernel against the plain model of its own step order (in place,
    one W·R product a panel): the same algebra, 3xTF32 products and
    another summation order, so 1e-4 of the largest entry as above."""
    x = _spd_blocks(batch, bs, 12, cuda_device)
    t = panel or gj.default_panel(bs)
    got = gj.blocked_leaf_inverse_cuda(x, panel=t)
    want = gj_ref.blocked_gauss_jordan_inplace_model(x, t)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("kernel,strip", [("tri_tc", n) for n in gj.TRI_STRIPS] + [
    ("tri_dinv", 64), ("tri_pack", 64), ("bgj_panel", 64), ("bgj_update", 64)])
def test_blocked_leaf_kernels_keep_their_registers(cuda_device, kernel, strip):
    assert gj.blocked_attributes(kernel, strip)["local_bytes"] == 0


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 133])                  # 133: more blocks than SMs
@pytest.mark.parametrize("bs", [1, 17, 128, 200, 256])       # 256: the device-memory route
def test_scalar_gauss_jordan_step_exact(cuda_device, bs, batch, in_dtype):
    x = _spd_blocks(min(batch, 3), bs, 9, cuda_device)
    x = x.repeat((batch + 2) // 3, 1, 1)[:batch].contiguous().to(in_dtype)
    kernels.reset_launch_counts()
    got = gj.leaf_inverse_cuda(x, out_dtype=torch.float32)
    assert kernels.launch_counts()["gauss_jordan"] == 1
    want = gj_ref.gauss_jordan_ref(x, out_dtype=torch.float32)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    # The same rounding step for step: equal up to ~1 ulp.
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_gauss_jordan_kernel_keeps_its_registers(cuda_device):
    # bs = 128, the main path's leaf: 16 cells a thread, no spill.
    assert gj.gauss_jordan_attributes(128)["local_bytes"] == 0


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


def _packed_lu(batch: int, bs: int, seed: int, device) -> torch.Tensor:
    """Contiguous packed LU factors of SPD blocks: what the solve's leaf
    hands the triangular-solve kernel."""
    lu, _, _ = torch.linalg.lu_factor_ex(_spd_blocks(batch, bs, seed, device))
    return lu.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 37, 300, 256, 4352])      # the last two: the solve's leaves
@pytest.mark.parametrize("bs", [64, 128, 1024])
@pytest.mark.parametrize("batch", [1, 2])
def test_triangular_solve_kernel_matches_plain(cuda_device, batch, bs, k, dtype):
    t = _packed_lu(batch, bs, 7, cuda_device).to(dtype)
    g = torch.Generator(device="cpu").manual_seed(bs * k + batch)
    b = torch.randn(batch, bs, k, generator=g).to(cuda_device, dtype)
    panel = gj.default_panel(bs)
    for lower, unit in ((True, True), (False, False)):
        kernels.reset_launch_counts()
        got = gj.triangular_solve_cuda(t, b, lower=lower, unit_diagonal=unit)
        assert kernels.launch_counts()["triangular_solve"] == 1
        want = gj_ref.blocked_triangular_solve_ref(t, b, panel, lower=lower,
                                                   unit_diagonal=unit)
        assert got.dtype == b.dtype and got.shape == b.shape
        assert bool(torch.isfinite(got.float()).all())
        # f32: the inverted diagonal blocks applied as 3xTF32 products, one
        # a panel, round in another order than the plain version's
        # Gauss-Jordan sweeps and rank-t updates. bf16: both round the f32
        # solution once, so one bf16 ulp (2^-7) of the largest entry.
        tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("batch,bs,k,panel", [(1, 64, 5, None), (2, 48, 33, 16),
                                              (1, 1024, 300, None), (1, 128, 70, 8)])
def test_triangular_solve_matches_its_model(cuda_device, batch, bs, k, panel):
    """The kernel against the plain model of its own step order (D_p⁻¹
    first, then one product a panel): 3xTF32 products and another order of
    the sums, 1e-4 of the largest entry as above."""
    t = _packed_lu(batch, bs, 13, cuda_device)
    g = torch.Generator(device="cpu").manual_seed(bs + k)
    b = torch.randn(batch, bs, k, generator=g).to(cuda_device)
    tp = panel or gj.default_panel(bs)
    for lower, unit in ((True, True), (False, False), (True, False), (False, True)):
        got = gj.triangular_solve_cuda(t, b, tp, lower=lower, unit_diagonal=unit)
        want = gj_ref.triangular_solve_dinv_model(t, b, tp, lower=lower, unit_diagonal=unit)
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_lu_leaf_on_the_card_matches_plain(cuda_device):
    """The LU baseline's leaf at its main-path size: one unpivoted
    lu_factor_ex on the card against the plain column-by-column loop."""
    import importlib

    lu_mod = importlib.import_module("repro_torch.core.lu_inverse")
    a = _spd_blocks(1, 1024, 14, cuda_device)[0]
    l, u = lu_mod._local_lu(a)
    packed = lu_mod._local_lu_plain(a)
    # Both unpivoted in f32, summed in another order: 1e-4 of the largest
    # entry of each factor at the block's condition (≈ 10).
    want_l = torch.tril(packed, -1) + torch.eye(1024, device=cuda_device)
    want_u = torch.triu(packed)
    assert float((l - want_l).abs().max()) <= 1e-4 * float(want_l.abs().max())
    assert float((u - want_u).abs().max()) <= 1e-4 * float(want_u.abs().max())


def test_triangular_solve_takes_column_major_t(cuda_device):
    a = _spd_blocks(2, 128, 8, cuda_device)
    lu, _, _ = torch.linalg.lu_factor_ex(a)
    col = lu.transpose(1, 2).contiguous().transpose(1, 2)   # column-major
    assert col.stride(1) == 1
    b = torch.randn(2, 128, 50, device=cuda_device)
    for lower, unit in ((True, True), (False, False)):
        got = gj.triangular_solve_cuda(col, b, lower=lower, unit_diagonal=unit)
        want = gj.triangular_solve_cuda(col.contiguous(), b, lower=lower,
                                        unit_diagonal=unit)
        assert torch.equal(got, want)                       # same reads, same order
    with pytest.raises(ValueError, match="contiguous"):
        gj.triangular_solve_cuda(col, b.transpose(1, 2).contiguous().transpose(1, 2))


def test_spin_solve_on_the_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(3)
    a = testing.make_spd(512, rng, device="cpu")
    b = torch.from_numpy(rng.standard_normal((512, 8), dtype=np.float32))
    kernels.reset_launch_counts()
    with count_ops() as counts:
        x = spin_solve_dense(a, b, 64, "cuda", engine="cuda")
    launches = kernels.launch_counts()
    assert x.device.type == "cuda"
    assert launches["triangular_solve"] == 2 * 8 and launches["matmul"] == 2 * 7
    assert launches["schur_update"] == launches["blocked_gauss_jordan"] == 0
    assert counts.multiplies == counts.arranges == counts.leaf_inversions == 0
    assert counts.leaf_solves == 8 and counts.solve_applies == 3 * 7
    assert verify.solve_residual(a.to(cuda_device), x, b.to(cuda_device)) < 1e-3
    # LAPACK on the CPU and cuSOLVER on the card may pivot differently, so
    # the solutions are compared, not the factors.
    x_cpu = spin_solve_dense(a, b, 64, "cuda", engine="cuda", device="cpu")
    assert float((x.cpu() - x_cpu).abs().max()) <= 1e-4 * float(x_cpu.abs().max())


# ---------------------------------------------------------------------------
# The precision policies and the Strassen engine on the GEMM kernel
# ---------------------------------------------------------------------------


def _gemm_dtypes(monkeypatch) -> list:
    """Record the operand dtype of every GEMM launch (either body)."""
    seen = []
    launch = mm._launch

    def spy(c, a, b, *args):
        seen.append(a.dtype)
        return launch(c, a, b, *args)

    monkeypatch.setattr(mm, "_launch", spy)
    return seen


def test_bf16_preset_on_the_card(cuda_device, monkeypatch):
    rng = np.random.default_rng(4)
    a = testing.make_spd(512, rng, device="cpu")
    bf16 = PRECISION_PRESETS["bf16"]
    seen = _gemm_dtypes(monkeypatch)
    kernels.reset_launch_counts()
    raw = spin_inverse_dense(a, 128, "cuda", engine="cuda",
                             precision=dataclasses.replace(bf16, polish_sweeps=0))
    launches = kernels.launch_counts()
    # grid 4: 3 internal nodes of 4 products and 2 Schur updates, 4 leaves,
    # every product on the bf16 tensor-core body.
    assert launches["matmul"] == 12 and launches["schur_update"] == 6
    assert launches["blocked_gauss_jordan"] == 4
    assert launches["gemm_tensor_core"] == 18 and launches["gemm_ffma"] == 0
    assert seen == [torch.bfloat16] * 18
    seen.clear()
    kernels.reset_launch_counts()
    x = spin_inverse_dense(a, 128, "cuda", engine="cuda", precision="bf16")
    launches = kernels.launch_counts()
    # ... and one f32 polish sweep: two more products, on the f32 body.
    assert launches["matmul"] == 14 and launches["schur_update"] == 6
    assert launches["gemm_tensor_core"] == 20 and launches["gemm_ffma"] == 0
    assert seen == [torch.bfloat16] * 18 + [torch.float32] * 2
    assert raw.dtype == x.dtype == torch.bfloat16
    bound = bf16.bound(torch.float32)
    ac = a.to(cuda_device)
    assert verify.inverse_residual(ac, x) <= bound
    assert verify.inverse_residual(ac, x) <= verify.inverse_residual(ac, raw)
    x_cpu = spin_inverse_dense(a, 128, "cuda", engine="cuda", device="cpu",
                               precision="bf16").float()
    assert float((x.cpu().float() - x_cpu).abs().max()) <= 2.0 ** -7 * float(
        x_cpu.abs().max())
    b = torch.from_numpy(rng.standard_normal((512, 4), dtype=np.float32))
    xs = spin_solve_dense(a, b, 128, "cuda", engine="cuda", precision="bf16")
    assert xs.dtype == torch.float32
    assert verify.solve_residual(ac, xs, b.to(cuda_device)) <= bound


def _fused_strassen_leaves(grid: int, bs: int, cutoff: int) -> int:
    """Schur updates that are one classical leaf under the strassen engine:
    the two of every SPIN node whose half-grid h has h == 1 or h·bs at or
    below the cutoff. Each is one schur_update launch; every other leaf is
    one matmul launch."""
    fused, nodes, h = 0, 1, grid // 2
    while h >= 1:
        if h == 1 or h * bs <= cutoff:
            fused += 2 * nodes
        nodes, h = nodes * 2, h // 2
    return fused


def test_strassen_inversion_on_the_card(cuda_device, monkeypatch):
    monkeypatch.setenv("SPIN_STRASSEN_CUTOFF", "256")
    rng = np.random.default_rng(5)
    a = testing.make_spd(1024, rng, device="cpu")
    kernels.reset_launch_counts()
    with count_ops() as counts:
        x = spin_inverse_dense(a, 128, "cuda", engine="strassen")
    launches = kernels.launch_counts()
    base, adds = verify.expected_spin_strassen_counts(8, 128, 256)
    assert (counts.strassen_base_multiplies, counts.strassen_adds) == (base, adds)
    verify.assert_paper_op_counts(8, counts)
    fused = _fused_strassen_leaves(8, 128, 256)
    assert fused == 12
    assert launches["schur_update"] == fused
    assert launches["matmul"] == base - fused
    assert launches["gemm_tensor_core"] == base and launches["gemm_ffma"] == 0
    assert launches["blocked_gauss_jordan"] == 8
    assert verify.inverse_residual(a.to(cuda_device), x) < 1e-3
    x_cpu = spin_inverse_dense(a, 128, "cuda", engine="strassen", device="cpu")
    assert float((x.cpu() - x_cpu).abs().max()) <= 1e-4 * float(x_cpu.abs().max())


def test_strassen_matmul_on_the_card_matches_the_kernel(cuda_device):
    g = torch.Generator(device="cpu").manual_seed(6)
    a, b = (torch.randn(2048, 2048, generator=g).to(cuda_device) for _ in range(2))
    kernels.reset_launch_counts()
    got = strassen_matmul(a, b, cutoff=1024)
    assert kernels.launch_counts()["matmul"] == 7
    want = mm.matmul_cuda(a, b)
    # One split: 18 f32 add passes beside the kernel's 3xTF32 products.
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    assert rel <= 2e-5
    assert float((got - mm_ref.matmul_ref(a, b)).abs().max()) <= 1e-4 * float(
        want.abs().max())


def test_block_gemm_on_the_card(cuda_device):
    g = torch.Generator(device="cpu").manual_seed(7)
    a = torch.randn(2, 3, 64, 64, generator=g).to(cuda_device)
    b = torch.randn(3, 2, 64, 64, generator=g).to(cuda_device)
    kernels.reset_launch_counts()
    got = mm_ops.block_gemm(a, b)
    assert kernels.launch_counts()["matmul"] == 2 * 2 * 3
    want = mm_ops.block_gemm(a.cpu(), b.cpu())
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())


# ---------------------------------------------------------------------------
# Flash attention (B6) and the dense LM serving path
# ---------------------------------------------------------------------------

# The reference's bounds (tests/test_flash_attention.py): bf16 keeps 8
# mantissa bits and f16 11, and both versions round the f32 result once;
# in f32 the two differ in summation order only.
_FA_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2, torch.float16: 1e-2}


def _qkv(b, h, kv, sq, skv, hd, dtype, seed, device):
    """q, k, v made in the model's (B, S, H, hd) layout and handed over as
    (B, H, S, hd) views, as attn_apply hands them."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, sq, h, hd, generator=g).to(device, dtype)
    k = torch.randn(b, skv, kv, hd, generator=g).to(device, dtype)
    v = torch.randn(b, skv, kv, hd, generator=g).to(device, dtype)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _fa_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2), (48, 1)])     # groups 1, 4, 48
@pytest.mark.parametrize("hd", [64, 96, 128, 160])
def test_flash_attention_kernel_matches_plain(cuda_device, hd, h, kv, dtype, causal):
    q, k, v = _qkv(2, h, kv, 200, 200, hd, dtype, hd * h + kv, cuda_device)  # ragged S
    kernels.reset_launch_counts()
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    assert kernels.launch_counts()["flash_attention"] == 1
    want = fa_ref.attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    assert got.stride() == q.stride()          # the output keeps q's layout
    assert bool(torch.isfinite(got.float()).all())
    assert _fa_err(got, want) < _FA_TOL[dtype]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("h,kv", [(32, 8), (8, 8)])
@pytest.mark.parametrize("s", [64, 128, 129, 2048])
@pytest.mark.parametrize("hd", [16, 32, 64, 96, 128, 160])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_tensor_core_kernel(cuda_device, dtype, hd, s, h, kv, causal):
    q, k, v = _qkv(1, h, kv, s, s, hd, dtype, s * hd + h, cuda_device)
    kernels.reset_launch_counts()
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    assert kernels.launch_counts()["flash_attention"] == 1
    want = fa_ref.attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    assert _fa_err(got, want) < _FA_TOL[dtype]


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_tensor_core_kernel_keeps_its_registers(cuda_device, dtype, hd):
    # The consumers grow to 240 registers by setmaxnreg; a kernel that
    # spills at these head dims has lost that (PERF.md §6).
    attrs = fa.flash_attention_attributes(dtype, hd)
    assert attrs["local_bytes"] == 0, attrs
    assert attrs["dynamic_smem"] <= 232448, attrs


@pytest.mark.parametrize("window", [1, 7, 64, 100, 128, 257, 1024])
@pytest.mark.parametrize("s", [129, 300, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_attention_window_matches_plain(cuda_device, dtype, s, window):
    """The sliding window (hymba's attention): both kernels walk the band
    from its first tile and mask its lower edge; GQA 10/2, ragged S."""
    q, k, v = _qkv(2, 10, 2, s, s, 64, dtype, s + window, cuda_device)
    kernels.reset_launch_counts()
    got = fa.flash_attention_cuda(q, k, v, causal=True, window=window)
    assert kernels.launch_counts()["flash_attention"] == 1
    want = fa_ref.attention_ref(q, k, v, causal=True, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    assert _fa_err(got, want) < _FA_TOL[dtype]


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 200)])
@pytest.mark.parametrize("s", [64, 129, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_attention_hd80_matches_plain(cuda_device, dtype, s, causal, window):
    """hd 80 (hubert-xlarge): the 32-byte swizzle with 5 chunks a row on the
    tensor cores, 5 columns a thread on FFMA."""
    q, k, v = _qkv(2, 16, 16, s, s, 80, dtype, s + 80 + window, cuda_device)
    got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = fa_ref.attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    assert _fa_err(got, want) < _FA_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_hd80_keeps_its_registers(cuda_device, dtype):
    attrs = fa.flash_attention_attributes(dtype, 80)
    assert attrs["local_bytes"] == 0 and attrs["dynamic_smem"] <= 232448, attrs


def test_the_backward_takes_a_window_and_hd80_on_the_card(cuda_device):
    """B6-bwd takes hymba's sliding window and hubert's hd 80: the training
    route launches B6 and B6-bwd once each and its gradients agree with the
    plain version's; a head dim the kernels are not built for (48) still
    raises before any launch, and the forward without grad still runs."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    for h, kv, hd, causal, window, seed in ((5, 1, 64, True, 16, 3), (4, 4, 80, False, 0, 4)):
        q, k, v = _qkv(1, h, kv, 200, 200, hd, torch.bfloat16, seed, cuda_device)
        do = _qkv(1, h, h, 200, 200, hd, torch.bfloat16, seed + 10, cuda_device)[0]
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        kernels.reset_launch_counts()
        got = torch.autograd.grad(flash_attention(*leaves, causal=causal, window=window),
                                  leaves, do)
        assert kernels.launch_counts()["flash_attention"] == 1
        assert kernels.launch_counts()["flash_attention_bwd"] == 1
        want = fa_ref.attention_bwd_ref(q, k, v, do, causal=causal, window=window)
        for g, w in zip(got, want):
            # bf16: each gradient rounded once, D from the rounded output
            scale = float(w.float().abs().max())
            assert float((g.float() - w.float()).abs().max()) <= 2e-2 * scale
    q, k, v = _qkv(1, 4, 2, 64, 64, 48, torch.bfloat16, 5, cuda_device)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="head_dim 48"):
        flash_attention(q.detach().requires_grad_(), k, v, causal=True, window=16)
    assert kernels.launch_counts()["flash_attention"] == 0
    q8, k8, v8 = _qkv(1, 4, 4, 64, 64, 80, torch.bfloat16, 4, cuda_device)
    flash_attention(q8, k8, v8, causal=False)
    assert kernels.launch_counts()["flash_attention"] == 1


# The five families, reduced, trained on the card (ROADMAP A.1).
_TRAIN_FAMILIES = ["qwen2-moe-a2.7b", "hymba-1.5b", "mamba2-130m", "phi-3-vision-4.2b",
                   "hubert-xlarge"]


def _train_state(cfg, device):
    """The reduced config's AdamW state from seed 0 on the CPU, on `device`."""
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.trainer import TrainState

    params = _tree_to(T.init_params(cfg, torch.Generator().manual_seed(0), "cpu", 1), device)
    return TrainState(params, adamw_init(params), torch.zeros((), dtype=torch.int32))


def _family_batches(cfg, n: int, device) -> list:
    """`n` train batches of 4 x 96 positions: above the reduced window (32),
    a whole number of reduced SSD chunks (16)."""
    from repro_torch.data.synthetic import make_batch

    return [make_batch(cfg, 4, 96, np.random.default_rng([3, i]), "train", device)
            for i in range(n)]


@pytest.mark.parametrize("arch", _TRAIN_FAMILIES)
def test_a_reduced_family_trains_a_step_on_the_card_as_on_the_cpu(cuda_device, arch):
    """One AdamW step (2 microbatches, full remat) of each reduced family on
    the card against the same step on the CPU, where attention is the
    kernels' plain version: loss and gradient norm within 2e-2 relative (bf16
    activations rounded at other places by B6 and B6-bwd than by the plain
    softmax, and by cuBLAS than by the CPU's products); B6 launched 2·L·2
    times and B6-bwd L·2 times (none for mamba2), no other kernel."""
    from repro_torch.runtime.trainer import TrainConfig, make_train_step

    cfg = get_arch(arch).reduced()
    step = make_train_step(cfg, TrainConfig(microbatches=2, warmup=1))
    (batch,) = _family_batches(cfg, 1, "cpu")
    _, want = step(_train_state(cfg, "cpu"), batch)
    kernels.reset_launch_counts()
    _, got = step(_train_state(cfg, cuda_device), _tree_to(batch, cuda_device))
    launches = kernels.launch_counts()
    attn_layers = 0 if cfg.attn_free else cfg.n_layers
    assert launches["flash_attention"] == 2 * attn_layers * 2
    assert launches["flash_attention_bwd"] == attn_layers * 2
    assert sum(launches.values()) == 3 * attn_layers * 2
    for key in ("loss", "grad_norm"):
        g, w = float(got[key]), float(want[key])
        assert np.isfinite(g) and abs(g - w) <= 2e-2 * abs(w), (key, g, w)
    assert (float(got["aux"]) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", _TRAIN_FAMILIES)
def test_a_reduced_family_repeats_its_steps_bit_for_bit_on_the_card(cuda_device, arch):
    """Two runs of two AdamW steps from the same state and batches give the
    same bits: B6-bwd sums in one order, the embedding's backward sorts, and
    the MoE combine's gather (`y[ex, pos2]`), whose backward accumulates by
    index, meets at most one nonzero gradient a slot."""
    from repro_torch.runtime.trainer import TrainConfig, make_train_step
    from repro_torch.tree import leaves

    cfg = get_arch(arch).reduced()
    step = make_train_step(cfg, TrainConfig(microbatches=2, warmup=1))
    batches = _family_batches(cfg, 2, cuda_device)
    runs = []
    for _ in range(2):
        state, metrics = _train_state(cfg, cuda_device), []
        for batch in batches:
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        runs.append((leaves(state.params), metrics))
    (p0, m0), (p1, m1) = runs
    assert m0 == m1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def _kernel_names(fn) -> list[str]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def test_flash_attention_f32_keeps_the_ffma_kernel(cuda_device):
    q, k, v = _qkv(2, 8, 2, 300, 300, 128, torch.float32, 5, cuda_device)
    names = _kernel_names(lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    assert any("flash_fwd<" in n for n in names), names
    assert not any("flash_fwd_tc" in n for n in names), names
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    assert _fa_err(got, fa_ref.attention_ref(q, k, v, causal=True)) < 2e-3
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    names = _kernel_names(lambda: fa.flash_attention_cuda(*bf, causal=True))
    assert any("flash_fwd_tc" in n for n in names), names


def test_flash_attention_rejects_unaligned_tma_operands(cuda_device):
    q, k, v = _qkv(1, 4, 2, 64, 64, 64, torch.bfloat16, 0, cuda_device)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
    shifted = flat[1:].view(q.shape)                       # 2-byte offset base
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention_cuda(shifted, k, v)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sq,skv,hd", [(1, 1, 16), (1, 130, 32), (77, 130, 128),
                                       (130, 77, 64), (64, 64, 16), (1000, 1000, 128)])
def test_flash_attention_kernel_ragged_and_contiguous(cuda_device, sq, skv, hd, causal):
    g = torch.Generator(device="cpu").manual_seed(sq * skv + hd)
    q = torch.randn(1, 8, sq, hd, generator=g).to(cuda_device, torch.bfloat16)
    k = torch.randn(1, 2, skv, hd, generator=g).to(cuda_device, torch.bfloat16)
    v = torch.randn(1, 2, skv, hd, generator=g).to(cuda_device, torch.bfloat16)
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    want = fa_ref.attention_ref(q, k, v, causal=causal)
    assert got.is_contiguous()
    assert _fa_err(got, want) < _FA_TOL[torch.bfloat16]


def test_flash_attention_rejects_what_the_kernel_does_not_take(cuda_device):
    q, k, v = _qkv(1, 4, 2, 64, 64, 48, torch.bfloat16, 0, cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_cuda(q, k, v)                      # hd 48
    q, k, v = _qkv(1, 4, 2, 64, 64, 64, torch.bfloat16, 0, cuda_device)
    with pytest.raises(ValueError, match="unit stride"):
        fa.flash_attention_cuda(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, k[:, :1].expand(1, 3, 64, 64), v)   # 4 % 3
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, k.float(), v)              # mixed dtypes


@pytest.mark.parametrize("arch", ["granite-8b", "olmo-1b"])
def test_attn_apply_on_the_card_matches_cpu(cuda_device, arch):
    cfg = get_arch(arch).reduced()
    lp = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")["layers"]["attn"]
    lp = {name: w[0] for name, w in lp.items()}
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 100, cfg.d_model, generator=g).to(torch.bfloat16)
    want = attention.attn_apply(lp, x, cfg)
    kernels.reset_launch_counts()
    got = attention.attn_apply({n: w.to(cuda_device) for n, w in lp.items()},
                               x.to(cuda_device), cfg)
    assert kernels.launch_counts()["flash_attention"] == 1
    scale = float(want.float().abs().max())
    # bf16 output: two roundings (attention output, projection) apart.
    assert float((got.cpu().float() - want.float()).abs().max()) <= 2e-2 * scale


def _tree_to(tree: dict, device) -> dict:
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def test_lm_serving_path_on_the_card(cuda_device):
    cfg = get_arch("granite-8b").reduced()
    params = T.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(3))
    kernels.reset_launch_counts()
    logits, _, _, cache = T.prefill(params, {"tokens": tokens.to(cuda_device)}, cfg)
    launches = kernels.launch_counts()
    assert launches["flash_attention"] == cfg.n_layers
    assert sum(launches.values()) == cfg.n_layers
    want, *_ = T.forward(_tree_to(params, "cpu"), {"tokens": tokens}, cfg)
    assert float((logits.cpu() - want).abs().max()) < 2e-2
    # decode on from the padded prefill cache, against the forward logits
    pad = {k: torch.nn.functional.pad(cache[k], (0, 0, 0, 0, 0, 8)) for k in ("k", "v")}
    cache = {**pad, "pos": cache["pos"]}
    nxt = torch.argmax(logits[:, -1], -1)
    step, _ = T.decode_step(params, cache, nxt, cfg)
    full, *_ = T.forward(params, {"tokens": torch.cat([tokens.to(cuda_device), nxt[:, None]], 1)}, cfg)
    assert float((step - full[:, -1]).abs().max()) < 2e-2
    # the engine against the same request alone in an engine of the same
    # width: the same GEMM shapes, so the same bits, so the same tokens
    reqs = [Request(uid=i, prompt=[5 + i, 9, 2, i], max_new_tokens=6) for i in range(3)]
    eng = ServingEngine(cfg, params, slots=2, max_len=32)
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    solo = Request(uid=9, prompt=list(reqs[0].prompt), max_new_tokens=6)
    alone = ServingEngine(cfg, params, slots=2, max_len=32)
    alone.submit(solo)
    alone.run_until_done()
    assert all(r.done for r in reqs) and reqs[0].output == solo.output


# ---------------------------------------------------------------------------
# The planner, the SMW update, the sketched inverse and the checkpoint on
# the card, against the same calls on the CPU (the kernels' plain versions)
# ---------------------------------------------------------------------------


def test_planned_inversion_on_the_card(cuda_device, tmp_path, monkeypatch):
    from repro_torch import planner

    monkeypatch.setenv("SPIN_PLAN_CACHE", str(tmp_path / "plans.json"))
    a = testing.make_spd(2048, np.random.default_rng(11), device=cuda_device)
    kernels.reset_launch_counts()
    x = spin_inverse_dense(a)                 # n > MEASURE_MAX_N: the model
    plan = planner.get_plan("inverse", 2048, torch.float32)
    assert plan.multiply_engine == "cuda" and plan.leaf_solver == "cuda"
    assert kernels.launch_counts()["blocked_gauss_jordan"] == 2048 // plan.block_size
    assert torch.equal(x, spin_inverse_dense(a, plan.block_size, plan.leaf_solver,
                                             engine=plan.multiply_engine))
    assert verify.inverse_residual(a, x) < 1e-3
    assert (tmp_path / "plans.torch.json").exists()
    assert not (tmp_path / "plans.json").exists()
    # a small problem is timed on the card (warm-up first), then recalled
    small = testing.make_spd(256, np.random.default_rng(12), device=cuda_device)
    p = planner.get_plan("inverse", 256, torch.float32, measure=True, top_k=3)
    assert p.source == "measured" and p.measured_s > 0
    assert verify.inverse_residual(small, spin_inverse_dense(small)) < 1e-3
    b = torch.randn(2048, 16, device=cuda_device)
    assert verify.solve_residual(a, spin_solve_dense(a, b), b) < 1e-3


@pytest.mark.parametrize("rep", ["dense", "block"])
def test_smw_update_on_the_card_matches_cpu(cuda_device, rep):
    from repro_torch.core import (BlockMatrix, apply_inverse, smw_update_inverse,
                                  smw_update_solve)

    n, k = 1024, 16
    rng = np.random.default_rng(13)
    a = testing.make_spd(n, rng, device="cpu")
    u = torch.from_numpy(rng.standard_normal((n, k), dtype=np.float32)) / n ** 0.5
    rhs = torch.from_numpy(rng.standard_normal((n, 4), dtype=np.float32))
    inv = torch.linalg.inv(a)
    wrap = (lambda t: BlockMatrix.from_dense(t, 128)) if rep == "block" else (lambda t: t)
    dense = (lambda r: r.to_dense()) if rep == "block" else (lambda r: r)
    got = dense(smw_update_inverse(wrap(inv.to(cuda_device)), u.to(cuda_device),
                                   u.to(cuda_device))).cpu()
    want = dense(smw_update_inverse(wrap(inv), u, u))
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    xs = smw_update_solve(wrap(inv.to(cuda_device)), u.to(cuda_device),
                          u.to(cuda_device), rhs.to(cuda_device)).cpu()
    ws = smw_update_solve(wrap(inv), u, u, rhs)
    assert float((xs - ws).abs().max()) <= 1e-4 * float(ws.abs().max())
    # the bf16 serve GEMM runs on the GEMM kernel's bf16 body, any width
    inv16 = inv.to(torch.bfloat16)
    for cols in (1, 2, 3, 130):
        r = torch.from_numpy(rng.standard_normal((n, cols), dtype=np.float32))
        kernels.reset_launch_counts()
        g = apply_inverse(inv16.to(cuda_device), r.to(cuda_device), precision="bf16")
        assert kernels.launch_counts()["matmul"] == 1
        w = apply_inverse(inv16, r, precision="bf16")
        assert g.dtype == torch.float32
        assert float((g.cpu() - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_sketched_inverse_on_the_card(cuda_device):
    from repro_torch.core import sketched_approx_inverse

    a = testing.make_spd(1024, np.random.default_rng(14), device=cuda_device)
    kernels.reset_launch_counts()
    with multiply_engine("cuda"):
        got = sketched_approx_inverse(a, torch.Generator(device=cuda_device).manual_seed(0))
    assert got.converged and got.residual_est <= 1e-3
    assert kernels.launch_counts()["matmul"] == 2 * got.sweeps
    assert verify.inverse_residual(a, got.inverse) < 1e-2


def test_checkpoint_resume_on_the_card_is_bit_identical(cuda_device, tmp_path):
    from repro_torch.core import BlockMatrix, CheckpointedSpin

    a = testing.make_spd(1024, np.random.default_rng(15), device=cuda_device)
    bm = BlockMatrix.from_dense(a, 128)

    def stop(name):
        if name == "0/VI":
            raise KeyboardInterrupt(name)

    with multiply_engine("cuda"):
        whole = CheckpointedSpin(str(tmp_path / "whole"), leaf_solver="cuda").inverse(bm)
        with pytest.raises(KeyboardInterrupt):
            CheckpointedSpin(str(tmp_path / "run"), leaf_solver="cuda",
                             on_op=stop).inverse(bm)
        resumed = CheckpointedSpin(str(tmp_path / "run"), leaf_solver="cuda")
        x = resumed.inverse(bm)
    assert resumed.loaded_ops > 0
    assert x.device.type == "cuda" and torch.equal(x.blocks, whole.blocks)
    assert verify.inverse_residual(a, x.to_dense()) < 1e-3


def test_spin_service_on_the_card(cuda_device, tmp_path, monkeypatch):
    """SpinService at n = 2048 on the card: the planned factorization
    launches B1, B2 and B3 as the plan implies, a coalesced tick is one
    solve (B2 + B5) bitwise the offline call, and a bf16 tenant serves
    within its preset's bound on B2's bf16 body."""
    from repro_torch.serving import SpinService

    monkeypatch.setenv("SPIN_PLAN_CACHE", str(tmp_path / "plans.json"))
    n = 2048
    a = testing.make_spd(n, np.random.default_rng(13), device=cuda_device)
    svc = SpinService(slots=4)
    kernels.reset_launch_counts()
    st = svc.add_matrix("m", a)
    grid = n // st.block_size
    assert (st.leaf_solver, st.engine) == ("cuda", "cuda")
    got = kernels.launch_counts()
    assert (got["schur_update"], got["matmul"], got["blocked_gauss_jordan"]) == \
        (2 * (grid - 1), 4 * (grid - 1), grid)

    g = torch.Generator(device=cuda_device).manual_seed(0)
    cols = [torch.randn(n, 8, generator=g, device=cuda_device) for _ in range(4)]
    kernels.reset_launch_counts()
    reqs = [svc.solve("m", c) for c in cols]
    svc.tick()
    got = kernels.launch_counts()
    assert (got["triangular_solve"], got["matmul"], got["schur_update"]) == \
        (2 * grid, 2 * (grid - 1), 0)
    assert all(r.path == "recursion" for r in reqs)
    b = torch.cat(cols, dim=1)
    offline = spin_solve_dense(a, b, st.block_size, "cuda", engine="cuda")
    assert torch.equal(torch.cat([r.x for r in reqs], dim=1), offline)
    assert verify.solve_residual(a, offline, b) < 1e-3

    bound = PRECISION_PRESETS["bf16"].bound(torch.float32)
    lowp = svc.add_matrix("m16", a, precision="bf16")
    assert lowp.inv.dtype == torch.bfloat16
    kernels.reset_launch_counts()
    r = svc.solve("m16", b)
    svc.tick()
    assert r.path == "maintained" and r.residual_est <= bound
    assert kernels.launch_counts()["matmul"] == 1       # the bf16 serve product
    assert verify.solve_residual(a, r.x, b) <= bound


# ----------------------------------------------------- the sharded placement


def _mesh(shape):
    from repro_torch.launch.mesh import make_worker_mesh

    return make_worker_mesh(shape, devices=["cuda:0"] * (shape[0] * shape[1]))


def test_sharded_inverse_on_a_1x1_mesh_is_the_dense_path(cuda_device):
    from repro_torch.core import spin_inverse_sharded
    from repro_torch.launch.mesh import set_mesh

    n, bs = 1024, 128
    a = testing.make_spd(n, np.random.default_rng(20), device=cuda_device)
    kernels.reset_launch_counts()
    dense = spin_inverse_dense(a, bs, "cuda", engine="cuda")
    want = kernels.launch_counts()
    kernels.reset_launch_counts()
    with set_mesh(_mesh((1, 1))):
        x = spin_inverse_sharded(a, bs, leaf_solver="cuda", engine="cuda")
    assert torch.equal(x, dense)
    assert kernels.launch_counts() == want


@pytest.mark.parametrize("engine", ["cuda", "allgather", "ring", "strassen"])
def test_sharded_engines_on_a_2x2_mesh_of_one_card(cuda_device, engine):
    """Each engine on a 2×2 mesh of the card against its plain run on the
    CPU mesh of the same shape; the cuda engine's launches: one B2 or B1 a
    shard where the quadrant grid divides the mesh, once where it does
    not, one B3 a leaf."""
    from repro_torch.core import spin_inverse_sharded
    from repro_torch.launch.mesh import make_worker_mesh, set_mesh
    from repro_torch.parallel import (assert_mesh_resident, collective_bytes,
                                      record_specs, reset_collective_bytes)

    n, bs = 1024, 64
    grid = n // bs
    a = testing.make_spd(n, np.random.default_rng(21), device=cuda_device)
    with set_mesh(make_worker_mesh((2, 2), devices=["cpu"] * 4)):
        plain = spin_inverse_sharded(a.cpu(), bs, leaf_solver="linalg",
                                     engine=engine)
    kernels.reset_launch_counts()
    reset_collective_bytes()
    with set_mesh(_mesh((2, 2))), record_specs() as recs:
        x = spin_inverse_sharded(a, bs, leaf_solver="cuda", engine=engine)
    launches = kernels.launch_counts()
    assert verify.inverse_residual(a, x) < 1e-3
    assert float((x.cpu() - plain).abs().max()) < 1e-3 * float(plain.abs().max())
    assert assert_mesh_resident(recs)["grid_sharded"] > 0
    assert collective_bytes()["gather"] + collective_bytes()["ring"] > 0
    assert launches["blocked_gauss_jordan"] == grid
    if engine == "cuda":
        b2 = b1 = 0
        nodes, h = 1, grid // 2
        while h >= 1:
            per = 4 if h % 2 == 0 else 1
            b2, b1 = b2 + nodes * 4 * per, b1 + nodes * 2 * per
            nodes, h = 2 * nodes, h // 2
        assert (launches["matmul"], launches["schur_update"]) == (b2, b1)
    elif engine in ("allgather", "ring"):
        assert launches["matmul"] == launches["schur_update"] == 0


def test_sharded_solve_on_a_2x2_mesh_of_one_card(cuda_device):
    from repro_torch.core import spin_solve_sharded
    from repro_torch.launch.mesh import set_mesh

    n, bs = 1024, 128
    a = testing.make_spd(n, np.random.default_rng(22), device=cuda_device)
    b = torch.randn(n, 16, generator=torch.Generator().manual_seed(22)).to(cuda_device)
    kernels.reset_launch_counts()
    with set_mesh(_mesh((2, 2))):
        x = spin_solve_sharded(a, b, bs, leaf_solver="cuda", engine="cuda")
    assert verify.solve_residual(a, x, b) < 1e-3
    launches = kernels.launch_counts()
    assert launches["triangular_solve"] == 2 * (n // bs)
    assert launches["matmul"] > 0


def test_ring_overlaps_on_the_side_stream_and_stays_exact(cuda_device):
    """The ring at a size where its panel copies run beside the products
    on the side stream. Each shard must equal, bit for bit, the same sum
    taken on one stream with no copies in flight (acc + A_cols·B_panel,
    panel by panel, in the ring's order), so a panel freed or overwritten
    while in flight would show."""
    from repro_torch.core.multiply import matmul_blocks_einsum, multiply_dist
    from repro_torch.parallel import collectives as col

    mesh = _mesh((2, 2))
    g = torch.Generator(device=cuda_device).manual_seed(23)
    a, b = (torch.randn((8, 8, 512, 512), generator=g, device=cuda_device)
            for _ in range(2))
    spec = ("data", "model", None, None)
    da, db = col.distribute(a, spec, mesh), col.distribute(b, spec, mesh)
    want = torch.empty_like(a)
    for i in range(2):
        for j in range(2):
            acc = torch.zeros((4, 4, 512, 512), device=cuda_device)
            for t in range(2):
                src = (i - t) % 2
                acc = acc + matmul_blocks_einsum(
                    a[4 * i:4 * i + 4, 4 * src:4 * src + 4],
                    b[4 * src:4 * src + 4, 4 * j:4 * j + 4])
            want[4 * i:4 * i + 4, 4 * j:4 * j + 4] = acc
    for _ in range(3):
        col.reset_collective_bytes()
        got = col.gather(multiply_dist(da, db, "ring"))
        assert torch.equal(got, want)
        # one ring step on two data ranks: every shard of B crosses once
        assert col.collective_bytes()["ring"] == b.numel() * b.element_size()
    assert torch.device("cuda:0") in col._SIDE_STREAMS


def test_coded_inverse_on_the_card_does_not_wait_for_the_straggler(cuda_device):
    import time

    from repro_torch.parallel import CodedConfig, FaultPlan, coded_inverse

    n, bs = 1024, 128
    a = testing.make_spd(n, np.random.default_rng(24), device=cuda_device)
    cfg = CodedConfig(workers=4, redundancy=1)
    coded_inverse(a, cfg, block_size=bs, leaf_solver="cuda", engine="cuda",
                  fault_plan=FaultPlan())
    t0 = time.perf_counter()
    inv, report = coded_inverse(a, cfg, block_size=bs, leaf_solver="cuda",
                                engine="cuda",
                                fault_plan=FaultPlan().inject_straggler(0, 3.0))
    assert time.perf_counter() - t0 < 3.0
    assert report.used_ranks == [1, 2, 3]
    assert verify.inverse_residual(a, inv) < 1e-3


# ---------------------------------------------------------------------------
# A mesh of the one card (chip_smoke.py phase 19, at a reduced size)
# ---------------------------------------------------------------------------


def _mesh_of(device, shape=(2, 4), axes=("data", "model")):
    from repro_torch.launch.mesh import make_worker_mesh

    n = int(np.prod(shape))
    return make_worker_mesh(shape, axes, devices=[device] * n)


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_expert_parallel_moe_on_the_card_matches_the_cpu(cuda_device, cf):
    """The reduced qwen2-moe's MoE block, f32, expert-parallel under a
    (2, 4) mesh of the card against the same on a CPU mesh (the same drops:
    to 1e-5 of the largest entry), and at factor 8 against the mesh-free
    block on the card; every coordinate's shards stay on the card."""
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import moe

    base = get_arch("qwen2-moe-a2.7b").reduced()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=cf))
    layers = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu", 4)["layers"]["moe"]
    params = {k: ({n: w[0].float() for n, w in v.items()} if isinstance(v, dict)
                  else v[0].float()) for k, v in layers.items()}
    x = torch.randn(4, 16, cfg.d_model, generator=torch.Generator().manual_seed(1))
    with set_mesh(_mesh_of("cpu")):
        want = moe.moe_apply(params, x, cfg)
    with set_mesh(_mesh_of(cuda_device)):
        got = moe.moe_apply(_tree_to(params, cuda_device), x.to(cuda_device), cfg)
    assert all(t.device.type == "cuda" for t in got)
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-5 * float(w.abs().max())
    if cf == 8.0:
        free = moe.moe_apply(_tree_to(params, cuda_device), x.to(cuda_device), cfg)
        assert float((got[0] - free[0]).abs().max()) <= 1e-5 * float(free[0].abs().max())


def test_sharded_embedding_and_compressed_psum_on_the_card(cuda_device):
    import torch.nn.functional as F

    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models.embedding import embed_lookup
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.compression import compressed_psum

    g = torch.Generator(device=cuda_device).manual_seed(2)
    table = torch.randn(512, 64, generator=g, device=cuda_device).to(torch.bfloat16)
    toks = torch.randint(0, 512, (4, 40), generator=g, device=cuda_device)
    with set_mesh(_mesh_of(cuda_device)):
        got = embed_lookup(table, toks)
    assert got.device.type == "cuda" and torch.equal(got, F.embedding(toks, table))

    x = torch.randn(4, 4096, generator=g, device=cuda_device)
    pods = {"cpu": _mesh_of("cpu", (4,), ("pod",)), "cuda": _mesh_of(cuda_device, (4,), ("pod",))}
    sums = {}
    for name, pod in pods.items():
        out = compressed_psum(col.split(x.to(pod.device(pod.coords()[0])), ("pod", None), pod),
                              "pod", pod)
        sums[name] = [out[c].cpu() for c in pod.coords()]
    for a, b in zip(sums["cuda"], sums["cpu"]):
        assert torch.equal(a, b)      # integer sums and one f32 rescale: the same bits


def test_a_moe_step_under_a_mesh_of_the_card_meets_the_cpus(cuda_device):
    """One AdamW step (2 microbatches, full remat) of the reduced qwen2-moe
    under a (2, 4) mesh of the card against the same under a CPU mesh: the
    card's backward runs on autograd's worker thread, so each checkpointed
    layer's recompute must carry the mesh in. Loss and gradient norm
    within 2e-2 relative (as the mesh-free card test), B6 and B6-bwd as
    mesh-free, and a second run repeats the step's bits."""
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.runtime.trainer import TrainConfig, make_train_step
    from repro_torch.tree import leaves

    cfg = get_arch("qwen2-moe-a2.7b").reduced()
    step = make_train_step(cfg, TrainConfig(microbatches=2, warmup=1))
    (batch,) = _family_batches(cfg, 1, "cpu")
    with set_mesh(_mesh_of("cpu")):
        _, want = step(_train_state(cfg, "cpu"), batch)
    runs = []
    for _ in range(2):
        kernels.reset_launch_counts()
        with set_mesh(_mesh_of(cuda_device)):
            state, got = step(_train_state(cfg, cuda_device), _tree_to(batch, cuda_device))
        runs.append((leaves(state.params), {k: float(v) for k, v in got.items()},
                     kernels.launch_counts()))
    (p0, m0, launches), (p1, m1, _) = runs
    assert launches["flash_attention"] == 2 * cfg.n_layers * 2
    assert launches["flash_attention_bwd"] == cfg.n_layers * 2
    for key in ("loss", "grad_norm"):
        assert abs(m0[key] - float(want[key])) <= 2e-2 * abs(float(want[key])), key
    assert m0 == m1 and all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_elastic_restore_onto_a_mesh_of_the_card(cuda_device, tmp_path):
    from repro_torch.checkpoint.ckpt import restore, save
    from repro_torch.parallel import NamedSharding, PartitionSpec as P
    from repro_torch.parallel.collectives import gather

    w = torch.randn(64, 8, generator=torch.Generator().manual_seed(4)).to(cuda_device)
    save(str(tmp_path), 3, {"w": w})
    for mesh, spec in ((_mesh_of(cuda_device), P("data", "model")),
                       (_mesh_of(cuda_device, (8,), ("data",)), P("data", None))):
        got, _ = restore(str(tmp_path), 3, {"w": w}, shardings={"w": NamedSharding(mesh, spec)})
        assert all(t.device.type == "cuda" for t in got["w"].shards.values())
        assert torch.equal(gather(got["w"]), w)
