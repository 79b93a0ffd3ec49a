"""Precision policies and the Newton–Schulz polish: the port against the JAX
package.

The policy object (presets, aliases, descriptors, environment resolution,
the fp8 gate, the deprecated `compute_dtype=`) must read the same in both
packages. The low-precision entry points take the same matrices, built on
the CPU from a numpy seed and handed bit for bit to both; the reference
leaves are `linalg` and einsum, so nothing runs in Pallas interpret mode.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat as j_compat
from repro.core import PRECISION_PRESETS as J_PRESETS
from repro.core import BlockMatrix as JBlockMatrix
from repro.core import PrecisionPolicy as JPolicy
from repro.core import newton_schulz_polish as j_polish
from repro.core import residual_norm as j_residual_norm
from repro.core import resolve_precision as j_resolve
from repro.core import spin_inverse as j_spin_inverse
from repro.core import spin_inverse_dense as j_spin_inverse_dense
from repro.core import spin_solve_dense as j_spin_solve_dense
from repro.core import verify as j_verify
from repro.core.solve import spin_inverse_batched as j_spin_inverse_batched
from repro_torch import bridge, compat
from repro_torch.core import (PRECISION_PRESETS, BlockMatrix, PrecisionPolicy,
                              newton_schulz_polish, resolve_precision,
                              residual_norm, spin_inverse, spin_inverse_dense,
                              spin_inverse_batched, spin_solve_dense, testing,
                              verify)
from repro_torch.core.precision import _WARNED_SITES

N, BS = 128, 32
BF16 = PRECISION_PRESETS["bf16"]
J_BF16 = J_PRESETS["bf16"]
BF16_BOUND = BF16.bound(torch.float32)
WELL_POSED = ["spd", "diag_dominant", "block_banded_spd"]
ENV_KNOBS = ("SPIN_PRECISION", "SPIN_PRECISION_POLISH_SWEEPS",
             "SPIN_PRECISION_MAX_POLISH_SWEEPS", "SPIN_PRECISION_TOL")


@pytest.fixture(autouse=True)
def _no_precision_env(monkeypatch):
    for var in ENV_KNOBS:
        monkeypatch.delenv(var, raising=False)


def _matrix(family: str, n: int = N, seed: int = 0, **kwargs) -> torch.Tensor:
    rng = np.random.default_rng([seed, WELL_POSED.index(family)
                                 if family in WELL_POSED else 9, n])
    if family == "block_banded_spd":
        kwargs.setdefault("band", BS)
    return testing.MATRIX_FAMILIES[family](n, rng, device="cpu", **kwargs)


def _to_jax(t: torch.Tensor):
    return jnp.asarray(bridge.to_numpy(t))


def _from_jax(x) -> torch.Tensor:
    return bridge.to_torch(np.asarray(x), "cpu")


def _fields(policy) -> dict:
    return dataclasses.asdict(policy)


# ---------------------------------------------------------------- the policy


def test_preset_keys_equal_reference():
    assert sorted(PRECISION_PRESETS) == sorted(J_PRESETS)
    assert PRECISION_PRESETS["f32"] is PRECISION_PRESETS["exact"]
    assert PRECISION_PRESETS["float32"] is PRECISION_PRESETS["exact"]
    assert PRECISION_PRESETS["bfloat16"] is PRECISION_PRESETS["bf16"]
    assert PRECISION_PRESETS["exact"].is_exact and not BF16.is_exact


@pytest.mark.parametrize("key", ["exact", "f32", "float32", "bf16", "bfloat16",
                                 "auto"])
def test_presets_and_descriptors_equal_reference(key):
    ours, ref = PRECISION_PRESETS[key], J_PRESETS[key]
    assert _fields(ours) == _fields(ref)
    assert ours.descriptor() == ref.descriptor()
    assert PrecisionPolicy.from_descriptor(key) == ours


@pytest.mark.parametrize("kwargs", [
    dict(name="x", store_dtype="bfloat16", polish_sweeps=3, tolerance=5e-3),
    dict(name="legacy", compute_dtype="bfloat16", polish_sweeps=0),
    dict(name="half", store_dtype="float16", max_polish_sweeps=2),
    dict(name="wide", store_dtype="float32", compute_dtype="bfloat16",
         accum_dtype="float64", auto_store=True),
], ids=lambda k: k["name"])
def test_custom_descriptor_round_trips_as_reference(kwargs):
    ours, ref = PrecisionPolicy(**kwargs), JPolicy(**kwargs)
    text = ours.descriptor()
    assert text == ref.descriptor()
    assert PrecisionPolicy.from_descriptor(text) == ours
    assert _fields(JPolicy.from_descriptor(text)) == _fields(ours)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("key", ["exact", "bf16", "auto"])
def test_resolution_and_bound_equal_reference(key, dtype):
    ours, ref = PRECISION_PRESETS[key], J_PRESETS[key]
    assert ours.resolve_store(getattr(torch, dtype)) == ref.resolve_store(dtype)
    assert ours.resolve_compute(getattr(torch, dtype)) == ref.resolve_compute(dtype)
    assert ours.bound(getattr(torch, dtype)) == ref.bound(jnp.dtype(dtype))
    assert (ours.candidate_store_dtypes(getattr(torch, dtype))
            == ref.candidate_store_dtypes(dtype))


@pytest.mark.parametrize("env", [
    {},
    {"SPIN_PRECISION": "bf16"},
    {"SPIN_PRECISION": "bf16", "SPIN_PRECISION_POLISH_SWEEPS": "4"},
    {"SPIN_PRECISION": "exact", "SPIN_PRECISION_MAX_POLISH_SWEEPS": "3",
     "SPIN_PRECISION_TOL": "0.005"},
    {"SPIN_PRECISION": "n=c;s=float16;c=-;a=float32;auto=0;ps=2;mps=8;tol=-"},
], ids=["unset", "bf16", "bf16-sweeps", "exact-fields", "descriptor"])
def test_env_resolution_equals_reference(monkeypatch, env):
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    assert _fields(resolve_precision(None)) == _fields(j_resolve(None))
    assert _fields(resolve_precision("bf16")) == _fields(j_resolve("bf16"))
    # An object the caller built is taken verbatim: no env overrides.
    assert resolve_precision(BF16) is BF16
    assert j_resolve(J_BF16) is J_BF16


@pytest.mark.parametrize("bad", [
    lambda m: m.resolve_precision("no_such_preset"),
    lambda m: m.PrecisionPolicy(store_dtype="int8"),
    lambda m: m.PrecisionPolicy(accum_dtype="bfloat16"),
    lambda m: m.PrecisionPolicy(polish_sweeps=-1),
    lambda m: m.PrecisionPolicy.from_descriptor("n=x;ps=many"),
], ids=["preset", "store", "accum", "sweeps", "descriptor"])
def test_bad_policies_fail_in_both(bad):
    import repro.core as j_core
    import repro_torch.core as core

    for module in (core, j_core):
        with pytest.raises(ValueError):
            bad(module)


def test_resolve_rejects_other_types():
    with pytest.raises(TypeError):
        resolve_precision(16)


def test_fp8_gate_follows_each_probe():
    assert ("fp8" in PRECISION_PRESETS) == compat.supports_float8()
    assert ("fp8" in J_PRESETS) == j_compat.supports_float8()
    for presets, make in ((PRECISION_PRESETS, PrecisionPolicy),
                          (J_PRESETS, JPolicy)):
        if "fp8" not in presets:
            with pytest.raises(ValueError):
                make(store_dtype="float8_e4m3fn")
            continue
        fp8 = presets["fp8"]
        assert fp8.store_dtype == "float8_e4m3fn"
        assert fp8.compute_dtype == "bfloat16"
        # The residual table has no float8 row, so the default bound raises.
        with pytest.raises(ValueError):
            fp8.bound("float32")
    if compat.supports_float8() and j_compat.supports_float8():
        assert _fields(PRECISION_PRESETS["fp8"]) == _fields(J_PRESETS["fp8"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "float64"])
def test_residual_tolerance_takes_names_as_reference(dtype):
    assert (verify.residual_tolerance(dtype)
            == verify.residual_tolerance(getattr(torch, dtype))
            == j_verify.residual_tolerance(dtype))


def test_residual_tolerance_rejects_float8_and_unknown_names():
    for name in ("float8_e4m3fn", "int8", "float"):
        with pytest.raises(ValueError):
            verify.residual_tolerance(name)


# ----------------------------------------------------------- the entry points


def test_exact_is_bitwise_the_plain_call():
    a = _matrix("spd")
    rhs = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (N, 3), dtype=np.float32))
    for precision in ("exact", "f32", PRECISION_PRESETS["auto"]):
        assert torch.equal(spin_inverse_dense(a, BS, "cuda", device="cpu"),
                           spin_inverse_dense(a, BS, "cuda", device="cpu",
                                              precision=precision))
        assert torch.equal(spin_solve_dense(a, rhs, BS, device="cpu"),
                           spin_solve_dense(a, rhs, BS, device="cpu",
                                            precision=precision))
        bm = BlockMatrix.from_dense(a, BS)
        assert torch.equal(spin_inverse(bm).blocks,
                           spin_inverse(bm, precision=precision).blocks)
    batch = torch.stack([a, _matrix("diag_dominant")])
    assert torch.equal(spin_inverse_batched(batch, BS, device="cpu"),
                       spin_inverse_batched(batch, BS, device="cpu",
                                            precision="exact"))


def _call_site(site, a, rhs, **kwargs):
    if site == "spin_inverse_dense":
        return spin_inverse_dense(a, BS, "linalg", device="cpu", **kwargs)
    if site == "spin_solve_dense":
        return spin_solve_dense(a, rhs, BS, "linalg", device="cpu", **kwargs)
    return spin_inverse_batched(a[None], BS, "linalg", device="cpu", **kwargs)


@pytest.mark.parametrize("site", ["spin_inverse_dense", "spin_solve_dense",
                                  "spin_inverse_batched"])
def test_compute_dtype_warns_once_a_site_and_is_bitwise(site):
    a = _matrix("spd", 64)
    rhs = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64, 2), dtype=np.float32))
    _WARNED_SITES.discard(site)
    with pytest.warns(DeprecationWarning, match=site):
        old = _call_site(site, a, rhs, compute_dtype=torch.bfloat16)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        again = _call_site(site, a, rhs, compute_dtype=torch.bfloat16)
    new = _call_site(site, a, rhs, precision=PrecisionPolicy(
        name="legacy", compute_dtype="bfloat16", polish_sweeps=0))
    assert old.dtype == torch.float32     # computed in bf16, returned in f32
    assert torch.equal(old, new) and torch.equal(old, again)


@pytest.mark.parametrize("sweeps", [0, 1])
@pytest.mark.parametrize("leaf", ["linalg", "cuda"])
@pytest.mark.parametrize("family", WELL_POSED)
def test_bf16_inverse_matches_reference(family, leaf, sweeps):
    a = _matrix(family)
    policy = dataclasses.replace(BF16, polish_sweeps=sweeps)
    x = spin_inverse_dense(a, BS, leaf, engine="cuda", device="cpu",
                           precision=policy)
    want = j_spin_inverse_dense(_to_jax(a), BS, "linalg", precision=
                                dataclasses.replace(J_BF16, polish_sweeps=sweeps))
    assert x.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert verify.inverse_residual(a, x) <= BF16_BOUND
    assert j_verify.inverse_residual(_to_jax(a), want) <= BF16_BOUND
    if sweeps:
        # Polished, both are within an f32 rounding of A⁻¹ before the bf16
        # store, so they differ by at most one bf16 ulp (2⁻⁷ relative).
        ref = _from_jax(want).float()
        assert float((x.float() - ref).abs().max()) <= 2.0 ** -7 * float(
            ref.abs().max())


def test_bf16_ill_conditioned_needs_polish_in_both():
    """κ = 1e2: the raw bf16 recursion misses the bf16 bound, and three f32
    Newton–Schulz sweeps bring it under, in both packages. The polished
    residual sits near the bound for this κ in both (the bf16 store of X
    alone costs about κ·2⁻⁸ of it)."""
    a = testing.make_ill_conditioned_spd(N, np.random.default_rng([7, 0]),
                                         cond=1e2, device="cpu")
    aj = _to_jax(a)
    for sweeps, over in ((0, True), (3, False)):
        x = spin_inverse_dense(a, BS, "linalg", device="cpu", precision=
                               dataclasses.replace(BF16, polish_sweeps=sweeps))
        xj = j_spin_inverse_dense(aj, BS, "linalg", precision=
                                  dataclasses.replace(J_BF16, polish_sweeps=sweeps))
        for res in (verify.inverse_residual(a, x), j_verify.inverse_residual(aj, xj)):
            assert (res > BF16_BOUND) == over, (sweeps, res)


@pytest.mark.parametrize("sweeps", [0, 1, 2, 3])
@pytest.mark.parametrize("grid", [1, 2, 4])
def test_newton_schulz_matches_reference(grid, sweeps):
    n = grid * BS
    a = _matrix("spd", n)
    # x0: the inverse rounded through bf16, the polish's real starting point.
    x0 = torch.linalg.inv(a).to(torch.bfloat16).float()
    bm, bx = BlockMatrix.from_dense(a, BS), BlockMatrix.from_dense(x0, BS)
    jbm = JBlockMatrix.from_dense(_to_jax(a), BS)
    jbx = JBlockMatrix.from_dense(_to_jax(x0), BS)
    x = newton_schulz_polish(bm, bx, sweeps=sweeps).to_dense()
    want = _from_jax(j_polish(jbm, jbx, sweeps=sweeps).to_dense())
    assert x.dtype == torch.float32
    assert float((x - want).abs().max()) <= 1e-5 * float(want.abs().max())
    got_r = float(residual_norm(bm, BlockMatrix.from_dense(x, BS)))
    want_r = float(j_residual_norm(jbm, JBlockMatrix.from_dense(_to_jax(x), BS)))
    assert abs(got_r - want_r) <= 1e-5
    if sweeps:
        assert got_r < float(residual_norm(bm, bx))


def test_bf16_solve_returns_at_rhs_dtype_as_reference():
    a = _matrix("spd", 64)
    rhs = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, 3), dtype=np.float32))
    x = spin_solve_dense(a, rhs, BS, "cuda", engine="cuda", device="cpu",
                         precision="bf16")
    want = j_spin_solve_dense(_to_jax(a), _to_jax(rhs), BS, "linalg",
                              precision="bf16")
    assert x.dtype == rhs.dtype and want.dtype == jnp.float32
    exact = torch.linalg.solve(a, rhs)
    for got in (x, _from_jax(want)):
        assert float(torch.linalg.norm(got - exact) / torch.linalg.norm(exact)) <= BF16_BOUND
    assert verify.solve_residual(a, x, rhs) <= BF16_BOUND


def test_bf16_batched_inverse_returns_store_dtype_as_reference():
    batch = torch.stack([_matrix("spd", 64, seed=s) for s in range(2)])
    got = spin_inverse_batched(batch, BS, "linalg", device="cpu",
                               precision="bf16")
    want = j_spin_inverse_batched(_to_jax(batch), BS, "linalg",
                                  precision="bf16")
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    for i in range(2):
        assert verify.inverse_residual(batch[i], got[i]) <= BF16_BOUND
        # No polish on the batched path: both round the bf16 recursion.
        ref = _from_jax(want[i]).float()
        assert float((got[i].float() - ref).abs().max()) <= 2e-2 * float(
            ref.abs().max())


def test_blockmatrix_precision_matches_reference():
    a = _matrix("spd")
    x = spin_inverse(BlockMatrix.from_dense(a, BS), precision="bf16")
    want = j_spin_inverse(JBlockMatrix.from_dense(_to_jax(a), BS),
                          precision="bf16")
    assert x.dtype == torch.bfloat16
    ref = _from_jax(want.to_dense()).float()
    assert float((x.to_dense().float() - ref).abs().max()) <= 2.0 ** -7 * float(
        ref.abs().max())


def test_env_preset_reaches_the_entry_points(monkeypatch):
    a = _matrix("spd", 64)
    monkeypatch.setenv("SPIN_PRECISION", "bf16")
    monkeypatch.setenv("SPIN_PRECISION_POLISH_SWEEPS", "0")
    x = spin_inverse_dense(a, BS, device="cpu")
    raw = spin_inverse_dense(a, BS, device="cpu",
                             precision=dataclasses.replace(BF16, polish_sweeps=0))
    assert x.dtype == torch.bfloat16 and torch.equal(x, raw)
