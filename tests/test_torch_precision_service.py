"""Certified low-precision serving in the PyTorch port's SpinService, held
to the service-side tests of `tests/test_precision.py` and to the JAX
package's service on the same inputs.

bf16 answers are held to the preset's bound (`BF16.bound("float32")`,
2e-2) against a float64 solve. Certification polishes only while the
probe exceeds the bound, so on a matrix whose bf16 inverse is already
inside it the count of polish triggers is the JAX service's, whatever
that is (its own test of this path expects ≥ 1 and is red, a caveat of
the reference); a policy with a tolerance no bf16 store can meet forces
the polish in both services, to the policy's cap.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precision import PrecisionPolicy as JPrecisionPolicy
from repro.serving import SpinService as JSpinService
from repro_torch.core import PRECISION_PRESETS, resolve_precision, testing
from repro_torch.serving import SpinService

BF16 = PRECISION_PRESETS["bf16"]
BF16_BOUND = BF16.bound("float32")


def _spd(n: int, seed: int) -> torch.Tensor:
    return testing.make_spd(n, np.random.default_rng(seed), device="cpu")


def _normal(seed: int, *shape) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32))


def _serve_one(svc, mid, rhs):
    req = svc.solve(mid, rhs)
    svc.run_until_done()
    return req


def _rel_err(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> float:
    ref = torch.linalg.solve(a.double(), b.double())
    return float(torch.linalg.norm(x.double() - ref) / torch.linalg.norm(ref))


def test_service_bf16_serves_maintained_with_residual():
    n = 128
    a = _spd(n, 0)
    svc = SpinService(slots=4, device="cpu")
    st = svc.add_matrix("m", a, precision="bf16")
    assert st.precision == "bf16" and st.store_dtype == "bfloat16"
    assert st.inv.dtype == torch.bfloat16
    assert st.serve_bound == BF16_BOUND
    assert st.drift.residual_est <= st.serve_bound     # certified at admit
    rhs = _normal(1, n)
    req = _serve_one(svc, "m", rhs)
    assert req.path == "maintained"                    # never the recursion
    assert req.residual_est is not None
    assert req.residual_est <= st.serve_bound
    assert req.x.dtype == rhs.dtype
    assert _rel_err(a, req.x, rhs) <= BF16_BOUND
    assert svc.stats["lowp_serves"] == 1
    snap = svc.metrics()
    assert snap["residual"]["count"] == 1
    assert snap["counters"]["path_maintained"] == 1


def _churn(svc, a_arr, to, n):
    st = svc.add_matrix("ill", a_arr, precision="bf16")
    residuals = [st.drift.residual_est]
    for i in range(3):
        u = 0.05 * _normal(10 + i, n, 2)
        svc.update("ill", to(u), to(u))
        svc.run_until_done()
        residuals.append(st.drift.residual_est)
    req = _serve_one(svc, "ill", to(_normal(2, n)))
    return st, residuals, req


def test_service_certifies_under_churn_and_counts_polish():
    """SMW churn on a bf16-maintained inverse: every certification probes
    through the bf16 product and stays within the bound, and the polish
    fires as often as in the JAX service on the same inputs."""
    n = 128
    a = testing.make_ill_conditioned_spd(n, np.random.default_rng(5),
                                         cond=1e2, device="cpu")
    svc = SpinService(slots=2, device="cpu")
    st, residuals, req = _churn(svc, a, lambda t: t, n)
    ref = JSpinService(slots=2)
    jst, _, _ = _churn(ref, jnp.asarray(a.numpy()),
                       lambda t: jnp.asarray(t.numpy()), n)
    assert all(r <= st.serve_bound for r in residuals)
    assert req.path == "maintained" and req.residual_est <= st.serve_bound
    assert st.polish_triggers == jst.polish_triggers
    assert svc.stats["polish_triggers"] == ref.stats["polish_triggers"]
    assert svc.stats["polish_sweeps"] >= svc.stats["polish_triggers"]
    assert (svc.metrics()["counters"].get("polish_triggers", 0)
            == svc.stats["polish_triggers"])


def test_service_tight_tolerance_forces_polish_to_its_cap():
    """tolerance=1e-4 is below what a bf16 store can hold, so every
    certification fires the polish and gives up at max_polish_sweeps, in
    both services alike; the counters land in stats and metrics()."""
    n = 64
    a = _spd(n, 3)
    tight = dataclasses.replace(BF16, name="tight", tolerance=1e-4,
                                max_polish_sweeps=3)
    j_tight = dataclasses.replace(JPrecisionPolicy.from_descriptor("bf16"),
                                  name="tight", tolerance=1e-4,
                                  max_polish_sweeps=3)
    u = 0.05 * _normal(4, n, 2)
    svc = SpinService(slots=2, device="cpu")
    ref = JSpinService(slots=2)
    st = svc.add_matrix("m", a, precision=tight)
    jst = ref.add_matrix("m", jnp.asarray(a.numpy()), precision=j_tight)
    svc.update("m", u, u)
    ref.update("m", jnp.asarray(u.numpy()), jnp.asarray(u.numpy()))
    svc.run_until_done()
    ref.run_until_done()
    assert st.serve_bound == 1e-4 and st.drift.residual_est > 1e-4
    assert st.polish_triggers == 2 and st.polish_sweeps == 2 * 3
    assert (st.polish_triggers, st.polish_sweeps) == \
        (jst.polish_triggers, jst.polish_sweeps)
    assert svc.stats["polish_sweeps"] == 6
    counters = svc.metrics()["counters"]
    assert counters["polish_triggers"] == 2 and counters["polish_sweeps"] == 6
    assert st.inv.dtype == torch.bfloat16              # recast after polish


def test_service_snapshot_restores_policy_and_serves_bitwise(tmp_path):
    n = 64
    a = _spd(n, 0)
    svc = SpinService(slots=2, precision="bf16", device="cpu")
    st = svc.add_matrix("m", a)               # service default policy
    rhs = _normal(1, n)
    before = _serve_one(svc, "m", rhs)
    svc.snapshot(str(tmp_path / "snap"))
    svc2 = SpinService.restore(str(tmp_path / "snap"), device="cpu")
    st2 = svc2._matrices["m"]
    assert st2.precision == st.precision
    assert st2.store_dtype == st.store_dtype
    assert st2.serve_bound == st.serve_bound
    assert st2.polish_triggers == st.polish_triggers
    assert st2.inv.dtype == torch.bfloat16    # store dtype survives the I/O
    after = _serve_one(svc2, "m", rhs)
    assert after.path == "maintained"
    assert torch.equal(after.x, before.x)     # bit-identical resumed serving
    assert resolve_precision(svc2.precision).descriptor() == "bf16"


def test_service_eviction_spill_preserves_bf16_store(tmp_path):
    n = 64
    svc = SpinService(slots=2, max_resident=1,
                      spill_dir=str(tmp_path / "spill"), device="cpu")
    svc.add_matrix("hot", _spd(n, 0), precision="bf16")
    svc.add_matrix("cold", _spd(n, 1))        # evicts "hot"
    assert not svc.is_resident("hot")
    req = _serve_one(svc, "hot", _normal(2, n))   # rehydrates
    st = svc._matrices["hot"]
    assert st.precision == "bf16" and st.inv.dtype == torch.bfloat16
    assert req.path == "maintained" and req.residual_est <= st.serve_bound


def test_service_rejects_sharded_lowp():
    svc = SpinService(slots=2, device="cpu")
    with pytest.raises(ValueError, match="dense-only"):
        svc.add_matrix("m", _spd(64, 0), sharded=True, precision="bf16")


def test_service_exact_path_unchanged_without_policy():
    n = 64
    svc = SpinService(slots=2, device="cpu")
    st = svc.add_matrix("m", _spd(n, 0))
    assert st.precision == "" and st.inv.dtype == torch.float32
    req = _serve_one(svc, "m", _normal(1, n))
    assert req.path == "recursion" and req.residual_est is None
    assert svc.stats["lowp_serves"] == 0


def test_serving_reexports_precision():
    import repro_torch.core as core
    import repro_torch.serving as serving

    for mod in (core, serving):
        assert mod.PrecisionPolicy is core.PrecisionPolicy
        assert mod.resolve_precision is resolve_precision
        assert "PrecisionPolicy" in mod.__all__
