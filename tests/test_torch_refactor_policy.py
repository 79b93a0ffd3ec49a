"""The refactor-or-update policy: the PyTorch port against the JAX package.

On CPU signatures the port's decisions and prices equal the reference's
(prices within 1e-9 relative: both evaluate the same model). On a CUDA
signature (built by hand, no card) the SMW side is the card's bound: the
larger of the f32 flop time and two passes of the resident inverse
through HBM.
"""

import json

import jax.numpy as jnp
import pytest
import torch

from repro import planner as jp
from repro_torch.core.costmodel import H100_SXM
from repro_torch.planner import (PlanCache, RefactorPolicy, get_plan,
                                 signature_for, smw_update_cost)


def _policies(tmp_path, **kw):
    return (RefactorPolicy(cache=PlanCache(str(tmp_path / "port.json")), **kw),
            jp.RefactorPolicy(cache=jp.PlanCache(str(tmp_path / "ref.json")), **kw))


def _same(d, jd) -> None:
    assert (d.refactor, d.reason) == (jd.refactor, jd.reason)
    for field in ("smw_cost_s", "refactor_cost_s", "cumulative_s"):
        assert getattr(d, field) == pytest.approx(getattr(jd, field), rel=1e-9)
    assert d.plan.block_size == jd.plan.block_size


def test_signature_update_rank_axis():
    base = signature_for("inverse", 256, torch.float32, backend="cpu", cores=4)
    churned = signature_for("inverse", 256, torch.float32, backend="cpu",
                            cores=4, update_rank=16)
    assert base.update_rank == 0 and "/u" not in base.key()
    assert churned.key() == base.key() + "/u16"
    assert churned.key() == jp.signature_for(
        "inverse", 256, jnp.float32, backend="cpu", device_count=1, cores=4,
        update_rank=16).key()


def test_update_rank_plans_round_trip_the_cache(tmp_path):
    cache = PlanCache(str(tmp_path / "plans.json"))
    plan = get_plan("inverse", 256, torch.float32, measure=False, cache=cache,
                    update_rank=16, backend="cpu")
    sig = signature_for("inverse", 256, torch.float32, update_rank=16,
                        backend="cpu")
    assert cache.get(sig).execution_key() == plan.execution_key()
    assert cache.get(signature_for("inverse", 256, torch.float32,
                                   backend="cpu")) is None
    assert PlanCache(str(tmp_path / "plans.json")).get(sig) is not None


@pytest.mark.parametrize("n,k", [(512, 1), (512, 8), (4096, 64)])
def test_smw_update_cost_equals_reference_on_cpu(n, k):
    sig = signature_for("inverse", n, torch.float32, backend="cpu", cores=4)
    jsig = jp.signature_for("inverse", n, jnp.float32, backend="cpu",
                            device_count=1, cores=4)
    assert smw_update_cost(sig, k) == pytest.approx(jp.smw_update_cost(jsig, k),
                                                    rel=1e-9)
    calib = {"t_flop": 3e-11}
    assert smw_update_cost(sig, k, calib) == pytest.approx(
        jp.smw_update_cost(jsig, k, calib), rel=1e-9)


def test_smw_update_cost_scales_linearly_in_rank_and_is_bound_on_the_card():
    sig = signature_for("inverse", 512, torch.float32, backend="cpu", cores=4)
    c1, c8 = smw_update_cost(sig, 1), smw_update_cost(sig, 8)
    assert c1 > 0 and c8 == pytest.approx(8 * c1, rel=0.05)
    n = 16384
    card = signature_for("inverse", n, torch.float32, backend="cuda")
    for k in (1, 64, 2048):
        flops = (4 * n * n * k + k ** 3) * 2 / H100_SXM["peak_flops_f32"]
        hbm = 2 * n * n * 4 / H100_SXM["hbm_bw"]
        assert smw_update_cost(card, k) == pytest.approx(max(flops, hbm))
    # small ranks stream the resident inverse: a bf16 store halves them
    bf16 = signature_for("inverse", n, torch.float32, backend="cuda",
                         precision="bf16")
    assert smw_update_cost(bf16, 1) == pytest.approx(smw_update_cost(card, 1) / 2)


def test_decide_equals_reference_and_is_rent_or_buy(tmp_path):
    pol, jpol = _policies(tmp_path)
    fresh = pol.decide(256, torch.float32, new_rank=4, backend="cpu")
    _same(fresh, jpol.decide(256, jnp.float32, new_rank=4))
    assert not fresh.refactor and fresh.reason == "smw"
    assert fresh.cumulative_s == pytest.approx(fresh.smw_cost_s)
    spent = pol.decide(256, torch.float32, new_rank=4, pending_rank=16,
                       cumulative_s=fresh.refactor_cost_s, backend="cpu")
    _same(spent, jpol.decide(256, jnp.float32, new_rank=4, pending_rank=16,
                             cumulative_s=fresh.refactor_cost_s))
    assert spent.refactor and spent.reason == "crossover"
    lax, jlax = _policies(tmp_path, slack=1e6)
    d = lax.decide(256, torch.float32, new_rank=4, pending_rank=16,
                   cumulative_s=fresh.refactor_cost_s, backend="cpu")
    _same(d, jlax.decide(256, jnp.float32, new_rank=4, pending_rank=16,
                         cumulative_s=fresh.refactor_cost_s))
    assert not d.refactor


def test_drift_and_rank_bounds_override_cost(tmp_path):
    pol, jpol = _policies(tmp_path)
    for kw in ({"residual_est": 1.0, "drift_tolerance": 1e-2},
               {"pending_rank": 124}):
        d = pol.decide(256, torch.float32, new_rank=4, backend="cpu", **kw)
        _same(d, jpol.decide(256, jnp.float32, new_rank=4, **kw))
    assert pol.decide(256, torch.float32, new_rank=4, residual_est=1.0,
                      drift_tolerance=1e-2, backend="cpu").reason == "drift"
    assert pol.decide(256, torch.float32, new_rank=4, pending_rank=124,
                      backend="cpu").reason == "rank"


def test_crossover_rank_and_reinversion_cost_equal_reference(tmp_path):
    pol, jpol = _policies(tmp_path)
    r256 = pol.crossover_rank(256, torch.float32, step_rank=8, backend="cpu")
    r1024 = pol.crossover_rank(1024, torch.float32, step_rank=8, backend="cpu")
    assert r256 == jpol.crossover_rank(256, jnp.float32, step_rank=8)
    assert r1024 == jpol.crossover_rank(1024, jnp.float32, step_rank=8)
    assert 8 <= r256 <= 256 and r1024 >= r256
    assert pol.reinversion_cost(512, torch.float32, backend="cpu") == pytest.approx(
        jpol.reinversion_cost(512, jnp.float32), rel=1e-9)


def test_crossover_rank_on_the_card():
    # a rank-1 update streams the 1 GiB inverse twice (0.64 ms at
    # 3.35 TB/s); the re-inversion is the fitted model's ≈ 96 ms
    pol = RefactorPolicy()
    rank = pol.crossover_rank(16384, torch.float32, backend="cuda")
    reinvert = pol.reinversion_cost(16384, torch.float32, backend="cuda")
    step = smw_update_cost(signature_for("inverse", 16384, torch.float32,
                                         backend="cuda"), 1)
    assert rank == int(-(-reinvert // step))
    assert 100 < rank < 200


def test_policy_validates_slack():
    with pytest.raises(ValueError):
        RefactorPolicy(slack=0.0)


def test_decide_buckets_rank_axis_to_powers_of_two(tmp_path):
    path = tmp_path / "plans.json"
    pol = RefactorPolicy(cache=PlanCache(str(path)))
    cumulative, rank = 0.0, 0
    for _ in range(9):
        d = pol.decide(256, torch.float32, new_rank=1, pending_rank=rank,
                       cumulative_s=cumulative, backend="cpu")
        rank += 1
        cumulative = d.cumulative_s
    keys = [k for k in json.loads(path.read_text())["plans"] if "/u" in k]
    assert len(keys) <= 5, keys
    assert all(int(k.split("/u")[1].split("/")[0]) in (1, 2, 4, 8, 16)
               for k in keys), keys
