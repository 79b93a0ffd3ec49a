"""The port's optimizers and schedule against the JAX package, on the CPU.

Parameters are the JAX package's `init_params` of reduced olmo-1b,
carried across by `repro_torch.bridge`; gradients are drawn with numpy
and handed to both packages; states go across with
`bridge.train_state_from_numpy`-style conversions. Also the two API gaps
this slice folds in: `core.testing.make_spd_batch` and
`core.blockmatrix.current_counts`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import spin_inverse_dense as j_spin_inverse_dense
from repro.core import testing as j_testing
from repro.core.blockmatrix import count_ops as j_count_ops
from repro.core.blockmatrix import current_counts as j_current_counts
from repro.models import transformer as JT
from repro.optim import adamw as j_adamw, schedule as j_schedule
from repro.optim import spin_shampoo as j_shampoo
from repro_torch import bridge, tree
from repro_torch.core import (count_ops, current_counts, solve_grid_for,
                              spin_inverse_dense, testing)
from repro_torch.optim import adamw, schedule, spin_shampoo
from repro_torch.planner import get_plan


def _np32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _params():
    cfg = j_get_arch("olmo-1b").reduced()
    jparams = JT.init_params(cfg, jax.random.PRNGKey(0), model_size_hint=1)
    return jparams, bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _grads(jparams, seed: int, scale: float):
    """The same bf16 gradients for both packages, drawn with numpy."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree.flatten(jparams)
    g = [jnp.asarray(rng.standard_normal(p.shape, dtype=np.float32) * scale,
                     jnp.bfloat16) for p in flat]
    jg = jax.tree.unflatten(treedef, g)
    return jg, bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jg), "cpu")


def _close(got_leaves, want_leaves, rel: float, what: str) -> None:
    assert len(got_leaves) == len(want_leaves), what
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        w = _np32(w)
        gv = g.detach().float().numpy()
        assert gv.shape == w.shape, (what, i)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(gv - w).max()) <= rel * scale, (what, i, float(np.abs(gv - w).max()), scale)


# Steps: two at a scale whose global norm is ~0.6 (reduced olmo-1b has
# ~1e5 parameters; not clipped) and a third 100x larger, past grad_clip = 1.
STEP_SCALES = (0.002, 0.002, 0.2)
# The global norm sums ~1e5 squares in f32, in another order than XLA's.
NORM_REL = 1e-5


def test_adamw_update_matches_the_reference_over_three_steps():
    jparams, params = _params()
    cfg = adamw.AdamWConfig()
    jcfg = j_adamw.AdamWConfig()
    jstate, state = j_adamw.adamw_init(jparams), adamw.adamw_init(params)
    for i, scale in enumerate(STEP_SCALES):
        jg, g = _grads(jparams, i, scale)
        lr_scale = 0.5 + 0.25 * i
        jnew, jstate, jnorm = j_adamw.adamw_update(jcfg, jg, jstate, lr_scale)
        new, state, gnorm = adamw.adamw_update(cfg, g, state, lr_scale)
        assert int(state.step) == int(jstate.step) == i + 1
        assert state.step.device.type == "cpu"
        assert (float(gnorm) > cfg.grad_clip) == (i == 2)
        # f32 state: the same arithmetic, rounded at other places (a fused
        # add, the bias correction on the host): a few f32 ulps.
        assert abs(float(gnorm) - float(jnorm)) <= NORM_REL * float(jnorm)
        for name in ("m", "v", "master"):
            _close(tree.leaves(getattr(state, name)),
                   jax.tree.leaves(getattr(jstate, name)), 1e-5, name)
        # bf16 params: the master's cast; a near tie may round one ulp apart.
        _close(tree.leaves(new), jax.tree.leaves(jnew), 2.0 ** -8, "params")
        assert all(p.dtype == torch.bfloat16 for p in tree.leaves(new))
    assert float(gnorm) > cfg.grad_clip          # the third step was clipped


def _damped(f: torch.Tensor, damping: float) -> list[np.ndarray]:
    """The damped factor(s) invert_spd inverts, in f64, one a layer."""
    mats = f.double().numpy()
    out = []
    for m in (mats if mats.ndim == 3 else mats[None]):
        n = m.shape[0]
        out.append(m + damping * (np.trace(m) / n + 1e-12) * np.eye(n))
    return out


def _residuals(f, inv, damping) -> list[float]:
    """max |(F + λI)·X − I| of each layer's inverse, in f64."""
    xs = np.asarray(inv, np.float64)
    xs = xs if xs.ndim == 3 else xs[None]
    return [float(np.abs(d @ x - np.eye(len(d))).max())
            for d, x in zip(_damped(f, damping), xs)]


def test_spin_shampoo_update_matches_the_reference_over_three_steps():
    """A refresh (step 1), a non-refresh (step 2) and a clipped step (3),
    at damping 0.1: the damped factors' condition is then ≤ 84 (the default
    1e-3 leaves the reduced model's rank-deficient Gram factors at up to
    8e3, where two f32 inversions differ by up to 9 %; the next test holds
    that case to the reference's own residual)."""
    jparams, params = _params()
    cfg = spin_shampoo.SpinShampooConfig(damping=0.1)
    jcfg = j_shampoo.SpinShampooConfig(damping=0.1)
    jstate = j_shampoo.spin_shampoo_init(jparams, jcfg)
    state = spin_shampoo.spin_shampoo_init(params, cfg)
    assert [f is None for f in state.factors] == [f is None for f in jstate.factors]
    assert sum(f is not None for f in state.factors) > 0
    for i, scale in enumerate(STEP_SCALES):
        jg, g = _grads(jparams, 10 + i, scale)
        jnew, jstate, jnorm = j_shampoo.spin_shampoo_update(jcfg, jg, jstate, 1.0)
        linv_before = [f.linv.clone() for f in state.factors if f is not None]
        new, state, gnorm = spin_shampoo.spin_shampoo_update(cfg, g, state, 1.0)
        refreshed = spin_shampoo.needs_refresh(i + 1, cfg)
        assert refreshed == (i == 0)
        assert (float(gnorm) > cfg.grad_clip) == (i == 2)
        changed = [not torch.equal(a, f.linv) for a, f in
                   zip(linv_before, [f for f in state.factors if f is not None])]
        assert all(changed) if refreshed else not any(changed)
        assert abs(float(gnorm) - float(jnorm)) <= NORM_REL * float(jnorm)
        for fac, jfac in zip(state.factors, jstate.factors):
            if fac is None:
                assert jfac is None
                continue
            # Gram factors: f32 products in another order, a few ulps.
            _close([fac.l, fac.r], [jfac.l, jfac.r], 1e-5, "gram")
            # The inverses: SPIN in f32 on other grids and leaves than the
            # reference's; condition ≤ 84 and n ≤ 256: κ·n·2^-24 ≤ 1.3e-3
            # bounds the difference, measured ≤ 1e-5 of the largest entry.
            _close([fac.linv, fac.rinv], [jfac.linv, jfac.rinv], 1e-4, "inverse")
        _close(state.m, jstate.m, 1e-5, "m")
        _close(state.v, jstate.v, 1e-5, "v")
        # master: lr 1e-3 times a grafted direction of Adam's norm.
        _close(state.master, jstate.master, 1e-5, "master")
        _close(tree.leaves(new), jax.tree.leaves(jnew), 2.0 ** -8, "params")


def test_spin_shampoo_refresh_is_as_accurate_as_the_reference_at_default_damping():
    """At the default damping the reduced model's factors reach condition
    8e3 (rank-deficient Gram matrices plus 1e-3 of their mean eigenvalue):
    each of the port's inverses must meet 4x the reference's residual on
    the same damped factor (or 1e-4, the f32 noise floor of the
    well-conditioned ones)."""
    jparams, params = _params()
    cfg, jcfg = spin_shampoo.SpinShampooConfig(), j_shampoo.SpinShampooConfig()
    jg, g = _grads(jparams, 10, STEP_SCALES[0])
    _, jstate, _ = j_shampoo.spin_shampoo_update(
        jcfg, jg, j_shampoo.spin_shampoo_init(jparams, jcfg), 1.0)
    _, state, _ = spin_shampoo.spin_shampoo_update(
        cfg, g, spin_shampoo.spin_shampoo_init(params, cfg), 1.0)
    worst = 0.0
    for fac, jfac in zip(state.factors, jstate.factors):
        if fac is None:
            continue
        for f, x, jx in ((fac.l, fac.linv, jfac.linv), (fac.r, fac.rinv, jfac.rinv)):
            for got, want in zip(_residuals(f, x.numpy(), cfg.damping),
                                 _residuals(f, jx, cfg.damping)):
                assert got <= max(4 * want, 1e-4), (got, want)
                worst = max(worst, got)
    assert worst > 1e-2        # the ill-conditioned embed factor is in the set


def test_invert_spd_uses_the_planned_grid():
    """Twin of tests/test_models_extra.py::test_spin_shampoo_invert_spd_uses_grid:
    invert_spd goes through the BlockMatrix recursion on the plan's grid
    for large divisible dims and stays accurate."""
    assert solve_grid_for(6144) == 8      # granite-34b d_model
    assert solve_grid_for(512) == 8
    assert solve_grid_for(50) == 1        # odd dims -> leaf
    m = testing.make_spd(512, np.random.default_rng(3), device="cpu")
    with count_ops() as counts:
        inv = spin_shampoo.invert_spd(m, damping=1e-6)
    resid = torch.linalg.norm(inv @ m - torch.eye(512)) / 512 ** 0.5
    assert float(resid) < 1e-2
    plan = get_plan("inverse", 512, torch.float32, measure=False, backend="cpu")
    assert counts.leaf_inversions == plan.grid(512)
    # the plan's whole configuration, not its block size alone
    damped = m + 1e-6 * (torch.trace(m) / 512 + 1e-12) * torch.eye(512)
    want = spin_inverse_dense(damped, plan.block_size, plan.leaf_solver,
                              engine=plan.multiply_engine, device="cpu")
    assert torch.equal(inv, want)
    # a stack inverts layer by layer, as the refresh does
    stack = testing.make_spd_batch(3, 64, np.random.default_rng(4), device="cpu")
    got = spin_shampoo.invert_spd(stack, damping=1e-3)
    for i in range(3):
        assert torch.equal(got[i], spin_shampoo.invert_spd(stack[i], damping=1e-3))


@pytest.mark.parametrize("step", [0, 1, 7, 50, 99, 100, 101, 5000, 9999, 10_000, 12_000])
def test_cosine_with_warmup_matches_the_reference(step):
    want = float(j_schedule.cosine_with_warmup(jnp.int32(step)))
    got = schedule.cosine_with_warmup(step)
    assert abs(got - want) <= 2.0 ** -23 * max(abs(want), 1e-30)   # one f32 ulp
    assert schedule.cosine_with_warmup(torch.tensor(step, dtype=torch.int32)) == got
    assert schedule.constant(step) == float(j_schedule.constant(jnp.int32(step)))


def test_make_spd_batch_matches_the_reference_family():
    """The draws differ (numpy against jax.random); the family is the same:
    shape, dtype, symmetry, and a spectrum inside [boost, boost + 4.5]
    (B Bᵀ/n of a square Gaussian B has its eigenvalues in [0, 4])."""
    for boost in (1.0, 0.1):
        want = np.asarray(j_testing.make_spd_batch(3, 64, jax.random.PRNGKey(0),
                                                   cond_boost=boost))
        got = testing.make_spd_batch(3, 64, np.random.default_rng(0),
                                     cond_boost=boost, device="cpu")
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        for mats in (got.numpy(), want):
            assert np.allclose(mats, np.swapaxes(mats, 1, 2), atol=1e-6)
            eig = np.linalg.eigvalsh(mats.astype(np.float64))
            assert eig.min() >= boost * (1 - 1e-5) and eig.max() <= boost + 4.5
        # each slice is make_spd drawn in turn from the same generator
        rng = np.random.default_rng(0)
        for i in range(3):
            assert torch.equal(got[i], testing.make_spd(64, rng, cond_boost=boost,
                                                        device="cpu"))


def test_current_counts_matches_the_reference():
    assert current_counts() is None and j_current_counts() is None
    # The reference counts while it traces: a size no other test of this
    # file inverts, so that its program is traced here.
    a = testing.make_spd(80, np.random.default_rng(5), device="cpu")
    with count_ops() as counts, j_count_ops() as j_counts:
        assert current_counts() is counts and j_current_counts() is j_counts
        spin_inverse_dense(a, 20, device="cpu")
        j_spin_inverse_dense(jnp.asarray(a.numpy()), 20)
        assert current_counts().as_dict() == j_current_counts().as_dict()
    assert counts.as_dict() == dataclasses.asdict(j_counts)
    assert current_counts() is None


def test_optimizer_state_crosses_the_bridge_bit_for_bit():
    from repro.runtime.trainer import TrainConfig as JTrainConfig
    from repro.runtime.trainer import init_state as j_init_state

    cfg = j_get_arch("olmo-1b").reduced()
    for opt in ("adamw", "spin_shampoo"):
        jstate = j_init_state(cfg, JTrainConfig(optimizer=opt),
                              jax.random.PRNGKey(1), 1)
        state = bridge.train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
        assert state.step.device.type == "cpu" and state.opt.step.dtype == torch.int32
        if opt == "spin_shampoo":
            assert [f is None for f in state.opt.factors] == \
                [f is None for f in jstate.opt.factors]
        back = bridge.train_state_to_numpy(state)
        jl, bl = jax.tree.leaves(jstate), tree.leaves(back)
        assert len(jl) == len(bl)
        for a, b in zip(jl, bl):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == np.asarray(b).tobytes()
        rebuilt = jax.tree.unflatten(jax.tree.structure(jstate), bl)
        assert type(rebuilt) is type(jstate)
