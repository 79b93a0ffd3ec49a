"""The port's mixture of experts against the JAX package, on the CPU.

Expert and router weights come from the JAX package's initializer,
carried across bit for bit by `repro_torch.bridge`; inputs are drawn with
numpy from a seed and handed to both packages. The routes (the top-k
expert sets) must be the same; outputs and the aux losses agree to 2e-2
of the largest entry in bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import moe as j_moe
from repro.models.layers import init_tree as j_init_tree
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import Mesh, set_mesh
from repro_torch.models import moe
from repro_torch.optim import SpinShampooConfig, spin_shampoo_init

BF16_RTOL = 2e-2
# (config, model_size_hint): reduced qwen2-moe has 4 experts top-2 and
# shared experts; hint 8 pads them to 8 (4 phantoms). Reduced dbrx has 4
# experts top-2 and no shared expert.
CASES = [("qwen2-moe-a2.7b", 8), ("qwen2-moe-a2.7b", 1), ("dbrx-132b", 1)]


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got: torch.Tensor, want) -> float:
    w = _np(want)
    return float(np.abs(got.detach().float().numpy() - w).max()) / max(
        float(np.abs(w).max()), 1e-30)


def _with_cf(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _setup(name, hint, cf=None, t=(2, 16), seed=1):
    jcfg, cfg = j_get_arch(name).reduced(), get_arch(name).reduced()
    if cf is not None:
        jcfg, cfg = _with_cf(jcfg, cf), _with_cf(cfg, cf)
    jp = j_init_tree(j_moe.moe_params(jcfg, model_size_hint=hint), jax.random.PRNGKey(0))
    tp = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((*t, cfg.d_model)),
                    jnp.float32).astype(jnp.bfloat16)
    return jcfg, cfg, jp, tp, x, bridge.to_torch(np.asarray(x), "cpu")


def _j_routes(jp, x, jcfg):
    """The reference's router, as `_moe_local` computes it."""
    moe_cfg = jcfg.moe
    tokens = x.reshape(-1, x.shape[-1])
    logits = tokens.astype(jnp.float32) @ jp["router"].astype(jnp.float32)
    e_pad = jp["router"].shape[1]
    logits = jnp.where(jnp.arange(e_pad)[None, :] < moe_cfg.num_experts, logits, -1e30)
    return jax.lax.top_k(jax.nn.softmax(logits, axis=-1), moe_cfg.top_k)


@pytest.mark.parametrize("name,hint", CASES)
def test_moe_params_match_the_reference(name, hint):
    jdefs = j_moe.moe_params(j_get_arch(name), model_size_hint=hint)
    defs = moe.moe_params(get_arch(name), model_size_hint=hint)
    flat = jax.tree_util.tree_flatten_with_path(
        jdefs, is_leaf=lambda d: isinstance(d, j_moe.ParamDef))[0]
    assert len(flat) == sum(1 for _ in _walk(defs))
    for path, d in flat:
        node = defs
        for key in path:
            node = node[key.key]
        assert node.shape == d.shape and node.logical == d.logical
        assert (node.dtype == torch.float32) == (d.dtype == jnp.float32)
    assert defs["router"].dtype == torch.float32


def _walk(tree):
    for v in tree.values():
        yield from (_walk(v) if isinstance(v, dict) else (v,))


@pytest.mark.parametrize("name,hint", CASES)
def test_moe_apply_matches_the_reference(name, hint):
    jcfg, cfg, jp, tp, xj, xt = _setup(name, hint)
    jout, jaux, jz = j_moe.moe_apply(jp, xj, jcfg)
    out, aux, z = moe.moe_apply(tp, xt, cfg)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == tuple(xt.shape)
    assert aux.dtype == z.dtype == torch.float32 and aux.ndim == z.ndim == 0
    # identical top-k routes
    jg, je = _j_routes(jp, xj, jcfg)
    _, _, gate, eidx = moe.route(xt, tp["router"], cfg)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(je))
    assert _rel(gate, jg / jnp.sum(jg, -1, keepdims=True)) <= 1e-5
    assert _rel(out, jout) <= BF16_RTOL
    assert abs(float(aux) - float(jaux)) <= BF16_RTOL * abs(float(jaux))
    assert abs(float(z) - float(jz)) <= BF16_RTOL * abs(float(jz))


def test_phantom_experts_are_never_chosen():
    """Twin of tests/test_models.py::test_moe_capacity_and_gates: 4 experts
    padded to 8 by the hint; the gates sum to 1, the output is finite, the
    aux loss positive."""
    _, cfg, _, tp, _, xt = _setup("qwen2-moe-a2.7b", 8, t=(4, 64), seed=2)
    assert tp["router"].shape[1] == 8 and cfg.moe.num_experts == 4
    logits, probs, gate, eidx = moe.route(xt, tp["router"], cfg)
    assert int(eidx.max()) < cfg.moe.num_experts
    assert float(probs[:, cfg.moe.num_experts:].max()) == 0.0
    assert torch.allclose(gate.sum(-1), torch.ones(gate.shape[0]))
    out, aux, z = moe.moe_apply(tp, xt, cfg)
    assert bool(torch.isfinite(out.float()).all()) and float(aux) > 0 and float(z) >= 0


def test_positions_by_dest_matches_the_reference():
    rng = np.random.default_rng(3)
    for n_dest in (1, 4, 7):
        dest = rng.integers(0, n_dest + 1, 50).astype(np.int32)   # n_dest: the OOB marker
        want = np.asarray(j_moe._positions_by_dest(jnp.asarray(dest), n_dest))
        got = moe._positions_by_dest(torch.from_numpy(dest), n_dest).numpy()
        live = dest < n_dest
        np.testing.assert_array_equal(got[live], want[live])


def test_capacity_drop_matches_the_reference_bits():
    """capacity_factor 0.05 (cap = max(8, int(0.05·t·k))): the dropped
    (token, choice) pairs are the reference's, bit for bit; the output is
    finite, agrees with the reference, and its norm falls below 0.7 of the
    undropped output's (twin of tests/test_models_extra.py::
    test_moe_capacity_drop_is_graceful)."""
    jcfg, cfg, jp, tp, xj, xt = _setup("dbrx-132b", 1, cf=0.05, t=(2, 64))
    _, je = _j_routes(jp, xj, jcfg)
    t, k = je.shape
    cap = max(8, int(jcfg.moe.capacity_factor * t * k))
    dest = je // jp["wi"].shape[0]                       # one model shard: all 0
    jpos = j_moe._positions_by_dest(dest.reshape(-1), 1).reshape(t, k)
    jdropped = np.asarray(jnp.where(jpos < cap, jpos, cap) >= cap)
    _, _, _, eidx = moe.route(xt, tp["router"], cfg)
    pos, dropped, got_cap = moe.first_level(eidx, cfg)
    assert got_cap == cap and 0 < int(dropped.sum()) < dropped.numel()
    np.testing.assert_array_equal(dropped.numpy(), jdropped)

    out, *_ = moe.moe_apply(tp, xt, cfg)
    jout, *_ = j_moe.moe_apply(jp, xj, jcfg)
    assert bool(torch.isfinite(out.float()).all())
    assert _rel(out, jout) <= BF16_RTOL
    full, *_ = moe.moe_apply(tp, xt, get_arch("dbrx-132b").reduced())
    assert float(out.float().norm()) < 0.7 * float(full.float().norm())


def test_second_level_drop_matches_the_reference():
    """Routes crowded onto one expert overflow its cap2 rows: the rows past
    it are dropped, as in the reference."""
    jcfg, cfg, jp, tp, xj, xt = _setup("dbrx-132b", 1, t=(2, 64), seed=4)
    router = np.zeros(np.asarray(jp["router"]).shape, np.float32)
    router[:, 0] = 1.0                                   # expert 0 wins everywhere
    router += 1e-3 * np.random.default_rng(5).standard_normal(router.shape)
    jp = {**jp, "router": jnp.asarray(router)}
    tp = {**tp, "router": torch.from_numpy(router)}
    jout, jaux, _ = j_moe.moe_apply(jp, xj, jcfg)
    out, aux, _ = moe.moe_apply(tp, xt, cfg)
    assert _rel(out, jout) <= BF16_RTOL
    assert abs(float(aux) - float(jaux)) <= BF16_RTOL * abs(float(jaux))


def test_moe_apply_keeps_its_gradient():
    """The dispatch is differentiable: x, the router and the expert weights
    receive gradients (the dropped slots take none)."""
    _, cfg, _, tp, _, xt = _setup("qwen2-moe-a2.7b", 1)
    leaves = {k: v.detach().requires_grad_() for k, v in tp.items() if k != "shared"}
    x = xt.detach().requires_grad_()
    out, aux, z = moe.moe_apply({**leaves, "shared": tp["shared"]}, x, cfg)
    (out.float().square().sum() + aux + z).backward()
    for t in (x, *leaves.values()):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.abs().max()) > 0


def test_moe_apply_refuses_a_model_axis():
    """A model axis that does not split the padded experts (4 over 3) is
    refused, as the reference's shard_map refuses it; one that splits them
    runs expert-parallel (tests/test_torch_moe_ep.py holds its numbers),
    and a model axis of 1 takes the local path, bit for bit."""
    _, cfg, _, tp, _, xt = _setup("dbrx-132b", 1)
    with set_mesh(Mesh([["cpu", "cpu", "cpu"]], ("data", "model"))):
        with pytest.raises(ValueError, match="does not split"):
            moe.moe_apply(tp, xt, cfg)
    with set_mesh(Mesh([["cpu", "cpu"]], ("data", "model"))):
        out, _, _ = moe.moe_apply(tp, xt, cfg)
    assert tuple(out.shape) == tuple(xt.shape)
    with set_mesh(Mesh([["cpu"], ["cpu"]], ("data", "model"))):
        local = moe.moe_apply(tp, xt, cfg)               # model axis 1: the local path
    for a, b in zip(local, moe.moe_apply(tp, xt, cfg)):
        assert torch.equal(a, b)


def test_spin_shampoo_leaves_stacked_expert_weights_to_adam():
    """(L, E, d, f) expert weights are not matrices to either package's
    SPIN-Shampoo: no factor, the Adam direction; the (L, d, E) router is
    (E padded to 16 by the default hint)."""
    from repro.optim import SpinShampooConfig as JConfig, spin_shampoo_init as j_init
    from repro.models import transformer as JT
    from repro_torch.models import transformer as T

    jcfg, cfg = j_get_arch("qwen2-moe-a2.7b").reduced(), get_arch("qwen2-moe-a2.7b").reduced()
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), model_size_hint=16)
    params = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jstate = j_init(jparams, JConfig())
    state = spin_shampoo_init(params, SpinShampooConfig())
    assert [f is None for f in state.factors] == [f is None for f in jstate.factors]
    shapes = [tuple(p.shape) for p in jax.tree.leaves(jparams)]
    by_shape = dict(zip(shapes, state.factors))
    assert by_shape[tuple(params["layers"]["moe"]["wi"].shape)] is None
    assert by_shape[tuple(params["layers"]["moe"]["router"].shape)] is not None
    assert T.param_defs(cfg)["layers"]["moe"]["wi"].shape == (2, 16, 64, 64)
