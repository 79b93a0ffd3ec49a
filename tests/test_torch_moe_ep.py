"""The port's expert-parallel MoE against the JAX package's, on CPU meshes.

The reference runs `moe_apply` under `make_mesh(shape, ("data",
"model"))` of fake host devices in a subprocess (`mesh_harness.run_mesh`);
the port runs it under a mesh of the CPU repeated (`make_worker_mesh(...,
devices=["cpu"] * n)`), one coordinate at a time. Weights come from the
reference's initializer (`model_size_hint` 4), the input and the output
cotangent from numpy, all in f32 so that the drops are the same on both
sides: under EP the capacities are per shard, and on the (1, 4) mesh at
capacity factor 1.25 the reference's EP output differs from its mesh-free
output by 37 % of the largest entry with these inputs. The port's EP is held to the
reference's EP to 1e-5 of the largest entry (f32, sums in another order),
its gradients to 1e-4.

The reference's shared experts under EP multiply each coordinate's
tokens by its `model` slice of the shared FFN and `psum` slices of
different tokens; the port follows the mesh-free semantics there, and
`test_reference_ep_shared_experts_mix_tokens` records the reference's
mismatch (ROADMAP §C, reference caveats).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesh_harness import run_mesh
from repro.configs import get_arch as j_get_arch
from repro.models import moe as j_moe
from repro.models.layers import init_tree as j_init_tree
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_worker_mesh, set_mesh
from repro_torch.models import moe
from repro_torch.parallel import collective_bytes, reset_collective_bytes

HINT = 4
X_SHAPE = (4, 16)
MESHES = [(4, 4), (2, 2), (1, 4)]
FACTORS = [1.25, 8.0]
OUT_RTOL = 1e-5           # f32 against f32: the same drops, sums in another order
GRAD_RTOL = 1e-4
PARAMS = ("router", "wi", "wg", "wo")

_CHILD = """
import numpy as np, jax, jax.numpy as jnp, dataclasses
from repro.compat import AxisType, make_mesh, set_mesh
from repro.configs import get_arch
from repro.models import moe as moe_mod
from repro.models.layers import init_tree

rng = np.random.default_rng(7)
devs = jax.devices()
for name, dtype, want_grad in (("dbrx-132b", jnp.float32, True),
                               ("qwen2-moe-a2.7b", jnp.bfloat16, False)):
    base = get_arch(name).reduced()
    params = init_tree(moe_mod.moe_params(base, model_size_hint=4), jax.random.PRNGKey(0))
    if dtype == jnp.float32:
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        x = jnp.asarray(rng.standard_normal((4, 16, base.d_model)), jnp.float32)
    else:
        x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, base.d_model),
                              jnp.float32).astype(jnp.bfloat16)
    ct = jnp.asarray(rng.standard_normal((4, 16, base.d_model)), jnp.float32)
    for cf in (1.25, 8.0):
        cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=cf))

        def loss(p, x):
            out, aux, z = moe_mod.moe_apply(p, x, cfg)
            return jnp.sum(out.astype(jnp.float32) * ct) + aux + z

        free = moe_mod.moe_apply(params, x, cfg)
        for shape in ((4, 4), (2, 2), (1, 4)):
            mesh = make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                             devices=devs[:shape[0] * shape[1]])
            with set_mesh(mesh):
                out, aux, z = jax.jit(lambda p, x: moe_mod.moe_apply(p, x, cfg))(params, x)
                res = {"name": name, "cf": cf, "mesh": list(shape),
                       "out": np.asarray(out, np.float32).tolist(),
                       "aux": float(aux), "z": float(z),
                       "free_out": np.asarray(free[0], np.float32).tolist(),
                       "free_aux": float(free[1]), "free_z": float(free[2])}
                if want_grad:
                    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
                    res["grads"] = {k: np.asarray(gp[k]).tolist()
                                    for k in ("router", "wi", "wg", "wo")}
                    res["grads"]["x"] = np.asarray(gx).tolist()
            emit_result(res)
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's EP runs, keyed (name, cf, mesh), from one
    16-device subprocess; the f32 input is regenerated here from the same
    seed."""
    out = run_mesh(_CHILD, devices=16, timeout=600)
    return {(r["name"], r["cf"], tuple(r["mesh"])): r for r in out}


def _cfg(name, cf):
    jcfg, cfg = j_get_arch(name).reduced(), get_arch(name).reduced()
    rep = lambda c: dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=cf))
    return rep(jcfg), rep(cfg)


def _inputs(name):
    """The child's weights (its PRNGKey(0) init) and f32 input and
    cotangent (its numpy seed), made the same way here."""
    jcfg = j_get_arch(name).reduced()
    jp = j_init_tree(j_moe.moe_params(jcfg, model_size_hint=HINT), jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((*X_SHAPE, jcfg.d_model))
    ct = rng.standard_normal((*X_SHAPE, jcfg.d_model))
    return jp, x.astype(np.float32), ct.astype(np.float32)


def _torch_params(jp):
    return {k: (_torch_params(v) if isinstance(v, dict) else torch.from_numpy(v.copy()))
            for k, v in jp.items()}


def _mesh(shape):
    return make_worker_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))


def _rel(got, want) -> float:
    w = np.asarray(want, np.float32)
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ep_matches_the_reference_ep(reference, shape, cf):
    ref = reference[("dbrx-132b", cf, shape)]
    _, cfg = _cfg("dbrx-132b", cf)
    jp, x, _ = _inputs("dbrx-132b")
    with set_mesh(_mesh(shape)):
        out, aux, z = moe.moe_apply(_torch_params(jp), torch.from_numpy(x), cfg)
    assert out.dtype == torch.float32 and aux.ndim == z.ndim == 0
    assert _rel(out, ref["out"]) <= OUT_RTOL
    assert abs(float(aux) - ref["aux"]) <= OUT_RTOL * abs(ref["aux"])
    assert abs(float(z) - ref["z"]) <= OUT_RTOL * abs(ref["z"])


def test_ep_drops_differ_from_the_mesh_free_drops(reference):
    """The (1, 4) mesh at factor 1.25 drops at the first level's per-shard
    capacity: EP and mesh-free differ by over a fifth of the output there
    (0.368 of the largest entry, the reference's own numbers), and the port's EP and mesh-free differ
    just as the reference's do; at factor 8 nothing drops and they agree."""
    jp, x, _ = _inputs("dbrx-132b")
    for cf, apart in ((1.25, True), (8.0, False)):
        ref = reference[("dbrx-132b", cf, (1, 4))]
        gap = _rel(np.asarray(ref["out"]), ref["free_out"])
        assert (gap > 0.2) if apart else (gap < OUT_RTOL), (cf, gap)
        _, cfg = _cfg("dbrx-132b", cf)
        p, xt = _torch_params(jp), torch.from_numpy(x)
        with set_mesh(_mesh((1, 4))):
            ep, _, _ = moe.moe_apply(p, xt, cfg)
        free, _, _ = moe.moe_apply(p, xt, cfg)
        assert abs(_rel(ep, free.detach().numpy()) - gap) <= 1e-4, cf


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ep_gradients_match_jax_grad(reference, shape, cf):
    ref = reference[("dbrx-132b", cf, shape)]["grads"]
    _, cfg = _cfg("dbrx-132b", cf)
    jp, x, ct = _inputs("dbrx-132b")
    p = {k: v.requires_grad_() for k, v in _torch_params(jp).items()}
    xt = torch.from_numpy(x).requires_grad_()
    with set_mesh(_mesh(shape)):
        out, aux, z = moe.moe_apply(p, xt, cfg)
        loss = torch.sum(out.float() * torch.from_numpy(ct)) + aux + z
    grads = torch.autograd.grad(loss, [p[k] for k in PARAMS] + [xt])
    for key, g in zip(PARAMS + ("x",), grads):
        assert _rel(g, ref[key]) <= GRAD_RTOL, (key, _rel(g, ref[key]))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ep_shared_experts_follow_the_mesh_free_semantics(shape):
    """qwen2-moe reduced (4 shared experts), f32, factor 8 (no drop at
    either level): the port's EP equals the reference's mesh-free
    `moe_apply`, shared experts included; aux is per group and z agrees."""
    jcfg, cfg = _cfg("qwen2-moe-a2.7b", 8.0)
    jp, x, _ = _inputs("qwen2-moe-a2.7b")
    jout, _, jz = j_moe.moe_apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg)
    reset_collective_bytes()
    with set_mesh(_mesh(shape)):
        out, aux, z = moe.moe_apply(_torch_params(jp), torch.from_numpy(x), cfg)
    assert _rel(out, np.asarray(jout)) <= OUT_RTOL
    assert abs(float(z) - float(jz)) <= OUT_RTOL * abs(float(jz))
    moved = collective_bytes()
    assert moved["all_to_all"] > 0 and moved["pmean"] > 0
    assert (moved["all_gather"] > 0) == (shape[0] > 1 or shape[1] > 1)


def test_reference_ep_shared_experts_mix_tokens(reference):
    """An observed fact about the reference, not the port's behaviour: its
    EP with shared experts (qwen2-moe reduced, bf16, PRNGKey(1) input)
    differs from its own mesh-free output by most of the output even at
    factor 8, where nothing drops (0.0127 of 0.0130 on (4, 4) and (1, 4),
    0.0084 on (2, 2) when measured), because each coordinate's shared-FFN
    slice is applied to its own tokens and the slices are psum'd over
    `model`."""
    for shape in MESHES:
        ref = reference[("qwen2-moe-a2.7b", 8.0, shape)]
        gap = _rel(np.asarray(ref["out"]), ref["free_out"])
        assert gap > 0.3, (shape, gap)
    # without shared experts (dbrx) the reference's EP agrees at factor 8
    ref = reference[("dbrx-132b", 8.0, (4, 4))]
    assert _rel(np.asarray(ref["out"]), ref["free_out"]) < OUT_RTOL


def test_ep_decode_keeps_the_sequence_whole(reference):
    """One token a row (decode): the sequence does not split over `model`,
    every coordinate of a `model` group routes the same tokens, and the
    result is the mesh-free one (factor 8)."""
    _, cfg = _cfg("dbrx-132b", 8.0)
    jp, x, _ = _inputs("dbrx-132b")
    p, xt = _torch_params(jp), torch.from_numpy(x[:, :1].copy())
    with set_mesh(_mesh((2, 2))):
        out, aux, z = moe.moe_apply(p, xt, cfg)
    free, faux, fz = moe.moe_apply(p, xt, cfg)
    assert _rel(out, free.numpy()) <= OUT_RTOL
    assert abs(float(z) - float(fz)) <= OUT_RTOL * abs(float(fz))
