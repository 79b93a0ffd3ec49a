"""The partitioned MoE step on a (data, model) mesh of the CPU, against the
JAX package's placed jit, the port's global-view mesh step and its
mesh-free step.

The reference child (`mesh_harness.run_mesh`, 8 fake devices) runs
`make_train_step(cfg, tcfg, rules)` jitted with `in_shardings` from
`_param_state_specs` and `_batch_specs`, from `init_params(PRNGKey(0),
model_size_hint=4)`, with one correction: its expert-parallel
`moe_apply` multiplies each coordinate's tokens by that coordinate's
slice of the shared experts and `psum`s slices of different tokens
(ROADMAP §C, reference caveats), so the child computes the shared
experts as its mesh-free path does, on the whole tokens
(tests/test_torch_sharded_lm.py). It also runs the reference as it is
once in tests/test_torch_partition_moe_serve.py, which prints that gap. The port gets the same state laid
out by the reference's specs (`bridge.train_state_from_numpy(...,
shardings=state_shardings(...))`): the MoE body runs `_moe_ep` per
coordinate on the region `moe_apply` lays out (`moe_apply_laid_out`).

Every expert is chosen (top_k = num_experts, in the child too) where the
runs are held to the reference. Two programs that round the router's
bf16 input differently part at a near tie of the k-th and (k+1)-th
expert, and at top-2 of 4 experts the reduced models have k/(k+1) logit
gaps under 1e-3, about the router's move under one bf16 ulp of its
input, in every case: one token routed apart moves the expert weights'
gradients by up to 15 % of their largest entry and a prefill logit by
0.023 (ROADMAP §C, reference caveats). With every expert chosen the
dispatch, both levels, the expert products and the gated combine all
run, but no choice is discrete: a near tie swaps only the order of a
token's choices, and at these sizes no capacity is reached. The
reduced configs' own top-2, which drops choices at the first level, is
held to the port's global-view step token by token (the same drops, the
same dispatches up to ROUTES_APART_MAX of the tokens, none apart under
`dp_only`) and to the analytic count of bytes and calls.

Two AdamW steps of B 8 x S 32 in 2 microbatches, warmup 1, held as
tests/test_torch_partition.py holds the dense step: the loss to 2e-3
relative, every gradient (read from the first step's AdamW m) to 2^-5 of
its largest entry, qwen2-moe's router to 2^-4 (tests/test_torch_sharded_lm.py
says why), the masters to 2.02 · lr · lr_scale, the second step's update
a leaf within 3 % in norm and 0.9 in cosine; aux and z non-zero and
within 2e-3 of the reference's. The same against the port's global-view
step under the mesh (the same per-shard capacities, so the same drops),
and at capacity factor 8, where neither level drops a choice (counted),
against the mesh-free step, with aux out of both gradients there: laid
out it is each coordinate's group loss averaged, mesh-free one loss over
every token (the reference's two definitions), so z is held and aux not.

Reduced qwen2-moe-a2.7b (shared experts, rmsnorm) and dbrx-132b (no
shared experts, one KV head, layernorm), experts padded to 4, on (2, 4)
(E_loc 1) and (4, 2) (E_loc 2) under `default`, and on (2, 4) under
`dp_only` (the experts move from the FSDP layout to the expert axis by an
all_to_all); qwen2-moe also on (4, 1), where no `model` axis splits the
experts and the body runs on the whole batch at every coordinate, as
the reference's placed program runs `_moe_local`. The bytes and calls of
each collective kind in one step equal
`launch.dryrun.partitioned_step_collectives`.
"""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mesh_harness import run_mesh
from test_torch_partition import (LOSS_RTOL, MICRO, _assert_close, _batch, _batch_np, _grads,
                                  _id, _jax_state, _mesh, _tcfg, _whole)
from repro_torch import bridge, tree
from repro_torch.configs import get_arch
from repro_torch.launch.dryrun import RULES_VARIANTS, partitioned_step_collectives
from repro_torch.launch.mesh import set_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.parallel import collectives as col
from repro_torch.parallel.collectives import DistArray
from repro_torch.runtime.trainer import make_train_step, state_shardings

B, S = 8, 32
HINT = 4
ROUTER_TOL = 2.0 ** -4       # qwen2-moe's router: tests/test_torch_sharded_lm.py
NO_DROP_CF = 8.0
ARCHS = ["qwen2-moe-a2.7b", "dbrx-132b"]
CASES = [(a, s, r) for a in ARCHS
         for s, r in (((2, 4), "default"), ((2, 4), "dp_only"), ((4, 2), "default"))]
CASES.append(("qwen2-moe-a2.7b", (4, 1), "default"))   # no expert parallelism
ROUTES_APART_MAX = 0.02      # share of dispatched tokens two programs may route apart
KINDS = ("all_gather", "all_to_all", "reduce_scatter", "psum", "pmean", "pmax")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(name: str, cf: float | None = None, every: bool = True):
    """Reduced `name`, every expert chosen (`every`), at capacity factor `cf`."""
    cfg = get_arch(name).reduced()
    moe = cfg.moe
    if every:
        moe = dataclasses.replace(moe, top_k=moe.num_experts)
    if cf is not None:
        moe = dataclasses.replace(moe, capacity_factor=cf)
    return dataclasses.replace(cfg, moe=moe)


@contextlib.contextmanager
def _aux_without_gradient():
    """aux enters the loss with no gradient while open (its value stays)."""
    losses = moe_mod._losses

    def detached(*args, **kwargs):
        aux, z = losses(*args, **kwargs)
        return aux.detach(), z

    moe_mod._losses = detached
    try:
        yield
    finally:
        moe_mod._losses = losses


@contextlib.contextmanager
def _counting_drops():
    """The choices and rows either dispatch level drops while open."""
    drops = {"first": 0, "second": 0}
    first, second = moe_mod.first_level, moe_mod.second_level

    def first_level(*args, **kwargs):
        out = first(*args, **kwargs)
        drops["first"] += int(out[1].sum())
        return out

    def second_level(*args, **kwargs):
        out = second(*args, **kwargs)
        drops["second"] += int(out[1].sum())
        return out

    moe_mod.first_level, moe_mod.second_level = first_level, second_level
    try:
        yield drops
    finally:
        moe_mod.first_level, moe_mod.second_level = first, second


@contextlib.contextmanager
def _recording_routes():
    """The experts each dispatch chose, (tokens, k) a call, in call order,
    while open."""
    routes = []
    dispatch = moe_mod._dispatch

    def recorded(*args, **kwargs):
        r = dispatch(*args, **kwargs)
        routes.append(r["eidx"].detach().clone())
        return r

    moe_mod._dispatch = recorded
    try:
        yield routes
    finally:
        moe_mod._dispatch = dispatch


def _dispatches(routes: list, mesh, laid: bool) -> list:
    """`routes` one entry a dispatch of the program: laid out on a mesh
    without a `model` axis each coordinate routes the whole batch, so each
    of its groups of n equal calls counts once."""
    n = len(mesh.coords())
    if not laid or mesh.shape.get("model", 1) > 1:
        return routes
    groups = [routes[i:i + n] for i in range(0, len(routes), n)]
    assert all(torch.equal(g[0], r) for g in groups for r in g)
    return [g[0] for g in groups]


def _two_steps(name: str, mesh=None, rules: str = "default", laid: bool = True,
               cf: float | None = None, every: bool = True) -> dict:
    """Two AdamW steps of `name` from the reference's initial state: laid out
    by its specs on `mesh` (`laid`), whole under `mesh` (the global view),
    or whole without a mesh; the losses, aux, z, grad norms, the first
    step's gradients, the masters, the first step's counts and drops, and
    every dispatch's routes."""
    cfg = _cfg(name, cf, every)
    sh = (state_shardings(cfg, _tcfg(), mesh, RULES_VARIANTS[rules], HINT)
          if laid else None)
    state = bridge.train_state_from_numpy(_jax_state(name), "cpu", shardings=sh)
    step = make_train_step(cfg, _tcfg(), RULES_VARIANTS[rules])
    batch = _batch(cfg)
    init = [_whole(x) for x in tree.leaves(state.opt.master)]
    col.reset_collective_bytes()
    with set_mesh(mesh) if mesh is not None and not laid else contextlib.nullcontext(), \
            _counting_drops() as drops, _recording_routes() as routes, \
            _aux_without_gradient() if cf == NO_DROP_CF else contextlib.nullcontext():
        state, m1 = step(state, batch)
        counts = (col.collective_bytes(), col.collective_calls())
        first_m = [_whole(x) for x in tree.leaves(state.opt.m)]
        state, m2 = step(state, batch)
    return {"loss": [float(m1["loss"]), float(m2["loss"])],
            "aux": [float(m1["aux"]), float(m2["aux"])],
            "z": [float(m1["z"]), float(m2["z"])],
            "grad_norm": [float(m1["grad_norm"]), float(m2["grad_norm"])],
            "lr_scale": [m1["lr_scale"], m2["lr_scale"]],
            "grads": _grads(first_m, float(m1["grad_norm"])),
            "master": [_whole(x) for x in tree.leaves(state.opt.master)], "init": init,
            "counts": counts, "drops": drops, "state": state,
            "routes": _dispatches(routes, mesh, laid) if mesh is not None else routes}


_CHILD = """
import dataclasses, os, numpy as np, jax, jax.numpy as jnp
from repro.compat import AxisType, jit_shardings, make_mesh, set_mesh
from repro.configs import get_arch
from repro.launch.dryrun import RULES_VARIANTS, _batch_specs, _param_state_specs
from repro.models import moe as M, transformer as JT
from repro.runtime.trainer import TrainConfig, init_state, make_train_step

_ep = M.moe_apply


def _shared_free(params, x, cfg, rules=None):
    # the reference's EP for the routed experts; its shared experts as its
    # own mesh-free path computes them, on the whole tokens
    shared = params.get("shared")
    out, aux, z = _ep({k: v for k, v in params.items() if k != "shared"}, x, cfg)
    if shared is None:
        return out, aux, z
    hs = jnp.einsum("bsd,df->bsf", x, shared["wi"])
    gs = jnp.einsum("bsd,df->bsf", x, shared["wg"])
    hs = jax.nn.silu(gs.astype(jnp.float32)).astype(hs.dtype) * hs
    ys = jnp.einsum("bsf,fd->bsd", hs, shared["wo"]).astype(jnp.float32)
    return (out.astype(jnp.float32) + ys).astype(x.dtype), aux, z


def two_steps(cfg, rules, mesh, batch):
    tcfg = TrainConfig(microbatches=2, warmup=1, total_steps=100)
    state = init_state(cfg, tcfg, jax.random.PRNGKey(0), 4)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=cfg.moe.num_experts))
    with set_mesh(mesh):
        specs = (_param_state_specs(cfg, rules, mesh), _batch_specs(batch, rules, mesh))
        step = jax.jit(make_train_step(cfg, tcfg, rules),
                       in_shardings=jit_shardings(specs, mesh),
                       out_shardings=jit_shardings((specs[0], None), mesh))
        # the first step's aux and z (its metrics carry neither): each
        # microbatch's, placed alike, averaged as the step averages its loss
        rows = batch["tokens"].shape[0] // 2
        mbs = [{k: np.asarray(v)[i * rows:(i + 1) * rows] for k, v in batch.items()}
               for i in range(2)]
        losses = jax.jit(lambda p, b: JT.loss_fn(p, b, cfg, rules)[1],
                         in_shardings=jit_shardings((specs[0].params,
                                                     _batch_specs(mbs[0], rules, mesh)), mesh))
        metrics = [losses(state.params, mb) for mb in mbs]
        aux_z = [float(sum(m[k] for m in metrics)) / 2 for k in ("aux", "z")]
        s1, m1 = step(state, batch)
        first_m = [np.asarray(x, np.float32) for x in jax.tree.leaves(s1.opt.m)]
        s2, m2 = step(s1, batch)
    return s2, m1, m2, first_m, aux_z


M.moe_apply = _shared_free
out = OUT
for name, shape, rname in CASES:
    cfg, rules = get_arch(name).reduced(), RULES_VARIANTS[rname]
    mesh = make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:shape[0] * shape[1]])
    raw = np.load(os.path.join(out, "batch_" + name + ".npz"))
    batch = {k: jnp.asarray(raw[k]) for k in ("labels", "tokens")}
    key = "%s-%dx%d-%s" % (name, shape[0], shape[1], rname)
    s2, m1, m2, first_m, (aux, z) = two_steps(cfg, rules, mesh, batch)
    np.savez(os.path.join(out, key + ".npz"), *first_m,
             *[np.asarray(x, np.float32) for x in jax.tree.leaves(s2.opt.master)])
    emit_result({"case": key, "n": len(first_m),
                 "loss": [float(m1["loss"]), float(m2["loss"])],
                 "aux": [aux], "z": [z],
                 "grad_norm": [float(m1["grad_norm"]), float(m2["grad_norm"])],
                 "lr_scale": [float(m1["lr_scale"]), float(m2["lr_scale"])],
                 "wi_spec": str(s2.params["layers"]["moe"]["wi"].sharding.spec)})
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's placed jit, every case in one child."""
    out = tmp_path_factory.mktemp("partition_moe_ref")
    for name in ARCHS:
        np.savez(out / f"batch_{name}.npz", **_batch_np(get_arch(name).reduced()))
    code = (_CHILD.replace("OUT", repr(str(out)))
            .replace("CASES", repr([(a, list(s), r) for a, s, r in CASES])))
    got = {}
    for r in run_mesh(code, devices=8, timeout=900):
        arrays = np.load(out / f"{r['case']}.npz")
        n = r["n"]
        r["grads"] = _grads([arrays[f"arr_{i}"] for i in range(n)], r["grad_norm"][0])
        r["master"] = [arrays[f"arr_{n + i}"] for i in range(n)]
        got[r["case"]] = r
    return got


@pytest.fixture(scope="module")
def runs():
    """The port's runs, each made when first asked for: (case, kind) with
    kind "laid" (laid out), "mesh" (the global view under the mesh),
    "laid8" (laid out at capacity factor 8), "top2" and "mesh2" (laid out
    and the global view, the reduced config's own top-2); (name, "free8")
    the mesh-free step at capacity factor 8."""
    cache = {}

    def get(case, kind):
        key = (case if isinstance(case, str) else _id(case), kind)
        if key not in cache:
            if kind == "free8":
                cache[key] = _two_steps(case, laid=False, cf=NO_DROP_CF)
            else:
                name, shape, rules = case
                cache[key] = _two_steps(name, _mesh(shape), rules,
                                        laid=kind not in ("mesh", "mesh2"),
                                        cf=NO_DROP_CF if kind == "laid8" else None,
                                        every=kind not in ("top2", "mesh2"))
        return cache[key]

    return get


def _assert_moe_close(got: dict, want: dict, what: str, name: str,
                      losses: bool = True) -> None:
    """tests/test_torch_partition.py's bounds, qwen2-moe's router at 2^-4;
    aux and z non-zero and within LOSS_RTOL (`losses`)."""
    router = [i for i, (k, _) in enumerate(tree.leaves_with_path(got["state"].params))
              if k.endswith("router")]
    tol = ROUTER_TOL if name == "qwen2-moe-a2.7b" else None
    grads = [g if i not in router or tol is None else None
             for i, g in enumerate(got["grads"])]
    _assert_close({**got, "grads": [g for g in grads if g is not None]},
                  {**want, "grads": [w for g, w in zip(grads, want["grads"]) if g is not None]},
                  what)
    for i in router if tol is not None else []:
        g, w = np.asarray(got["grads"][i]), np.asarray(want["grads"][i])
        assert float(np.abs(g - w).max()) <= tol * float(np.abs(w).max()), (what, "router")
    if losses:
        for key in ("aux", "z"):
            assert got[key][0] > 0 and abs(got[key][0] - want[key][0]) <= \
                LOSS_RTOL * abs(want[key][0]), (what, key, got[key], want[key])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_partitioned_moe_step_meets_the_references_placed_jit(reference, runs, case):
    ref, got = reference[_id(case)], runs(case, "laid")
    assert ref["wi_spec"] == str(jax.sharding.PartitionSpec(
        *got["state"].params["layers"]["moe"]["wi"].spec))
    _assert_moe_close(got, ref, _id(case), case[0])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_partitioned_moe_step_meets_the_global_view_mesh_step(runs, case):
    got, want = runs(case, "laid"), runs(case, "mesh")
    _assert_moe_close(got, want, _id(case), case[0])
    assert got["drops"] == want["drops"], (got["drops"], want["drops"])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_top2_partitioned_moe_step_meets_the_global_view_mesh_step(runs, case):
    """The reduced config's own top-2, laid out and in the global view under
    the mesh (the same per-shard capacities): the same drops at both
    levels, the loss, aux and z within LOSS_RTOL, and the dispatches held
    token by token. Under `dp_only` (no partial sums) and without a
    `model` axis every token takes the same experts; under `default` a
    near tie of the k-th and (k+1)-th router logit parts at most
    ROUTES_APART_MAX of them (module docstring). Where none parts, the
    gradients and masters are held as the every-expert runs are."""
    got, want = runs(case, "top2"), runs(case, "mesh2")
    assert got["drops"] == want["drops"], (got["drops"], want["drops"])
    assert [r.shape for r in got["routes"]] == [r.shape for r in want["routes"]]
    apart = sum(int((a != b).any(-1).sum()) for a, b in zip(got["routes"], want["routes"]))
    routed = sum(r.shape[0] for r in want["routes"])
    for key in ("loss", "aux", "z"):
        assert abs(got[key][0] - want[key][0]) <= LOSS_RTOL * abs(want[key][0]), \
            (key, got[key], want[key])
    if case[2] == "dp_only" or case[1][1] == 1:
        assert apart == 0, apart
    assert apart <= ROUTES_APART_MAX * routed, (apart, routed)
    if apart == 0:
        _assert_moe_close(got, want, _id(case), case[0])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_without_drops_the_partitioned_moe_step_meets_the_mesh_free_step(runs, case):
    """At capacity factor 8 no choice is dropped at either level, laid out
    or mesh-free; aux is each group's loss averaged laid out and one loss
    over every token mesh-free, so it enters neither gradient and only z
    is held."""
    got, want = runs(case, "laid8"), runs(case[0], "free8")
    assert got["drops"] == want["drops"] == {"first": 0, "second": 0}
    _assert_moe_close(got, want, _id(case), case[0], losses=False)
    assert abs(got["z"][0] - want["z"][0]) <= LOSS_RTOL * abs(want["z"][0])


@pytest.mark.parametrize("every", [True, False], ids=["every-expert", "top2"])
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_moe_collective_bytes_and_calls_equal_the_analytic_count(runs, case, every):
    name, shape, rules = case
    run = runs(case, "laid" if every else "top2")
    moved, calls = run["counts"]
    if not every and shape[1] > 1:
        assert run["drops"]["first"] > 0          # the top-2 step drops at capacity
    want_moved, want_calls = partitioned_step_collectives(_cfg(name, every=every), shape,
                                                          rules, B, S, MICRO, HINT)
    assert {k: moved[k] for k in KINDS} == want_moved
    assert {k: calls[k] for k in KINDS} == want_calls
    # nothing else moves: no leaf is made whole, the batch is cut where it lies
    assert all(moved[k] == 0 for k in moved if k not in KINDS), moved


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_every_moe_leaf_stays_laid_out_by_its_spec(runs, case):
    name, shape, rules = case
    state = runs(case, "laid")["state"]
    mesh = state.params["embed"].mesh
    want = state_shardings(get_arch(name).reduced(), _tcfg(), mesh, RULES_VARIANTS[rules],
                           HINT)
    for x, sh in zip(tree.leaves(state), tree.leaves(want)):
        assert isinstance(x, DistArray) and x.spec == tuple(sh.spec) and x.mesh is mesh
        for c in mesh.coords():
            assert tuple(x.shards[c].shape) == tuple(hi - lo for lo, hi in x.region(c))
    # a coordinate holds 1/n of each expert weight
    n = len(mesh.coords())
    for w in (state.params["layers"]["moe"][k] for k in ("wi", "wg", "wo")):
        assert all(t.numel() * n == w.shape[0] * w.shape[1] * w.shape[2] * w.shape[3]
                   for t in w.shards.values())
