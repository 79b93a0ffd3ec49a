"""Partitioned prefill and decode of the MoE LM on a (data, model) mesh of
the CPU, against the JAX package's placed jit and the port's global-view
serving path under the same mesh.

The reference child (`mesh_harness.run_mesh`, 8 fake devices) runs the
programs tests/test_torch_partition_serve.py runs for the dense family:
`prefill` jitted with `in_shardings` from `param_specs` and `_batch_specs`,
the caller's decode cache (`init_cache(cfg, B, 48)`, the prompt's k and v
set into its first S slots, the rows' positions 28..35, placed by
`cache_specs`, placed again before each step), then three `decode_step`s
jitted with the parameters by `param_specs`, the cache by `cache_specs`
and the tokens by ("batch",), fed their own argmax, from `init_params(
PRNGKey(0), model_size_hint=4)`. Its shared experts are corrected as in
tests/test_torch_partition_moe.py (computed on the whole tokens, not
`psum`'d slices of different tokens). The port lays the same weights out
by `param_specs`, runs `prefill`, `pad_cache` to 48 and three
`decode_step`s fed the reference's tokens: the prefill's MoE routes each
coordinate's slice of the sequence, decode every model coordinate the
same rows, as the reference's region does.

Every expert is chosen (top_k = num_experts, in the child too) where the
port is held to the reference, as in tests/test_torch_partition_moe.py,
which says why: at top-2 a token the two programs route apart moves its
prefill logits by 0.023. The child also runs its prefill once as it is
(the shared experts psum'd over `model`), and the test prints that gap.
The reduced configs' own top-2 is held to the port's global view token
by token: bit for bit under `dp_only` and without a `model` axis, every
token routed alike; under `default` at most ROUTES_APART_MAX of the
tokens routed apart and the logits within LOGIT_TOL on the tokens routed
alike at every layer (the rule chip_smoke.py's phase 25 applies at full
width); and to the analytic count of bytes and calls.

Held within LOGIT_TOL (absolute) and CACHE_RTOL (of the largest entry):
the prefill's logits and cache, and every step's logits and cache,
against the reference and against the port's global-view `prefill` /
`decode_step` under the mesh (whole weights, the same EP capacities).
Reduced qwen2-moe-a2.7b and dbrx-132b, experts padded to 4, on (2, 4)
and (4, 2) under `default` and on (2, 4) under `dp_only`; qwen2-moe also
on (4, 1), without expert parallelism. The bytes and calls of each collective kind equal
`launch.dryrun.partitioned_serve_collectives`.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mesh_harness import run_mesh
from test_torch_partition_moe import ROUTES_APART_MAX, _dispatches, _recording_routes
from test_torch_partition_serve import (CACHE_RTOL, LOGIT_TOL, _abs_err, _layout_ok, _named,
                                        _rel, _tokens)
from repro.configs import get_arch as j_get_arch
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.launch.dryrun import RULES_VARIANTS, partitioned_serve_collectives
from repro_torch.launch.mesh import make_worker_mesh, set_mesh
from repro_torch.models import transformer as T
from repro_torch.parallel import NamedSharding, collectives as col
from repro_torch.parallel.sharding import lay_out

B, S, CACHE, STEPS = 8, 32, 48, 3
HINT = 4
RAGGED = list(range(28, 36))                 # the rows' positions at the first step
ARCHS = ["qwen2-moe-a2.7b", "dbrx-132b"]
CASES = [(a, s, r) for a in ARCHS
         for s, r in (((2, 4), "default"), ((2, 4), "dp_only"), ((4, 2), "default"))]
CASES.append(("qwen2-moe-a2.7b", (4, 1), "default"))   # no expert parallelism
KINDS = ("all_gather", "all_to_all", "psum", "pmax", "pmean")
AS_IS = ("qwen2-moe-a2.7b", (2, 4), "default")


def _cfg(name: str, every: bool = True):
    """Reduced `name`, every expert chosen (`every`)."""
    cfg = get_arch(name).reduced()
    if not every:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            top_k=cfg.moe.num_experts))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _id(case) -> str:
    name, shape, rules = case
    return f"{name}-{shape[0]}x{shape[1]}-{rules}"


def _params_np(name: str) -> dict:
    return jax.tree.map(np.asarray, JT.init_params(j_get_arch(name).reduced(),
                                                   jax.random.PRNGKey(0),
                                                   model_size_hint=HINT))


_CHILD = """
import dataclasses, os, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.compat import AxisType, jit_shardings, make_mesh, set_mesh
from repro.configs import get_arch
from repro.launch.dryrun import RULES_VARIANTS, _batch_specs
from repro.models import moe as M, transformer as T
from repro.parallel.sharding import logical_spec

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


M.moe_apply = _shared_free
out = OUT
for name, shape, rname in CASES:
    cfg, rules = get_arch(name).reduced(), RULES_VARIANTS[rname]
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=cfg.moe.num_experts))
    mesh = make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:shape[0] * shape[1]])
    params = T.init_params(cfg, jax.random.PRNGKey(0), model_size_hint=4)
    batch = {"tokens": jnp.asarray(np.load(os.path.join(out, name + ".npy")))}
    b, s = batch["tokens"].shape
    with set_mesh(mesh):
        pspecs = T.param_specs(cfg, rules, mesh, model_size_hint=4)
        # a new jit a variant: a traced function keeps the moe_apply it traced
        prefill = lambda: jax.jit(lambda p, x: T.prefill(p, x, cfg, rules)[::3],
                                  in_shardings=jit_shardings(
                                      (pspecs, _batch_specs(batch, rules, mesh)), mesh))
        as_is = None
        if (name, list(shape), rname) == AS_IS:
            M.moe_apply = _ep
            as_is = np.asarray(prefill()(params, batch)[0])
            M.moe_apply = _shared_free
        logits, cache = prefill()(params, batch)
        full = T.init_cache(cfg, b, CACHE)
        full["k"] = full["k"].at[:, :, :s].set(cache["k"])
        full["v"] = full["v"].at[:, :, :s].set(cache["v"])
        full["pos"] = jnp.asarray(RAGGED, jnp.int32)
        cspecs = T.cache_specs(cfg, b, CACHE, rules, mesh)
        placed = jax.tree.map(lambda sp: NamedSharding(mesh, sp), cspecs,
                              is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        tspec = logical_spec((b,), ("batch",), rules, mesh)
        decode = jax.jit(lambda p, c, t: T.decode_step(p, c, t, cfg, rules),
                         in_shardings=jit_shardings((pspecs, cspecs, tspec), mesh))
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        saved = {"logits": logits, "k": cache["k"], "v": cache["v"]}
        for i in range(STEPS):
            full = jax.device_put(full, placed)
            lg, full = decode(params, full, tok)
            saved.update({f"tok{i}": tok, f"logits{i}": lg, f"k{i}": full["k"],
                          f"v{i}": full["v"], f"pos{i}": full["pos"]})
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
    key = "%s-%dx%d-%s" % (name, shape[0], shape[1], rname)
    np.savez(os.path.join(out, key + ".npz"),
             **{k: np.asarray(v).astype(np.float32) if v.dtype == jnp.bfloat16 else np.asarray(v)
                for k, v in saved.items()})
    emit_result({"case": key, "cache_spec": list(cspecs["k"]),
                 "as_is_gap": None if as_is is None else float(np.abs(
                     as_is - np.asarray(logits)).max())})
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's placed prefill and decode, every case in one child."""
    out = tmp_path_factory.mktemp("partition_moe_serve_ref")
    for name in ARCHS:
        np.save(out / f"{name}.npy", _tokens(get_arch(name).reduced()))
    code = (_CHILD.replace("OUT", repr(str(out)))
            .replace("CASES", repr([(a, list(s), r) for a, s, r in CASES]))
            .replace("RAGGED", repr(RAGGED)).replace("STEPS", str(STEPS))
            .replace("CACHE", str(CACHE))
            .replace("AS_IS", repr((AS_IS[0], list(AS_IS[1]), AS_IS[2]))))
    got = {}
    for r in run_mesh(code, devices=8, timeout=900):
        r["arrays"] = dict(np.load(out / f"{r['case']}.npz"))
        got[r["case"]] = r
    return got


def _mesh(shape):
    return make_worker_mesh(tuple(shape), devices=["cpu"] * (shape[0] * shape[1]))


def _by_token(routes: list, mesh, laid: bool, seq: int) -> torch.Tensor:
    """One phase's dispatches (B x `seq` tokens, a call a coordinate and
    layer, or one a layer without a `model` axis) as (layers, B, seq, k):
    a coordinate routes its rows of the batch and, where `model` divides
    `seq`, its slice of the sequence."""
    routes = _dispatches(routes, mesh, laid)
    if mesh.shape["model"] == 1:
        return torch.stack([r.reshape(B, seq, -1) for r in routes])
    coords, (d_n, m_n) = mesh.coords(), (mesh.shape["data"], mesh.shape["model"])
    rows, cols = B // d_n, seq // m_n if seq % m_n == 0 else seq
    di, mi = mesh.axis_index("data"), mesh.axis_index("model")
    layers = []
    for i in range(0, len(routes), len(coords)):
        whole = torch.empty(B, seq, routes[i].shape[-1], dtype=routes[i].dtype)
        for c, r in zip(coords, routes[i:i + len(coords)]):
            s0 = c[mi] * cols if cols < seq else 0
            whole[c[di] * rows:(c[di] + 1) * rows, s0:s0 + cols] = r.reshape(rows, cols, -1)
        layers.append(whole)
    return torch.stack(layers)


def _serve(case, ref, every: bool = True) -> dict:
    """The port's run of `case`, laid out and in the global view under the
    mesh, fed the reference's tokens; each phase's dispatches in "routes"
    and "mesh_routes"."""
    name, shape, rname = case
    cfg, rules = _cfg(name, every), RULES_VARIANTS[rname]
    mesh = _mesh(shape)
    whole = bridge.lm_params_from_numpy(_params_np(name), "cpu")
    laid = lay_out(whole, _named(T.param_specs(cfg, rules, mesh, HINT), mesh))
    batch = {"tokens": torch.from_numpy(_tokens(cfg)).long()}
    fed = [torch.from_numpy(ref[f"tok{i}"]).long() for i in range(STEPS)]
    pos = torch.tensor(RAGGED, dtype=torch.int32)
    out = {"layout": [], "counts": [], "steps": [], "mesh_steps": [], "routes": [],
           "mesh_routes": []}

    col.reset_collective_bytes()
    with _recording_routes() as routes:
        logits, aux, z, cache = T.prefill(laid, batch, cfg, rules)
    out["routes"].append(_by_token(routes, mesh, True, S))
    out["counts"].append((col.collective_bytes(), col.collective_calls()))
    out["prefill"] = (logits, {k: col.gather(cache[k]) for k in ("k", "v")}, float(aux),
                      float(z))
    out["layout"].append(_layout_ok(cache, cfg, rules, mesh))
    cache = T.pad_cache(cache, cfg, CACHE, rules)
    cache["pos"] = lay_out(pos, NamedSharding(mesh, cache["pos"].spec))
    out["layout"].append(_layout_ok(cache, cfg, rules, mesh))

    with set_mesh(mesh), _recording_routes() as routes:
        g_logits, g_aux, g_z, g_cache = T.prefill(whole, batch, cfg, rules)
    out["mesh_routes"].append(_by_token(routes, mesh, False, S))
    out["mesh_prefill"] = (g_logits, {k: g_cache[k] for k in ("k", "v")}, float(g_aux),
                           float(g_z))
    pad = (0, 0, 0, 0, 0, CACHE - S)
    g_cache = {"k": F.pad(g_cache["k"], pad), "v": F.pad(g_cache["v"], pad), "pos": pos}
    for tok in fed:
        col.reset_collective_bytes()
        with _recording_routes() as routes:
            lg, new = T.decode_step(laid, cache, tok, cfg, rules)
        out["counts"].append((col.collective_bytes(), col.collective_calls()))
        out["routes"].append(_by_token(routes, mesh, True, 1))
        assert new["k"] is cache["k"] and new["v"] is cache["v"]     # written in place
        cache = new
        out["layout"].append(_layout_ok(cache, cfg, rules, mesh))
        out["steps"].append((lg, {k: col.gather(cache[k]) for k in ("k", "v", "pos")}))
        with set_mesh(mesh), _recording_routes() as routes:
            lg, g_cache = T.decode_step(whole, g_cache, tok, cfg, rules)
        out["mesh_routes"].append(_by_token(routes, mesh, False, 1))
        out["mesh_steps"].append((lg, {k: g_cache[k].clone() for k in ("k", "v", "pos")}))
    return out


@pytest.fixture(scope="module")
def runs(reference):
    cache = {}

    def get(case, every=True):
        key = (_id(case), every)
        if key not in cache:
            cache[key] = _serve(case, reference[_id(case)]["arrays"], every)
        return cache[key]

    return get


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_moe_prefill_and_decode_meet_the_references_placed_jit(reference, runs, case):
    ref, run = reference[_id(case)], runs(case)
    want = ref["arrays"]
    logits, kv, aux, z = run["prefill"]
    assert aux > 0 and z > 0
    if ref["as_is_gap"] is not None:
        print(f"{_id(case)}: the reference's prefill as it is (shared experts psum'd over "
              f"model) differs from the corrected one by {ref['as_is_gap']!r}; the port "
              f"from the corrected one by {_abs_err(logits, want['logits'])!r}")
    assert _abs_err(logits, want["logits"]) < LOGIT_TOL
    for key in ("k", "v"):
        assert _rel(kv[key], want[key]) <= CACHE_RTOL, key
    for i, (lg, got) in enumerate(run["steps"]):
        assert bool(torch.isfinite(lg).all()), i
        assert _abs_err(lg, want[f"logits{i}"]) < LOGIT_TOL, i
        for key in ("k", "v"):
            assert _rel(got[key], want[f"{key}{i}"]) <= CACHE_RTOL, (i, key)
        assert np.array_equal(got["pos"].numpy(), want[f"pos{i}"]), i
    name, shape, rules = case
    spec = ref["cache_spec"] + [None] * (5 - len(ref["cache_spec"]))
    assert tuple(spec) == tuple(T.cache_specs(_cfg(name), B, CACHE,
                                              RULES_VARIANTS[rules], _mesh(shape))["k"])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_moe_prefill_and_decode_meet_the_global_view_under_the_mesh(runs, case):
    run = runs(case)
    logits, kv, aux, z = run["prefill"]
    g_logits, g_kv, g_aux, g_z = run["mesh_prefill"]
    assert _abs_err(logits, g_logits) < LOGIT_TOL
    assert abs(aux - g_aux) <= 2e-3 * g_aux and abs(z - g_z) <= 2e-3 * g_z
    for key in ("k", "v"):
        assert _rel(kv[key], g_kv[key]) <= CACHE_RTOL, key
    for i, ((lg, got), (glg, g)) in enumerate(zip(run["steps"], run["mesh_steps"])):
        assert _abs_err(lg, glg) < LOGIT_TOL, i
        for key in ("k", "v"):
            assert _rel(got[key], g[key]) <= CACHE_RTOL, (i, key)
        assert torch.equal(got["pos"], g["pos"]), i


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_top2_moe_serving_meets_the_global_view_on_the_tokens_routed_alike(runs, case):
    """The reduced config's own top-2, laid out against the global view
    under the mesh, phase by phase (the prefill, each decode step): under
    `dp_only` (no partial sums) and without a `model` axis every token
    routed alike and the logits and caches bit for bit; under `default`
    at most ROUTES_APART_MAX of the tokens routed apart, and the logits
    within LOGIT_TOL on the tokens routed alike at every layer. aux and z
    within 2e-3."""
    run = runs(case, every=False)
    exact = case[2] == "dp_only" or case[1][1] == 1
    (logits, kv, aux, z), (g_logits, g_kv, g_aux, g_z) = run["prefill"], run["mesh_prefill"]
    assert abs(aux - g_aux) <= 2e-3 * g_aux and abs(z - g_z) <= 2e-3 * g_z
    got = [logits] + [lg for lg, _ in run["steps"]]
    want = [g_logits] + [lg for lg, _ in run["mesh_steps"]]
    apart = routed = 0
    for i, (lg, glg, r, gr) in enumerate(zip(got, want, run["routes"], run["mesh_routes"])):
        assert r.shape == gr.shape, i
        alike = (r == gr).all(-1).all(0)                       # (B, seq)
        apart, routed = apart + int((~alike).sum()), routed + alike.numel()
        lg, glg = lg.reshape(*alike.shape, -1), glg.reshape(*alike.shape, -1)
        if exact:
            assert bool(alike.all()) and torch.equal(lg, glg), i
        else:
            assert _abs_err(lg[alike], glg[alike]) < LOGIT_TOL, i
    assert apart <= ROUTES_APART_MAX * routed, (apart, routed)
    if exact:
        assert all(torch.equal(kv[k], g_kv[k]) for k in ("k", "v"))
        for (_, c), (_, g) in zip(run["steps"], run["mesh_steps"]):
            assert all(torch.equal(c[k], g[k]) for k in ("k", "v", "pos"))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_the_moe_cache_stays_laid_out_by_cache_specs(runs, case):
    assert runs(case)["layout"] == [True] * (2 + STEPS)


@pytest.mark.parametrize("every", [True, False], ids=["every-expert", "top2"])
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_moe_serving_bytes_and_calls_equal_the_analytic_count(runs, case, every):
    name, shape, rules = case
    want = partitioned_serve_collectives(_cfg(name, every), shape, rules, B, S, CACHE, HINT)
    for phase, (moved, calls) in zip(["prefill"] + ["decode"] * STEPS,
                                     runs(case, every)["counts"]):
        want_moved, want_calls = want[phase]
        assert {k: moved[k] for k in KINDS} == want_moved, phase
        assert {k: calls[k] for k in KINDS} == want_calls, phase
        assert all(moved[k] == 0 for k in moved if k not in KINDS), (phase, moved)
