"""Partitioned prefill and decode of the audio and VLM LMs on a (data,
model) mesh of the CPU, against the JAX package's placed jit and the
port's mesh-free serving path.

The reference child (`mesh_harness.run_mesh`, 8 fake devices) runs, as
tests/test_torch_partition_serve.py's: `prefill` jitted with
`in_shardings` from `param_specs` and `_batch_specs`; for the VLM then the
caller's decode cache (`init_cache(cfg, B, 32)` with the prefill's k and
v set into the prompt's slots, placed by `cache_specs`) and three
`decode_step`s jitted with the parameters by `param_specs`, the cache by
`cache_specs` and the tokens by ("batch",), fed its own argmax. The port
lays the same weights out by `param_specs`, runs `prefill` (its cache laid
out by `cache_specs(cfg, B, S)`), and for the VLM `pad_cache` to 32 and
three `decode_step`s fed the reference's tokens. hubert (an encoder)
prefills 16 frames and decodes nothing: the reference's dry run builds
no decode cell for it. phi-3-vision's prompts are 8 patch stubs before 8
tokens, and vlm-odd's before 9: 17 positions, which neither `model` 4 nor
2 divides, so its prefill cache keeps `kv_seq` whole (the KV heads laid
out as k's) and its decode cache splits it.

Reduced hubert-xlarge and phi-3-vision-4.2b on (2, 4) and (4, 2) under
`default` and on (2, 4) under `dp_only`. Held within LOGIT_TOL
(absolute) and CACHE_RTOL (of the largest entry): the prefill's logits
and cache, and every step's logits and cache, against the reference and
the port's mesh-free path; the bytes and calls of each collective kind
equal `launch.dryrun.partitioned_serve_collectives`.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mesh_harness import run_mesh
from test_torch_partition_frontend import MESHES, batch_np, batch_of, cfg_of
from torch_multiprocess_ranks import _held_bytes, _own_bytes
from repro_torch import bridge
from repro_torch.launch.dryrun import RULES_VARIANTS, partitioned_serve_collectives
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.models import transformer as T
from repro_torch.parallel import NamedSharding, collectives as col
from repro_torch.parallel.collectives import DistArray
from repro_torch.parallel.sharding import lay_out

B, CACHE, STEPS = 8, 32, 3
LOGIT_TOL = 2e-2          # tests/test_torch_models.py:30
CACHE_RTOL = 2e-2         # tests/test_torch_families.py:43
# (name, config, the prompt's model positions): hubert's frames; the VLM's
# 8 patch stubs and 8 or 9 tokens
PROMPTS = {"hubert-xlarge": ("hubert-xlarge", 16), "phi-3-vision-4.2b":
           ("phi-3-vision-4.2b", 16), "vlm-odd": ("phi-3-vision-4.2b", 17)}
CASES = [(p, s, r) for p in PROMPTS for s, r in MESHES]
KINDS = ("all_gather", "all_to_all", "psum", "pmax")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _id(case) -> str:
    prompt, shape, rules = case
    return f"{prompt}-{shape[0]}x{shape[1]}-{rules}"


def _cfg(prompt: str):
    return cfg_of(PROMPTS[prompt][0])


def _decodes(prompt: str) -> bool:
    return _cfg(prompt).family == "vlm"


def _prompt_np(prompt: str) -> dict:
    cfg, seq = _cfg(prompt), PROMPTS[prompt][1]
    return batch_np(cfg, seq, seed=5, labels=False)


def _named(specs, mesh):
    return {k: _named(v, mesh) if isinstance(v, dict) else NamedSharding(mesh, v)
            for k, v in specs.items()}


def _params_np(name: str) -> dict:
    from repro.configs import get_arch as j_get_arch
    from repro.models import transformer as JT

    return jax.tree.map(np.asarray, JT.init_params(cfg_of(name, j_get_arch),
                                                   jax.random.PRNGKey(0)))


_CHILD = """
import os, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.compat import AxisType, jit_shardings, make_mesh, set_mesh
from repro.configs import get_arch
from repro.launch.dryrun import RULES_VARIANTS, _batch_specs
from repro.models import transformer as T
from repro.parallel.sharding import logical_spec

out = OUT
for prompt, name, decodes, shape, rname in CASES:
    cfg, rules = get_arch(name).reduced(), RULES_VARIANTS[rname]
    mesh = make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:8])
    params = T.init_params(cfg, jax.random.PRNGKey(0))
    raw = np.load(os.path.join(out, prompt + ".npz"))
    batch = {k: jnp.asarray(raw[k]) for k in raw.files}
    with set_mesh(mesh):
        pspecs = T.param_specs(cfg, rules, mesh, model_size_hint=shape[1])
        prefill = jax.jit(lambda p, x: T.prefill(p, x, cfg, rules)[::3],
                          in_shardings=jit_shardings((pspecs, _batch_specs(batch, rules, mesh)),
                                                     mesh))
        logits, cache = prefill(params, batch)
        saved = {"logits": logits, "k": cache["k"], "v": cache["v"]}
        cspecs = {}
        if decodes:
            b, s = logits.shape[:2]
            full = T.init_cache(cfg, b, CACHE_LEN)
            full["k"] = full["k"].at[:, :, :s].set(cache["k"])
            full["v"] = full["v"].at[:, :, :s].set(cache["v"])
            full["pos"] = cache["pos"]
            cspecs = T.cache_specs(cfg, b, CACHE_LEN, rules, mesh)
            placed = jax.tree.map(lambda sp: NamedSharding(mesh, sp), cspecs,
                                  is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            tspec = logical_spec((b,), ("batch",), rules, mesh)
            decode = jax.jit(lambda p, c, t: T.decode_step(p, c, t, cfg, rules),
                             in_shardings=jit_shardings((pspecs, cspecs, tspec), mesh))
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
            for i in range(STEPS):
                full = jax.device_put(full, placed)
                lg, full = decode(params, full, tok)
                saved.update({f"tok{i}": tok, f"logits{i}": lg, f"pos{i}": full["pos"],
                              f"k{i}": full["k"], f"v{i}": full["v"]})
                tok = jnp.argmax(lg, -1).astype(jnp.int32)
    key = "%s-%dx%d-%s" % (prompt, shape[0], shape[1], rname)
    np.savez(os.path.join(out, key + ".npz"),
             **{k: np.asarray(v).astype(np.float32) if v.dtype == jnp.bfloat16 else np.asarray(v)
                for k, v in saved.items()})
    emit_result({"case": key, "cache_specs": {k: list(v) for k, v in cspecs.items()}})
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's placed prefill and decode, every case in one child."""
    out = tmp_path_factory.mktemp("partition_frontend_serve_ref")
    for prompt in PROMPTS:
        np.savez(out / f"{prompt}.npz", **_prompt_np(prompt))
    cases = [(p, PROMPTS[p][0], _decodes(p), list(s), r) for p, s, r in CASES]
    code = (_CHILD.replace("OUT", repr(str(out))).replace("CASES", repr(cases))
            .replace("CACHE_LEN", str(CACHE)).replace("STEPS", str(STEPS)))
    got = {}
    for r in run_mesh(code, devices=8, timeout=900):
        r["arrays"] = dict(np.load(out / f"{r['case']}.npz"))
        got[r["case"]] = r
    return got


def _mesh(shape):
    return make_worker_mesh(tuple(shape), devices=["cpu"] * (shape[0] * shape[1]))


def _layout_ok(cache: dict, cfg, rules, mesh) -> bool:
    """Every leaf a DistArray laid out by `cache_specs` at its length, each
    coordinate holding its region's shape, and no storage beyond the
    process's own regions."""
    specs = T.cache_specs(cfg, B, cache["k"].shape[2], rules, mesh)
    for key, x in cache.items():
        if not (isinstance(x, DistArray) and x.spec == tuple(specs[key])):
            return False
        for c in mesh.local_coords():
            if tuple(x.shards[c].shape) != tuple(hi - lo for lo, hi in x.region(c)):
                return False
    return _held_bytes(cache) == _own_bytes(cache)


def _serve(case, ref) -> dict:
    """The port's run of `case`, laid out and mesh-free, the decode fed the
    reference's tokens."""
    prompt, shape, rname = case
    cfg, rules = _cfg(prompt), RULES_VARIANTS[rname]
    mesh = _mesh(shape)
    whole = bridge.lm_params_from_numpy(_params_np(PROMPTS[prompt][0]), "cpu")
    laid = lay_out(whole, _named(T.param_specs(cfg, rules, mesh), mesh))
    batch = batch_of(_prompt_np(prompt))
    out = {"layout": [], "counts": [], "steps": [], "free_steps": [], "specs": []}

    col.reset_collective_bytes()
    logits, _, _, cache = T.prefill(laid, batch, cfg, rules)
    out["counts"].append((col.collective_bytes(), col.collective_calls()))
    out["prefill"] = (logits, {k: col.gather(cache[k]) for k in ("k", "v")})
    out["layout"].append(_layout_ok(cache, cfg, rules, mesh))
    out["specs"].append(cache["k"].spec)
    out["pos"] = col.gather(cache["pos"])
    free_logits, _, _, free = T.prefill(whole, batch, cfg)
    out["free_prefill"] = (free_logits, {k: free[k].clone() for k in ("k", "v")})
    if not _decodes(prompt):
        return out

    s = cache["k"].shape[2]
    cache = T.pad_cache(cache, cfg, CACHE, rules)
    out["layout"].append(_layout_ok(cache, cfg, rules, mesh))
    out["specs"].append(cache["k"].spec)
    pad = (0, 0, 0, 0, 0, CACHE - s)
    free["k"], free["v"] = F.pad(free["k"], pad), F.pad(free["v"], pad)
    for i in range(STEPS):
        tok = torch.from_numpy(ref[f"tok{i}"]).long()
        col.reset_collective_bytes()
        lg, new = T.decode_step(laid, cache, tok, cfg, rules)
        out["counts"].append((col.collective_bytes(), col.collective_calls()))
        assert all(new[k] is cache[k] for k in ("k", "v"))          # written in place
        cache = new
        out["layout"].append(_layout_ok(cache, cfg, rules, mesh))
        out["steps"].append((lg, {k: col.gather(cache[k]) for k in ("k", "v", "pos")}))
        lg, free = T.decode_step(whole, free, tok, cfg)
        out["free_steps"].append((lg, {k: free[k].clone() for k in ("k", "v", "pos")}))
    return out


@pytest.fixture(scope="module")
def runs(reference):
    cache = {}

    def get(case):
        key = _id(case)
        if key not in cache:
            cache[key] = _serve(case, reference[key]["arrays"])
        return cache[key]

    return get


def _abs_err(got: torch.Tensor, want) -> float:
    want = want.float().numpy() if isinstance(want, torch.Tensor) else want
    return float(np.abs(got.float().numpy() - want).max())


def _rel(got: torch.Tensor, want) -> float:
    w = want.float().numpy() if isinstance(want, torch.Tensor) else want
    return _abs_err(got, w) / max(float(np.abs(w).max()), 1e-30)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_frontend_prefill_and_decode_meet_the_references_placed_jit(reference, runs, case):
    ref, run = reference[_id(case)], runs(case)
    want = ref["arrays"]
    logits, kv = run["prefill"]
    assert tuple(logits.shape) == (B, PROMPTS[case[0]][1], _cfg(case[0]).vocab)
    assert _abs_err(logits, want["logits"]) < LOGIT_TOL
    for key, got in kv.items():
        assert _rel(got, want[key]) <= CACHE_RTOL, key
    assert len(run["steps"]) == (STEPS if _decodes(case[0]) else 0)
    for i, (lg, got) in enumerate(run["steps"]):
        assert bool(torch.isfinite(lg).all()), i
        assert _abs_err(lg, want[f"logits{i}"]) < LOGIT_TOL, i
        for key in ("k", "v"):
            assert _rel(got[key], want[f"{key}{i}"]) <= CACHE_RTOL, (i, key)
        assert np.array_equal(got["pos"].numpy(), want[f"pos{i}"]), i
    # the reference's decode takes its cache laid out as the port's
    prompt, shape, rules = case
    specs = T.cache_specs(_cfg(prompt), B, CACHE, RULES_VARIANTS[rules], _mesh(shape))
    for key, spec in ref["cache_specs"].items():
        assert tuple(spec + [None] * (len(specs[key]) - len(spec))) == tuple(specs[key]), key


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_frontend_prefill_and_decode_meet_the_mesh_free_port(runs, case):
    run = runs(case)
    logits, kv = run["prefill"]
    free_logits, free_kv = run["free_prefill"]
    assert _abs_err(logits, free_logits) < LOGIT_TOL
    for key, got in kv.items():
        assert _rel(got, free_kv[key]) <= CACHE_RTOL, key
    # the prompt's positions count the patches: decoding goes on from there
    assert run["pos"].tolist() == [PROMPTS[case[0]][1]] * B
    for i, ((lg, got), (flg, free)) in enumerate(zip(run["steps"], run["free_steps"])):
        assert _abs_err(lg, flg) < LOGIT_TOL, i
        for key in ("k", "v"):
            assert _rel(got[key], free[key]) <= CACHE_RTOL, (i, key)
        assert torch.equal(got["pos"], free["pos"]), i


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_the_frontend_cache_stays_laid_out_by_cache_specs(runs, case):
    """After the prefill and, for the VLM, the move to the decode length
    and every step: each leaf a DistArray of its `cache_specs`, each
    coordinate holding its own region and nothing more. vlm-odd's prompt
    of 17 keeps `kv_seq` whole and its KV heads as k's; its decode cache
    of 32 splits `kv_seq` over `model`."""
    run = runs(case)
    prompt, shape, rules = case
    assert run["layout"] == [True] * (1 + (1 + STEPS if _decodes(prompt) else 0))
    if prompt == "vlm-odd":
        kv_heads = None if rules == "dp_only" else "model"
        assert run["specs"][0][2:4] == (None, kv_heads)
        assert run["specs"][1][2:4] == ("model", None)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_frontend_serve_collective_bytes_and_calls_equal_the_analytic_count(runs, case):
    prompt, shape, rules = case
    want = partitioned_serve_collectives(_cfg(prompt), shape, rules, B, PROMPTS[prompt][1],
                                         CACHE)
    counts = runs(case)["counts"]
    assert len(counts) == 1 + (STEPS if _decodes(prompt) else 0)
    for phase, (moved, calls) in zip(["prefill"] + ["decode"] * STEPS, counts):
        want_moved, want_calls = want[phase]
        assert {k: moved[k] for k in KINDS} == want_moved, phase
        assert {k: calls[k] for k in KINDS} == want_calls, phase
        assert all(moved[k] == 0 for k in moved if k not in KINDS), (phase, moved)
