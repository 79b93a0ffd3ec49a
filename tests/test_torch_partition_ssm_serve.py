"""Partitioned prefill and decode of the SSM and hybrid LMs on a (data,
model) mesh of the CPU, against the JAX package's placed jit and the
port's mesh-free serving path.

The reference child (`mesh_harness.run_mesh`, 8 fake devices) runs, as
tests/test_torch_partition_serve.py's: `prefill` jitted with
`in_shardings` from `param_specs` and `_batch_specs` on a prompt of 16
(a multiple of the reduced chunk), then the caller's decode cache
(`init_cache(cfg, B, 32)` with the prefill's SSM state and its k and v
set into the first 16 slots, placed by `cache_specs`), then three
`decode_step`s jitted with the parameters by `param_specs`, the cache by
`cache_specs` and the tokens by ("batch",), fed its own argmax. The port
lays the same weights out by `param_specs`, runs `prefill` (its cache laid
out by `cache_specs(cfg, B, 16)`: ssm_h on each coordinate's SSD heads,
ssm_conv whole along `model`), `pad_cache` to 32 and three
`decode_step`s fed the reference's tokens.

For hymba the decode cache is the window's 32 slots: a rolling cache.
Its rows stand at positions 28..35 at the first step, so that within the
three steps rows write across the wrap (slot pos % 32) into the first
slice of the sequence, held by the first `model` coordinate. Reduced
mamba2-130m, hymba-1.5b and hymba-odd (tests/test_torch_partition_ssm.py)
on (2, 4) and (4, 2) under `default` and on (2, 4) under `dp_only`.
Held within LOGIT_TOL (absolute) and CACHE_RTOL (of the largest entry):
the prefill's logits and cache, and every step's logits and cache (k, v,
ssm_h, ssm_conv), against the reference and the port's mesh-free path;
the bytes and calls of each collective kind equal
`launch.dryrun.partitioned_serve_collectives`.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mesh_harness import run_mesh
from test_torch_partition_ssm import ARCHS, MESHES, ODD, ODD_SSM, cfg_of
from torch_multiprocess_ranks import _held_bytes, _own_bytes
from repro_torch import bridge
from repro_torch.launch.dryrun import RULES_VARIANTS, partitioned_serve_collectives
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.models import transformer as T
from repro_torch.parallel import NamedSharding, collectives as col
from repro_torch.parallel.collectives import DistArray
from repro_torch.parallel.sharding import lay_out

B, S, CACHE, STEPS = 8, 16, 32, 3
LOGIT_TOL = 2e-2          # tests/test_torch_models.py:30
CACHE_RTOL = 2e-2         # tests/test_torch_families.py:43
RAGGED = list(range(28, 36))                 # the rows' positions at the first step
CASES = [(a, s, r) for a in ARCHS for s, r in MESHES]
KINDS = ("all_gather", "all_to_all", "psum", "pmax")
STATE = ("ssm_h", "ssm_conv")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _id(case) -> str:
    name, shape, rules = case
    return f"{name}-{shape[0]}x{shape[1]}-{rules}"


def _keys(cfg) -> tuple:
    return STATE if cfg.attn_free else ("k", "v") + STATE


def _ragged(cfg) -> bool:
    return bool(cfg.sliding_window)


def _tokens(cfg) -> np.ndarray:
    return np.random.default_rng(3).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _named(specs, mesh):
    return {k: _named(v, mesh) if isinstance(v, dict) else NamedSharding(mesh, v)
            for k, v in specs.items()}


def _params_np(name: str) -> dict:
    from repro.configs import get_arch as j_get_arch
    from repro.models import transformer as JT

    return jax.tree.map(np.asarray, JT.init_params(cfg_of(name, j_get_arch),
                                                   jax.random.PRNGKey(0)))


_CHILD = """
import dataclasses, os, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.compat import AxisType, jit_shardings, make_mesh, set_mesh
from repro.configs import get_arch
from repro.launch.dryrun import RULES_VARIANTS, _batch_specs
from repro.models import transformer as T
from repro.parallel.sharding import logical_spec

out = OUT
def cfg_of(name):
    if name != "hymba-odd":
        return get_arch(name).reduced()
    cfg = get_arch("hymba-1.5b").reduced()
    return dataclasses.replace(cfg, **ODD, ssm=dataclasses.replace(cfg.ssm, **ODD_SSM))

for name, shape, rname in CASES:
    cfg, rules = cfg_of(name), RULES_VARIANTS[rname]
    mesh = make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:8])
    params = T.init_params(cfg, jax.random.PRNGKey(0))
    batch = {"tokens": jnp.asarray(np.load(os.path.join(out, name + ".npy")))}
    b, s = batch["tokens"].shape
    with set_mesh(mesh):
        pspecs = T.param_specs(cfg, rules, mesh, model_size_hint=shape[1])
        prefill = jax.jit(lambda p, x: T.prefill(p, x, cfg, rules)[::3],
                          in_shardings=jit_shardings((pspecs, _batch_specs(batch, rules, mesh)),
                                                     mesh))
        logits, cache = prefill(params, batch)
        full = T.init_cache(cfg, b, CACHE_LEN)
        for key in ("ssm_h", "ssm_conv"):
            full[key] = cache[key]
        if "k" in full:
            full["k"] = full["k"].at[:, :, :s].set(cache["k"])
            full["v"] = full["v"].at[:, :, :s].set(cache["v"])
        full["pos"] = jnp.asarray(RAGGED, jnp.int32) if cfg.sliding_window else cache["pos"]
        cspecs = T.cache_specs(cfg, b, CACHE_LEN, rules, mesh)
        placed = jax.tree.map(lambda sp: NamedSharding(mesh, sp), cspecs,
                              is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        tspec = logical_spec((b,), ("batch",), rules, mesh)
        decode = jax.jit(lambda p, c, t: T.decode_step(p, c, t, cfg, rules),
                         in_shardings=jit_shardings((pspecs, cspecs, tspec), mesh))
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        saved = {"logits": logits, **{k: v for k, v in cache.items() if k != "pos"}}
        for i in range(STEPS):
            full = jax.device_put(full, placed)
            lg, full = decode(params, full, tok)
            saved.update({f"tok{i}": tok, f"logits{i}": lg, f"pos{i}": full["pos"]})
            saved.update({f"{k}{i}": v for k, v in full.items() if k != "pos"})
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
    key = "%s-%dx%d-%s" % (name, shape[0], shape[1], rname)
    np.savez(os.path.join(out, key + ".npz"),
             **{k: np.asarray(v).astype(np.float32) if v.dtype == jnp.bfloat16 else np.asarray(v)
                for k, v in saved.items()})
    emit_result({"case": key, "cache_specs": {k: list(v) for k, v in cspecs.items()}})
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's placed prefill and decode, every case in one child."""
    out = tmp_path_factory.mktemp("partition_ssm_serve_ref")
    for name in ARCHS:
        np.save(out / f"{name}.npy", _tokens(cfg_of(name)))
    code = (_CHILD.replace("OUT", repr(str(out)))
            .replace("ODD_SSM", repr(ODD_SSM)).replace("ODD", repr(ODD))
            .replace("CASES", repr([(a, list(s), r) for a, s, r in CASES]))
            .replace("CACHE_LEN", str(CACHE)).replace("RAGGED", repr(RAGGED))
            .replace("STEPS", str(STEPS)))
    got = {}
    for r in run_mesh(code, devices=8, timeout=900):
        r["arrays"] = dict(np.load(out / f"{r['case']}.npz"))
        got[r["case"]] = r
    return got


def _mesh(shape):
    return make_worker_mesh(tuple(shape), devices=["cpu"] * (shape[0] * shape[1]))


def _layout_ok(cache: dict, cfg, rules, mesh) -> bool:
    """Every leaf a DistArray laid out by `cache_specs`, each coordinate
    holding its region's shape, and no storage beyond the process's own
    regions."""
    specs = T.cache_specs(cfg, B, CACHE if "k" not in cache else cache["k"].shape[2], rules,
                          mesh)
    for key, x in cache.items():
        if not (isinstance(x, DistArray) and x.spec == tuple(specs[key])):
            return False
        for c in mesh.local_coords():
            if tuple(x.shards[c].shape) != tuple(hi - lo for lo, hi in x.region(c)):
                return False
    return _held_bytes(cache) == _own_bytes(cache)


def _serve(case, ref) -> dict:
    """The port's run of `case`, laid out and mesh-free, fed the
    reference's tokens."""
    name, shape, rname = case
    cfg, rules = cfg_of(name), RULES_VARIANTS[rname]
    keys = _keys(cfg)
    mesh = _mesh(shape)
    whole = bridge.lm_params_from_numpy(_params_np(name), "cpu")
    laid = lay_out(whole, _named(T.param_specs(cfg, rules, mesh), mesh))
    batch = {"tokens": torch.from_numpy(_tokens(cfg)).long()}
    fed = [torch.from_numpy(ref[f"tok{i}"]).long() for i in range(STEPS)]
    out = {"layout": [], "counts": [], "steps": [], "free_steps": []}

    col.reset_collective_bytes()
    logits, _, _, cache = T.prefill(laid, batch, cfg, rules)
    out["counts"].append((col.collective_bytes(), col.collective_calls()))
    out["prefill"] = (logits, {k: col.gather(cache[k]) for k in keys})
    out["layout"].append(_layout_ok(cache, cfg, rules, mesh))
    cache = T.pad_cache(cache, cfg, CACHE, rules)
    pos = torch.tensor(RAGGED, dtype=torch.int32) if _ragged(cfg) else None
    if pos is not None:
        cache["pos"] = lay_out(pos, NamedSharding(mesh, cache["pos"].spec))
    out["layout"].append(_layout_ok(cache, cfg, rules, mesh))

    free_logits, _, _, free = T.prefill(whole, batch, cfg)
    out["free_prefill"] = (free_logits, {k: free[k].clone() for k in keys})
    if "k" in free:
        pad = (0, 0, 0, 0, 0, CACHE - S)
        free["k"], free["v"] = F.pad(free["k"], pad), F.pad(free["v"], pad)
    if pos is not None:
        free["pos"] = pos.clone()
    for tok in fed:
        col.reset_collective_bytes()
        lg, new = T.decode_step(laid, cache, tok, cfg, rules)
        out["counts"].append((col.collective_bytes(), col.collective_calls()))
        assert all(new[k] is cache[k] for k in keys)            # written in place
        cache = new
        out["layout"].append(_layout_ok(cache, cfg, rules, mesh))
        out["steps"].append((lg, {k: col.gather(cache[k]) for k in keys + ("pos",)}))
        lg, free = T.decode_step(whole, free, tok, cfg)
        out["free_steps"].append((lg, {k: free[k].clone() for k in keys + ("pos",)}))
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
def test_ssm_prefill_and_decode_meet_the_references_placed_jit(reference, runs, case):
    ref, run = reference[_id(case)], runs(case)
    want = ref["arrays"]
    logits, state = run["prefill"]
    assert _abs_err(logits, want["logits"]) < LOGIT_TOL
    for key, got in state.items():
        assert _rel(got, want[key]) <= CACHE_RTOL, key
    for i, (lg, got) in enumerate(run["steps"]):
        assert bool(torch.isfinite(lg).all()), i
        assert _abs_err(lg, want[f"logits{i}"]) < LOGIT_TOL, i
        for key in got:
            if key != "pos":
                assert _rel(got[key], want[f"{key}{i}"]) <= CACHE_RTOL, (i, key)
        assert np.array_equal(got["pos"].numpy(), want[f"pos{i}"]), i
    # the reference's decode takes its cache laid out as the port's
    name, shape, rules = case
    specs = T.cache_specs(cfg_of(name), B, CACHE, RULES_VARIANTS[rules], _mesh(shape))
    for key, spec in ref["cache_specs"].items():
        assert tuple(spec + [None] * (len(specs[key]) - len(spec))) == tuple(specs[key]), key


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_ssm_prefill_and_decode_meet_the_mesh_free_port(runs, case):
    run = runs(case)
    logits, state = run["prefill"]
    free_logits, free_state = run["free_prefill"]
    assert _abs_err(logits, free_logits) < LOGIT_TOL
    for key, got in state.items():
        assert _rel(got, free_state[key]) <= CACHE_RTOL, key
    for i, ((lg, got), (flg, free)) in enumerate(zip(run["steps"], run["free_steps"])):
        assert _abs_err(lg, flg) < LOGIT_TOL, i
        for key in got:
            if key != "pos":
                assert _rel(got[key], free[key]) <= CACHE_RTOL, (i, key)
        assert torch.equal(got["pos"], free["pos"]), i


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_the_ssm_cache_stays_laid_out_by_cache_specs(runs, case):
    """After the prefill, the move to the decode length and every step:
    each leaf a DistArray of its `cache_specs`, each coordinate holding its
    own region and nothing more."""
    assert runs(case)["layout"] == [True] * (2 + STEPS)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_ssm_serve_collective_bytes_and_calls_equal_the_analytic_count(runs, case):
    name, shape, rules = case
    want = partitioned_serve_collectives(cfg_of(name), shape, rules, B, S, CACHE)
    for phase, (moved, calls) in zip(["prefill"] + ["decode"] * STEPS, runs(case)["counts"]):
        want_moved, want_calls = want[phase]
        assert {k: moved[k] for k in KINDS} == want_moved, phase
        assert {k: calls[k] for k in KINDS} == want_calls, phase
        assert all(moved[k] == 0 for k in moved if k not in KINDS), (phase, moved)


@pytest.mark.parametrize("name", ["hymba-1.5b", "hymba-odd"])
def test_the_rolling_cache_writes_across_the_wrap_into_the_first_slice(reference, runs, name):
    """Rows at positions 28..35 of the window's 32 slots, split over
    `model` 4 (8 slots a slice): at step i a row at position p writes slot
    (p + i) % 32, so rows past 31 write slots 0.. of the first slice, which
    the first `model` coordinate holds, as the reference's one-hot write
    does; every slot is then valid for them (pos >= 32)."""
    case = (name, (2, 4), "default")
    want, run = reference[_id(case)]["arrays"], runs(case)
    prompt = run["prefill"][1]["k"].float().numpy()
    wrapped = 0
    for i, (_, got) in enumerate(run["steps"]):
        k = got["k"].float().numpy()
        for row, p in enumerate(RAGGED):
            slot = (p + i) % CACHE
            assert k[:, row, slot].any() and np.allclose(k[:, row, slot],
                                                         want[f"k{i}"][:, row, slot],
                                                         atol=CACHE_RTOL * np.abs(prompt).max())
            wrapped += slot < CACHE // 4
        # a slot no step has reached keeps the prefill's (zero past the prompt)
        assert not k[:, 0, 20:28].any()
    assert wrapped == sum(p + i >= CACHE for p in RAGGED for i in range(STEPS)) > 0
