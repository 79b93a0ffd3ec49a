"""Partitioned prefill and decode of the dense LM on a (data, model) mesh of
the CPU, against the JAX package's placed jit and the port's mesh-free
serving path.

The reference child (`mesh_harness.run_mesh`, 8 fake devices) runs the
programs of the reference's dry run: `prefill` jitted with `in_shardings`
from `param_specs` and `_batch_specs`, then the caller's decode cache
(`init_cache(cfg, B, CACHE)`, the prompt's k and v set into its first S
slots, placed by `cache_specs`), then `decode_step` jitted with the
parameters by `param_specs`, the cache by `cache_specs` and the tokens by
("batch",), three steps fed its own argmax. The port lays the same
weights (`bridge.lm_params_from_numpy`) out by `param_specs`, runs
`prefill` (its cache laid out by `cache_specs(cfg, B, S)`), `pad_cache`
to the decode length and three `decode_step`s fed the reference's tokens,
each coordinate holding and computing only its own shards and cache
regions.

Held within LOGIT_TOL (absolute, tests/test_torch_models.py) and
CACHE_RTOL (of the largest entry, tests/test_torch_families.py): the
prefill's logits and cache, and every step's logits and cache, against
the reference and against the port's mesh-free `prefill` / `decode_step`
on the same tokens. Reduced olmo-1b (MHA: its KV heads split with the
query heads, so the prefill moves k and v from the heads' axis to the
cache's sequence by an all_to_all) and granite-8b (one KV head, whole at
every coordinate) on (2, 4) and (4, 2) under `default` and `dp_only`; one
case whose rows stand at positions 28..35 (so that in one step rows write
into two of the sequence's slices), one whose rows stand at positions
44..51 (half of them at or past the cache's 48 slots, where the
reference writes nothing and counts every slot valid), and a decode
length of 50, which `model` 4 does not divide: `kv_seq` is dropped, and
the cache lies as k (olmo: split by KV heads; granite: whole at every
coordinate). The bytes
and calls of each collective kind equal
`launch.dryrun.partitioned_serve_collectives`.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mesh_harness import run_mesh
from torch_multiprocess_ranks import _held_bytes, _own_bytes
from repro.configs import get_arch as j_get_arch
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.launch.dryrun import RULES_VARIANTS, partitioned_serve_collectives
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.models import attention
from repro_torch.models import transformer as T
from repro_torch.parallel import NamedSharding, collectives as col
from repro_torch.parallel.collectives import DistArray
from repro_torch.parallel.sharding import Program, lay_out

B, S, CACHE, STEPS = 8, 32, 48, 3
LOGIT_TOL = 2e-2          # tests/test_torch_models.py:30
CACHE_RTOL = 2e-2         # tests/test_torch_families.py:43
RAGGED = list(range(28, 36))                 # the rows' positions at the first step
PAST = list(range(44, 52))                   # ... half of them at or past CACHE
POSITIONS = {"ragged": RAGGED, "past": PAST}
ARCHS = ["olmo-1b", "granite-8b"]
CASES = ([(a, s, r, CACHE, False) for a in ARCHS for s in [(2, 4), (4, 2)]
          for r in ["default", "dp_only"]]
         + [("olmo-1b", (2, 4), "default", CACHE, "ragged"),
            ("olmo-1b", (2, 4), "default", CACHE, "past"),
            ("olmo-1b", (2, 4), "default", 50, False),
            ("granite-8b", (2, 4), "default", 50, False)])
KINDS = ("all_gather", "all_to_all", "psum", "pmax")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _id(case) -> str:
    name, shape, rules, cache_len, ragged = case
    return f"{name}-{shape[0]}x{shape[1]}-{rules}-{cache_len}" + (f"-{ragged}" if ragged else "")


def _tokens(cfg) -> np.ndarray:
    return np.random.default_rng(3).integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _named(specs, mesh):
    return {k: _named(v, mesh) if isinstance(v, dict) else NamedSharding(mesh, v)
            for k, v in specs.items()}


def _params_np(name: str) -> dict:
    return jax.tree.map(np.asarray, JT.init_params(j_get_arch(name).reduced(),
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
for name, shape, rname, cache_len, ragged in CASES:
    cfg, rules = get_arch(name).reduced(), RULES_VARIANTS[rname]
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
        full = T.init_cache(cfg, b, cache_len)
        full["k"] = full["k"].at[:, :, :s].set(cache["k"])
        full["v"] = full["v"].at[:, :, :s].set(cache["v"])
        full["pos"] = jnp.asarray(POSITIONS[ragged], jnp.int32) if ragged else cache["pos"]
        cspecs = T.cache_specs(cfg, b, cache_len, rules, mesh)
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
    key = "%s-%dx%d-%s-%d" % (name, shape[0], shape[1], rname, cache_len) + \\
        ("-" + ragged if ragged else "")
    np.savez(os.path.join(out, key + ".npz"),
             **{k: np.asarray(v).astype(np.float32) if v.dtype == jnp.bfloat16 else np.asarray(v)
                for k, v in saved.items()})
    emit_result({"case": key, "cache_spec": list(cspecs["k"])})
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's placed prefill and decode, every case in one child."""
    out = tmp_path_factory.mktemp("partition_serve_ref")
    for name in ARCHS:
        np.save(out / f"{name}.npy", _tokens(get_arch(name).reduced()))
    code = (_CHILD.replace("OUT", repr(str(out)))
            .replace("CASES", repr([(a, list(s), r, n, g) for a, s, r, n, g in CASES]))
            .replace("POSITIONS", repr(POSITIONS)).replace("STEPS", str(STEPS)))
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
    specs = T.cache_specs(cfg, B, cache["k"].shape[2], rules, mesh)
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
    name, shape, rname, cache_len, ragged = case
    cfg, rules = get_arch(name).reduced(), RULES_VARIANTS[rname]
    mesh = _mesh(shape)
    whole = bridge.lm_params_from_numpy(_params_np(name), "cpu")
    laid = lay_out(whole, _named(T.param_specs(cfg, rules, mesh), mesh))
    batch = {"tokens": torch.from_numpy(_tokens(cfg)).long()}
    fed = [torch.from_numpy(ref[f"tok{i}"]).long() for i in range(STEPS)]
    out = {"layout": [], "counts": [], "steps": [], "free_steps": []}

    col.reset_collective_bytes()
    logits, _, _, cache = T.prefill(laid, batch, cfg, rules)
    out["counts"].append((col.collective_bytes(), col.collective_calls()))
    out["prefill"] = (logits, {k: col.gather(cache[k]) for k in ("k", "v")})
    out["layout"].append(_layout_ok(cache, cfg, rules, mesh))
    out["graph"] = [logits.requires_grad] + [t.requires_grad for x in cache.values()
                                             for t in x.shards.values()]
    cache = T.pad_cache(cache, cfg, cache_len, rules)
    if ragged:
        pos = torch.tensor(POSITIONS[ragged], dtype=torch.int32)
        cache["pos"] = lay_out(pos, NamedSharding(mesh, cache["pos"].spec))
    out["layout"].append(_layout_ok(cache, cfg, rules, mesh))

    free_logits, _, _, free = T.prefill(whole, batch, cfg)
    out["free_prefill"] = (free_logits, {k: free[k] for k in ("k", "v")})
    pad = (0, 0, 0, 0, 0, cache_len - S)
    free = {"k": F.pad(free["k"], pad), "v": F.pad(free["v"], pad),
            "pos": torch.tensor(POSITIONS[ragged], dtype=torch.int32) if ragged else free["pos"]}
    for tok in fed:
        col.reset_collective_bytes()
        lg, new = T.decode_step(laid, cache, tok, cfg, rules)
        out["counts"].append((col.collective_bytes(), col.collective_calls()))
        assert new["k"] is cache["k"] and new["v"] is cache["v"]     # written in place
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
def test_prefill_and_decode_meet_the_references_placed_jit(reference, runs, case):
    ref, run = reference[_id(case)], runs(case)
    want = ref["arrays"]
    logits, kv = run["prefill"]
    assert _abs_err(logits, want["logits"]) < LOGIT_TOL
    for key in ("k", "v"):
        assert _rel(kv[key], want[key]) <= CACHE_RTOL, key
    for i, (lg, got) in enumerate(run["steps"]):
        assert bool(torch.isfinite(lg).all()), i
        assert _abs_err(lg, want[f"logits{i}"]) < LOGIT_TOL, i
        for key in ("k", "v"):
            assert _rel(got[key], want[f"{key}{i}"]) <= CACHE_RTOL, (i, key)
        assert np.array_equal(got["pos"].numpy(), want[f"pos{i}"]), i
    # the reference's decode takes its cache laid out as the port's (its
    # output cache is laid out as GSPMD chooses, and placed anew each step)
    name, shape, rules, cache_len, _ = case
    spec = ref["cache_spec"] + [None] * (5 - len(ref["cache_spec"]))
    assert tuple(spec) == tuple(T.cache_specs(get_arch(name).reduced(), B, cache_len,
                                              RULES_VARIANTS[rules], _mesh(shape))["k"])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_prefill_and_decode_meet_the_mesh_free_port(runs, case):
    run = runs(case)
    logits, kv = run["prefill"]
    free_logits, free_kv = run["free_prefill"]
    assert _abs_err(logits, free_logits) < LOGIT_TOL
    for key in ("k", "v"):
        assert _rel(kv[key], free_kv[key]) <= CACHE_RTOL, key
    for i, ((lg, got), (flg, free)) in enumerate(zip(run["steps"], run["free_steps"])):
        assert _abs_err(lg, flg) < LOGIT_TOL, i
        for key in ("k", "v"):
            assert _rel(got[key], free[key]) <= CACHE_RTOL, (i, key)
        assert torch.equal(got["pos"], free["pos"]), i


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_the_cache_stays_laid_out_by_cache_specs(runs, case):
    """After the prefill, the move to the decode length and every step:
    each leaf a DistArray of its `cache_specs`, each coordinate holding its
    own region and nothing more; nothing records an autograd graph."""
    run = runs(case)
    assert run["layout"] == [True] * (2 + STEPS)
    assert not any(run["graph"])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_collective_bytes_and_calls_equal_the_analytic_count(runs, case):
    name, shape, rules, cache_len, _ = case
    want = partitioned_serve_collectives(get_arch(name).reduced(), shape, rules, B, S,
                                         cache_len)
    counts = runs(case)["counts"]
    for phase, (moved, calls) in zip(["prefill"] + ["decode"] * STEPS, counts):
        want_moved, want_calls = want[phase]
        assert {k: moved[k] for k in KINDS} == want_moved, phase
        assert {k: calls[k] for k in KINDS} == want_calls, phase
        # nothing else moves: no leaf is made whole, the tokens are cut where they lie
        assert all(moved[k] == 0 for k in moved if k not in KINDS), (phase, moved)


def test_a_row_at_or_past_the_decode_length_writes_nothing(reference, runs):
    """Rows at positions 48..51 of a 48-slot cache (split along its
    sequence over `model`): the reference writes nothing there and counts
    every slot valid (`_write_row` and `_partial_softmax`); the rows'
    cache stays the prefill's, padded, at every step, in the port and in
    the reference, while the rows below 48 write theirs."""
    case = ("olmo-1b", (2, 4), "default", CACHE, "past")
    want, run = reference[_id(case)]["arrays"], runs(case)
    past = np.asarray(PAST) >= CACHE
    assert past.any() and not past.all()
    for key in ("k", "v"):
        prompt = run["prefill"][1][key].float().numpy()
        for i, (_, got) in enumerate(run["steps"]):
            got = got[key].float().numpy()
            assert np.array_equal(got[:, past, :S], prompt[:, past])
            assert not got[:, past, S:].any() and not want[f"{key}{i}"][:, past, S:].any()
            # a row below the cache's end writes its slot
            row = int(np.flatnonzero(~past)[0])
            assert got[:, row, PAST[row] + i].any()


def test_a_wholly_masked_slice_adds_exactly_zero():
    """Decode attention over a cache split along its sequence at (2, 4)
    while every row's position lies in the first slice (pos 0..7 of 48):
    the other three slices score NEG_INF everywhere, yet the output is
    finite and the mesh-free `attn_decode`'s within bf16 rounding, and a
    slice's weight in the combine is exactly 0."""
    cfg = get_arch("olmo-1b").reduced()
    mesh = _mesh((2, 4))
    rules = RULES_VARIANTS["default"]
    gen = torch.Generator().manual_seed(5)
    params = {k: (0.2 * torch.randn(*d.shape, generator=gen)).to(torch.bfloat16)
              for k, d in attention.attn_params(cfg).items()}
    x = torch.randn(B, 1, cfg.d_model, generator=gen).to(torch.bfloat16)
    ck = torch.randn(B, CACHE, cfg.n_kv_heads, cfg.head_dim, generator=gen).to(torch.bfloat16)
    cv = torch.randn(B, CACHE, cfg.n_kv_heads, cfg.head_dim, generator=gen).to(torch.bfloat16)
    pos = torch.arange(B, dtype=torch.int32)
    spec = T.cache_specs(cfg, B, CACHE, rules, mesh)["k"][1:]
    assert spec[1] == "model"
    prog = Program(mesh, rules, B, 1)
    laid = lay_out(params, {k: NamedSharding(mesh, s) for k, s in _attn_specs(cfg, mesh)})
    k_laid = col.distribute(ck.clone(), spec, mesh)
    v_laid = col.distribute(cv.clone(), spec, mesh)
    xs = col.split(x, ("data", None, None), mesh)
    ps = col.split(pos, ("data",), mesh)
    with torch.inference_mode():
        y = col.join(attention.attn_decode_laid_out(laid, xs, k_laid, v_laid, ps, cfg, prog),
                     ("data", None, None), mesh)
        want, wk, _ = attention.attn_decode(params, x, ck.clone(), cv.clone(), pos, cfg)
        q = torch.randn(2, 1, cfg.n_heads, cfg.head_dim, generator=gen)
        m, l, o = attention._partial_softmax(q, ck[:2, 12:24], cv[:2, 12:24],
                                             torch.zeros(2, dtype=torch.int32), 12, CACHE)
    assert bool(torch.isfinite(y.float()).all())
    assert float((y.float() - want.float()).abs().max()) <= 2.0 ** -6 * float(
        want.float().abs().max())
    assert torch.equal(col.gather(k_laid), wk)
    # the masked slice: finite m, l, o, and a weight of exactly 0 beside a live score
    assert bool(torch.isfinite(m).all() & torch.isfinite(l).all() & torch.isfinite(o).all())
    assert bool((torch.exp(m - 0.0) == 0).all())


def _attn_specs(cfg, mesh):
    """The attention weights' specs of one layer (the stacked specs without
    their leading `layers` entry)."""
    stacked = T.param_specs(cfg, RULES_VARIANTS["default"], mesh)["layers"]["attn"]
    return [(k, tuple(s)[1:]) for k, s in stacked.items()]
