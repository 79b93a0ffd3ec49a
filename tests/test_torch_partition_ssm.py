"""The partitioned SSM and hybrid step on a (data, model) mesh of the CPU,
against the JAX package's placed jit and the port's mesh-free step.

The reference child (`mesh_harness.run_mesh`, 8 fake devices) runs the
program of the reference's dry run, as tests/test_torch_partition.py's:
`make_train_step(cfg, tcfg, rules)` jitted with `in_shardings` from
`_param_state_specs` and `_batch_specs`, from `init_state(PRNGKey(0))`.
The port gets the same state laid out by the reference's specs
(`bridge.train_state_from_numpy(..., shardings=state_shardings(...))`):
each coordinate runs the SSD on the heads its layout gives it
(`ssm.ssm_apply_laid_out`), sums the gated norm's squares and its output
projection over the heads' axis, and sums the gradients of the leaves
every `model` coordinate holds (wxbc, wdt, conv_w, the per-head leaves,
the norm scales) over their holders.

Reduced mamba2-130m (attention-free, tied head, 4 SSD heads of 32),
reduced hymba-1.5b (attention with a window of 32 and the SSD heads in
parallel on one norm) and hymba-odd: reduced hymba with 5 heads, 1 KV
head, a vocabulary of 255 and d_inner 192 (6 SSD heads of 32), the shape
of hymba at full width on `model` 4, whose heads, SSD heads and
vocabulary stay whole while `wq`, `wz` and `wo` split their columns
mid-head (gathered whole; no head psum, no vocabulary-parallel lookup or
loss). Each on (2, 4) and (4, 2) under `default` and on (2, 4) under
`dp_only`. Two AdamW steps of B 8 x S 32 in 2 microbatches held with
tests/test_torch_partition.py's bounds (loss 2e-3, gradients 2^-5 of
their largest entry, masters 2.02 · lr · lr_scale, the second update 3 %
in norm and 0.9 in cosine) against the port's mesh-free step in every
case, and against the reference's placed jit in REF_CASES (five of the
nine: the child's compiles take 10-18 s a case). Against the reference
the SSD's per-head scalars and conv taps are held to 2^-3, as
tests/test_torch_families.py holds them: each is one sum over every
position and channel of bf16 products that largely cancel, and the
port's mesh-free step already differs from the reference there by up to
0.06 of the largest entry (d_skip), while the laid-out step stays within
2^-5 of the mesh-free one. The bytes and calls of each collective kind
in one step equal `launch.dryrun.partitioned_step_collectives`.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mesh_harness import run_mesh
from test_torch_partition import (B, MICRO, S, _assert_close, _batch, _batch_np, _grads,
                                  _mesh, _tcfg, _whole)
from repro.runtime.trainer import TrainConfig as JTrainConfig
from repro.runtime.trainer import init_state as j_init_state
from repro_torch import bridge, tree
from repro_torch.configs import get_arch
from repro_torch.launch.dryrun import (RULES_VARIANTS, partitioned_step_collectives,
                                       ssm_block_collectives)
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as T
from repro_torch.parallel import collectives as col
from repro_torch.parallel import logical_spec, record_specs
from repro_torch.parallel.collectives import DistArray
from repro_torch.parallel.sharding import NamedSharding, Program, lay_out
from repro_torch.runtime.trainer import make_train_step, state_shardings

GRAD_TOL = 2.0 ** -5
# hymba-odd: full-width hymba's divisibility on `model` 4 at the reduced size
ODD = {"n_heads": 5, "n_kv_heads": 1, "vocab": 255}
ODD_SSM = {"d_inner": 192}
ARCHS = ["mamba2-130m", "hymba-1.5b", "hymba-odd"]
MESHES = [((2, 4), "default"), ((2, 4), "dp_only"), ((4, 2), "default")]
CASES = [(a, s, r) for a in ARCHS for s, r in MESHES]
REF_CASES = [("mamba2-130m", (2, 4), "default"), ("mamba2-130m", (4, 2), "default"),
             ("hymba-1.5b", (2, 4), "default"), ("hymba-odd", (2, 4), "default"),
             ("hymba-odd", (2, 4), "dp_only")]
KINDS = ("all_gather", "reduce_scatter", "psum", "pmax")
# the SSD's per-head scalars and conv taps (module docstring)
SSD_SUMS = ("a_log", "conv_w", "d_skip", "dt_bias")
SSD_SUMS_TOL = 2.0 ** -3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _id(case) -> str:
    name, shape, rules = case
    return f"{name}-{shape[0]}x{shape[1]}-{rules}"


def odd(cfg):
    """Reduced hymba cut to hymba-odd (`dataclasses.replace`, as the
    reference's child builds it)."""
    return dataclasses.replace(cfg, **ODD, ssm=dataclasses.replace(cfg.ssm, **ODD_SSM))


def cfg_of(name: str, get=get_arch):
    return odd(get("hymba-1.5b").reduced()) if name == "hymba-odd" else get(name).reduced()


def _jax_state(name: str):
    from repro.configs import get_arch as j_get_arch

    state = j_init_state(cfg_of(name, j_get_arch),
                         JTrainConfig(microbatches=MICRO, warmup=1, total_steps=100),
                         jax.random.PRNGKey(0), 4)
    return jax.tree.map(np.asarray, state)


def _state(name: str, mesh=None, rules: str = "default"):
    cfg = cfg_of(name)
    sh = None if mesh is None else state_shardings(cfg, _tcfg(), mesh, RULES_VARIANTS[rules], 4)
    return bridge.train_state_from_numpy(_jax_state(name), "cpu", shardings=sh)


def _two_steps(name: str, mesh=None, rules: str = "default") -> dict:
    cfg = cfg_of(name)
    state = _state(name, mesh, rules)
    step = make_train_step(cfg, _tcfg(), RULES_VARIANTS[rules])
    batch = _batch(cfg)
    init = [_whole(x) for x in tree.leaves(state.opt.master)]
    col.reset_collective_bytes()
    state, m1 = step(state, batch)
    counts = (col.collective_bytes(), col.collective_calls())
    first_m = [_whole(x) for x in tree.leaves(state.opt.m)]
    state, m2 = step(state, batch)
    return {"loss": [float(m1["loss"]), float(m2["loss"])],
            "grad_norm": [float(m1["grad_norm"]), float(m2["grad_norm"])],
            "lr_scale": [m1["lr_scale"], m2["lr_scale"]],
            "grads": _grads(first_m, float(m1["grad_norm"])),
            "master": [_whole(x) for x in tree.leaves(state.opt.master)], "init": init,
            "counts": counts, "state": state}


_CHILD = """
import dataclasses, os, numpy as np, jax, jax.numpy as jnp
from repro.compat import AxisType, jit_shardings, make_mesh, set_mesh
from repro.configs import get_arch
from repro.launch.dryrun import RULES_VARIANTS, _batch_specs, _param_state_specs
from repro.runtime.trainer import TrainConfig, init_state, make_train_step

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
    tcfg = TrainConfig(microbatches=2, warmup=1, total_steps=100)
    state = init_state(cfg, tcfg, jax.random.PRNGKey(0), 4)
    raw = np.load(os.path.join(out, "batch_" + name + ".npz"))
    batch = {k: jnp.asarray(raw[k]) for k in ("labels", "tokens")}
    with set_mesh(mesh):
        specs = (_param_state_specs(cfg, rules, mesh), _batch_specs(batch, rules, mesh))
        step = jax.jit(make_train_step(cfg, tcfg, rules),
                       in_shardings=jit_shardings(specs, mesh),
                       out_shardings=jit_shardings((specs[0], None), mesh))
        s1, m1 = step(state, batch)
        first_m = [np.asarray(x, np.float32) for x in jax.tree.leaves(s1.opt.m)]
        s2, m2 = step(s1, batch)
    key = "%s-%dx%d-%s" % (name, shape[0], shape[1], rname)
    np.savez(os.path.join(out, key + ".npz"), *first_m,
             *[np.asarray(x, np.float32) for x in jax.tree.leaves(s2.opt.master)])
    emit_result({"case": key, "n": len(first_m),
                 "loss": [float(m1["loss"]), float(m2["loss"])],
                 "grad_norm": [float(m1["grad_norm"]), float(m2["grad_norm"])],
                 "lr_scale": [float(m1["lr_scale"]), float(m2["lr_scale"])],
                 "wz_spec": str(s2.params["layers"]["ssm"]["wz"].sharding.spec)})
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's placed jit, every case in one child."""
    out = tmp_path_factory.mktemp("partition_ssm_ref")
    for name in ARCHS:
        np.savez(out / f"batch_{name}.npz", **_batch_np(cfg_of(name)))
    code = (_CHILD.replace("OUT", repr(str(out)))
            .replace("ODD_SSM", repr(ODD_SSM)).replace("ODD", repr(ODD))
            .replace("CASES", repr([(a, list(s), r) for a, s, r in REF_CASES])))
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
    cache = {}

    def get(case):
        key = case if isinstance(case, str) else _id(case)
        if key not in cache:
            cache[key] = (_two_steps(case) if isinstance(case, str)
                          else _two_steps(case[0], _mesh(case[1]), case[2]))
        return cache[key]

    return get


@pytest.mark.parametrize("case", REF_CASES, ids=_id)
def test_partitioned_ssm_step_meets_the_references_placed_jit(reference, runs, case):
    ref = reference[_id(case)]
    state = runs(case)["state"]
    assert ref["wz_spec"] == str(jax.sharding.PartitionSpec(
        *state.params["layers"]["ssm"]["wz"].spec))
    tols = {i: SSD_SUMS_TOL for i, (key, _) in enumerate(tree.leaves_with_path(state.params))
            if key.split("|")[-1] in SSD_SUMS and "|ssm|" in key}
    assert len(tols) == len(SSD_SUMS)
    _assert_close(runs(case), ref, _id(case), tols)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_partitioned_ssm_step_meets_the_mesh_free_port(runs, case):
    _assert_close(runs(case), runs(case[0]), _id(case))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_ssm_collective_bytes_and_calls_equal_the_analytic_count(runs, case):
    name, shape, rules = case
    moved, calls = runs(case)["counts"]
    want_moved, want_calls = partitioned_step_collectives(cfg_of(name), shape, rules, B, S,
                                                          MICRO, 4)
    assert {k: moved[k] for k in KINDS} == want_moved
    assert {k: calls[k] for k in KINDS} == want_calls
    assert all(moved[k] == 0 for k in moved if k not in KINDS), moved


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_every_ssm_leaf_stays_laid_out_by_its_spec(runs, case):
    name, shape, rules = case
    state = runs(case)["state"]
    mesh = state.params["embed"].mesh
    want = state_shardings(cfg_of(name), _tcfg(), mesh, RULES_VARIANTS[rules], 4)
    for x, sh in zip(tree.leaves(state), tree.leaves(want)):
        assert isinstance(x, DistArray) and x.spec == tuple(sh.spec) and x.mesh is mesh
        for c in mesh.coords():
            assert tuple(x.shards[c].shape) == tuple(hi - lo for lo, hi in x.region(c))


@pytest.mark.parametrize("name", ARCHS)
def test_ssm_shard_sites_check_and_record_their_layouts(name):
    """The forward on a laid-out state records the SSD heads' site (B, S,
    H, P) split over `model` where it divides the heads (mamba2, hymba:
    4 heads), whole where it does not (hymba-odd: 6 heads), and hymba-odd's
    query heads and vocabulary whole."""
    cfg = cfg_of(name)
    mesh = _mesh((2, 4))
    state = _state(name, mesh)
    with record_specs() as recs:
        logits = T.forward(state.params, _batch(cfg), cfg)[0]
    assert tuple(logits.shape) == (B, S, cfg.vocab)
    sites = {r.axes: tuple(r.spec) for r in recs}
    want_ax = None if name == "hymba-odd" else "model"
    assert sites[("batch", "seq", "ssm_inner", None)] == ("data", None, want_ax, None)
    if name == "hymba-odd":
        assert sites[("batch", "seq", "heads", None)] == ("data", None, None, None)
        assert sites[("batch", "seq", "vocab")] == ("data", None, None)
    for r in recs:
        assert r.spec == logical_spec(r.shape, r.axes, RULES_VARIANTS["default"], mesh)


def test_a_chunk_split_raises_naming_the_axis():
    """`ssd_cp` maps the SSD's chunks (`ssm_chunk`) to `model`: on (4, 2)
    `model` divides S 32's two chunks of 16, which the partitioned program
    does not split, and says so (on (2, 4) they stay whole and it runs)."""
    cfg = cfg_of("mamba2-130m")
    mesh = _mesh((4, 2))
    rules = RULES_VARIANTS["ssd_cp"]
    state = bridge.train_state_from_numpy(
        _jax_state("mamba2-130m"), "cpu",
        shardings=state_shardings(cfg, _tcfg(), mesh, rules, 4))
    with pytest.raises(ValueError, match="'ssm_chunk'"):
        make_train_step(cfg, _tcfg(), rules)(state, _batch(cfg))


def _block_specs(cfg, mesh, rules):
    """One layer's SSM weights' specs (the stacked specs without their
    leading `layers` entry)."""
    stacked = T.param_specs(cfg, rules, mesh)["layers"]["ssm"]
    return {k: NamedSharding(mesh, tuple(s)[1:]) for k, s in stacked.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_the_block_alone_meets_ssm_apply_with_its_gradients(name):
    """`ssm_apply_laid_out` on laid-out weights (the seeded init's first
    layer) and each coordinate's rows against `ssm_apply` on the same bits:
    the output, the state (h on the coordinate's heads, the conv state)
    and every weight's gradient of a fixed projection of the output within
    2^-5 of their largest entry; the forward's and backward's bytes and
    calls equal to `ssm_block_collectives` (chip_smoke.py phase 26 (a)
    holds the full-width blocks to it)."""
    cfg = cfg_of(name)
    mesh, rules = _mesh((2, 4)), RULES_VARIANTS["default"]
    gen = torch.Generator().manual_seed(11)
    params = T.init_params(cfg, gen, "cpu")["layers"]["ssm"]
    params = {k: v[0] for k, v in params.items()}
    x = torch.randn(B, S, cfg.d_model, generator=gen).to(torch.bfloat16)
    probe = torch.randn(B, S, cfg.d_model, generator=gen)
    ps = [p.detach().requires_grad_() for p in tree.leaves(params)]
    y, st = ssm_mod.ssm_apply(tree.unflatten(params, ps), x, cfg, rules)
    want = torch.autograd.grad((y.float() * probe).sum(), ps)
    laid = lay_out(params, _block_specs(cfg, mesh, rules))
    prog = Program(mesh, rules, B, S)
    xs = col.split(x, ("data", None, None), mesh)
    col.reset_collective_bytes()
    (got, got_st), (entered,) = col.laid_out_region(
        lambda p: ssm_mod.ssm_apply_laid_out(p, xs, cfg, prog))(laid)
    y_spec = ("data", None, None)
    loss = (col.join(got, y_spec, mesh).float() * probe).sum()
    with col.backward_context(mesh):
        flat = tree.leaves(entered)
        g = iter(torch.autograd.grad(loss, [t for x in flat for t in col.per_coord(x).values()],
                                     allow_unused=True))
    moved, calls = col.collective_bytes(), col.collective_calls()
    want_moved, want_calls = ssm_block_collectives(cfg, (2, 4), "default", B, S, backward=True)
    assert {k: v for k, v in moved.items() if v} == {k: v for k, v in want_moved.items() if v}
    assert {k: v for k, v in calls.items() if v} == {k: v for k, v in want_calls.items() if v}
    grads = [{c: next(g) for c in mesh.coords()} for _ in flat]

    def close(a, b):
        a, b = a.detach().float(), b.detach().float()
        return float((a - b).abs().max()) <= GRAD_TOL * float(b.abs().max())

    assert close(col.join(got, y_spec, mesh), y)
    h_spec = T.cache_specs(cfg, B, S, rules, mesh)["ssm_h"][1:]
    assert close(col.join(got_st.h, h_spec, mesh), st.h)
    assert close(col.join(got_st.conv, ("data", None, None), mesh), st.conv)
    for (key, x), parts, w in zip(tree.leaves_with_path(laid), grads, want):
        whole = torch.zeros(x.shape)
        for c, part in parts.items():        # each region the sum of its holders' parts
            if part is not None:             # a replica whose output the join does not read
                whole[tuple(slice(lo, hi) for lo, hi in x.region(c))] += part.float()
        assert close(whole, w), key
