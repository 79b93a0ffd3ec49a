"""SPIN-Shampoo on a laid-out state, on meshes of the CPU: the update alone
against the JAX package's unplaced update and the port's mesh-free one,
the partitioned step of every family against the mesh-free step, the
layouts, the bytes against the analytic count, and the checkpoint.

The update alone: reduced olmo-1b's parameters (a 256 x 64 embedding,
whose 256² factor the CPU plan inverts at grid 8, and stacked (2, d_in,
d_out) layers) with two leaves of their own: (24, 18), whose R factor
`model` 4 does not divide, and a (64,) scale, which is no matrix and
takes Adam's direction. Three steps at damping 0.1: a refresh, a
non-refresh and a clipped one. The first two draw bf16 gradients of
scale 0.002 (a global norm ≈ 0.6: the clip factor is exactly 1); the
third draws multiples of 1/16 up to 1/2, whose squares and their sums
are exact in f32 in any order, so the clipped step's clip factor is the
same bits in every run and laid-out m and v are the mesh-free port's,
bit for bit. The rest are `tests/test_torch_optim.py`'s bounds against
the reference: Gram factors 1e-5, inverses 1e-4, m, v and the masters
1e-5 of the largest entry.

The step: two steps of every family on (2, 4) under `default`, against
the mesh-free step on the same weights, with tests/test_torch_partition.py's
bounds on the loss, the grad norm, the gradients, the masters and the
update's norm. The MoE family (reduced qwen2-moe) runs every expert at
capacity factor 8 with aux out of the gradients, as
tests/test_torch_partition_moe.py holds it to its mesh-free step: aux is
each group's loss laid out and one loss over every token mesh-free, so z
stands in for the loss. The optimizer's part is held
against the mesh-free optimizer run on the laid-out step's own gradients:
each leaf's update (the second step's; the first has lr_scale 0), entry
by entry against its largest entry and in norm, within 1e-5 (the update
alone's bound; and the masters' own rounding, 2^-23 of their largest
entry) plus, for a factored leaf, 4·u·(n_L·κ_L + n_R·κ_R), the
first-order bound c·n·u·κ on each of the two inversions (sharded and
dense, in other orders) that L⁻¹·m·R⁻¹ multiplies by (u = 2^-24, κ the
damped factor's condition, largest over the layers). hubert's
rank-deficient factors (below) need it: their update parts by 0.7 % of
its largest entry, the other families' by at most 9.2e-5. Across
the two runs the masters and the update's direction are not held here:
the grafted direction L⁻¹·m·R⁻¹ moves further than the gradients do
where the factors are rank-deficient. hubert's loss reads the 15 % of
frames that are masked, and the mesh-free optimizer given the two runs'
gradients (within 2^-5 of each other) makes updates whose cosine is 0.744
on its head and 0.890 on its attention output, the same as laid out
against mesh-free, and whose masters part by up to 2.69·lr·lr_scale on
its head, past AdamW's 2.02; tests/test_torch_partition_shampoo.py holds
both on olmo-1b and granite-8b.

The count: a step that does not refresh moves, by kind, what
`launch.dryrun.partitioned_step_collectives(..., optimizer="spin_shampoo")`
counts and nothing else; a refresh step moves in excess exactly the same
sharded inversions run alone plus `dryrun.shampoo_refresh_moves`.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import transformer as JT
from repro.optim import spin_shampoo as j_shampoo
from repro_torch import bridge, tree
from repro_torch.checkpoint.ckpt import restore
from repro_torch.configs import get_arch
from repro_torch.core import spin_inverse_sharded
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch.dryrun import (RULES_VARIANTS, partitioned_step_collectives,
                                       shampoo_refresh_moves)
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as T
from repro_torch.optim import SpinShampooConfig, spin_shampoo
from repro_torch.parallel import (NamedSharding, ShardedBlockMatrix, assert_mesh_resident,
                                  record_specs)
from repro_torch.parallel import collectives as col
from repro_torch.parallel.collectives import DistArray
from repro_torch.optim.adamw import step_count
from repro_torch.parallel.sharding import PartitionSpec as P, lay_out
from repro_torch.planner import get_plan
from repro_torch.runtime import trainer as trainer_mod
from repro_torch.runtime.trainer import (TrainConfig, Trainer, init_state, make_train_step,
                                         state_shardings)

B, S, MICRO = 8, 32, 2
HINT = 4
DAMPING = 0.1
STEP_SCALES = (0.002, 0.002, None)   # None: the exact multiples of 1/16
NORM_REL = 1e-5
LOSS_RTOL = 2e-3
GRAD_TOL = 2.0 ** -5
UPDATE_RTOL = 0.03
MESHES = [(2, 4), (4, 2), (8, 1)]
FAMILIES = ["olmo-1b", "qwen2-moe-a2.7b", "hymba-1.5b", "mamba2-130m", "hubert-xlarge",
            "phi-3-vision-4.2b"]
UPDATE_FLOOR = 1e-5               # the update alone's bound, where nothing is inverted
REFRESH_C = 4.0                   # c of the refresh's c·n·u·κ (chip_smoke.py)
KINDS = ("all_gather", "reduce_scatter", "psum", "pmax", "gather")
NO_DROP_CF = 8.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(shape):
    return make_worker_mesh(tuple(shape), devices=["cpu"] * (shape[0] * shape[1]))


def _named(tree_, mesh):
    return {k: _named(v, mesh) if isinstance(v, dict) else NamedSharding(mesh, v)
            for k, v in tree_.items()}


def _whole(x) -> torch.Tensor:
    """A leaf whole: a laid-out one assembled from this process's shards
    without a collective, so that reading it inside a step moves no
    counted bytes."""
    if not isinstance(x, DistArray):
        return x
    out = torch.empty(x.shape, dtype=x.dtype)
    for c, t in x.shards.items():
        out[tuple(slice(lo, hi) for lo, hi in x.region(c))] = t
    return out


def _close(got, want, rel: float, what: str) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        g = _whole(g).detach().float().numpy()
        w = np.asarray(jnp.asarray(w, jnp.float32)) if not isinstance(w, torch.Tensor) \
            else _whole(w).detach().float().numpy()
        assert g.shape == w.shape, (what, i)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= rel * scale, (what, i)


# ---------------------------------------------------------------------------
# (i) the update alone
# ---------------------------------------------------------------------------


def _params():
    """The reference's parameters and the port's: reduced olmo-1b's and the
    two extra leaves the docstring names."""
    cfg = j_get_arch("olmo-1b").reduced()
    rng = np.random.default_rng(1)
    jparams = dict(JT.init_params(cfg, jax.random.PRNGKey(0), model_size_hint=1))
    jparams["odd"] = jnp.asarray(rng.standard_normal((24, 18), dtype=np.float32) * 0.02,
                                 jnp.bfloat16)
    jparams["scale"] = jnp.ones((64,), jnp.bfloat16)
    return jparams, bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _specs(mesh) -> dict:
    """olmo's leaves by `param_specs`, the extra ones as the docstring says."""
    specs = dict(T.param_specs(get_arch("olmo-1b").reduced(), RULES_VARIANTS["default"],
                               mesh, 1))
    specs["odd"], specs["scale"] = P("data", None), P(None)
    return specs


def _grads(jparams, seed: int, scale):
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree.flatten(jparams)
    if scale is None:
        draw = [rng.integers(-8, 9, p.shape).astype(np.float32) / 16 for p in flat]
    else:
        draw = [rng.standard_normal(p.shape, dtype=np.float32) * scale for p in flat]
    jg = jax.tree.unflatten(treedef, [jnp.asarray(g, jnp.bfloat16) for g in draw])
    return jg, bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jg), "cpu")


def _laid_state(params, specs, mesh, cfg):
    state = spin_shampoo.spin_shampoo_init(params, cfg)
    flat = tree.leaves(_named(specs, mesh))
    whole = NamedSharding(mesh, P())
    factors = [None if f is None else spin_shampoo._Factor(*(
        NamedSharding(mesh, P(*spin_shampoo.factor_spec(t.shape, mesh))) for t in f))
        for f in state.factors]
    return lay_out(state, spin_shampoo.SpinShampooState(whole, flat, factors, flat, flat))


@pytest.fixture(scope="module")
def unplaced():
    """The parameters, and each step's gradients with the reference's
    update (jitted once) and the mesh-free port's: their states after the
    step (the port's copied: it updates in place), new parameters and
    grad norms."""
    jparams, params = _params()
    cfg = SpinShampooConfig(damping=DAMPING)
    jcfg = j_shampoo.SpinShampooConfig(damping=DAMPING)
    update = jax.jit(j_shampoo.spin_shampoo_update, static_argnums=0)
    jstate = j_shampoo.spin_shampoo_init(jparams, jcfg)
    free = spin_shampoo.spin_shampoo_init(params, cfg)
    steps = []
    for i, scale in enumerate(STEP_SCALES):
        jg, g = _grads(jparams, 10 + i, scale)
        jnew, jstate, jnorm = update(jcfg, jg, jstate, 1.0)
        _, free, fnorm = spin_shampoo.spin_shampoo_update(cfg, g, free, 1.0)
        steps.append({"grads": g, "ref": (jnew, jstate, float(jnorm)),
                      "free": (tree.tree_map(torch.clone, free), float(fnorm))})
    return params, steps


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_laid_out_update_meets_the_reference_and_the_mesh_free_port(unplaced, shape):
    mesh = _mesh(shape)
    params, steps = unplaced
    specs = _specs(mesh)
    cfg = SpinShampooConfig(damping=DAMPING)
    laid = _laid_state(params, specs, mesh, cfg)
    assert [f is None for f in laid.factors] == [f is None for f in steps[0]["ref"][1].factors] \
        == [False] * 8 + [False, True]
    # the 256² factor splits over both axes; R of (24, 18) keeps `model` whole
    assert laid.factors[0].l.spec == ("data", "model")
    assert laid.factors[8].r.spec == ("data" if 18 % shape[0] == 0 else None,
                                      "model" if 18 % shape[1] == 0 else None)
    for i, step in enumerate(steps):
        gl = lay_out(step["grads"], _named(specs, mesh))
        (jnew, jstate, jnorm), (free, fnorm) = step["ref"], step["free"]
        before = [_whole(f.linv).clone() for f in laid.factors if f is not None]
        col.reset_collective_bytes()
        with record_specs() as records:
            new, laid, gnorm = spin_shampoo.spin_shampoo_update(cfg, gl, laid, 1.0)
        assert col.collective_bytes()["to_dense"] == 0
        refreshed = i == 0
        assert (float(gnorm) > cfg.grad_clip) == (i == 2)
        assert abs(float(gnorm) - jnorm) <= NORM_REL * jnorm
        if i == 2:                                    # the exact squares: the same bits
            assert float(gnorm) == fnorm == jnorm
        changed = [not torch.equal(a, _whole(f.linv)) for a, f in
                   zip(before, [f for f in laid.factors if f is not None])]
        assert all(changed) if refreshed else not any(changed)
        assert bool(records) == refreshed
        if refreshed:
            assert_mesh_resident(records)
            split_both = [r for r in records if r.kind == "grid" and r.grid_sharded and
                          r.shape[:2] == ((4, 4) if 4 % shape[0] == 0 else (8, 8))]
            assert split_both, shape
        for fac, lfac, jfac in zip(free.factors, laid.factors, jstate.factors):
            if fac is None:
                assert lfac is None and jfac is None
                continue
            _close([lfac.l, lfac.r], [jfac.l, jfac.r], 1e-5, "gram")
            _close([lfac.linv, lfac.rinv], [jfac.linv, jfac.rinv], 1e-4, "inverse")
            _close([lfac.l, lfac.r], [fac.l, fac.r], 1e-5, "gram mesh-free")
            _close([lfac.linv, lfac.rinv], [fac.linv, fac.rinv], 1e-4, "inverse mesh-free")
        for name in ("m", "v"):
            assert all(torch.equal(_whole(a), b) for a, b in
                       zip(getattr(laid, name), getattr(free, name))), (name, i)
            _close(getattr(laid, name), getattr(jstate, name), 1e-5, name)
        _close(laid.master, jstate.master, 1e-5, "master")
        _close(laid.master, free.master, 1e-5, "master mesh-free")
        _close(tree.leaves(new), jax.tree.leaves(jnew), 2.0 ** -8, "params")
        assert all(isinstance(p, DistArray) and p.spec == tuple(sh.spec)
                   for p, sh in zip(tree.leaves(new), tree.leaves(_named(specs, mesh))))
        assert step_count(laid.step) == i + 1


# ---------------------------------------------------------------------------
# (iii) the step of every family, (iv) the layouts, and the count
# ---------------------------------------------------------------------------


def _cfg(name: str):
    cfg = get_arch(name).reduced()
    if cfg.moe is not None:                  # every expert, no drop
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, top_k=cfg.moe.num_experts, capacity_factor=NO_DROP_CF))
    return cfg


def _tcfg() -> TrainConfig:
    return TrainConfig(microbatches=MICRO, warmup=1, total_steps=100, optimizer="spin_shampoo",
                       shampoo=SpinShampooConfig(damping=DAMPING))


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


def _condition(inv: torch.Tensor) -> float:
    """The largest condition of a (stacked) inverse's layers, that of the
    damped factor it inverts."""
    e = torch.linalg.eigvalsh(inv.double()).abs()
    return float((e.max(-1).values / e.min(-1).values).max())


@contextlib.contextmanager
def _recording_updates(calls: list):
    """Each optimizer call of a step made while open appends its gradients
    (whole) and lr_scale to `calls`."""
    update = trainer_mod.spin_shampoo_update

    def recording(cfg, grads, state, lr_scale=1.0):
        calls.append(([_whole(g).clone() for g in tree.leaves(grads)], float(lr_scale)))
        return update(cfg, grads, state, lr_scale)

    trainer_mod.spin_shampoo_update = recording
    try:
        yield
    finally:
        trainer_mod.spin_shampoo_update = update


def _two_steps(name: str, shape=None, rules: str = "default") -> dict:
    """Two steps of `name` from one seed's state: laid out by
    `state_shardings` on a mesh of `shape`, or whole; the metrics, the
    first step's m, the masters, each step's counts, the optimizer's
    gradients and lr_scale, and the state."""
    cfg = _cfg(name)
    state = init_state(cfg, _tcfg(), torch.Generator().manual_seed(0), "cpu", HINT)
    if shape is not None:
        state = lay_out(state, state_shardings(cfg, _tcfg(), _mesh(shape),
                                               RULES_VARIANTS[rules], HINT))
    batch = TokenStream(cfg, B, S, seed=3, device="cpu").next()
    calls = []
    with _recording_updates(calls):
        step = make_train_step(cfg, _tcfg(), RULES_VARIANTS[rules])
    init = [_whole(x).clone() for x in state.opt.master]
    out = {"metrics": [], "counts": [], "updates": calls}
    with _aux_without_gradient() if cfg.moe is not None else contextlib.nullcontext():
        for i in range(2):
            col.reset_collective_bytes()
            state, m = step(state, batch)
            out["counts"].append((col.collective_bytes(), col.collective_calls()))
            out["metrics"].append({k: float(v) for k, v in m.items()})
            if i == 0:
                out["first_m"] = [_whole(x).clone() for x in state.opt.m]
    out.update(init=init, master=[_whole(x) for x in state.opt.master], state=state)
    return out


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name, shape=None, rules="default"):
        key = (name, shape, rules)
        if key not in cache:
            cache[key] = _two_steps(name, shape, rules)
        return cache[key]

    return get


@pytest.mark.parametrize("name", FAMILIES)
def test_laid_out_shampoo_step_meets_the_mesh_free_step(runs, name):
    got, want = runs(name, (2, 4)), runs(name)
    g1, w1 = got["metrics"][0], want["metrics"][0]
    key = "z" if _cfg(name).moe is not None else "loss"
    assert w1[key] > 0 and abs(g1[key] - w1[key]) <= LOSS_RTOL * w1[key]
    assert abs(g1["grad_norm"] - w1["grad_norm"]) <= LOSS_RTOL * w1["grad_norm"]
    assert g1["lr_scale"] == w1["lr_scale"] == 0
    clip = [min(1.0, 1.0 / r["metrics"][0]["grad_norm"]) for r in (got, want)]
    for i, (a, b) in enumerate(zip(got["first_m"], want["first_m"])):
        ga, gb = a.double() / clip[0], b.double() / clip[1]
        scale = float(gb.abs().max())
        # a leaf no loss reads (hubert's token table) has a zero gradient
        assert float((ga - gb).abs().max()) <= GRAD_TOL * scale, (name, i)
    for i, (m, w, m0) in enumerate(zip(got["master"], want["master"], got["init"])):
        nu, nw = float((m - m0).double().norm()), float((w - m0).double().norm())
        assert abs(nu - nw) <= UPDATE_RTOL * nw, (name, i, nu, nw)
    # the optimizer: the mesh-free one on the laid-out step's gradients
    state = init_state(_cfg(name), _tcfg(), torch.Generator().manual_seed(0), "cpu", HINT)
    opt = state.opt
    for grads, lr_scale in got["updates"]:
        _, opt, _ = spin_shampoo.spin_shampoo_update(
            _tcfg().shampoo, tree.unflatten(state.params, grads), opt, lr_scale)
    for i, (m, w, m0, fac) in enumerate(zip(got["master"], opt.master, got["init"],
                                            opt.factors)):
        rel = UPDATE_FLOOR
        if fac is not None:
            rel += REFRESH_C * 2.0 ** -24 * sum(inv.shape[-1] * _condition(inv)
                                                for inv in (fac.linv, fac.rinv))
        # the updates are read from f32 masters: one rounding of each (2^-23)
        du, dw, w = (m - m0).double(), (w - m0).double(), w.double()
        assert float((du - dw).abs().max()) <= rel * float(dw.abs().max()) + \
            2.0 ** -23 * float(w.abs().max()), (name, i, rel)
        assert abs(float(du.norm()) - float(dw.norm())) <= rel * float(dw.norm()) + \
            2.0 ** -23 * float(w.norm()), (name, i)
    assert all(c[0]["to_dense"] == 0 for c in got["counts"])


@pytest.mark.parametrize("name", FAMILIES)
def test_every_shampoo_leaf_stays_laid_out_by_state_shardings(runs, name):
    state = runs(name, (2, 4))["state"]
    mesh = state.params["embed"].mesh
    want = state_shardings(_cfg(name), _tcfg(), mesh, RULES_VARIANTS["default"], HINT)
    assert len(tree.leaves(state)) == len(tree.leaves(want))
    for x, sh in zip(tree.leaves(state), tree.leaves(want)):
        assert isinstance(x, DistArray) and x.spec == tuple(sh.spec) and x.mesh is mesh
        for c in mesh.coords():
            assert tuple(x.shards[c].shape) == tuple(hi - lo for lo, hi in x.region(c))
    factors = [f for f in state.opt.factors if f is not None]
    assert factors and any(f is None for f in state.opt.factors) == (name != "olmo-1b")
    for f in factors:
        for t in f:
            if t.spec[-2:] == ("data", "model"):    # both axes divide: 1/8 a coordinate
                assert all(s.numel() * 8 == np.prod(t.shape) for s in t.shards.values())


def _alone(n: int, mesh) -> tuple[dict, dict]:
    """The bytes and calls of one sharded inversion of an n x n matrix on
    `mesh` under its sharded plan, its grid laid out where it lies."""
    plan = get_plan("inverse", n, torch.float32, measure=False, placement="sharded",
                    backend="cpu")
    a = torch.eye(n) * 2 + 0.01
    sbm = ShardedBlockMatrix.from_dense(a, plan.block_size, mesh=mesh)
    col.reset_collective_bytes()
    spin_inverse_sharded(sbm, leaf_solver=plan.leaf_solver, engine=plan.multiply_engine)
    return col.collective_bytes(), col.collective_calls()


@pytest.mark.parametrize("case", [("olmo-1b", (2, 4), "default"),
                                  ("granite-8b", (4, 2), "dp_only")],
                         ids=["olmo-2x4-default", "granite-4x2-dp_only"])
def test_shampoo_bytes_and_calls_equal_the_analytic_count(runs, case):
    name, shape, rules = case
    run = runs(name, shape, rules)
    cfg = _cfg(name)
    (moved1, calls1), (moved2, calls2) = run["counts"]
    want_moved, want_calls = partitioned_step_collectives(cfg, shape, rules, B, S, MICRO, HINT,
                                                          optimizer="spin_shampoo")
    assert {k: moved2[k] for k in KINDS} == want_moved and want_moved["gather"] > 0
    assert {k: calls2[k] for k in KINDS} == want_calls
    # nothing else moves in a step that does not refresh
    assert all(moved2[k] == 0 for k in moved2 if k not in KINDS), moved2
    # a refresh step: the same sharded inversions run alone, and the moves
    # of each factor layer into its grid and back
    mesh = _mesh(shape)
    block = {}
    excess_b = {k: moved1[k] - moved2[k] for k in moved1}
    excess_c = {k: calls1[k] - calls2[k] for k in calls1}
    want_b, want_c = dict.fromkeys(moved1, 0), dict.fromkeys(calls1, 0)
    for f in run["state"].opt.factors:
        if f is None:
            continue
        for t in (f.l, f.r):
            n, layers = t.shape[-1], (t.shape[0] if len(t.shape) == 3 else 1)
            if n not in block:
                block[n] = _alone(n, mesh)
            for k in want_b:
                want_b[k] += layers * block[n][0][k]
                want_c[k] += layers * block[n][1][k]
    bs = lambda n: get_plan("inverse", n, torch.float32, measure=False,  # noqa: E731
                            placement="sharded", backend="cpu").block_size
    moves = shampoo_refresh_moves(cfg, shape, bs, HINT)
    want_b["reshard"] += moves[0]
    want_c["reshard"] += moves[1]
    assert excess_b == want_b and excess_c == want_c
    assert excess_b["to_dense"] == 0 and excess_b["reshard"] > 0


def test_checkpoint_of_a_laid_out_shampoo_state_resumes_the_run(tmp_path):
    """`Trainer` saves a laid-out SPIN-Shampoo state (gathered to the host;
    granite-8b's norm scales have None factors), `maybe_restore` lays it
    out again bit for bit, and the next step equals the uninterrupted
    run's."""
    cfg = get_arch("granite-8b").reduced()
    mesh = _mesh((2, 4))
    shardings = state_shardings(cfg, _tcfg(), mesh, RULES_VARIANTS["default"], HINT)

    def fresh():
        return lay_out(init_state(cfg, _tcfg(), torch.Generator().manual_seed(0), "cpu",
                                  HINT), shardings)

    def trainer(ckpt_dir=None):
        return Trainer(cfg, _tcfg(), TokenStream(cfg, B, S, seed=0, device="cpu"),
                       ckpt_dir=ckpt_dir, ckpt_every=2)

    _, logs = trainer(str(tmp_path)).run(fresh(), 3, log_every=0)
    at2, _ = trainer().run(fresh(), 2, log_every=0)
    got, _ = restore(str(tmp_path), 2, fresh(), shardings=shardings)
    assert any(f is None for f in got.opt.factors)
    assert [f is None for f in got.opt.factors] == [f is None for f in at2.opt.factors]
    for a, b in zip(tree.leaves(got), tree.leaves(at2)):
        assert isinstance(a, DistArray) and a.spec == b.spec
        assert torch.equal(col.gather(a), col.gather(b))
    resumed = trainer(str(tmp_path))
    state = resumed.maybe_restore(fresh())
    for a, b in zip(tree.leaves(state), tree.leaves(at2)):
        assert isinstance(a, DistArray) and a.spec == b.spec
        assert torch.equal(col.gather(a), col.gather(b))
    _, more = resumed.run(state, 1, log_every=0)
    assert more[0]["step"] == 3 and more[0]["loss"] == logs[2]["loss"]
    assert more[0]["grad_norm"] == logs[2]["grad_norm"]
