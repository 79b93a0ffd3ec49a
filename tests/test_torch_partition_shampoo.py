"""The partitioned SPIN-Shampoo step on a (data, model) mesh of the CPU,
against the JAX package's placed jit and the port's mesh-free step.

The reference child (`mesh_harness.run_mesh`, 8 fake devices) jits the
reference's `make_train_step(cfg, TrainConfig(optimizer="spin_shampoo"))`
with `in_shardings` built as its dry run builds AdamW's
(`_param_state_specs`, `_batch_specs`): the parameters by `param_specs`;
the SpinShampooState's step whole, its master, m and v (lists in leaf
order) by their parameters' specs, and every factor and inverse (…, d, d)
by the port's `factor_spec` rule, `data` over the rows where |data|
divides d and `model` over the columns where |model| does. The reference
has no spec of its own for this state; nothing in it changes for the
test. The port gets the reference's initial state through
`bridge.train_state_from_numpy(..., shardings=state_shardings(...))`.

Two steps of B 8 x S 32 in 2 microbatches, warmup 1, damping 0.1 (at the
default 1e-3 the reduced model's rank-deficient factors reach a condition
where two f32 inversions differ by up to 9 %, tests/test_torch_optim.py).
Step 1 refreshes the inverses, step 2 does not. The bounds are
tests/test_torch_partition.py's: loss and grad norm within 2e-3; the
first step's gradients (read back from its m = (1 - β)·clip·g) within
2^-5 of their largest entry; masters after the second step within
2.02·lr·lr_scale; the second step's update a leaf within 3 % in norm and
0.9 in cosine (the grafted step has Adam's norm, whatever the
preconditioner).

The Gram factors after step 1 are L = (1 - β)·c²·G·Gᵀ = M·Mᵀ/(1 - β), M the
step's m. An entry of M is off by at most δ = (2^-5 + 2·2e-3)·max|M| (the
gradient's bound, and each run's clip factor from a grad norm within
2e-3), so a row of M by at most √d·δ in norm, and by Cauchy-Schwarz an
entry of L by at most √d·δ·(2·max_k‖M_k‖ + √d·δ)/(1 - β), d the length of
a row (R: of a column, from Mᵀ). That bound, with M the reference's m,
holds L and R layer by layer.

Reduced olmo-1b on (2, 4) under `default` and reduced granite-8b (one KV
head, rmsnorm scales, an untied `lm_head`) on (4, 2) under `dp_only`.
"""

import jax
import numpy as np
import pytest
import torch

from mesh_harness import run_mesh
from repro.configs import get_arch as j_get_arch
from repro.optim.spin_shampoo import SpinShampooConfig as JSpinShampooConfig
from repro.runtime.trainer import TrainConfig as JTrainConfig
from repro.runtime.trainer import init_state as j_init_state
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.launch.dryrun import RULES_VARIANTS
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.optim import SpinShampooConfig
from repro_torch.parallel import collectives as col
from repro_torch.parallel.collectives import DistArray
from repro_torch.runtime.trainer import TrainConfig, make_train_step, state_shardings

B, S, MICRO = 8, 32, 2
HINT = 4
DAMPING = 0.1
LOSS_RTOL = 2e-3
GRAD_TOL = 2.0 ** -5
MASTER_STEPS = 2.02
UPDATE_RTOL = 0.03
UPDATE_COS = 0.9
CASES = [("olmo-1b", (2, 4), "default"), ("granite-8b", (4, 2), "dp_only")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _id(case) -> str:
    name, shape, rules = case
    return f"{name}-{shape[0]}x{shape[1]}-{rules}"


def _tcfg() -> TrainConfig:
    return TrainConfig(microbatches=MICRO, warmup=1, total_steps=100, optimizer="spin_shampoo",
                       shampoo=SpinShampooConfig(damping=DAMPING))


def _batch_np(cfg, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[:, :3] = -1
    return {"tokens": tokens, "labels": labels}


def _jax_state(name: str):
    jcfg = j_get_arch(name).reduced()
    tcfg = JTrainConfig(microbatches=MICRO, warmup=1, total_steps=100,
                        optimizer="spin_shampoo", shampoo=JSpinShampooConfig(damping=DAMPING))
    return jax.tree.map(np.asarray, j_init_state(jcfg, tcfg, jax.random.PRNGKey(0), HINT))


def _whole(x) -> np.ndarray:
    t = col.gather(x) if isinstance(x, DistArray) else x
    return t.detach().float().numpy().astype(np.float64)


def _run(name: str, shape=None, rules: str = "default") -> dict:
    """The port's two steps, laid out on a mesh of `shape` or mesh-free."""
    cfg = get_arch(name).reduced()
    sh = None
    if shape is not None:
        mesh = make_worker_mesh(tuple(shape), devices=["cpu"] * (shape[0] * shape[1]))
        sh = state_shardings(cfg, _tcfg(), mesh, RULES_VARIANTS[rules], HINT)
    state = bridge.train_state_from_numpy(_jax_state(name), "cpu", shardings=sh)
    step = make_train_step(cfg, _tcfg(), RULES_VARIANTS[rules])
    batch = {k: torch.from_numpy(v).long() for k, v in _batch_np(cfg).items()}
    init = [_whole(x) for x in state.opt.master]
    col.reset_collective_bytes()
    state, m1 = step(state, batch)
    dense = col.collective_bytes()["to_dense"]
    first_m = [_whole(x) for x in state.opt.m]
    gram = [None if f is None else (_whole(f.l), _whole(f.r)) for f in state.opt.factors]
    col.reset_collective_bytes()
    state, m2 = step(state, batch)
    dense += col.collective_bytes()["to_dense"]
    return {"loss": [float(m1["loss"]), float(m2["loss"])],
            "grad_norm": [float(m1["grad_norm"]), float(m2["grad_norm"])],
            "lr_scale": [float(m1["lr_scale"]), float(m2["lr_scale"])],
            "first_m": first_m, "gram": gram, "init": init,
            "master": [_whole(x) for x in state.opt.master],
            "to_dense": dense, "state": state}


_CHILD = """
import os, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import AxisType, jit_shardings, make_mesh, set_mesh
from repro.configs import get_arch
from repro.launch.dryrun import RULES_VARIANTS, _batch_specs
from repro.models import transformer as T
from repro.optim.spin_shampoo import SpinShampooConfig, SpinShampooState, _Factor
from repro.runtime.trainer import TrainConfig, TrainState, init_state, make_train_step

out = OUT
for name, shape, rname in CASES:
    cfg, rules = get_arch(name).reduced(), RULES_VARIANTS[rname]
    mesh = make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:8])
    tcfg = TrainConfig(microbatches=2, warmup=1, total_steps=100, optimizer="spin_shampoo",
                       shampoo=SpinShampooConfig(damping=DAMPING))
    state = init_state(cfg, tcfg, jax.random.PRNGKey(0), 4)
    raw = np.load(os.path.join(out, "batch_" + name + ".npz"))
    batch = {k: jnp.asarray(raw[k]) for k in ("labels", "tokens")}

    def fspec(x):
        d = x.shape[-1]
        return P(*([None] * (x.ndim - 2)), "data" if d % shape[0] == 0 else None,
                 "model" if d % shape[1] == 0 else None)

    with set_mesh(mesh):
        pspecs = T.param_specs(cfg, rules, mesh, model_size_hint=4)
        flat = jax.tree.leaves(pspecs, is_leaf=lambda x: isinstance(x, P))
        factors = [None if f is None else _Factor(*(fspec(t) for t in f))
                   for f in state.opt.factors]
        specs = (TrainState(pspecs, SpinShampooState(P(), flat, factors, flat, flat), P()),
                 _batch_specs(batch, rules, mesh))
        # placed before the first call, so that the second reuses its program
        state, batch = jax.device_put((state, batch), jit_shardings(specs, mesh))
        step = jax.jit(make_train_step(cfg, tcfg, rules),
                       in_shardings=jit_shardings(specs, mesh),
                       out_shardings=jit_shardings((specs[0], None), mesh))
        s1, m1 = step(state, batch)
        first_m = [np.asarray(x, np.float32) for x in s1.opt.m]
        gram = [np.asarray(t, np.float32) for f in s1.opt.factors if f is not None
                for t in (f.l, f.r)]
        laid = [list(t.sharding.spec) for f in s1.opt.factors if f is not None
                for t in (f.linv, f.rinv)]
        s2, m2 = step(s1, batch)
    key = "%s-%dx%d-%s" % (name, shape[0], shape[1], rname)
    np.savez(os.path.join(out, key + ".npz"), *first_m,
             *[np.asarray(x, np.float32) for x in s2.opt.master], *gram)
    emit_result({"case": key, "n": len(first_m), "n_gram": len(gram),
                 "loss": [float(m1["loss"]), float(m2["loss"])],
                 "grad_norm": [float(m1["grad_norm"]), float(m2["grad_norm"])],
                 "lr_scale": [float(m1["lr_scale"]), float(m2["lr_scale"])],
                 "inverse_specs": laid})
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's placed jit, both cases in one child."""
    out = tmp_path_factory.mktemp("partition_shampoo_ref")
    for name, _, _ in CASES:
        np.savez(out / f"batch_{name}.npz", **_batch_np(get_arch(name).reduced()))
    code = (_CHILD.replace("OUT", repr(str(out))).replace("DAMPING", repr(DAMPING))
            .replace("CASES", repr([(a, list(s), r) for a, s, r in CASES])))
    got = {}
    for r in run_mesh(code, devices=8, timeout=900):
        arrays = np.load(out / f"{r['case']}.npz")
        n, k = r["n"], r["n_gram"]
        r["first_m"] = [arrays[f"arr_{i}"].astype(np.float64) for i in range(n)]
        r["master"] = [arrays[f"arr_{n + i}"].astype(np.float64) for i in range(n)]
        r["gram"] = [arrays[f"arr_{2 * n + i}"].astype(np.float64) for i in range(k)]
        got[r["case"]] = r
    return got


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(case):
        key = case if isinstance(case, str) else _id(case)
        if key not in cache:
            cache[key] = _run(case) if isinstance(case, str) else _run(*case)
        return cache[key]

    return get


def _grads(first_m: list, gnorm: float) -> list:
    """The first step's gradients from its m: m = (1 - β)·clip·g."""
    cfg = _tcfg().shampoo
    clip = min(1.0, cfg.grad_clip / max(gnorm, 1e-9))
    return [m / ((1 - cfg.beta) * clip) for m in first_m]


def _assert_close(got: dict, want: dict, what: str) -> None:
    assert abs(got["loss"][0] - want["loss"][0]) <= LOSS_RTOL * abs(want["loss"][0]), what
    assert abs(got["grad_norm"][0] - want["grad_norm"][0]) <= \
        LOSS_RTOL * abs(want["grad_norm"][0]), what
    assert got["lr_scale"] == pytest.approx(want["lr_scale"]) and want["lr_scale"][0] == 0
    for i, (g, w) in enumerate(zip(_grads(got["first_m"], got["grad_norm"][0]),
                                   _grads(want["first_m"], want["grad_norm"][0]))):
        scale = float(np.abs(w).max())
        assert scale > 0 and float(np.abs(g - w).max()) <= GRAD_TOL * scale, (what, i)
    bound = MASTER_STEPS * _tcfg().shampoo.lr * want["lr_scale"][1]
    assert len(got["master"]) == len(want["master"])
    for i, (m, w, m0) in enumerate(zip(got["master"], want["master"], got["init"])):
        assert float(np.abs(m - w).max()) <= bound, (what, i)
        du, dw = m - m0, w - m0
        nu, nw = float(np.linalg.norm(du)), float(np.linalg.norm(dw))
        assert nw > 0 and abs(nu - nw) <= UPDATE_RTOL * nw, (what, i, nu, nw)
        assert float(np.vdot(du, dw)) >= UPDATE_COS * nu * nw, (what, i)


def _trimmed(spec) -> tuple:
    """A spec without its trailing Nones (JAX may print either)."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _gram_bound(m: np.ndarray, left: bool) -> float:
    """The module docstring's bound on an entry of L (left) or R."""
    beta = _tcfg().shampoo.beta
    rows = m if left else np.swapaxes(m, -1, -2)
    d = rows.shape[-1]
    delta = (GRAD_TOL + 2 * LOSS_RTOL) * float(np.abs(m).max())
    rmax = float(np.linalg.norm(rows, axis=-1).max())
    return np.sqrt(d) * delta * (2 * rmax + np.sqrt(d) * delta) / (1 - beta)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_partitioned_shampoo_meets_the_references_placed_jit(reference, runs, case):
    got, ref = runs(case), reference[_id(case)]
    _assert_close(got, ref, _id(case))
    # the factors after step 1, against the bound the gradients' give them
    want = iter(ref["gram"])
    factored = [(m, g) for m, g in zip(ref["first_m"], got["gram"]) if g is not None]
    assert 2 * len(factored) == len(ref["gram"]) > 0
    for m, (lg, rg) in factored:
        for g, w, left in ((lg, next(want), True), (rg, next(want), False)):
            assert g.shape == w.shape
            assert float(np.abs(g - w).max()) <= _gram_bound(m, left), (_id(case), left)
    # the reference's inverses stay laid out by the same rule
    name, shape, _ = case
    sh = state_shardings(get_arch(name).reduced(), _tcfg(), got["state"].params[
        "embed"].mesh, RULES_VARIANTS[case[2]], HINT)
    mine = [tuple(t.spec) for f in sh.opt.factors if f is not None for t in (f.linv, f.rinv)]
    assert [_trimmed(s) for s in ref["inverse_specs"]] == [_trimmed(s) for s in mine]
    assert got["to_dense"] == 0


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_partitioned_shampoo_meets_the_mesh_free_port(runs, case):
    got, free = runs(case), runs(case[0])
    _assert_close(got, free, _id(case))
    for fg, gg, m in zip(free["gram"], got["gram"], free["first_m"]):
        assert (fg is None) == (gg is None)
        if gg is not None:
            for g, w, left in ((gg[0], fg[0], True), (gg[1], fg[1], False)):
                assert float(np.abs(g - w).max()) <= _gram_bound(m, left)
