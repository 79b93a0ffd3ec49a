"""The partitioned dense LM step on a (data, model) mesh of the CPU, against
the JAX package's placed jit and the port's mesh-free step.

The reference child (`mesh_harness.run_mesh`, 8 fake devices) runs the
program of the reference's dry run: `make_train_step(cfg, tcfg, rules)`
jitted with `in_shardings` from `_param_state_specs` and `_batch_specs`
under the same rules set, from `init_params(PRNGKey(0),
model_size_hint=4)`. The port gets the same state through
`bridge.train_state_from_numpy(..., shardings=state_shardings(...))`:
every leaf a DistArray laid out by the reference's specs, each coordinate
computing on its own shards.

Two AdamW steps of B 8 x S 32 in 2 microbatches, warmup 1. The schedule
gives the first step lr_scale 0, so the first step's AdamW `m` is
(1 - b1) · clip · g: the step's gradient g, read back through the
step's own clip factor on each side. The weights first move at the
second step: each master entry then lies within 2.02 · lr · lr_scale of
the other run's (at b1 0.9, b2 0.95 the bias-corrected second Adam step
is at most 1.0004 in size, so even a sign flip of a tiny gradient moves
an entry by no more). That bound alone passes a state the update left
unmoved, so the update itself (second-step master minus initial master)
is held leaf by leaf too: its norm within 3 % of the other run's (an
unmoved leaf reads 0) and its cosine with the other run's at least 0.9
(an update the wrong way reads -1; a gradient within its rounding of 0
may flip the sign of its entry's step, and on the 128-entry norm scales
two such flips cost 0.03). The loss is held to 2e-3 relative and every
gradient to 2^-5 of its largest entry, tests/test_torch_sharded_lm.py's
bounds; the same against the port's mesh-free step.

Reduced olmo-1b (MHA, tied head, no norm weights) and granite-8b (one KV
head, rmsnorm scales, an untied `lm_head`) on (2, 4) and (4, 2) under the
`default` and `dp_only` rules. The bytes and calls of each collective
kind in one step equal `launch.dryrun.partitioned_step_collectives`,
written from the shapes.
"""

import jax
import numpy as np
import pytest
import torch

from mesh_harness import run_mesh
from torch_multiprocess_ranks import _held_bytes, _own_bytes
from repro.configs import get_arch as j_get_arch
from repro.runtime.trainer import TrainConfig as JTrainConfig
from repro.runtime.trainer import init_state as j_init_state
from repro_torch import bridge, tree
from repro_torch.checkpoint.ckpt import restore
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch.dryrun import RULES_VARIANTS, partitioned_step_collectives
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.models import transformer as T
from repro_torch.parallel import collectives as col
from repro_torch.parallel import logical_spec, record_specs
from repro_torch.parallel.collectives import DistArray
from repro_torch.parallel.sharding import PartitionSpec as P, Program, lay_out
from repro_torch.runtime.trainer import TrainConfig, Trainer, make_train_step, state_shardings

B, S, MICRO = 8, 32, 2
HINT = 4
LOSS_RTOL = 2e-3
GRAD_TOL = 2.0 ** -5
MASTER_STEPS = 2.02            # a master entry's bound, in units of lr · lr_scale
UPDATE_RTOL = 0.03             # the second step's update: its norm, leaf by leaf,
UPDATE_COS = 0.9               # and its cosine with the other run's
ARCHS = ["olmo-1b", "granite-8b"]
SHAPES = [(2, 4), (4, 2)]
RULES = ["default", "dp_only"]
CASES = [(a, s, r) for a in ARCHS for s in SHAPES for r in RULES]
KINDS = ("all_gather", "reduce_scatter", "psum", "pmax")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The reduced models' products are small: one torch thread a test
    process keeps the module's time when other test processes share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _id(case) -> str:
    name, shape, rules = case
    return f"{name}-{shape[0]}x{shape[1]}-{rules}"


def _tcfg() -> TrainConfig:
    return TrainConfig(microbatches=MICRO, warmup=1, total_steps=100)


def _mesh(shape):
    return make_worker_mesh(tuple(shape), devices=["cpu"] * (shape[0] * shape[1]))


def _batch_np(cfg, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[:, :3] = -1                       # masked positions carry no loss
    return {"tokens": tokens, "labels": labels}


def _batch(cfg) -> dict:
    return {k: torch.from_numpy(v).long() for k, v in _batch_np(cfg).items()}


def _jax_state(name: str):
    jcfg = j_get_arch(name).reduced()
    state = j_init_state(jcfg, JTrainConfig(microbatches=MICRO, warmup=1, total_steps=100),
                         jax.random.PRNGKey(0), HINT)
    return jax.tree.map(np.asarray, state)


def _state(name: str, mesh=None, rules: str = "default"):
    """The reference's initial state in the port: laid out by the
    reference's specs on `mesh`, or whole without one."""
    cfg = get_arch(name).reduced()
    sh = None if mesh is None else state_shardings(cfg, _tcfg(), mesh, RULES_VARIANTS[rules],
                                                   HINT)
    return bridge.train_state_from_numpy(_jax_state(name), "cpu", shardings=sh)


def _whole(x) -> torch.Tensor:
    return (col.gather(x) if isinstance(x, DistArray) else x).detach().clone()


def _two_steps(name: str, mesh=None, rules: str = "default") -> dict:
    """Two AdamW steps: the losses, grad norms, the first step's m (a
    gradient, module docstring), the initial and the second step's masters,
    the counts of the first step and the final state."""
    cfg = get_arch(name).reduced()
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


def _grads(m1: list, gnorm: float) -> list:
    """The first step's gradients from its AdamW m: m = (1 - b1)·clip·g."""
    b1, clip = _tcfg().adamw.b1, min(1.0, _tcfg().adamw.grad_clip / max(gnorm, 1e-9))
    return [np.asarray(m, np.float64) / ((1 - b1) * clip) for m in m1]


_CHILD = """
import os, numpy as np, jax, jax.numpy as jnp
from repro.compat import AxisType, jit_shardings, make_mesh, set_mesh
from repro.configs import get_arch
from repro.launch.dryrun import RULES_VARIANTS, _batch_specs, _param_state_specs
from repro.runtime.trainer import TrainConfig, init_state, make_train_step

out = OUT
for name, shape, rname in CASES:
    cfg, rules = get_arch(name).reduced(), RULES_VARIANTS[rname]
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
                 "wq_spec": str(s2.params["layers"]["attn"]["wq"].sharding.spec)})
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's placed jit, every case in one child."""
    out = tmp_path_factory.mktemp("partition_ref")
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
    """The port's partitioned runs (one a case, made when first asked for)
    and its mesh-free run of each arch."""
    cache = {}

    def get(case):
        key = case if isinstance(case, str) else _id(case)
        if key not in cache:
            cache[key] = (_two_steps(case) if isinstance(case, str)
                          else _two_steps(case[0], _mesh(case[1]), case[2]))
        return cache[key]

    return get


def _assert_close(got: dict, want: dict, what: str, grad_tols=None) -> None:
    """The module docstring's bounds; `grad_tols` gives a leaf's gradient
    its own bound in place of GRAD_TOL (leaf index -> bound)."""
    assert abs(got["loss"][0] - want["loss"][0]) <= LOSS_RTOL * abs(want["loss"][0]), what
    assert abs(got["grad_norm"][0] - want["grad_norm"][0]) <= \
        LOSS_RTOL * abs(want["grad_norm"][0]), what
    assert got["lr_scale"] == pytest.approx(want["lr_scale"]) and want["lr_scale"][0] == 0
    assert len(got["grads"]) == len(want["grads"])
    for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        scale = float(np.abs(w).max())
        tol = (grad_tols or {}).get(i, GRAD_TOL)
        assert scale > 0 and float(np.abs(np.asarray(g) - w).max()) <= tol * scale, \
            (what, i)
    bound = MASTER_STEPS * _tcfg().adamw.lr * want["lr_scale"][1]
    for i, (m, w) in enumerate(zip(got["master"], want["master"])):
        assert float(np.abs(np.asarray(m, np.float64) - np.asarray(w, np.float64)).max()) \
            <= bound, (what, i)
    # the second step's update, leaf by leaf: its size and its direction
    for i, (m, w, m0) in enumerate(zip(got["master"], want["master"], got["init"])):
        m0 = np.asarray(m0, np.float64)
        du, dw = np.asarray(m, np.float64) - m0, np.asarray(w, np.float64) - m0
        nu, nw = float(np.linalg.norm(du)), float(np.linalg.norm(dw))
        assert nw > 0 and abs(nu - nw) <= UPDATE_RTOL * nw, (what, i, nu, nw)
        assert float(np.vdot(du, dw)) >= UPDATE_COS * nu * nw, (what, i)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_partitioned_step_meets_the_references_placed_jit(reference, runs, case):
    ref = reference[_id(case)]
    assert ref["wq_spec"] == str(jax.sharding.PartitionSpec(
        *runs(case)["state"].params["layers"]["attn"]["wq"].spec))
    _assert_close(runs(case), ref, _id(case))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_partitioned_step_meets_the_mesh_free_port(runs, case):
    _assert_close(runs(case), runs(case[0]), _id(case))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_collective_bytes_and_calls_equal_the_analytic_count(runs, case):
    name, shape, rules = case
    moved, calls = runs(case)["counts"]
    want_moved, want_calls = partitioned_step_collectives(get_arch(name).reduced(), shape,
                                                          rules, B, S, MICRO)
    assert {k: moved[k] for k in KINDS} == want_moved
    assert {k: calls[k] for k in KINDS} == want_calls
    # nothing else moves: no leaf is made whole, the batch is cut where it lies
    assert all(moved[k] == 0 for k in moved if k not in KINDS), moved


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_every_leaf_stays_laid_out_by_its_spec(runs, case):
    name, shape, rules = case
    state = runs(case)["state"]
    mesh = state.params["embed"].mesh
    want = state_shardings(get_arch(name).reduced(), _tcfg(), mesh, RULES_VARIANTS[rules],
                           HINT)
    for x, sh in zip(tree.leaves(state), tree.leaves(want)):
        assert isinstance(x, DistArray) and x.spec == tuple(sh.spec) and x.mesh is mesh
        for c in mesh.coords():
            assert tuple(x.shards[c].shape) == tuple(hi - lo for lo, hi in x.region(c))
    # FSDP (and tensor parallelism): a coordinate holds 1/8 of each 2-D weight
    for w in tree.leaves(state.params["layers"]["attn"]):
        assert all(t.numel() * 8 == w.shape[0] * w.shape[1] * w.shape[2]
                   for t in w.shards.values())


@pytest.mark.parametrize("name", ARCHS)
def test_shard_sites_check_and_record_their_layouts(name):
    cfg = get_arch(name).reduced()
    mesh = _mesh((2, 4))
    state = _state(name, mesh)
    with record_specs() as recs:
        logits = T.forward(state.params, _batch(cfg), cfg)[0]
    assert tuple(logits.shape) == (B, S, cfg.vocab)
    sites = {r.axes for r in recs}
    assert sites == {("batch", "seq", "embed"), ("batch", "seq", "heads", None),
                     ("batch", "seq", "kv_heads", None), ("batch", "seq", "ffn"),
                     ("batch", "seq", "vocab")}
    for r in recs:
        assert r.op == "shard" and r.spec == logical_spec(r.shape, r.axes, RULES_VARIANTS[
            "default"], mesh)
    # a coordinate holding another cut than the spec's is refused
    xs = {c: torch.zeros(B, S, cfg.d_model) for c in mesh.coords()}
    with pytest.raises(ValueError, match="coordinate"):
        Program(mesh, RULES_VARIANTS["default"], B, S).shard(xs, (B, S, cfg.d_model),
                                                             "batch", "seq", "embed")


def test_forward_on_laid_out_parameters_joins_the_logits():
    """Inference on a laid-out state: the logits come back whole, within
    the bf16 rounding of the summed partial projections of the mesh-free
    logits; under dp_only (no partial sums) bit for bit."""
    cfg = get_arch("granite-8b").reduced()
    batch = _batch(cfg)
    free = T.forward(_state("granite-8b").params, batch, cfg)[0]
    laid = T.forward(_state("granite-8b", _mesh((4, 2)), "dp_only").params, batch, cfg,
                     RULES_VARIANTS["dp_only"])[0]
    assert torch.equal(laid, free)
    laid = T.forward(_state("granite-8b", _mesh((2, 4))).params, batch, cfg)[0]
    assert float((laid - free).abs().max()) <= 2.0 ** -5 * float(free.abs().max())


@pytest.mark.parametrize("variant", ["sp", "fsdp_both"])
def test_a_sequence_split_raises_naming_the_axis(variant):
    cfg = get_arch("olmo-1b").reduced()
    mesh = _mesh((2, 4))
    rules = RULES_VARIANTS[variant]
    state = bridge.train_state_from_numpy(
        _jax_state("olmo-1b"), "cpu", shardings=state_shardings(cfg, _tcfg(), mesh, rules,
                                                                HINT))
    with pytest.raises(ValueError, match="'seq'"):
        make_train_step(cfg, _tcfg(), rules)(state, _batch(cfg))


def test_audio_and_vlm_bodies_on_a_laid_out_state_meet_the_mesh_free_port():
    """The audio body (hubert: frames, `mask_embed` where masked, the loss
    on the masked frames) and the VLM body (phi-3-vision: 8 patch stubs
    before the text), laid out on (2, 4): `loss_fn` within LOSS_RTOL of
    the mesh-free loss and its token count equal, `prefill`'s logits and
    a `decode_step` from its cache (`pad_cache` to S + 8) within 2e-2 of
    the mesh-free path's. hubert decodes too: the reference's
    `decode_step` makes no exception for an encoder."""
    import torch.nn.functional as F

    mesh = _mesh((2, 4))
    rng = np.random.default_rng(3)
    for name in ("hubert-xlarge", "phi-3-vision-4.2b"):
        cfg = get_arch(name).reduced()
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu", HINT)
        specs = T.param_specs(cfg, RULES_VARIANTS["default"], mesh, HINT)
        laid = lay_out(params, _named(specs, mesh))
        if cfg.family == "audio":
            batch = {"frame_embeds": torch.from_numpy(rng.standard_normal(
                         (B, S, cfg.d_model), dtype=np.float32)),
                     "mask": torch.from_numpy(rng.random((B, S)) < 0.15)}
            text = S
        else:
            text = S - cfg.n_frontend_tokens
            batch = {"patch_embeds": torch.from_numpy(rng.standard_normal(
                         (B, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)),
                     "tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, text)))}
        batch["labels"] = torch.from_numpy(rng.integers(-1, cfg.vocab, (B, text)))
        want, want_m = T.loss_fn(params, batch, cfg)
        got, got_m = T.loss_fn(laid, batch, cfg)
        assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want)), name
        assert float(got_m["tokens"]) == float(want_m["tokens"]) > 0, name
        prompt = {k: v for k, v in batch.items() if k != "labels"}
        free_logits, _, _, free = T.prefill(params, prompt, cfg)
        logits, _, _, cache = T.prefill(laid, prompt, cfg)
        assert tuple(logits.shape) == (B, S, cfg.vocab)
        assert float((logits - free_logits).abs().max()) < 2e-2, name
        cache = T.pad_cache(cache, cfg, S + 8)
        pad = (0, 0, 0, 0, 0, 8)
        free["k"], free["v"] = F.pad(free["k"], pad), F.pad(free["v"], pad)
        tok = torch.argmax(free_logits[:, -1], -1)
        got, cache = T.decode_step(laid, cache, tok, cfg)
        want, free = T.decode_step(params, free, tok, cfg)
        assert float((got - want).abs().max()) < 2e-2, name
        assert torch.equal(col.gather(cache["pos"]), free["pos"]) and int(free["pos"][0]) == S + 1


def test_pad_cache_refuses_a_prompt_longer_than_the_rolling_cache():
    """Reduced hymba (window 32): a laid-out prefill of 48 positions keeps
    its whole k and v, as the mesh-free prefill does, but a decode cache
    under the window has min(length, 32) slots, into which the reference's
    caller cannot set the prompt either: `pad_cache` raises. A prompt that
    fits pads to the window's slots, and a length below the prompt's still
    raises as before."""
    cfg = get_arch("hymba-1.5b").reduced()
    mesh = _mesh((2, 4))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu", HINT)
    laid = lay_out(params, _named(T.param_specs(cfg, RULES_VARIANTS["default"], mesh, HINT),
                                  mesh))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (B, 48)))
    cache = T.prefill(laid, {"tokens": tokens}, cfg)[3]
    assert cache["k"].shape[2] == 48 == T.prefill(params, {"tokens": tokens}, cfg)[3][
        "k"].shape[2]
    for length in (48, 64):
        with pytest.raises(ValueError, match="rolling cache's 32 slots"):
            T.pad_cache(cache, cfg, length)
    with pytest.raises(ValueError, match="below the prompt"):
        T.pad_cache(cache, cfg, 32)
    short = T.prefill(laid, {"tokens": tokens[:, :16]}, cfg)[3]
    assert T.pad_cache(short, cfg, 64)["k"].shape[2] == 32


def _named(specs: dict, mesh):
    from repro_torch.parallel import NamedSharding

    return {k: _named(v, mesh) if isinstance(v, dict) else NamedSharding(mesh, v)
            for k, v in specs.items()}


def test_the_laid_out_batch_moves_its_rows_and_gives_the_same_step():
    """A batch laid out by the reference's `_batch_specs` (rows over
    `data`): each microbatch's rows move to the coordinates that take
    them ("reshard"), and the step is the whole batch's, bit for bit."""
    cfg = get_arch("olmo-1b").reduced()
    mesh = _mesh((2, 4))
    batch = _batch(cfg)
    laid = {k: col.distribute(v, logical_spec(tuple(v.shape), ("batch", None),
                                              RULES_VARIANTS["default"], mesh), mesh)
            for k, v in batch.items()}
    step = make_train_step(cfg, _tcfg())
    out = []
    for b in (batch, laid):
        col.reset_collective_bytes()
        state, m = step(_state("olmo-1b", mesh), b)
        out.append((float(m["loss"]), [_whole(x) for x in tree.leaves(state.opt.m)],
                    col.collective_bytes()["reshard"]))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert out[0][2] == 0 and out[1][2] > 0


def test_the_gradient_is_the_mesh_free_autograd_gradient():
    """`laid_out_region` + `grads` on one batch against autograd of the
    mesh-free `loss_fn`: every gradient within 2^-5 of its largest entry;
    a replicated leaf (the norm scales) sums its coordinates' parts."""
    cfg = get_arch("granite-8b").reduced()
    batch = {k: v[:4] for k, v in _batch(cfg).items()}
    params = _state("granite-8b").params
    flat = [t.detach().requires_grad_() for t in tree.leaves(params)]
    loss, _ = T.loss_fn(tree.unflatten(params, flat), batch, cfg)
    want = torch.autograd.grad(loss, flat)
    laid = _state("granite-8b", _mesh((2, 4))).params
    (got_loss, _), (entered,) = col.laid_out_region(
        lambda p: T.loss_fn(p, batch, cfg))(laid)
    got = col.grads(got_loss, entered)
    got_loss, loss = float(got_loss.detach()), float(loss.detach())
    assert abs(got_loss - loss) <= LOSS_RTOL * abs(loss)
    for (key, g), p, w in zip(tree.leaves_with_path(got), tree.leaves(laid), want):
        assert isinstance(g, DistArray) and g.spec == p.spec, key
        w = w.float()
        err = float((col.gather(g).float() - w).abs().max())
        assert err <= GRAD_TOL * float(w.abs().max()), key


def _holds_only_its_regions(state) -> bool:
    """Every shard owns storage of its region's size (no view of a whole
    leaf keeps that leaf alive), and the distinct storages add up to the
    process's regions."""
    return (all(t.untyped_storage().nbytes() == t.numel() * t.element_size()
                for x in tree.leaves(state) for t in x.shards.values())
            and _held_bytes(state) == _own_bytes(state))


@pytest.mark.parametrize("name", ["granite-8b", "qwen2-moe-a2.7b"])
def test_checkpoint_of_a_laid_out_state_resumes_the_run(tmp_path, name):
    """`Trainer` saves a laid-out state (gathered to the host),
    `restore(shardings=)` lays it out again bit for bit, holding only its
    coordinates' regions (no whole leaf alive behind them), and a run
    resumed from it repeats the uninterrupted run's next loss."""
    cfg = get_arch(name).reduced()
    mesh = _mesh((2, 4))
    shardings = state_shardings(cfg, _tcfg(), mesh, RULES_VARIANTS["default"], HINT)

    def trainer(ckpt_dir=None):
        return Trainer(cfg, _tcfg(), TokenStream(cfg, B, S, seed=0, device="cpu"),
                       ckpt_dir=ckpt_dir, ckpt_every=2)

    _, logs = trainer(str(tmp_path)).run(_state(name, mesh), 3, log_every=0)
    at2, _ = trainer().run(_state(name, mesh), 2, log_every=0)
    got, extra = restore(str(tmp_path), 2, _state(name, mesh), shardings=shardings)
    assert "stream" in extra
    for a, b in zip(tree.leaves(got), tree.leaves(at2)):
        assert isinstance(a, DistArray) and a.spec == b.spec
        assert torch.equal(col.gather(a), col.gather(b))
    assert _holds_only_its_regions(got)
    resumed = trainer(str(tmp_path))
    state = resumed.maybe_restore(_state(name, mesh))
    assert all(isinstance(x, DistArray) for x in tree.leaves(state))
    assert _holds_only_its_regions(state)
    _, more = resumed.run(state, 1, log_every=0)
    assert more[0]["step"] == 3 and more[0]["loss"] == logs[2]["loss"]


@pytest.mark.parametrize("name", ["granite-8b", "qwen2-moe-a2.7b"])
def test_the_bridge_lays_out_the_references_state(name):
    """`train_state_from_numpy(..., shardings=)`: every leaf a DistArray
    whose whole is the reference's leaf, bit for bit; the step counters
    whole (P())."""
    mesh = _mesh((4, 2))
    raw = _jax_state(name)
    state = _state(name, mesh)
    assert state.step.spec == P() and state.opt.step.spec == P()
    for x, want in zip(tree.leaves(state), jax.tree.leaves(raw)):
        assert torch.equal(col.gather(x), bridge.to_torch(want, "cpu"))


def test_global_norm_counts_a_replicated_region_once():
    from repro_torch.optim import global_norm

    mesh = _mesh((2, 4))
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    whole = torch.sqrt(torch.sum(w ** 2) * 3)
    for spec in ((None, None), ("data", "model"), ("model", None)):
        laid = [col.distribute(w, spec, mesh) for _ in range(3)]
        assert torch.allclose(global_norm(laid), whole)
