"""The LM under a (data, model) mesh of the CPU against the JAX package's.

The port keeps a global view under a mesh: the activations stay whole,
each `shard` site records its resolved layout, and only the reference's
`shard_map` regions, the embedding lookup and MoE's expert-parallel
dispatch, run per coordinate. So a dense family's loss under the mesh is
the mesh-free loss bit for bit, the sharded lookup is `F.embedding`'s
bits, and a MoE family's step is the reference's EP step.

The reference's loss and gradients under the same (2, 4) mesh of fake
devices come from a subprocess (`mesh_harness.run_mesh`), with one
correction: its EP multiplies each coordinate's tokens by that
coordinate's slice of the shared experts and `psum`s slices of different
tokens (ROADMAP §C, reference caveats), so the child computes the shared
experts as its own mesh-free path does, outside the EP region, on the
whole tokens. The tolerances are those of tests/test_torch_families.py
for the mesh-free step: the loss to 2e-3 relative, each gradient to 2^-5
of its largest entry; the router's of qwen2-moe to 2^-4, since the
corrected reference rounds the routed output to bf16 once more before it
adds the shared experts' (the port adds them in f32 first) and the
router's gradient sums every token's gate term, which largely cancel.
"""

import json

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mesh_harness import run_mesh
from repro.configs import get_arch as j_get_arch
from repro.models import transformer as JT
from repro_torch import bridge, tree
from repro_torch.checkpoint.ckpt import restore, save
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import TokenStream, make_batch
from repro_torch.launch.mesh import make_worker_mesh, set_mesh
from repro_torch.models import transformer as T
from repro_torch.models.embedding import embed_lookup
from repro_torch.parallel import (DEFAULT_RULES, NamedSharding, PartitionSpec as P,
                                  ShardingRules, collective_bytes, logical_spec,
                                  record_specs, reset_collective_bytes)
from repro_torch.parallel.collectives import DistArray, distribute, gather
from repro_torch.runtime.trainer import TrainConfig, Trainer, init_state, make_train_step
from repro_torch.serving import Request, ServingEngine

MESH = (2, 4)
B, S = 4, 32
HINT = 4                     # 4 experts over model 4: E_loc 1
LOSS_RTOL = 2e-3
GRAD_TOL = 2.0 ** -5
ROUTER_TOL = 2.0 ** -4       # qwen2-moe's router: see the module docstring
FAMILIES = ["olmo-1b", "qwen2-moe-a2.7b", "dbrx-132b", "mamba2-130m", "hymba-1.5b",
            "hubert-xlarge", "phi-3-vision-4.2b"]


def _mesh(shape=MESH):
    return make_worker_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))


def _model(name, hint=HINT):
    jcfg, cfg = j_get_arch(name).reduced(), get_arch(name).reduced()
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), model_size_hint=hint)
    return cfg, bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _batch(cfg, seed=3):
    return make_batch(cfg, B, S, np.random.default_rng(seed), "train", "cpu")


def _loss_and_grads(params, batch, cfg, mesh=None):
    flat = [t.detach().requires_grad_() for t in tree.leaves(params)]
    if mesh is None:
        loss, metrics = T.loss_fn(tree.unflatten(params, flat), batch, cfg)
    else:
        with set_mesh(mesh):
            loss, metrics = T.loss_fn(tree.unflatten(params, flat), batch, cfg)
    return loss, metrics, torch.autograd.grad(loss, flat)


# ---------------------------------------------------------------------------
# The sharded embedding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 4), (2, 4), (1, 4), (4, 1)])
def test_embed_lookup_sharded_matches_take(shape, dtype):
    """Twin of tests/test_distributed.py::test_embed_lookup_sharded_matches_take,
    bit for bit; the gradient is the plain lookup's to rounding: the rows
    of one id sum across coordinates in another order, each partial sum
    rounded to the table's dtype (f32: 1e-5; bf16: 2^-6 of the largest
    entry, two ulps of it)."""
    g = torch.Generator().manual_seed(0)
    emb = torch.randn(64, 32, generator=g).to(dtype).requires_grad_()
    toks = torch.randint(0, 64, (8, 12), generator=g)
    want = F.embedding(toks, emb)
    reset_collective_bytes()
    with set_mesh(_mesh(shape)):
        got = embed_lookup(emb, toks)
    assert torch.equal(got, want)
    moved = collective_bytes()
    assert (moved["psum"] > 0) == (shape[1] > 1) and (moved["all_gather"] > 0) == (shape[0] > 1)
    ct = torch.randn(got.shape, generator=g).to(dtype)
    (ga,) = torch.autograd.grad(got, emb, ct)
    (gb,) = torch.autograd.grad(want, emb, ct)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    assert float((ga.float() - gb.float()).abs().max()) <= tol * float(gb.float().abs().max())


# ---------------------------------------------------------------------------
# Loss and gradients against the reference under the same mesh
# ---------------------------------------------------------------------------

_CHILD = """
import json, numpy as np, jax, jax.numpy as jnp
from repro.compat import AxisType, make_mesh, set_mesh
from repro.configs import get_arch
from repro.models import moe as M, transformer as JT

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


mesh = make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                 devices=jax.devices()[:8])
for name, batch in json.loads(BATCHES).items():
    batch = {k: jnp.asarray(np.asarray(v, np.int32)) for k, v in batch.items()}
    cfg = get_arch(name).reduced()
    params = JT.init_params(cfg, jax.random.PRNGKey(0), model_size_hint=4)
    # a new jit a variant: a traced function keeps the moe_apply it traced
    f = lambda: jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, b, cfg)[0]))
    with set_mesh(mesh):
        as_is, _ = f()(params, batch)
        M.moe_apply = _shared_free
        loss, g = f()(params, batch)
        M.moe_apply = _ep
    flat = jax.tree_util.tree_flatten_with_path(g)[0]
    emit_result({"name": name, "loss": float(loss), "loss_as_is": float(as_is),
                 "grads": {jax.tree_util.keystr(k): np.asarray(v, np.float32).tolist()
                           for k, v in flat}})
"""

_MOE = ["qwen2-moe-a2.7b", "dbrx-132b"]


@pytest.fixture(scope="module")
def reference():
    batches = {n: {k: v.tolist() for k, v in _batch(get_arch(n).reduced()).items()}
               for n in _MOE}
    out = run_mesh(_CHILD.replace("BATCHES", repr(json.dumps(batches))), devices=8)
    return {r["name"]: r for r in out}


@pytest.mark.parametrize("name", _MOE)
def test_loss_and_gradients_match_the_reference_under_the_mesh(reference, name):
    ref = reference[name]
    cfg, params = _model(name)
    loss, metrics, grads = _loss_and_grads(params, _batch(cfg), cfg, _mesh())
    loss = float(loss.detach())
    assert abs(loss - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    # the reference as it is (its shared-expert caveat included) moves the
    # loss by less than the tolerance too
    assert abs(loss - ref["loss_as_is"]) <= LOSS_RTOL * abs(ref["loss_as_is"])
    assert float(metrics["aux"]) > 0
    got = jax.tree_util.tree_flatten_with_path(
        bridge.lm_params_to_numpy(tree.unflatten(params, list(grads))))[0]
    assert [jax.tree_util.keystr(k) for k, _ in got] == list(ref["grads"])
    for path, g in got:
        key = jax.tree_util.keystr(path)
        w = np.asarray(ref["grads"][key], np.float32)
        scale = float(np.abs(w).max())
        err = float(np.abs(np.asarray(g, np.float32) - w).max())
        tol = ROUTER_TOL if key.endswith("['router']") and name == "qwen2-moe-a2.7b" \
            else GRAD_TOL
        assert scale > 0 and err <= tol * scale, (key, err / scale)


def test_dense_loss_under_the_mesh_is_the_mesh_free_bits():
    """Only the shard_map regions change numbers: the embedding lookup's
    masked sum adds zeros, so a dense family's loss and logits under the
    mesh are the mesh-free ones bit for bit."""
    cfg, params = _model("olmo-1b")
    batch = _batch(cfg)
    free = T.loss_fn(params, batch, cfg)
    with set_mesh(_mesh()):
        on_mesh = T.loss_fn(params, batch, cfg)
        logits = T.forward(params, batch, cfg)[0]
    assert torch.equal(on_mesh[0], free[0])
    assert torch.equal(logits, T.forward(params, batch, cfg)[0])


def test_the_recompute_carries_the_mesh():
    """A checkpointed layer's recompute runs where the backward runs (on
    the card: autograd's worker thread, which has no ambient mesh). A
    backward taken outside the `set_mesh` block must still recompute the
    EP layer, and give the gradients of a backward taken inside it."""
    cfg, params = _model("qwen2-moe-a2.7b")
    batch, mesh = _batch(cfg), _mesh()
    _, _, inside = _loss_and_grads(params, batch, cfg, mesh)
    flat = [t.detach().requires_grad_() for t in tree.leaves(params)]
    with set_mesh(mesh):
        loss, _ = T.loss_fn(tree.unflatten(params, flat), batch, cfg)
    outside = torch.autograd.grad(loss, flat)
    for a, b in zip(inside, outside):
        assert torch.equal(a, b)


def test_two_train_steps_under_the_mesh():
    """Two `make_train_step` steps of the reduced qwen2-moe (2 microbatches)
    under the (2, 4) mesh: finite losses, every expert leaf's gradient
    moves its master, the MoE losses reach the metrics, and the step moves
    bytes by all_to_all, all_gather, psum and pmean."""
    cfg = get_arch("qwen2-moe-a2.7b").reduced()
    tcfg = TrainConfig(microbatches=2, total_steps=100, warmup=1)
    state = init_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu", HINT)
    stream = TokenStream(cfg, B, S, seed=0, device="cpu")
    step = make_train_step(cfg, tcfg, DEFAULT_RULES)
    moe_keys = [k for k, _ in tree.leaves_with_path(state.opt.master)
                if "moe" in k and "norm" not in k]
    before = dict((k, v.clone()) for k, v in tree.leaves_with_path(state.opt.master)
                  if k in moe_keys)
    reset_collective_bytes()
    with set_mesh(_mesh()):
        for _ in range(2):
            state, m = step(state, stream.next())
            assert all(np.isfinite(float(v)) for v in m.values()) and float(m["aux"]) > 0
    moved = collective_bytes()
    assert all(moved[k] > 0 for k in ("all_to_all", "all_gather", "psum", "pmean"))
    after = dict(tree.leaves_with_path(state.opt.master))
    for k in moe_keys:
        assert not torch.equal(before[k], after[k]), k


def test_trainer_rules_take_effect():
    """`Trainer(rules=)` reaches every `shard` site of the step: with
    `ffn` unmapped the MLP's hidden site records no `model` split."""
    cfg = get_arch("olmo-1b").reduced()
    tcfg = TrainConfig(microbatches=1, total_steps=100, warmup=1)
    specs = {}
    for rules in (DEFAULT_RULES, ShardingRules(ffn=None)):
        state = init_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu", 1)
        tr = Trainer(cfg, tcfg, TokenStream(cfg, B, S, seed=0, device="cpu"), rules=rules)
        with set_mesh(_mesh()), record_specs() as recs:
            tr.run(state, 1, log_every=0)
        specs[rules.ffn] = {r.spec for r in recs if r.axes == ("batch", "seq", "ffn")}
    assert specs["model"] == {("data", None, "model")}
    assert specs[None] == {("data", None, None)}


@pytest.mark.parametrize("name", FAMILIES)
def test_shard_records_equal_logical_spec(name):
    """One forward under the mesh records every site of the reference's
    `shard` calls for the family, each with `logical_spec`'s spec."""
    cfg, params = _model(name, hint=1 if name != "qwen2-moe-a2.7b" else HINT)
    mesh = _mesh()
    with set_mesh(mesh), record_specs() as recs:
        T.forward(params, _batch(cfg), cfg)
    sites = {r.axes for r in recs}
    want = {("batch", "seq", "embed"), ("batch", "seq", "vocab")}
    if not cfg.attn_free:
        want |= {("batch", "seq", "heads", None), ("batch", "seq", "kv_heads", None)}
    if cfg.d_ff:
        want.add(("batch", "seq", "ffn"))
    if cfg.ssm is not None:
        want |= {("batch", "seq", "ssm_inner", None), ("batch", "ssm_chunk", None, None)}
    assert want <= sites, want - sites
    for r in recs:
        assert r.op == "shard" and r.kind == "logical"
        assert r.spec == logical_spec(r.shape, r.axes, DEFAULT_RULES, mesh), r
    assert ("data", None, None) in {r.spec for r in recs if r.axes == ("batch", "seq", "embed")}


# ---------------------------------------------------------------------------
# Checkpoints and serving under a mesh
# ---------------------------------------------------------------------------


def test_elastic_checkpoint_restore_across_meshes(tmp_path):
    """Twin of tests/test_distributed.py::test_elastic_checkpoint_restore_across_meshes:
    saved laid out on a 2x2 mesh, restored onto an 8-way `data` mesh, bit
    for bit."""
    mesh_a = _mesh((2, 2))
    w = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    state = {"w": distribute(w, ("data", "model"), mesh_a),
             "step": torch.tensor(5, dtype=torch.int32)}
    save(str(tmp_path), 5, state)
    mesh_b = make_worker_mesh((8,), ("data",), devices=["cpu"] * 8)
    shardings = {"w": NamedSharding(mesh_b, P("data", None)),
                 "step": NamedSharding(mesh_b, P())}
    got, _ = restore(str(tmp_path), 5, state, shardings=shardings)
    assert isinstance(got["w"], DistArray) and got["w"].mesh is mesh_b
    assert len(got["w"].tiles()) == 8
    assert torch.equal(gather(got["w"]), w) and int(gather(got["step"])) == 5
    plain, _ = restore(str(tmp_path), 5, {"w": w, "step": state["step"]})
    assert torch.equal(plain["w"], w)


def test_restore_lays_the_params_out_by_param_specs(tmp_path):
    """A training state's parameters restored onto the (2, 4) mesh by
    `param_specs` turned into NamedShardings: every leaf a DistArray whose
    whole is the saved leaf's bits."""
    cfg, params = _model("qwen2-moe-a2.7b")
    save(str(tmp_path), 1, params)
    mesh = _mesh()
    specs = T.param_specs(cfg, DEFAULT_RULES, mesh, model_size_hint=HINT)
    shardings = tree_of(specs, lambda s: NamedSharding(mesh, s))
    got, _ = restore(str(tmp_path), 1, params, shardings=shardings)
    for (key, a), (_, b) in zip(tree.leaves_with_path(got), tree.leaves_with_path(params)):
        assert isinstance(a, DistArray) and torch.equal(gather(a), b), key
    wi = got["layers"]["moe"]["wi"]
    assert wi.spec == (None, "model", "data", None)
    assert tuple(wi.shards[(1, 2)].shape) == (2, 1, 32, 64)


def tree_of(specs: dict, fn):
    return {k: tree_of(v, fn) if isinstance(v, dict) else fn(v) for k, v in specs.items()}


@pytest.mark.parametrize("name", ["olmo-1b", "qwen2-moe-a2.7b"])
def test_engine_under_a_mesh_gives_the_mesh_free_tokens(name):
    cfg, params = _model(name)
    reqs = lambda: [Request(uid=i, prompt=[3 + i, 8, 5 + 2 * i], max_new_tokens=6)
                    for i in range(4)]
    outs = []
    for mesh in (None, _mesh((2, 2))):
        eng = ServingEngine(cfg, params, slots=4, max_len=32, rules=DEFAULT_RULES)
        rs = reqs()
        for r in rs:
            eng.submit(r)
        with set_mesh(mesh):
            eng.run_until_done()
        outs.append([r.output for r in rs])
    assert outs[0] == outs[1]


def test_span_breakdown_sums_the_kernels_launched_in_each_range():
    """`profile_lm --train --mesh`'s span table on a made-up Chrome trace:
    a range's device time is that of the kernels whose launch (by
    correlation id) lies inside any of its ranges, nested ranges counted
    in both."""
    from repro_torch.profile_lm import span_breakdown

    def ev(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    trace = {"traceEvents": [
        ev("user_annotation", "moe:fsdp_gather", 0, 100),
        ev("user_annotation", "collective:all_gather", 10, 40),
        ev("user_annotation", "moe:fsdp_gather", 500, 50),
        ev("user_annotation", "step", 0, 1000),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 2, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 60, 2, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 510, 2, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 900, 2, corr=4),
        ev("kernel", "cat", 30, 1000, corr=1),
        ev("kernel", "cat", 70, 2000, corr=2),
        ev("gpu_memcpy", "copy", 520, 500, corr=3),
        ev("kernel", "gemm", 910, 9000, corr=4)]}
    got = span_breakdown(trace)
    assert sorted(got) == ["collective:all_gather", "moe:fsdp_gather"]
    row = got["moe:fsdp_gather"]
    assert (row["ranges"], row["device_ms"], row["kernels"]) == (2, 3.5, 3)
    assert row["host_ms"] == pytest.approx(0.15)
    assert got["collective:all_gather"]["device_ms"] == 1.0
