"""The partitioned audio and VLM step on a (data, model) mesh of the CPU,
against the JAX package's placed jit and the port's mesh-free step.

The reference child (`mesh_harness.run_mesh`, 8 fake devices) runs the
program of the reference's dry run, as tests/test_torch_partition.py's:
`make_train_step(cfg, tcfg, rules)` jitted with `in_shardings` from
`_param_state_specs` and `_batch_specs`, from `init_state(PRNGKey(0))`.
The port gets the same state laid out by the reference's specs
(`bridge.train_state_from_numpy(..., shardings=state_shardings(...))`).

Reduced hubert-xlarge (audio: 4 heads of 16, LayerNorm, GELU,
bidirectional; frame embeddings with `mask_embed` where a frame is
masked, the loss on the masked frames alone; its token table read by
nothing) and reduced phi-3-vision-4.2b (VLM: 4 heads, 8 patch stubs
before 24 tokens, the patch positions carrying no label), each on (2, 4)
and (4, 2) under `default` and on (2, 4) under `dp_only`. Two AdamW
steps of B 8 x S 32 in 2 microbatches held with
tests/test_torch_partition.py's bounds (loss 2e-3, gradients 2^-5 of
their largest entry, masters 2.02 · lr · lr_scale, the second update 3 %
in norm and 0.9 in cosine) against the reference's placed jit and the
port's mesh-free step. hubert's token table gets a zero gradient in every
run (every coordinate's part of it exactly zero), so its masters move by
the weight decay alone, as the reference's do. The bytes and calls of
each collective kind in one step equal
`launch.dryrun.partitioned_step_collectives`.
"""

import jax
import numpy as np
import pytest
import torch

from mesh_harness import run_mesh
from test_torch_partition import (B, MICRO, S, _assert_close, _grads, _mesh, _tcfg,
                                  _whole)
from repro.runtime.trainer import TrainConfig as JTrainConfig
from repro.runtime.trainer import init_state as j_init_state
from repro_torch import bridge, tree
from repro_torch.configs import get_arch
from repro_torch.kernels import BOOKED, reset_booked
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.launch.dryrun import RULES_VARIANTS, partitioned_step_collectives
from repro_torch.models import attention
from repro_torch.models import transformer as T
from repro_torch.parallel import collectives as col
from repro_torch.parallel import logical_spec, record_specs
from repro_torch.parallel.collectives import DistArray
from repro_torch.runtime.trainer import make_train_step, state_shardings

HINT = 4
ARCHS = ["hubert-xlarge", "phi-3-vision-4.2b"]
MESHES = [((2, 4), "default"), ((2, 4), "dp_only"), ((4, 2), "default")]
CASES = [(a, s, r) for a in ARCHS for s, r in MESHES]
KINDS = ("all_gather", "reduce_scatter", "psum", "pmax")
MASK_RATE = 0.15                 # audio's masked frames (data/synthetic.py)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _id(case) -> str:
    name, shape, rules = case
    return f"{name}-{shape[0]}x{shape[1]}-{rules}"


def cfg_of(name: str, get=get_arch):
    return get(name).reduced()


def batch_np(cfg, seq: int = S, seed: int = 3, labels: bool = True) -> dict:
    """One numpy batch of `seq` model positions, the reference's shapes:
    audio's f32 frames (both packages cast them to bf16), a mask and
    codebook labels; the VLM's f32 patch stubs, then seq - patches tokens
    and their labels; the first 3 labels of a row -1."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    if cfg.family == "audio":
        out = {"frame_embeds": rng.standard_normal((B, seq, d), dtype=np.float32),
               "mask": rng.random((B, seq)) < MASK_RATE}
        text = seq
    else:
        p = cfg.n_frontend_tokens
        text = seq - p
        out = {"patch_embeds": rng.standard_normal((B, p, d), dtype=np.float32),
               "tokens": rng.integers(0, cfg.vocab, (B, text)).astype(np.int32)}
    if labels:
        lab = rng.integers(0, cfg.vocab, (B, text)).astype(np.int32)
        lab[:, :3] = -1
        out["labels"] = lab
    return out


def batch_of(raw: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in raw.items()}


def _jax_state(name: str):
    from repro.configs import get_arch as j_get_arch

    state = j_init_state(cfg_of(name, j_get_arch),
                         JTrainConfig(microbatches=MICRO, warmup=1, total_steps=100),
                         jax.random.PRNGKey(0), HINT)
    return jax.tree.map(np.asarray, state)


def _state(name: str, mesh=None, rules: str = "default"):
    cfg = cfg_of(name)
    sh = None if mesh is None else state_shardings(cfg, _tcfg(), mesh, RULES_VARIANTS[rules],
                                                   HINT)
    return bridge.train_state_from_numpy(_jax_state(name), "cpu", shardings=sh)


def _two_steps(name: str, mesh=None, rules: str = "default") -> dict:
    cfg = cfg_of(name)
    state = _state(name, mesh, rules)
    step = make_train_step(cfg, _tcfg(), RULES_VARIANTS[rules])
    batch = batch_of(batch_np(cfg))
    init = [_whole(x) for x in tree.leaves(state.opt.master)]
    col.reset_collective_bytes()
    state, m1 = step(state, batch)
    counts = (col.collective_bytes(), col.collective_calls())
    first_m = [_whole(x) for x in tree.leaves(state.opt.m)]
    zero_parts = (all(not t.any() for t in state.opt.m["embed"].shards.values())
                  if mesh is not None else None)
    state, m2 = step(state, batch)
    return {"loss": [float(m1["loss"]), float(m2["loss"])],
            "grad_norm": [float(m1["grad_norm"]), float(m2["grad_norm"])],
            "lr_scale": [m1["lr_scale"], m2["lr_scale"]],
            "grads": _grads(first_m, float(m1["grad_norm"])),
            "master": [_whole(x) for x in tree.leaves(state.opt.master)], "init": init,
            "counts": counts, "state": state, "embed_m_zero": zero_parts}


def _embed_index(name: str) -> int:
    """The token table's place among the state's leaves."""
    paths = [k for k, _ in tree.leaves_with_path(T.abstract_params(cfg_of(name), HINT))]
    return paths.index("embed")


def _close(got: dict, want: dict, what: str, name: str) -> None:
    """tests/test_torch_partition.py's bounds; hubert's token table, whose
    gradient is zero in both runs, is held to zero exactly and its masters
    and update by the bounds (the weight decay alone moves them)."""
    if cfg_of(name).family != "audio":
        return _assert_close(got, want, what)
    i = _embed_index(name)
    assert not np.asarray(got["grads"][i]).any() and not np.asarray(want["grads"][i]).any()
    grads = lambda run: run["grads"][:i] + run["grads"][i + 1:]       # noqa: E731
    _assert_close({**got, "grads": grads(got)}, {**want, "grads": grads(want)}, what)


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
    batch = {k: jnp.asarray(raw[k]) for k in raw.files}
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
    out = tmp_path_factory.mktemp("partition_frontend_ref")
    for name in ARCHS:
        np.savez(out / f"batch_{name}.npz", **batch_np(cfg_of(name)))
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
    cache = {}

    def get(case):
        key = case if isinstance(case, str) else _id(case)
        if key not in cache:
            cache[key] = (_two_steps(case) if isinstance(case, str)
                          else _two_steps(case[0], _mesh(case[1]), case[2]))
        return cache[key]

    return get


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_partitioned_frontend_step_meets_the_references_placed_jit(reference, runs, case):
    ref = reference[_id(case)]
    assert ref["wq_spec"] == str(jax.sharding.PartitionSpec(
        *runs(case)["state"].params["layers"]["attn"]["wq"].spec))
    _close(runs(case), ref, _id(case), case[0])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_partitioned_frontend_step_meets_the_mesh_free_port(runs, case):
    _close(runs(case), runs(case[0]), _id(case), case[0])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_frontend_collective_bytes_and_calls_equal_the_analytic_count(runs, case):
    name, shape, rules = case
    moved, calls = runs(case)["counts"]
    want_moved, want_calls = partitioned_step_collectives(cfg_of(name), shape, rules, B, S,
                                                          MICRO, HINT)
    assert {k: moved[k] for k in KINDS} == want_moved
    assert {k: calls[k] for k in KINDS} == want_calls
    assert all(moved[k] == 0 for k in moved if k not in KINDS), moved


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_every_frontend_leaf_stays_laid_out_by_its_spec(runs, case):
    name, shape, rules = case
    state = runs(case)["state"]
    mesh = state.params["embed"].mesh
    want = state_shardings(cfg_of(name), _tcfg(), mesh, RULES_VARIANTS[rules], HINT)
    for x, sh in zip(tree.leaves(state), tree.leaves(want)):
        assert isinstance(x, DistArray) and x.spec == tuple(sh.spec) and x.mesh is mesh
        for c in mesh.coords():
            assert tuple(x.shards[c].shape) == tuple(hi - lo for lo, hi in x.region(c))
    if cfg_of(name).family == "audio":
        assert state.params["mask_embed"].spec == (None,)        # every coordinate's


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == "hubert-xlarge"], ids=_id)
def test_huberts_token_table_moves_by_weight_decay_alone(runs, case):
    """No loss reads hubert's `embed`: every coordinate's part of its
    gradient (the first step's AdamW m) is exactly zero, and its masters
    after the second step are the mesh-free step's bits, the initial
    table times 1 - lr · lr_scale · weight_decay."""
    run, free = runs(case), runs(case[0])
    i = _embed_index(case[0])
    assert run["embed_m_zero"]
    assert torch.equal(run["master"][i], free["master"][i])
    adamw = _tcfg().adamw
    decay = 1 - adamw.lr * run["lr_scale"][1] * adamw.weight_decay
    init = run["init"][i]
    assert float((run["master"][i] - init * decay).abs().max()) <= \
        2.0 ** -20 * float(init.abs().max())
    assert not torch.equal(run["master"][i], init)


@pytest.mark.parametrize("name", ARCHS)
def test_frontend_shard_sites_check_and_record_their_layouts(name):
    """The forward on a laid-out state records the embeddings' site at the
    model's sequence (the VLM's patches and text: 8 + 24 positions)."""
    cfg = cfg_of(name)
    mesh = _mesh((2, 4))
    state = _state(name, mesh)
    batch = batch_of(batch_np(cfg, labels=False))
    with record_specs() as recs:
        logits = T.forward(state.params, batch, cfg)[0]
    assert tuple(logits.shape) == (B, S, cfg.vocab)
    shapes = {r.axes: r.shape for r in recs}
    assert shapes[("batch", "seq", "embed")] == (B, S, cfg.d_model)
    for r in recs:
        assert r.spec == logical_spec(r.shape, r.axes, RULES_VARIANTS["default"], mesh)


def test_audio_attention_is_bidirectional_in_the_partitioned_program(monkeypatch):
    """Every attention call of hubert's laid-out loss and its gradient
    takes causal=False (the plain version on the CPU, autograd
    differentiating it), and on the card's route the backward kernel keeps
    it: `FlashAttentionFn` on meta operands books B6-bwd's unmasked work,
    every tile pair of S 512, more than the causal walk's."""
    cfg = cfg_of("hubert-xlarge")
    assert not cfg.causal
    seen = []

    def recording(q, k, v, **kw):
        seen.append(kw["causal"])
        return fa.attention_ref(q, k, v, **kw)

    monkeypatch.setattr(attention, "attention_ref", recording)
    state = _state("hubert-xlarge", _mesh((2, 4)))
    (loss, _), (entered,) = col.laid_out_region(
        lambda p: T.loss_fn(p, batch_of(batch_np(cfg)), cfg))(state.params)
    grads = col.grads(loss, entered)
    assert seen and not any(seen)
    assert any(t.any() for t in grads["layers"]["attn"]["wq"].shards.values())

    shape = (2, cfg.n_heads, 512, cfg.head_dim)
    booked = {}
    for causal in (False, True):
        reset_booked()
        q, k, v = (torch.empty(shape, dtype=torch.bfloat16, device="meta",
                               requires_grad=True) for _ in range(3))
        fa.FlashAttentionFn.apply(q, k, v, causal).sum().backward()
        booked[causal] = dict(BOOKED["flash_attention_bwd"])
        assert booked[causal]["calls"] == 1
        assert booked[causal]["flops"] == fa.flash_attention_work(
            shape, shape, torch.bfloat16, causal=causal, backward=True)
    assert booked[False]["flops"] > booked[True]["flops"]
