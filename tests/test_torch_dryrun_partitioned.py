"""The dry run on the partitioned program (`repro_torch.launch.dryrun`):
the cell's arguments laid out on a mesh of meta devices as the
reference's ``in_shardings`` lay them (`lay_out_args`), each coordinate
computing on its own regions, against the counts from the shapes and,
on a (pod, data, model) mesh of the CPU, against the JAX package's
placed jit.

* Every family (reduced olmo-1b, qwen2-moe, hymba, mamba2, hubert,
  phi-3-vision) on meta (2, 4) and (4, 2) under `default` and `dp_only`:
  the bytes and calls of each collective kind of a step (B 8 x S 32 in 2
  microbatches, the batch whole as a stream hands it), a prefill and a
  decode step (their inputs laid out) equal
  `partitioned_step_collectives` / `partitioned_serve_collectives`;
  SPIN-Shampoo's olmo-1b step adds `_shampoo_gathers`' "gather".
* The probes (`_partitioned_probes`: L = 1 and 2, one microbatch of B/M
  rows, extrapolated and times M) equal the full partitioned run at 4
  layers exactly in collectives, FLOPs and booked kernels; their
  bytes_accessed counts the optimizer's update M times, so it lies above
  the full run's.
* The `pod` axis: on (2, 2, 2) every family's counts equal the extended
  count; reduced olmo-1b's laid-out step (loss 2e-3 relative, the first
  step's gradients read from AdamW's m to 2^-5 of their largest entry,
  tests/test_torch_partition.py's bounds) and its prefill and three
  decode steps (logits 2e-2 absolute, tests/test_torch_partition_serve.py's)
  meet the reference's jit placed by `_param_state_specs`,
  `_batch_specs`, `param_specs`, `cache_specs` on a ("pod", "data",
  "model") mesh of 8 fake devices, under `default` and `dp_only`.
  SPIN-Shampoo's laid-out step and refresh on a CPU (2, 2, 2) mesh move
  what the extended counts and `shampoo_refresh_moves` say.
* The step counters of a laid-out train state stay on the host, and a
  refused rules set records `partitioned_error`.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mesh_harness import run_mesh
from repro.configs import get_arch as j_get_arch
from repro.runtime.trainer import TrainConfig as JTrainConfig
from repro.runtime.trainer import init_state as j_init_state
from repro_torch import bridge, tree
from repro_torch.configs import get_arch
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core import spin_inverse_sharded
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import SpinShampooConfig
from repro_torch.parallel import NamedSharding, ShardedBlockMatrix, collectives as col
from repro_torch.parallel.collectives import DistArray
from repro_torch.parallel.sharding import lay_out
from repro_torch.planner import get_plan
from repro_torch.runtime.trainer import TrainConfig, init_state, make_train_step, state_shardings

B, S, MICRO, CACHE, STEPS = 8, 32, 2, 48, 3
HINT = 4
LOSS_RTOL = 2e-3               # tests/test_torch_partition.py
GRAD_TOL = 2.0 ** -5
LOGIT_TOL = 2e-2               # tests/test_torch_partition_serve.py
FAMILIES = ["olmo-1b", "qwen2-moe-a2.7b", "hymba-1.5b", "mamba2-130m", "hubert-xlarge",
            "phi-3-vision-4.2b"]
CASES = [(a, s, r) for a in FAMILIES for s in [(2, 4), (4, 2)] for r in ["default", "dp_only"]]
POD = (2, 2, 2)
POD_RULES = ["default", "dp_only"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _id(case) -> str:
    name, shape, rules = case
    return f"{name}-{'x'.join(map(str, shape))}-{rules}"


def _axes(shape) -> tuple:
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _mesh(shape, device="meta"):
    return make_worker_mesh(tuple(shape), _axes(shape), devices=[device] * int(np.prod(shape)))


def _counted(moved: dict, calls: dict) -> tuple:
    return D._nonzero(moved), D._nonzero(calls)


def _traced_counts(cfg, kind, mesh, rules, optimizer="adamw"):
    """A step (the batch whole), or a prefill or decode step (inputs laid
    out), of the partitioned program on `mesh`: bytes and calls by kind."""
    if kind == "train" and optimizer != "adamw":
        built = D.build_train(cfg, ShapeConfig("t", S, B, kind), mesh, D.RULES_VARIANTS[rules],
                              MICRO, HINT, optimizer=optimizer)
        args = D.lay_out_args(built, mesh)
        traced = D._trace(built[0], (args[0], built[1][1]), None)
    else:
        shape = ShapeConfig("t", CACHE if kind == "decode" else S, B, kind)
        traced = D.trace_partitioned(cfg, shape, mesh, D.RULES_VARIANTS[rules],
                                     MICRO if kind == "train" else 1, model_size_hint=HINT,
                                     lay_batch=kind != "train")
    return _counted(traced["moved"], traced["calls"])


def _analytic(cfg, kind, shape, rules):
    if kind == "train":
        return _counted(*D.partitioned_step_collectives(cfg, shape, rules, B, S, MICRO, HINT))
    return _counted(*D.partitioned_serve_collectives(cfg, shape, rules, B, S, CACHE,
                                                     HINT)[kind])


# ---------------------------------------------------------------------------
# Every family's counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_every_family_counts_equal_the_analytic_count(case):
    name, shape, rules = case
    cfg, mesh = get_arch(name).reduced(), _mesh(shape)
    for kind in ("train", "prefill", "decode"):
        assert _traced_counts(cfg, kind, mesh, rules) == _analytic(cfg, kind, shape, rules), kind


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_spin_shampoo_step_counts_equal_the_analytic_count(shape):
    cfg = get_arch("olmo-1b").reduced()
    got = _traced_counts(cfg, "train", _mesh(shape), "default", optimizer="spin_shampoo")
    want = _counted(*D.partitioned_step_collectives(cfg, shape, "default", B, S, MICRO, HINT,
                                                    optimizer="spin_shampoo"))
    assert got == want and want[0]["gather"] > 0


@pytest.mark.parametrize("name", FAMILIES)
def test_the_pod_axis_counts_equal_the_extended_analytic_count(name):
    """`pod` splits the batch with `data` and no weight: the loss's sums
    and the MoE pmeans run over both, every region it does not split has
    twice the holders."""
    cfg, mesh = get_arch(name).reduced(), _mesh(POD)
    for rules in POD_RULES:
        for kind in ("train", "prefill", "decode"):
            assert _traced_counts(cfg, kind, mesh, rules) == _analytic(cfg, kind, POD, rules), \
                (rules, kind)
    flat = D._Layout((4, 2), "default")
    pod = D._Layout(POD, "default")
    assert pod.ways(B) == flat.ways(B) == 4 and pod.n == flat.n == 8


def _alone(n: int, mesh) -> tuple[dict, dict]:
    """The bytes and calls of one sharded inversion of an n x n matrix on
    `mesh` under its sharded plan (tests/test_torch_shampoo_laid_out.py)."""
    plan = get_plan("inverse", n, torch.float32, measure=False, placement="sharded",
                    backend="cpu")
    sbm = ShardedBlockMatrix.from_dense(torch.eye(n) * 2 + 0.01, plan.block_size, mesh=mesh)
    col.reset_collective_bytes()
    spin_inverse_sharded(sbm, leaf_solver=plan.leaf_solver, engine=plan.multiply_engine)
    return col.collective_bytes(), col.collective_calls()


def test_spin_shampoo_on_the_pod_axis_counts_its_step_and_its_refresh():
    """Two SPIN-Shampoo steps of reduced olmo-1b laid out on a CPU (2, 2,
    2) mesh: the second (no refresh) moves what the extended
    `partitioned_step_collectives(..., optimizer="spin_shampoo")` counts,
    the first adds the sharded inversions run alone and
    `shampoo_refresh_moves` on the same shape (factors whole over `pod`)."""
    cfg, mesh = get_arch("olmo-1b").reduced(), _mesh(POD, "cpu")
    tcfg = dataclasses.replace(_tcfg(), optimizer="spin_shampoo",
                               shampoo=SpinShampooConfig(damping=0.1))
    state = lay_out(init_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu", HINT),
                    state_shardings(cfg, tcfg, mesh, D.DEFAULT_RULES, HINT))
    stream, step = TokenStream(cfg, B, S, seed=0, device="cpu"), make_train_step(cfg, tcfg)
    counts = []
    for _ in range(2):
        col.reset_collective_bytes()
        state, _ = step(state, stream.next())
        counts.append((col.collective_bytes(), col.collective_calls()))
    assert _counted(*counts[1]) == _counted(*D.partitioned_step_collectives(
        cfg, POD, "default", B, S, MICRO, HINT, optimizer="spin_shampoo"))
    excess = [{k: first[k] - second[k] for k in first} for first, second in zip(*counts)]
    want = [dict.fromkeys(excess[0], 0), dict.fromkeys(excess[1], 0)]
    alone = {}
    for f in state.opt.factors:
        for t in (() if f is None else (f.l, f.r)):
            n, layers = t.shape[-1], (t.shape[0] if len(t.shape) == 3 else 1)
            alone.setdefault(n, _alone(n, mesh))
            for w, got in zip(want, alone[n]):
                for k in w:
                    w[k] += layers * got[k]
    moves = D.shampoo_refresh_moves(cfg, POD, lambda n: get_plan(
        "inverse", n, torch.float32, measure=False, placement="sharded",
        backend="cpu").block_size, HINT)
    want[0]["reshard"] += moves[0]
    want[1]["reshard"] += moves[1]
    # here each factor's grid lies as the factor does: the refresh moves
    # nothing into the grid and back, its inversions their bytes
    assert excess == want and moves == (0, 0) and sum(excess[0].values()) > 0


def test_a_mesh_of_one_or_four_axes_has_no_count():
    cfg = get_arch("olmo-1b").reduced()
    for shape in [(8,), (2, 2, 1, 2)]:
        with pytest.raises(ValueError, match="pod, data, model"):
            D.partitioned_step_collectives(cfg, shape, "default", B, S, MICRO, HINT)


# ---------------------------------------------------------------------------
# The probes against the full partitioned run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", ["olmo-1b", "hymba-1.5b"])
def test_the_probes_extrapolate_to_the_full_partitioned_run(name, kind):
    cfg = dataclasses.replace(get_arch(name).reduced(), n_layers=4)
    mesh, rules = _mesh((2, 4)), D.DEFAULT_RULES
    shape = ShapeConfig("t", CACHE if kind == "decode" else S, 2 * B, kind)
    micro = MICRO if kind == "train" else 1
    probes = D._partitioned_probes(cfg, shape, mesh, rules, micro)
    full = D._measure(D.trace_partitioned(cfg, shape, mesh, rules, micro,
                                          lay_batch=kind != "train"))
    assert probes["microbatch_scale"] == micro
    assert _counted(probes["moved"], probes["calls"]) == _counted(full["moved"], full["calls"])
    for key in ("flops", "flops_aten", "flops_kernels", "coll_bytes"):
        assert probes[key] == full[key], key
    assert probes["booked"] == full["booked"]
    # B6 a layer, microbatch and coordinate (the step's forward and remat
    # recompute); decode attends over the cache without it
    assert probes["booked"]["flash_attention"]["calls"] == \
        {"train": 2, "prefill": 1, "decode": 0}[kind] * 4 * micro * 8
    if kind == "train":
        assert probes["bytes_accessed"] > full["bytes_accessed"]
    else:
        assert probes["bytes_accessed"] == full["bytes_accessed"]
    want = D.analytic_collectives(cfg, shape, (2, 4), "default", micro, 4)
    assert _counted(probes["moved"], probes["calls"]) == _counted(*want)


def test_io_bytes_of_the_partitioned_program():
    """A device's argument, output and alias bytes read off the laid-out
    arguments and outputs (each DistArray's own shard) equal the global
    view's spec-based ones; the partitioned prefill also has output bytes
    where the global view records none: its logits' shard by the recorded
    spec and its laid-out cache's shards."""
    cfg, mesh = get_arch("olmo-1b").reduced(), _mesh((2, 4))
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("t", CACHE if kind == "decode" else S, B, kind)
        glob = D._trace_cell(cfg, shape, mesh, D.DEFAULT_RULES, MICRO, model_size_hint=HINT)
        part = D.trace_partitioned(cfg, shape, mesh, D.DEFAULT_RULES, MICRO,
                                   model_size_hint=HINT, lay_batch=kind != "train")
        got, want = D._io_bytes(part, kind, mesh), D._io_bytes(glob, kind, mesh)
        if kind == "prefill":
            logits, cache = part["outs"]
            assert want[1] is None and isinstance(cache["k"], DistArray)
            shards = sum(D._local_bytes(x) for x in cache.values())
            assert got[1] == logits.numel() * logits.element_size() // 8 + shards
            got, want = (got[0], got[2]), (want[0], want[2])
        assert got == want, kind


# ---------------------------------------------------------------------------
# The host counters and a refused rules set
# ---------------------------------------------------------------------------


def test_a_laid_out_train_state_keeps_its_step_counters_on_the_host():
    """`lay_out` makes every leaf a DistArray, the counters too; on meta a
    counter's value cannot be read (`optim.adamw.step_count`), so
    `lay_out_args` keeps them on the host, and the step runs."""
    cfg, mesh = get_arch("olmo-1b").reduced(), _mesh((2, 4))
    built = D.build_train(cfg, ShapeConfig("t", S, B, "train"), mesh, D.DEFAULT_RULES, 1, HINT)
    state, batch = D.lay_out_args(built, mesh)
    assert isinstance(lay_out(built[1][0], D._shardings(built[2][0], mesh)).step, DistArray)
    for counter in (state.step, state.opt.step):
        assert not isinstance(counter, DistArray) and counter.device.type == "cpu"
        assert counter.dtype == torch.int32 and int(counter) == 0
    assert all(isinstance(x, DistArray) for x in tree.leaves(state.params))
    assert all(isinstance(x, DistArray) and x.mesh is mesh for x in batch.values())
    new, metrics = built[0](state, batch)
    assert int(new.step) == 1 and int(new.opt.step) == 1
    assert metrics["loss"].device.type == "meta"


def test_a_refused_rules_set_records_partitioned_error():
    """Megatron's sequence split (`sp`) splits `seq`, which the partitioned
    program does not realise: the cell keeps the global view's regions,
    labelled so, and records the refusal."""
    rec = D.run_cell("olmo-1b", "prefill_32k", multi_pod=False, rules_name="sp",
                     verbose=False)
    assert rec["coll_scope"] == "port regions" and "'seq'" in rec["partitioned_error"]
    assert rec["analytic"] is None and rec["analytic_match"] is None
    assert "cost_partitioned" not in rec and rec["cost"] == rec["cost_raw"]
    assert "partitioned" not in rec["method"]


# ---------------------------------------------------------------------------
# The pod axis against the reference's placed jit
# ---------------------------------------------------------------------------

_CHILD = """
import os, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.compat import AxisType, jit_shardings, make_mesh, set_mesh
from repro.configs import get_arch
from repro.launch.dryrun import RULES_VARIANTS, _batch_specs, _param_state_specs
from repro.models import transformer as T
from repro.parallel.sharding import logical_spec
from repro.runtime.trainer import TrainConfig, init_state, make_train_step

out = @OUT@
cfg = get_arch("olmo-1b").reduced()
mesh = make_mesh(@SHAPE@, ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3,
                 devices=jax.devices()[:8])
raw = np.load(os.path.join(out, "batch.npz"))
for rname in @RULES@:
    rules = RULES_VARIANTS[rname]
    tcfg = TrainConfig(microbatches=@MICRO@, warmup=1, total_steps=100)
    state = init_state(cfg, tcfg, jax.random.PRNGKey(0), @HINT@)
    batch = {k: jnp.asarray(raw[k]) for k in ("labels", "tokens")}
    prompt = {"tokens": batch["tokens"]}
    b, s = batch["tokens"].shape
    with set_mesh(mesh):
        specs = (_param_state_specs(cfg, rules, mesh), _batch_specs(batch, rules, mesh))
        step = jax.jit(make_train_step(cfg, tcfg, rules),
                       in_shardings=jit_shardings(specs, mesh),
                       out_shardings=jit_shardings((specs[0], None), mesh))
        s1, m1 = step(state, batch)
        saved = {f"m{i}": np.asarray(x, np.float32)
                 for i, x in enumerate(jax.tree.leaves(s1.opt.m))}
        pspecs = specs[0].params
        prefill = jax.jit(lambda p, x: T.prefill(p, x, cfg, rules)[::3],
                          in_shardings=jit_shardings((pspecs, _batch_specs(prompt, rules, mesh)),
                                                     mesh))
        params = state.params
        logits, cache = prefill(params, prompt)
        full = T.init_cache(cfg, b, @CACHE@)
        full["k"] = full["k"].at[:, :, :s].set(cache["k"])
        full["v"] = full["v"].at[:, :, :s].set(cache["v"])
        full["pos"] = cache["pos"]
        cspecs = T.cache_specs(cfg, b, @CACHE@, rules, mesh)
        placed = jax.tree.map(lambda sp: NamedSharding(mesh, sp), cspecs,
                              is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        tspec = logical_spec((b,), ("batch",), rules, mesh)
        decode = jax.jit(lambda p, c, t: T.decode_step(p, c, t, cfg, rules),
                         in_shardings=jit_shardings((pspecs, cspecs, tspec), mesh))
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        saved["logits"] = np.asarray(logits, np.float32)
        for i in range(@STEPS@):
            full = jax.device_put(full, placed)
            lg, full = decode(params, full, tok)
            saved[f"tok{i}"] = np.asarray(tok)
            saved[f"logits{i}"] = np.asarray(lg, np.float32)
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
    np.savez(os.path.join(out, rname + ".npz"), **saved)
    emit_result({"rules": rname, "loss": float(m1["loss"]),
                 "grad_norm": float(m1["grad_norm"]), "lr_scale": float(m1["lr_scale"]),
                 "wq_spec": str(s1.params["layers"]["attn"]["wq"].sharding.spec)})
"""


def _tcfg() -> TrainConfig:
    return TrainConfig(microbatches=MICRO, warmup=1, total_steps=100)


def _batch_np(cfg) -> dict:
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[:, :3] = -1
    return {"tokens": tokens, "labels": labels}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's placed step, prefill and decode on (2, 2, 2)."""
    out = tmp_path_factory.mktemp("pod_ref")
    np.savez(out / "batch.npz", **_batch_np(get_arch("olmo-1b").reduced()))
    code = _CHILD
    for key, value in (("OUT", repr(str(out))), ("SHAPE", repr(POD)),
                       ("RULES", repr(POD_RULES)), ("MICRO", MICRO), ("HINT", HINT),
                       ("CACHE", CACHE), ("STEPS", STEPS)):
        code = code.replace(f"@{key}@", str(value))
    got = {}
    for r in run_mesh(code, devices=8, timeout=900):
        r["arrays"] = dict(np.load(out / f"{r['rules']}.npz"))
        got[r["rules"]] = r
    return got


def _grads(m1: list, gnorm: float) -> list:
    """The first step's gradients from its AdamW m: m = (1 - b1)·clip·g."""
    adamw = _tcfg().adamw
    clip = min(1.0, adamw.grad_clip / max(gnorm, 1e-9))
    return [np.asarray(m, np.float64) / ((1 - adamw.b1) * clip) for m in m1]


@pytest.mark.parametrize("rules", POD_RULES)
def test_the_pod_axis_step_prefill_and_decode_meet_the_references_placed_jit(reference,
                                                                             rules):
    ref = reference[rules]
    want = ref["arrays"]
    cfg, mesh, rset = get_arch("olmo-1b").reduced(), _mesh(POD, "cpu"), D.RULES_VARIANTS[rules]
    jstate = jax.tree.map(np.asarray, j_init_state(
        j_get_arch("olmo-1b").reduced(), JTrainConfig(microbatches=MICRO, warmup=1,
                                                      total_steps=100),
        jax.random.PRNGKey(0), HINT))
    state = bridge.train_state_from_numpy(
        jstate, "cpu", shardings=state_shardings(cfg, _tcfg(), mesh, rset, HINT))
    wq = state.params["layers"]["attn"]["wq"]
    assert ref["wq_spec"] == str(jax.sharding.PartitionSpec(*wq.spec))
    whole = bridge.lm_params_from_numpy(jstate.params, "cpu")
    params = state.params
    batch = {k: torch.from_numpy(v).long() for k, v in _batch_np(cfg).items()}

    # the step: the loss and the first step's gradients
    col.reset_collective_bytes()
    new, m1 = make_train_step(cfg, _tcfg(), rset)(state, batch)
    assert _counted(col.collective_bytes(), col.collective_calls()) == \
        _analytic(cfg, "train", POD, rules)
    assert abs(float(m1["loss"]) - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    assert float(m1["lr_scale"]) == ref["lr_scale"] == 0
    got = _grads([col.gather(x) for x in tree.leaves(new.opt.m)], float(m1["grad_norm"]))
    wants = _grads([want[f"m{i}"] for i in range(len(got))], ref["grad_norm"])
    for i, (g, w) in enumerate(zip(got, wants)):
        scale = float(np.abs(w).max())
        assert scale > 0 and float(np.abs(g - w).max()) <= GRAD_TOL * scale, i

    # prefill, the cache to the decode length, three steps fed the reference's tokens
    prompt = {"tokens": batch["tokens"]}
    logits, _, _, cache = T.prefill(params, prompt, cfg, rset)
    free_logits, _, _, free = T.prefill(whole, prompt, cfg)
    assert float((logits - torch.from_numpy(want["logits"])).abs().max()) < LOGIT_TOL
    assert float((logits - free_logits).abs().max()) < LOGIT_TOL
    cache = T.pad_cache(cache, cfg, CACHE, rset)
    assert all(x.spec == tuple(sp) for x, sp in zip(
        (cache[k] for k in sorted(cache)),
        (v for _, v in sorted(T.cache_specs(cfg, B, CACHE, rset, mesh).items()))))
    pad = (0, 0, 0, 0, 0, CACHE - S)
    free = {"k": F.pad(free["k"], pad), "v": F.pad(free["v"], pad), "pos": free["pos"]}
    for i in range(STEPS):
        tok = torch.from_numpy(want[f"tok{i}"]).long()
        col.reset_collective_bytes()
        lg, cache = T.decode_step(params, cache, tok, cfg, rset)
        assert _counted(col.collective_bytes(), col.collective_calls()) == \
            _analytic(cfg, "decode", POD, rules)
        flg, free = T.decode_step(whole, free, tok, cfg)
        assert float((lg - torch.from_numpy(want[f"logits{i}"])).abs().max()) < LOGIT_TOL, i
        assert float((lg - flg).abs().max()) < LOGIT_TOL, i


def test_the_pod_axis_lays_the_batch_over_pod_and_data():
    cfg, mesh = get_arch("olmo-1b").reduced(), _mesh(POD)
    built = D.build_prefill(cfg, ShapeConfig("t", S, B, "prefill"), mesh, D.DEFAULT_RULES, HINT)
    params, batch = D.lay_out_args(built, mesh)
    assert batch["tokens"].spec == (("pod", "data"), None)
    assert params["embed"].spec == ("model", "data")
    tokens = batch["tokens"]
    assert {c: tuple(t.shape) for c, t in tokens.shards.items()} == {c: (2, S) for c in
                                                                    mesh.coords()}
    assert isinstance(lay_out(torch.zeros(B, S), NamedSharding(mesh, tokens.spec)), DistArray)
