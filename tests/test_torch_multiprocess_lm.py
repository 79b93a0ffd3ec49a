"""The per-coordinate collectives, expert-parallel MoE, the sharded lookup,
`compressed_psum` and a training run on a mesh that spans processes, on
the CPU, against a single process's mesh and the JAX package.

As `tests/test_torch_multiprocess.py`: each case starts its ranks once
(gloo, every wait bounded, the spawn by SPAWN_S), the ranks run
`torch_multiprocess_ranks` (PyTorch port only), and the same function
runs here on one process's mesh of the same shape. Every process runs
every coordinate's program (another process's coordinates as ghosts on
`meta`) and every collective, forward and backward, so results are held
bitwise: every rank's outputs and gradients equal the single process's.
Bytes and calls by kind summed over the ranks equal the single
process's but "replicate" (the joined outputs and the split inputs'
gradients, which every process receives whole).

Against the JAX package (in this process, mesh-free: its mesh tests raise
under jax 0.9.0, and its EP with shared experts mixes tokens, ROADMAP
§C): reduced qwen2-moe's MoE block at capacity factor 8 (no drop, so EP
is the mesh-free block), f32, output and z within OUT_RTOL and gradients
within GRAD_RTOL of the largest entry, `tests/test_torch_moe_ep.py`'s
bounds; the lookup bitwise and its gradient within GRAD_RTOL. The
compressed sum lies within PSUM_RTOL of the exact one (the reference
test's 5 %). The training run: `launch.train.main` over 2 processes with
`--mesh 2x2` (reduced qwen2-moe, 3 steps), every rank's losses and
parameters equal to one process's run. The partitioned step (a state
laid out by the reference's specs, a process holding and computing only
its own coordinates' shards): two AdamW steps of reduced olmo-1b on
(2, 4) over 2 processes and of reduced granite-8b (replicated norm
scales) on (4, 2) over 4, every rank's losses, grad norms and gathered
parameters the single process's bits, the bytes and calls summed over
the ranks its counts, and a rank's state bytes those of its own
coordinates' regions. Partitioned serving (a prefill of reduced olmo-1b
on parameters laid out over (2, 4), the cache padded, 3 decode steps)
over 2 processes: every rank's logits and final cache the single
process's bits, and a rank's cache and parameter bytes its own regions'.
The MoE, hybrid and VLM bodies (reduced qwen2-moe, hymba, phi-3-vision:
its patch stubs before the text) run both over 2 processes likewise.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_multiprocess_ranks as ranks
from repro.configs import get_arch as j_get_arch
from repro.models import embedding as j_embedding
from repro.models import moe as j_moe
from repro_torch.launch.procs import run_ranks

SPAWN_S = 180.0                    # a spawn's ranks, start to finish
CHILD = str(Path(__file__).with_name("torch_multiprocess_ranks.py"))
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
PSUM_RTOL = 0.05
REGION_CASES = [pytest.param(((2, 2), 4), id="2x2-over-4"),
                pytest.param(((4, 2), 4), id="4x2-over-4")]
REGION_RUNS = [f"{name}_{axis}" for axis in ranks.REGION_AXES
               for name in ("all_to_all", "all_gather", "psum", "pmean", "pmax")]
LM_SHAPE, LM_PROCS = (2, 4), 4
TRAIN_ARGV = ["--arch", "qwen2-moe-a2.7b", "--reduced", "--device", "cpu", "--mesh", "2x2",
              "--steps", "3", "--batch", "2", "--seq", "32", "--microbatches", "1"]


def spawn(case: str, nprocs: int, **kwargs) -> list:
    return run_ranks([sys.executable, CHILD, case, json.dumps(kwargs)], nprocs,
                     timeout_s=SPAWN_S)


def _summed(got: list, what: str) -> dict:
    return {k: sum(rank[what][k] for rank in got) for k in got[0][what]}


def _assert_sums(got: list, ref: dict) -> None:
    for idx, what in enumerate(("bytes", "calls")):
        summed = _summed(got, what)
        assert {k: v for k, v in summed.items() if k != "replicate"} == \
            {k: v for k, v in ref[what].items() if k != "replicate"}, what
        assert ref[what]["replicate"] == 0
        assert all(rank["summed"][idx] == summed for rank in got)


@pytest.fixture(scope="module", params=REGION_CASES)
def region_run(request):
    shape, nprocs = request.param
    total = shape[0] * shape[1]
    return (spawn("regions", nprocs, shape=list(shape), devices=total // nprocs),
            ranks.run_here("regions", shape=list(shape), devices=total))


@pytest.mark.parametrize("run", REGION_RUNS)
def test_collectives_forward_and_backward_are_the_single_process_bits(region_run, run):
    got, ref = region_run
    for rank in got:
        assert torch.equal(rank[run]["y"], ref[run]["y"])
        if run.startswith("pmax"):
            assert rank[run]["grad"] is None
        else:
            assert torch.equal(rank[run]["grad"], ref[run]["grad"])
    _assert_sums([rank[run] for rank in got], ref[run])


@pytest.fixture(scope="module")
def lm_run():
    total = LM_SHAPE[0] * LM_SHAPE[1]
    return (spawn("lm", LM_PROCS, shape=list(LM_SHAPE), devices=total // LM_PROCS),
            ranks.run_here("lm", shape=list(LM_SHAPE), devices=total))


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(got.detach().numpy() - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def jax_moe():
    """The reference's mesh-free MoE block and its gradients on the ranks'
    inputs (the port's seeded init, handed over as numpy)."""
    import repro_torch.configs as cfgs
    from repro_torch.models import moe
    from repro_torch.models.layers import init_tree

    base = cfgs.get_arch("qwen2-moe-a2.7b").reduced()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=8.0))
    params = init_tree(moe.moe_params(cfg, 4), torch.Generator().manual_seed(7), "cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()), params)
    x = jnp.asarray(ranks._normal((4, 16, cfg.d_model), 7).numpy())
    ct = jnp.asarray(ranks._normal((4, 16, cfg.d_model), 8).numpy())
    jbase = j_get_arch("qwen2-moe-a2.7b").reduced()
    jcfg = dataclasses.replace(jbase, moe=dataclasses.replace(jbase.moe, capacity_factor=8.0))

    def loss(p, x):
        out, _, z = j_moe.moe_apply(p, x, jcfg)
        return jnp.sum(out.astype(jnp.float32) * ct) + z

    out, _, z = j_moe.moe_apply(jp, x, jcfg)
    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, x)
    grads = {"x": gx, **{k: gp[k] for k in ("router", "wi", "wg", "wo")},
             **{f"shared_{k}": v for k, v in gp["shared"].items()}}
    return np.asarray(out), float(z), {k: np.asarray(v) for k, v in grads.items()}


def test_ep_moe_block_is_the_single_process_bits(lm_run):
    got, ref = lm_run
    want = ref["moe"]
    for rank in got:
        for key in ("y", "aux", "z"):
            assert torch.equal(rank["moe"][key], want[key]), key
        assert rank["moe"]["grads"].keys() == want["grads"].keys()
        for key, g in rank["moe"]["grads"].items():
            assert torch.equal(g, want["grads"][key]), key
    _assert_sums([rank["moe"] for rank in got], want)
    assert _summed([rank["moe"] for rank in got], "bytes")["all_to_all"] > 0


def test_ep_moe_block_holds_the_reference(lm_run, jax_moe):
    out, z, grads = jax_moe
    moe = lm_run[0][0]["moe"]
    assert _rel(moe["y"], out) <= OUT_RTOL
    assert abs(float(moe["z"]) - z) <= OUT_RTOL * abs(z)
    for key, want in grads.items():
        assert _rel(moe["grads"][key], want) <= GRAD_RTOL, key


def test_sharded_lookup_is_the_single_process_bits_and_the_references(lm_run):
    got, ref = lm_run
    for rank in got:
        assert torch.equal(rank["embed"]["y"], ref["embed"]["y"])
        assert torch.equal(rank["embed"]["grad"], ref["embed"]["grad"])
    _assert_sums([rank["embed"] for rank in got], ref["embed"])
    table = ranks._normal((ref["embed"]["grad"].shape), 9).numpy() * 0.02
    toks = np.random.default_rng(10).integers(0, table.shape[0], (4, 16))
    w = ranks._normal(tuple(ref["embed"]["y"].shape), 11).numpy()
    want = np.asarray(j_embedding.embed_lookup(jnp.asarray(table), jnp.asarray(toks)))
    assert np.array_equal(got[0]["embed"]["y"].numpy(), want)
    gt = jax.grad(lambda t: jnp.sum(j_embedding.embed_lookup(t, jnp.asarray(toks)) * w))(
        jnp.asarray(table))
    assert _rel(got[0]["embed"]["grad"], np.asarray(gt)) <= GRAD_RTOL


def test_compressed_psum_is_the_single_process_bits(lm_run):
    got, ref = lm_run
    exact = ref["psum"]["exact"]
    for rank in got:
        for c, s in rank["psum"]["sum"].items():
            assert torch.equal(s, ref["psum"]["sum"][c])
            rel = float((s.double() - exact).abs().max() / exact.abs().max())
            assert rel <= PSUM_RTOL
    assert sorted(c for rank in got for c in rank["psum"]["sum"]) == \
        sorted(ref["psum"]["sum"])
    _assert_sums([rank["psum"] for rank in got], ref["psum"])


def test_training_across_processes_is_the_single_process_run():
    got = spawn("train", 2, argv=TRAIN_ARGV)
    ref = ranks.run_here("train", argv=TRAIN_ARGV)
    assert ref["processes"] == 1 and ref["mesh"] == "data2:model2"
    for rank in got:
        assert rank["processes"] == 2 and rank["mesh"] == "data2:model2"
        assert rank["losses"] == ref["losses"]
        assert len(rank["params"]) == len(ref["params"])
        assert all(torch.equal(p, q) for p, q in zip(rank["params"], ref["params"]))
    assert all(np.isfinite(ref["losses"]))


PARTITION_CASES = [pytest.param(("olmo-1b", (2, 4), 2), id="olmo-2x4-over-2"),
                   pytest.param(("granite-8b", (4, 2), 4), id="granite-4x2-over-4")]


@pytest.fixture(scope="module", params=PARTITION_CASES)
def partition_run(request):
    name, shape, nprocs = request.param
    total = shape[0] * shape[1]
    return (nprocs, spawn("partition", nprocs, shape=list(shape), devices=total // nprocs,
                          name=name),
            ranks.run_here("partition", shape=list(shape), devices=total, name=name))


def test_partitioned_step_across_processes_is_the_single_process_bits(partition_run):
    nprocs, got, ref = partition_run
    assert all(np.isfinite(ref["losses"]))
    assert sorted(c for rank in got for c in rank["local"]) == sorted(ref["local"])
    for rank in got:
        assert rank["losses"] == ref["losses"] and rank["grad_norms"] == ref["grad_norms"]
        assert len(rank["params"]) == len(ref["params"])
        assert all(torch.equal(p, q) for p, q in zip(rank["params"], ref["params"]))
    _assert_sums(got, ref)
    assert _summed(got, "bytes")["all_gather"] > 0


def test_a_rank_holds_only_its_coordinates_shards(partition_run):
    nprocs, got, ref = partition_run
    assert ref["held"] == ref["own"]
    for rank in got:
        assert rank["held"] == rank["own"]
        # the replicated regions (the step counters, granite's norm
        # scales) are held once a process; the rest splits over them
        assert rank["held"] * nprocs < 1.01 * ref["held"]
    assert sum(rank["held"] for rank in got) >= ref["held"]


@pytest.fixture(scope="module")
def shampoo_run():
    kw = dict(shape=[2, 4], name="olmo-1b", optimizer="spin_shampoo")
    return (spawn("partition", 2, devices=4, **kw), ranks.run_here("partition", devices=8, **kw))


def test_partitioned_shampoo_across_processes_is_the_single_process_bits(shampoo_run):
    """Two laid-out SPIN-Shampoo steps of reduced olmo-1b on (2, 4) over 2
    processes (the first refreshes: the sharded inversions run across
    them): every rank's losses, grad norms, parameters and optimizer
    leaves (Gram factors and inverses included) the single process's
    bits, the bytes and calls summed over the ranks its counts, and a
    rank holding only its own coordinates' regions of every factor."""
    got, ref = shampoo_run
    assert all(np.isfinite(ref["losses"])) and ref["bytes"]["reshard"] > 0
    for rank in got:
        assert rank["losses"] == ref["losses"] and rank["grad_norms"] == ref["grad_norms"]
        assert len(rank["opt"]) == len(ref["opt"]) > len(ref["params"])
        assert all(torch.equal(p, q) for p, q in zip(rank["params"], ref["params"]))
        assert all(torch.equal(p, q) for p, q in zip(rank["opt"], ref["opt"]))
        assert rank["held"] == rank["own"] and rank["held"] * 2 < 1.01 * ref["held"]
    _assert_sums(got, ref)
    assert ref["held"] == ref["own"] and ref["bytes"]["to_dense"] == 0


SERVE_SHAPE, SERVE_PROCS = (2, 4), 2


@pytest.fixture(scope="module")
def serve_run():
    total = SERVE_SHAPE[0] * SERVE_SHAPE[1]
    return (spawn("serve", SERVE_PROCS, shape=list(SERVE_SHAPE), devices=total // SERVE_PROCS),
            ranks.run_here("serve", shape=list(SERVE_SHAPE), devices=total))


def test_partitioned_serving_across_processes_is_the_single_process_bits(serve_run):
    """Prefill and 3 decode steps of reduced olmo-1b on parameters laid out
    over (2, 4), process p holding data row p: every rank's logits and
    final cache the single process's bits, the bytes and calls summed over
    the ranks its counts."""
    got, ref = serve_run
    assert all(bool(torch.isfinite(lg).all()) for lg in ref["logits"])
    assert sorted(c for rank in got for c in rank["local"]) == sorted(ref["local"])
    for rank in got:
        assert len(rank["logits"]) == len(ref["logits"]) == 4
        assert all(torch.equal(a, b) for a, b in zip(rank["logits"], ref["logits"]))
        assert rank["cache"].keys() == ref["cache"].keys()
        assert all(torch.equal(rank["cache"][k], ref["cache"][k]) for k in ref["cache"])
    _assert_sums(got, ref)
    assert _summed(got, "bytes")["all_to_all"] > 0 and _summed(got, "bytes")["pmax"] > 0


def test_a_rank_holds_only_its_cache_regions(serve_run):
    """After the prefill, the move to the decode length and every step, a
    rank's cache bytes are those of its own coordinates' regions: half of
    the single process's; and its parameter bytes its own shards'."""
    got, ref = serve_run
    assert ref["held"] == ref["own"] and ref["params_held"] == ref["params_own"]
    for rank in got:
        assert rank["held"] == rank["own"] and rank["params_held"] == rank["params_own"]
        assert all(h * SERVE_PROCS == r for h, r in zip(rank["held"], ref["held"]))
        assert rank["params_held"] * SERVE_PROCS < 1.01 * ref["params_held"]


@pytest.fixture(scope="module")
def moe_run():
    total = SERVE_SHAPE[0] * SERVE_SHAPE[1]
    return (spawn("moe", SERVE_PROCS, shape=list(SERVE_SHAPE), devices=total // SERVE_PROCS),
            ranks.run_here("moe", shape=list(SERVE_SHAPE), devices=total))


def test_partitioned_moe_across_processes_is_the_single_process_bits(moe_run):
    """Two AdamW steps, a prefill and 3 decode steps of reduced qwen2-moe
    on a state laid out over (2, 4), process p holding data row p: the
    expert-parallel dispatch runs its all_to_alls within a process and
    the experts' FSDP gathers across them; every rank's losses,
    parameters, logits and final cache the single process's bits, the
    bytes and calls of each part summed over the ranks its counts."""
    got, ref = moe_run
    assert all(np.isfinite(ref["step"]["losses"]))
    for part in ("step", "serve"):
        assert sorted(c for rank in got for c in rank[part]["local"]) == \
            sorted(ref[part]["local"])
        _assert_sums([rank[part] for rank in got], ref[part])
        assert _summed([rank[part] for rank in got], "bytes")["all_to_all"] > 0
        assert _summed([rank[part] for rank in got], "bytes")["pmean"] > 0
    for rank in got:
        assert rank["step"]["losses"] == ref["step"]["losses"]
        assert rank["step"]["grad_norms"] == ref["step"]["grad_norms"]
        assert all(torch.equal(p, q) for p, q in zip(rank["step"]["params"],
                                                     ref["step"]["params"]))
        assert len(rank["serve"]["logits"]) == len(ref["serve"]["logits"]) == 4
        assert all(torch.equal(a, b) for a, b in zip(rank["serve"]["logits"],
                                                     ref["serve"]["logits"]))
        assert all(torch.equal(rank["serve"]["cache"][k], ref["serve"]["cache"][k])
                   for k in ref["serve"]["cache"])


def test_a_rank_holds_only_its_moe_state_and_cache_regions(moe_run):
    """A rank's state bytes are its own coordinates' regions, fewer than
    the single process's (the experts split over both axes; the shared
    experts, router, norm scales and step counters, whole along `data`,
    once a process), the f32 router's parameter held once with its AdamW
    master (the update's cast to its own dtype is the master itself); its
    cache bytes after the prefill, the move to the decode length and every
    step are its own regions too: half."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    router = T.abstract_params(get_arch("qwen2-moe-a2.7b").reduced(), 4)["layers"]["moe"][
        "router"]
    aliased = router.numel() * router.element_size()
    got, ref = moe_run
    assert ref["step"]["held"] == ref["step"]["own"] - aliased
    assert ref["serve"]["held"] == ref["serve"]["own"]
    for rank in got:
        assert rank["step"]["held"] == rank["step"]["own"] - aliased
        assert rank["step"]["held"] < ref["step"]["held"]
        assert rank["serve"]["held"] == rank["serve"]["own"]
        assert all(h * SERVE_PROCS == r for h, r in zip(rank["serve"]["held"],
                                                         ref["serve"]["held"]))


@pytest.fixture(scope="module")
def hybrid_run():
    total = SERVE_SHAPE[0] * SERVE_SHAPE[1]
    return (spawn("hybrid", SERVE_PROCS, shape=list(SERVE_SHAPE), devices=total // SERVE_PROCS),
            ranks.run_here("hybrid", shape=list(SERVE_SHAPE), devices=total))


def test_partitioned_hybrid_across_processes_is_the_single_process_bits(hybrid_run):
    """Two AdamW steps, a prefill and 3 decode steps of reduced hymba on a
    state laid out over (2, 4), process p holding data row p: the SSD heads
    split over `model` (their gated norm's and output's psums within a
    process), the decode on the rolling cache across its wrap; every
    rank's losses, parameters, logits and final cache (k, v, ssm_h,
    ssm_conv) the single process's bits, the bytes and calls of each part
    summed over the ranks its counts."""
    got, ref = hybrid_run
    assert all(np.isfinite(ref["step"]["losses"]))
    assert set(ref["serve"]["cache"]) == {"pos", "k", "v", "ssm_h", "ssm_conv"}
    assert ref["serve"]["cache"]["k"].shape[2] == 32          # the window's slots
    for part in ("step", "serve"):
        assert sorted(c for rank in got for c in rank[part]["local"]) == \
            sorted(ref[part]["local"])
        _assert_sums([rank[part] for rank in got], ref[part])
        assert _summed([rank[part] for rank in got], "bytes")["psum"] > 0
    assert _summed([rank["serve"] for rank in got], "bytes")["pmax"] > 0
    for rank in got:
        assert rank["step"]["losses"] == ref["step"]["losses"]
        assert rank["step"]["grad_norms"] == ref["step"]["grad_norms"]
        assert all(torch.equal(p, q) for p, q in zip(rank["step"]["params"],
                                                     ref["step"]["params"]))
        assert len(rank["serve"]["logits"]) == len(ref["serve"]["logits"]) == 4
        assert all(torch.equal(a, b) for a, b in zip(rank["serve"]["logits"],
                                                     ref["serve"]["logits"]))
        assert all(torch.equal(rank["serve"]["cache"][k], ref["serve"]["cache"][k])
                   for k in ref["serve"]["cache"])


def test_a_rank_holds_only_its_hybrid_state_and_cache_regions(hybrid_run):
    """A rank's state bytes are its own coordinates' regions, fewer than
    the single process's (the SSM's wxbc, wdt, conv_w and per-head leaves
    and the norm scales, whole along `model`, once a process); its cache
    bytes after the prefill, the move to the decode length and every step
    are its own regions too: half (k and v by rows and slots, ssm_h by
    rows and SSD heads, ssm_conv by rows)."""
    got, ref = hybrid_run
    assert ref["step"]["held"] == ref["step"]["own"]
    assert ref["serve"]["held"] == ref["serve"]["own"]
    for rank in got:
        assert rank["step"]["held"] == rank["step"]["own"]
        assert rank["step"]["held"] < ref["step"]["held"]
        assert rank["serve"]["held"] == rank["serve"]["own"]
        assert all(h * SERVE_PROCS == r for h, r in zip(rank["serve"]["held"],
                                                         ref["serve"]["held"]))


def test_partitioned_vlm_across_processes_is_the_single_process_bits():
    """Two AdamW steps, a prefill and 3 decode steps of reduced
    phi-3-vision (8 patch stubs before 24 tokens a row) on a state laid
    out over (2, 4), process p holding data row p: every rank's losses,
    parameters, logits and final cache the single process's bits, the
    bytes and calls of each part summed over the ranks its counts; a
    rank's state bytes its own regions', fewer than the single process's,
    and its cache bytes after every phase half the single process's."""
    total = SERVE_SHAPE[0] * SERVE_SHAPE[1]
    got = spawn("vlm", SERVE_PROCS, shape=list(SERVE_SHAPE), devices=total // SERVE_PROCS)
    ref = ranks.run_here("vlm", shape=list(SERVE_SHAPE), devices=total)
    assert all(np.isfinite(ref["step"]["losses"]))
    assert int(ref["serve"]["cache"]["pos"][0]) == 32 + 3         # patches counted
    for part in ("step", "serve"):
        assert sorted(c for rank in got for c in rank[part]["local"]) == \
            sorted(ref[part]["local"])
        _assert_sums([rank[part] for rank in got], ref[part])
        assert _summed([rank[part] for rank in got], "bytes")["psum"] > 0
    assert ref["step"]["held"] == ref["step"]["own"]
    assert ref["serve"]["held"] == ref["serve"]["own"]
    for rank in got:
        assert rank["step"]["losses"] == ref["step"]["losses"]
        assert rank["step"]["grad_norms"] == ref["step"]["grad_norms"]
        assert all(torch.equal(p, q) for p, q in zip(rank["step"]["params"],
                                                     ref["step"]["params"]))
        assert len(rank["serve"]["logits"]) == len(ref["serve"]["logits"]) == 4
        assert all(torch.equal(a, b) for a, b in zip(rank["serve"]["logits"],
                                                     ref["serve"]["logits"]))
        assert all(torch.equal(rank["serve"]["cache"][k], ref["serve"]["cache"][k])
                   for k in ref["serve"]["cache"])
        assert rank["step"]["held"] == rank["step"]["own"] < ref["step"]["held"]
        assert rank["serve"]["held"] == rank["serve"]["own"]
        assert all(h * SERVE_PROCS == r for h, r in zip(rank["serve"]["held"],
                                                         ref["serve"]["held"]))
