"""The port's dry run (`repro_torch.launch.dryrun`) and production mesh
against the JAX package's.

The twins of tests/test_dryrun_machinery.py come first: the collective
statistics, the extrapolation, cell eligibility and the input specs.
Then the parity with the reference: one subprocess imports
`repro.launch.dryrun`, which gives itself 512 fake devices, and runs the
reference's `run_cell` on olmo-1b × decode_32k and × train_4k at 16×16,
`run_solver_cell(4096, 256)` under einsum, and a reduced qwen2-moe cell,
while this process runs the port's on the meta device. What must agree:

* ``argument_bytes``, to the byte, on every cell;
* ``alias_bytes`` to the byte; ``output_bytes`` to the byte once the
  compiler's own additions are taken off: the reference's output buffer
  holds a table of 8 bytes for each output leaf, and the train step's
  three metric scalars (loss, grad_norm, lr_scale: 12 bytes), which the
  port does not count as outputs with specs;
* FLOPs by a stated tolerance. The reference's cost analysis counts
  elementwise ops (one op an element) beside the products, and its
  chunked attention walks whole chunks of the causal band where B6's
  tiles are smaller; the port counts the matmul-class aten ops and B6's
  tiles. On olmo-1b × train_4k the port counts 6.2 % fewer FLOPs (ratio
  0.9377 measured), so the ratio must lie in [0.90, 1.0]. In the decode
  step the elementwise passes over the f32-upcast 32k cache dominate the
  reference's count (ratio 0.093 measured): there the port's count must
  be the analytic one exactly (2 FLOPs a weight a token, 4·H·S·hd a
  token and layer of attention) and below the reference's;
* MoE's all-to-all bytes a device, by a formula for each side: the
  reference's collectives are counted once a loop body (one layer), over
  the whole send buffers, which its CPU compiler carries in f32 (the
  expert rows (M, cap, d) out and back, the local-expert index (M, cap)
  int32); the port counts every layer, only the chunks a coordinate takes
  from the other M - 1, in bf16 with an int64 index. Each side equals its
  formula, and the port's count is at most L times the reference's.

* the partitioned program's collectives a device, kind by kind, by a
  formula for each side where one can be written. The reference counts
  the operand bytes of each collective of its partitioned HLO, a loop
  body (one layer) once, bf16 carried in f32 by its CPU compiler: an
  all-gather's operand is a coordinate's shard, an all-reduce's the whole
  local tensor. The port counts the bytes a coordinate receives, every
  layer, in bf16: (size - 1) shards of an all_gather, 2·(size - 1)/size
  of a psum's tensor. On olmo-1b × decode_32k both sides follow from the
  shapes. On × train_4k the reference's partitioner picks its own
  collectives (four collective-permutes, one reduce-scatter, the remat's
  gathers folded), which no formula here follows: both numbers are pinned,
  the port's to its own count (`partitioned_step_collectives`), and their
  ratio, port ÷ reference, is 294.84 (all-gather), 52.858 (all-reduce)
  and 46.584 (reduce-scatter); the reference's 103,120,896 B of
  collective-permute have no counterpart in the port (ROADMAP §C).

The solver cell's FLOPs are not compared: the reference's partitioner
computes the replicated lower levels on every device and counts them on
each, while the port's mesh of one meta device computes a replicated
value once.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES, cell_status as j_cell_status
from repro.configs import get_arch as j_get_arch, list_archs as j_list_archs
from repro.data.synthetic import input_specs as j_input_specs
from repro_torch import kernels
from repro_torch.configs import SHAPES, cell_status, get_arch, list_archs
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.data.synthetic import input_specs, make_batch
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh_shape, make_production_mesh

ROOT = Path(__file__).resolve().parents[1]
MOE_SHAPE = ("tiny", 256, 32)          # seq, batch: both split 16 ways
TRAIN_FLOPS_RATIO = (0.90, 1.0)        # port ÷ reference, olmo-1b × train_4k

_CHILD = r"""
import json, sys
import repro.launch.dryrun as dr
from repro.compat import set_mesh
from repro.configs import get_arch
from repro.configs.shapes import ShapeConfig
from repro.launch.mesh import make_production_mesh

out = {}
for shape in ("decode_32k", "train_4k"):
    out[shape] = dr.run_cell("olmo-1b", shape, multi_pod=False, verbose=False)
out["solver"] = dr.run_solver_cell(4096, 256, multi_pod=False, engine="einsum",
                                   verbose=False)
cfg = get_arch("qwen2-moe-a2.7b").reduced()
mesh = make_production_mesh()
with set_mesh(mesh):
    shape = ShapeConfig("tiny", int(sys.argv[1]), int(sys.argv[2]), "prefill")
    compiled = dr._compile_cell(cfg, shape, mesh,
                                dr.RULES_VARIANTS["default"], 1)[0]
    out["moe"] = dr._measure(compiled)["coll"]
print("RESULT " + json.dumps(out, default=str))
"""


@pytest.fixture(scope="module")
def ref():
    """The reference's records, from a child with 512 fake devices; it runs
    while this process computes the port's."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    child = subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(MOE_SHAPE[1]), str(MOE_SHAPE[2])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)

    def result():
        out, err = child.communicate(timeout=600)
        assert child.returncode == 0, err[-4000:]
        line = [x for x in out.splitlines() if x.startswith("RESULT ")][-1]
        return json.loads(line[len("RESULT "):])

    yield result
    if child.poll() is None:
        child.kill()
        child.communicate()


@pytest.fixture(scope="module")
def port(ref):
    """The port's records on the same cells (the child runs meanwhile)."""
    recs = {shape: D.run_cell("olmo-1b", shape, multi_pod=False, verbose=False)
            for shape in ("decode_32k", "train_4k")}
    recs["solver"] = D.run_solver_cell(4096, 256, multi_pod=False, engine="einsum",
                                       verbose=False)
    cfg = get_arch("qwen2-moe-a2.7b").reduced()
    traced = D._trace_cell(cfg, ShapeConfig(*MOE_SHAPE, "prefill"),
                           make_production_mesh(devices=["meta"]), D.DEFAULT_RULES, 1)
    recs["moe"] = {"moved": traced["moved"], "calls": traced["calls"]}
    return recs


# ---------------------------------------------------------------------------
# Twins of tests/test_dryrun_machinery.py
# ---------------------------------------------------------------------------


def test_collective_stats_maps_the_port_kinds():
    moved = {"gather": 10, "ring": 20, "reshard": 30, "to_dense": 40, "all_to_all": 50,
             "all_gather": 60, "reduce_scatter": 70, "psum": 80, "pmean": 90, "pmax": 100}
    calls = {k: i + 1 for i, k in enumerate(moved)}
    stats = D.collective_stats(moved, calls, chips=10)
    assert stats["all-gather"] == {"count": 1 + 4 + 6, "operand_bytes": 11.0}
    assert stats["all-reduce"] == {"count": 8 + 9 + 10, "operand_bytes": 27.0}
    assert stats["all-to-all"] == {"count": 3 + 5, "operand_bytes": 8.0}
    assert stats["collective-permute"] == {"count": 2, "operand_bytes": 2.0}
    assert stats["reduce-scatter"] == {"count": 7, "operand_bytes": 7.0}
    assert stats["total_operand_bytes"] == pytest.approx(sum(moved.values()) / 10)
    assert set(stats) == {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                          "collective-permute", "total_operand_bytes"}


def test_collective_counts_follow_the_calls():
    """A psum over a (2, 2) mesh is one call; its backward one more; an
    all_gather's backward is a reduce-scatter."""
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.parallel import collectives as col

    mesh = make_worker_mesh((2, 2), devices=["cpu"] * 4)
    xs = {c: torch.ones(3, requires_grad=True) for c in mesh.coords()}
    col.reset_collective_bytes()
    ys = col.psum(xs, "model", mesh)
    zs = col.all_gather(ys, "data", 0, mesh)
    sum(z.sum() for z in zs.values()).backward()
    calls, moved = col.collective_calls(), col.collective_bytes()
    assert calls["psum"] == 2 and calls["all_gather"] == 1 and calls["reduce_scatter"] == 1
    assert moved["reduce_scatter"] == moved["all_gather"] == 4 * 3 * 4


def test_extrapolation_linear():
    # f(L) = 10 + 3L  ->  f1=13, f2=16, L=88 -> 274
    assert D._extrapolate(13.0, 16.0, 88) == pytest.approx(274.0)
    # noise clamp: f2 < f1 must not extrapolate negative
    assert D._extrapolate(13.0, 12.0, 88) == pytest.approx(13.0)
    assert D._extrapolate(13, 16, 88) == 274          # integers stay exact


def test_cell_eligibility_matrix():
    """40 cells: 31 runnable, 8 long_500k skips, 1 encoder decode skip; the
    reference's split, cell for cell."""
    assert list_archs() == j_list_archs()
    got, want = {}, {}
    for arch in list_archs():
        for shape in SHAPES.values():
            got[arch, shape.name] = cell_status(get_arch(arch), shape)[0]
            want[arch, shape.name] = j_cell_status(j_get_arch(arch),
                                                   J_SHAPES[shape.name])[0]
    assert got == want
    skipped = [k for k, ok in got.items() if not ok]
    assert sum(got.values()) == 31 and len(skipped) == 9
    assert len([k for k in skipped if k[1] == "long_500k"]) == 8
    assert ("hubert-xlarge", "decode_32k") in skipped


def test_input_specs_match_batches_and_the_reference():
    """The dry run's meta inputs agree with `make_batch`'s batches (ids:
    int32 specs, int64 draws; the model takes either) and with the
    reference's `input_specs`, shape and dtype."""
    names = {"int32": torch.int32, "bool": torch.bool, "bfloat16": torch.bfloat16}
    for arch in ("olmo-1b", "hubert-xlarge", "phi-3-vision-4.2b", "mamba2-130m"):
        cfg = get_arch(arch)
        for shape in SHAPES.values():
            if not cell_status(cfg, shape)[0]:
                continue
            specs = input_specs(cfg, shape)
            small = make_batch(cfg.reduced(), 2, 32, np.random.default_rng(0), shape.kind,
                               device="cpu")
            assert set(specs) == set(small), (arch, shape.name)
            for k, spec in specs.items():
                assert spec.device.type == "meta"
                assert spec.ndim == small[k].ndim, (arch, shape.name, k)
                want = torch.int64 if spec.dtype == torch.int32 else spec.dtype
                assert small[k].dtype == want, (arch, shape.name, k)
            j_specs = j_input_specs(j_get_arch(arch), J_SHAPES[shape.name])
            assert set(j_specs) == set(specs)
            for k, spec in specs.items():
                assert tuple(spec.shape) == tuple(j_specs[k].shape), (arch, shape.name, k)
                assert spec.dtype == names[str(j_specs[k].dtype)], (arch, shape.name, k)


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------


def _out_leaves(rec_kind: str, cfg) -> int:
    """Output leaves of the reference's compiled step: the state's leaves
    and 3 metrics (train), or the logits and the cache's leaves (decode)."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    n_params = len(leaves(T.abstract_params(cfg)))
    if rec_kind == "train":
        return 4 * n_params + 2 + 3
    return 1 + len(T.abstract_cache(cfg, 2, 8))


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_argument_bytes_match_the_reference(ref, port, shape):
    got, want = port[shape]["per_device"], ref()[shape]["per_device"]
    assert got["argument_bytes"] == want["argument_bytes"]
    if shape == "train_4k":
        assert got["argument_bytes"] == 64_878_600


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_output_and_alias_bytes_match_the_reference(ref, port, shape):
    got, want = port[shape]["per_device"], ref()[shape]["per_device"]
    assert got["alias_bytes"] == want["alias_bytes"]
    kind = SHAPES[shape].kind
    metrics = 3 * 4 if kind == "train" else 0       # loss, grad_norm, lr_scale (f32)
    table = 8 * _out_leaves(kind, get_arch("olmo-1b"))
    assert want["output_bytes"] - got["output_bytes"] == metrics + table
    assert got["temp_bytes"] is None and port[shape]["temp_bytes_global"] > 0


def test_flops_within_the_stated_tolerance(ref, port):
    train = port["train_4k"]["cost"]["flops"] / ref()["train_4k"]["cost"]["flops"]
    assert TRAIN_FLOPS_RATIO[0] <= train <= TRAIN_FLOPS_RATIO[1], train
    # decode: the products' analytic count, and below the reference's
    cfg, sh = get_arch("olmo-1b"), SHAPES["decode_32k"]
    from repro_torch.models import transformer as T

    params = T.abstract_params(cfg)
    weights = sum(v.numel() for k, v in params["layers"].items() if k in ("attn", "mlp")
                  for v in v.values())
    head = params["embed"].numel() if cfg.tie_embeddings else params["lm_head"].numel()
    analytic = sh.global_batch * (2 * (weights + head) + 4 * cfg.n_layers * cfg.n_heads
                                  * sh.seq_len * cfg.head_dim)
    rec = port["decode_32k"]
    assert rec["cost"]["flops_global"] == analytic
    assert rec["cost"]["flops"] < ref()["decode_32k"]["cost"]["flops"]
    assert rec["flops_kernels_global"] == 0           # decode attention is plain


def test_solver_cell_matches_the_reference_layout(ref, port):
    got, want = port["solver"], ref()["solver"]
    assert got["per_device"]["argument_bytes"] == want["per_device"]["argument_bytes"]
    assert got["per_device"]["output_bytes"] == want["per_device"]["output_bytes"]
    assert got["shape"] == want["shape"] and got["chips"] == want["chips"] == 256
    assert got["cost"]["flops"] > 0 and got["coll_scope"] == "partitioned"
    lu = D.run_solver_cell(1024, 64, multi_pod=False, algo="lu", verbose=False)
    assert lu["cost"]["coll_bytes"] == 0 and lu["cost"]["flops"] > 0


def test_moe_all_to_all_bytes_against_the_reference(ref, port):
    cfg = get_arch("qwen2-moe-a2.7b").reduced()
    _, seq, batch = MOE_SHAPE
    data = model = 16
    tokens = batch // data * (seq // model)
    cap = max(8, int(cfg.moe.capacity_factor * tokens * cfg.moe.top_k / model))
    rows, index = model * cap * cfg.d_model, model * cap
    ref_once = ref()["moe"]["all-to-all"]
    assert ref_once["count"] == 3
    assert ref_once["operand_bytes"] == 2 * rows * 4 + index * 4
    got = port["moe"]["moved"]["all_to_all"] / (data * model)
    assert port["moe"]["calls"]["all_to_all"] == 3 * cfg.n_layers
    assert got == cfg.n_layers * (model - 1) / model * (2 * rows * 2 + index * 8)
    assert got <= cfg.n_layers * ref_once["operand_bytes"]


# the reference's train_4k collectives (jax 0.9.0's CPU partitioner), pinned
REF_TRAIN_COLLECTIVES = {"all-gather": (20, 7_483_392), "all-reduce": (17, 780_861_512),
                         "reduce-scatter": (1, 25_755_648),
                         "collective-permute": (4, 103_120_896)}
TRAIN_COLL_RATIO = {"all-gather": 294.84, "all-reduce": 52.858, "reduce-scatter": 46.584}


def test_partitioned_collective_bytes_by_kind_against_the_reference(ref, port):
    cfg = get_arch("olmo-1b")
    d, v, f, hd, L = cfg.d_model, cfg.vocab, cfg.d_ff, cfg.head_dim, cfg.n_layers
    data = model = 16
    # decode_32k: B 128, rows a coordinate; a coordinate's shards of the
    # table (vocab over model, width over data), of a layer's four
    # attention and three MLP weights, and of q, k, v (a head a coordinate)
    rows, heads = SHAPES["decode_32k"].global_batch // data, cfg.n_heads // model
    table = (v // model) * (d // data)
    layer = 4 * (d // data) * heads * hd + 3 * (d // data) * (f // model)
    qkv = 3 * rows * heads * hd
    # all-reduce: the lookup's partial rows, the attention's and the MLP's
    # outputs (rows, d), and the split softmax's max (rows, H) and (o, l)
    # (rows, H, hd + 1), f32
    sums = rows * d + L * (2 * rows * d)
    softmax = L * rows * cfg.n_heads * (hd + 1) * 4
    pmax = L * rows * cfg.n_heads * 4
    want_ref = {"all-gather": (12, 4 * (2 * table + layer + qkv)),
                "all-reduce": (6, 4 * (rows * d + 2 * rows * d) + (softmax + pmax) // L)}
    want_port = {"all-gather": (2 + 7 * L + 3 * L,
                                (model - 1) * 2 * (2 * table + L * (layer + qkv))),
                 "all-reduce": (1 + 3 * L + L,
                                2 * (model - 1) * (2 * sums + softmax + pmax) // model)}
    got_ref, got = ref()["decode_32k"]["collectives_once"], port["decode_32k"]
    assert got["coll_scope"] == "partitioned" and got["analytic_match"] is True
    for kind in want_ref:
        assert (got_ref[kind]["count"], got_ref[kind]["operand_bytes"]) == want_ref[kind], kind
        ours = got["collectives_once"][kind]
        assert (ours["count"], ours["operand_bytes"]) == want_port[kind], kind
    assert want_port["all-gather"][1] == 151_449_600 and want_ref["all-gather"][1] == 4_280_320
    assert got["cost"]["coll_bytes"] == sum(want_port[k][1] for k in want_port)
    # train_4k: pinned, each side to its own count, and their ratio
    got_ref, got = ref()["train_4k"]["collectives_once"], port["train_4k"]
    assert got["coll_scope"] == "partitioned" and got["analytic_match"] is True
    moved, calls = D.partitioned_step_collectives(cfg, (data, model), "default",
                                                  SHAPES["train_4k"].global_batch,
                                                  SHAPES["train_4k"].seq_len, 8)
    assert got["collectives_once"] == D.collective_stats(moved, calls, data * model)
    for kind, pinned in REF_TRAIN_COLLECTIVES.items():
        assert (got_ref[kind]["count"], got_ref[kind]["operand_bytes"]) == pinned, kind
        ours = got["collectives_once"][kind]["operand_bytes"]
        if kind in TRAIN_COLL_RATIO:
            assert round(ours / pinned[1], 3) == pytest.approx(TRAIN_COLL_RATIO[kind],
                                                               abs=5e-3), kind
        else:
            assert ours == 0, kind


# ---------------------------------------------------------------------------
# Self-consistency
# ---------------------------------------------------------------------------


def test_full_depth_flops_equal_the_extrapolated_probes(port):
    rec = port["train_4k"]
    p1, p2 = rec["probes"]["L1"], rec["probes"]["L2"]
    assert rec["cost"]["flops_global"] == D._extrapolate(p1["flops"], p2["flops"],
                                                         get_arch("olmo-1b").n_layers)
    assert rec["cost"] == rec["cost_raw"]
    assert rec["cost_extrapolated"]["flops_global"] == rec["cost"]["flops_global"]
    assert rec["coll_scope"] == "partitioned" and not rec["launches_moved"]
    booked = rec["kernels_booked"]
    assert booked["flash_attention"]["calls"] == 2 * 16 * 8      # forward + recompute
    assert booked["flash_attention_bwd"]["calls"] == 16 * 8


@pytest.mark.parametrize("variant", ["attn_chunk_512", "attn_chunk_1024"])
def test_attention_chunk_variants_count_as_base(variant):
    base = D.run_cell("olmo-1b", "prefill_32k", multi_pod=False, verbose=False)
    got = D.run_cell("olmo-1b", "prefill_32k", multi_pod=False, variant=variant,
                     verbose=False)
    for key in ("cost", "per_device", "collectives_once", "kernels_booked",
                "temp_bytes_global"):
        assert got[key] == base[key], key
    assert base["variant_effect"] == "none"
    assert "change nothing in the port" in got["variant_effect"]


# ---------------------------------------------------------------------------
# Kernels on meta
# ---------------------------------------------------------------------------


def _tile_pairs(sq, skv, bq, bk, causal, window, kv_outer):
    """Pairs inside the visited tiles, by marking each tile on a grid."""
    seen = np.zeros((sq, skv), bool)
    if kv_outer:
        for k0 in range(0, skv, bk):
            q_begin = k0 if causal else 0
            q_end = min(sq, k0 + bk - 1 + window) if window else sq
            for q0 in range(q_begin, q_end, bq):
                seen[q0:q0 + bq, k0:k0 + bk] = True
        return int(seen.sum())
    for q0 in range(0, sq, bq):
        last = min(q0 + bq, sq) - 1
        for k0 in range(0, skv, bk):
            if causal and k0 > last:
                continue
            if window and k0 + bk <= max(0, q0 - window + 1) // bk * bk:
                continue
            seen[q0:q0 + bq, k0:k0 + bk] = True
    return int(seen.sum())


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 96)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_meta_flash_attention_books_its_tiles(causal, window, dtype):
    b, h, kv, s, hd = 2, 4, 2, 300, 64
    q = torch.empty(b, h, s, hd, dtype=dtype, device="meta", requires_grad=True)
    k = torch.empty(b, kv, s, hd, dtype=dtype, device="meta", requires_grad=True)
    v = torch.empty(b, kv, s, hd, dtype=dtype, device="meta", requires_grad=True)
    kernels.reset_booked()
    before = kernels.launch_counts()
    from repro_torch.kernels.flash_attention.ops import flash_attention

    out = flash_attention(q, k, v, causal=causal, window=window)
    assert out.shape == q.shape and out.dtype == dtype and out.device.type == "meta"
    out.sum().backward()
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    bq, bk = (64, 64) if dtype == torch.float32 else (128, 128)
    bwd_q, bwd_k = (64, 64) if dtype == torch.float32 else (64, 128)
    fwd_pairs = _tile_pairs(s, s, bq, bk, causal, window, False)
    bwd_pairs = _tile_pairs(s, s, bwd_q, bwd_k, causal, window, True)
    booked = kernels.booked()
    item = torch.empty((), dtype=dtype).element_size()
    qkv = (b * h * s * hd * 2 + b * kv * s * hd * 2) * item       # q, o; k, v
    lse = b * h * s * 4
    assert booked["flash_attention"] == {"calls": 1, "flops": 4 * hd * fwd_pairs * b * h,
                                         "bytes": qkv + lse}
    assert booked["flash_attention_bwd"] == {
        "calls": 1, "flops": 10 * hd * bwd_pairs * b * h,
        "bytes": qkv + lse + 2 * b * h * s * hd * item + 2 * b * kv * s * hd * item}
    assert kernels.launch_counts() == before
    if not causal:
        assert fwd_pairs == s * s


def test_meta_branch_is_the_flash_attention_wrappers_only():
    from repro_torch.kernels.matmul.kernel import matmul_cuda

    a = torch.empty(64, 64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        matmul_cuda(a, a)
    q = torch.empty(1, 1, 8, 72, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_cuda(q, q, q)


def test_a_dry_run_launches_no_kernel(tmp_path):
    before = kernels.launch_counts()
    D.main(["--arch", "olmo-1b", "--shape", "decode_32k", "--mesh", "single",
            "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "olmo-1b__decode_32k__16x16__default.json").read_text())
    for key in ("runnable", "per_device", "cost", "cost_raw", "collectives_once",
                "coll_scope", "method", "trace_s"):
        assert key in rec, key
    assert not rec["launches_moved"] and kernels.launch_counts() == before
    D.main(["--solver", "--solver-n", "1024", "--solver-block", "64", "--mesh", "multi",
            "--out", str(tmp_path)])
    assert (tmp_path / "solver-spin__n1024_b16_float32_einsum__2x16x16.json").exists()


# ---------------------------------------------------------------------------
# The production mesh and the launcher
# ---------------------------------------------------------------------------


def test_make_mesh_shape_matches_the_reference():
    from repro.launch.mesh import make_mesh_shape as j_make_mesh_shape

    for multi in (False, True):
        assert make_mesh_shape(multi_pod=multi) == j_make_mesh_shape(multi_pod=multi)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh_axes(device, multi):
    mesh = make_production_mesh(multi_pod=multi, devices=[device])
    shape, axes = make_mesh_shape(multi_pod=multi)
    assert mesh.axis_names == axes and tuple(mesh.shape.values()) == shape
    assert len(mesh.coords()) == int(np.prod(shape))
    assert mesh.distinct_devices == [torch.device(device)]


def test_production_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_production_mesh()


def test_meta_only_where_named(monkeypatch):
    from repro_torch.core import spin_inverse_dense

    with pytest.raises(ValueError, match="meta"):
        resolve_device("meta")
    assert resolve_device("meta", allow_meta=True).type == "meta"
    with pytest.raises(ValueError, match="meta"):
        spin_inverse_dense(torch.eye(32), 16, device="meta")


def test_train_launcher_under_the_production_mesh_matches_mesh_free():
    """Dense olmo under the 16×16 mesh of the CPU: only the embedding runs
    per coordinate, and it is bitwise, so every step's loss and gradient
    norm are the mesh-free run's bits."""
    from repro_torch.launch import train

    argv = ["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "32", "--microbatches", "1"]
    free = train.main(argv)
    meshed = train.main(argv + ["--mesh", "single"])
    assert meshed["mesh"] == "data16:model16" and free["mesh"] is None
    for a, b in zip(free["logs"], meshed["logs"]):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
