"""Rank programs of the multi-process tests: PyTorch port only, no JAX.

    python tests/torch_multiprocess_ranks.py <case> '<json kwargs>'

runs `CASES[case](**kwargs)` under `repro_torch.launch.procs.rank_main`
(gloo, every wait bounded) in each rank that `run_ranks` starts. The
same functions run in the test process on a single process's mesh (no
`init_distributed`): `make_worker_mesh(shape, devices=["cpu"] * k)` is
then the whole mesh, while in a rank `k` names the rank's own
coordinates. Every case runs one torch thread, so a product's bits do
not depend on how many cores a process was given.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from repro_torch.core import (count_ops, spin_inverse_sharded, spin_solve_sharded,  # noqa: E402
                              testing)
from repro_torch.launch.mesh import make_worker_mesh, set_mesh  # noqa: E402
from repro_torch.parallel import collectives as col  # noqa: E402
from repro_torch.parallel import ShardedBlockMatrix, record_specs  # noqa: E402

GROUP_TIMEOUT_S = 60.0            # every wait of a rank's process group
SPIN_RUNS = (("allgather", "linalg"), ("ring", "linalg"), ("cuda", "cuda"))


def _counts() -> dict:
    return {"bytes": col.collective_bytes(), "calls": col.collective_calls(),
            "summed": col.summed_counts()}


def _specs(records) -> list:
    return [(r.op, r.kind, r.shape, r.spec, r.axes, r.mesh_axes) for r in records]


def _spd(n: int, seed: int) -> torch.Tensor:
    return testing.make_spd(n, np.random.default_rng([seed, n]), device="cpu")


def _normal(shape, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def spin(shape, devices: int, n: int = 256, bs: int = 32, rhs: int = 8,
         seed: int = 3) -> dict:
    """spin_inverse_sharded and spin_solve_sharded under each engine (a
    dense operand in, the dense result out in every process), with the
    op counts, the spec ledger and the bytes and calls by kind; and a
    ShardedBlockMatrix in and out, holding this process's shards only."""
    from repro_torch.launch.mesh import worker_info
    from repro_torch.parallel import mesh_fingerprint

    mesh = make_worker_mesh(tuple(shape), devices=["cpu"] * devices)
    a, b = _spd(n, seed), _normal((n, rhs), seed + 1)
    info = worker_info()
    out = {"local": mesh.local_coords(), "fingerprint": mesh_fingerprint(mesh, devices=True),
           "info": [info.process_index, info.process_count, info.local_device_count,
                    info.global_device_count]}
    for engine, leaf in SPIN_RUNS:
        for kind in ("inverse", "solve"):
            col.reset_collective_bytes()
            with set_mesh(mesh), record_specs() as recs, count_ops() as ops:
                x = (spin_inverse_sharded(a, bs, engine=engine, leaf_solver=leaf)
                     if kind == "inverse" else
                     spin_solve_sharded(a, b, bs, engine=engine, leaf_solver=leaf))
            out[f"{kind}_{engine}"] = {"x": x, "ops": ops.as_dict(),
                                       "specs": _specs(recs), **_counts()}
    with set_mesh(mesh):
        sa = ShardedBlockMatrix.from_dense(a, bs)
        sx = spin_inverse_sharded(sa, engine="cuda", leaf_solver="cuda")
        out["sharded"] = {"in": sorted(sa.shards), "out": sorted(sx.shards),
                          "x": sx.to_dense()}
    return out


# one axis and a tuple of axes, for each collective
REGION_AXES = ("data", "model", ("data", "model"))


def regions(shape, devices: int, seed: int = 5) -> dict:
    """all_to_all, all_gather, psum, pmean and pmax over each of
    REGION_AXES, forward and backward: a global input split by rows over
    both axes, the collective, the outputs joined by rows, and the
    gradient of a fixed linear loss back to the input."""
    mesh = make_worker_mesh(tuple(shape), devices=["cpu"] * devices)
    k = len(mesh.coords())
    spec = (("data", "model"), None, None)
    out = {}
    for axis in REGION_AXES:
        size = col.axis_size(axis, mesh)
        for name in ("all_to_all", "all_gather", "psum", "pmean", "pmax"):
            x = _normal((k * 2, 8, 3), seed).requires_grad_()
            col.reset_collective_bytes()
            xs = col.split(x, spec, mesh)
            if name == "all_to_all":
                ys = col.all_to_all(xs, axis, 1, 0, mesh)
            elif name == "all_gather":
                ys = col.all_gather(xs, axis, 0, mesh)
            else:
                ys = getattr(col, name)(xs, axis, mesh)
            y = col.join(ys, spec, mesh)
            grad = None
            if name != "pmax":
                w = _normal(tuple(y.shape), seed + 1)
                with col.backward_context(mesh):
                    (y * w).sum().backward()
                grad = x.grad
            out[f"{name}_{axis}"] = {"size": size, "y": y.detach(), "grad": grad,
                                     **_counts()}
    return out


def lm(shape, devices: int, seed: int = 7) -> dict:
    """Reduced qwen2-moe's MoE block (f32, capacity factor 8: no drop)
    expert-parallel, forward and backward (the loss takes the output and
    z; EP's aux is a mean over groups, not the mesh-free one); the sharded
    embedding lookup and its backward; and compressed_psum over a `pod`
    mesh of one coordinate a device."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    from repro_torch.models.embedding import embed_lookup
    from repro_torch.models.layers import init_tree
    from repro_torch.parallel.compression import compressed_psum

    mesh = make_worker_mesh(tuple(shape), devices=["cpu"] * devices)
    base = get_arch("qwen2-moe-a2.7b").reduced()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=8.0))
    params = init_tree(moe.moe_params(cfg, 4), torch.Generator().manual_seed(seed), "cpu")
    params = {k: ({kk: vv.float().requires_grad_() for kk, vv in v.items()}
                  if isinstance(v, dict) else v.float().requires_grad_())
              for k, v in params.items()}
    x = _normal((4, 16, cfg.d_model), seed).requires_grad_()
    ct = _normal((4, 16, cfg.d_model), seed + 1)
    col.reset_collective_bytes()
    with set_mesh(mesh):
        y, aux, z = moe.moe_apply(params, x, cfg)
        loss = (y * ct).sum() + z
    with col.backward_context(mesh):
        loss.backward()
    flat = {"x": x.grad, **{k: v.grad for k, v in params.items() if k != "shared"},
            **{f"shared_{k}": v.grad for k, v in params.get("shared", {}).items()}}
    out = {"moe": {"y": y.detach(), "aux": aux.detach(), "z": z.detach(),
                   "grads": flat, **_counts()}}

    table = (0.02 * _normal((cfg.vocab, cfg.d_model), seed + 2)).requires_grad_()
    toks = torch.from_numpy(np.random.default_rng(seed + 3).integers(
        0, cfg.vocab, (4, 16)))
    col.reset_collective_bytes()
    with set_mesh(mesh):
        e = embed_lookup(table, toks)
    with col.backward_context(mesh):
        (e * _normal(tuple(e.shape), seed + 4)).sum().backward()
    out["embed"] = {"y": e.detach(), "grad": table.grad, **_counts()}

    pod = make_worker_mesh((len(mesh.coords()),), ("pod",), devices=["cpu"] * devices)
    g = 1e-3 * _normal((len(pod.coords()), 64, 48), seed + 5)
    col.reset_collective_bytes()
    got = compressed_psum(col.split(g, ("pod", None, None), pod), "pod", pod)
    out["psum"] = {"sum": {str(c): got[c] for c in pod.local_coords()},
                   "exact": g.double().sum(0), **_counts()}
    return out


def train(argv: list) -> dict:
    """`launch.train.main(argv)`: it joins the group itself."""
    from repro_torch.launch import train as train_mod
    from repro_torch.tree import leaves

    res = train_mod.main(list(argv))
    return {"losses": [log["loss"] for log in res["logs"]],
            "params": [p.detach() for p in leaves(res["state"].params)],
            "mesh": res["mesh"], "processes": res["processes"]}


def _held_bytes(tree) -> int:
    """The bytes of the distinct storages behind this process's shards of
    every laid-out leaf of `tree`."""
    from repro_torch.tree import leaves

    seen = {}
    for x in leaves(tree):
        for t in x.shards.values():
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(seen.values())


def _own_bytes(tree) -> int:
    """The bytes of this process's coordinates' regions of every laid-out
    leaf of `tree`, each distinct region of a place once."""
    from repro_torch.tree import leaves

    total = 0
    for x in leaves(tree):
        regions = {(x.mesh.place(c), x.region(c)) for c in x.mesh.local_coords()}
        for _, r in regions:
            n = 1
            for lo, hi in r:
                n *= hi - lo
            total += n * x.shards[x.mesh.local_coords()[0]].element_size()
    return total


def _inputs(cfg, rng, labels: bool) -> dict:
    """8 rows of 32 model positions: tokens (labelled by themselves with
    `labels`), and for a VLM 8 patch stubs before 24 of them."""
    patches = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 32 - patches)))
    out = {"tokens": tokens, "labels": tokens} if labels else {"tokens": tokens}
    if patches:
        out["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (8, patches, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
    return out


def partition(shape, devices: int, name: str = "olmo-1b", steps: int = 2,
              seed: int = 3, optimizer: str = "adamw") -> dict:
    """Two steps of reduced `name` (AdamW, or SPIN-Shampoo at damping 0.1)
    on a state laid out by the default rules' specs over `shape` (the
    partitioned step: a process holds and computes only its own
    coordinates' shards, Shampoo's factor regions included), 8 x 32
    positions in 2 microbatches: the losses and grad norms, the bytes and
    calls by kind of the steps, the state bytes held beside its
    coordinates' regions, and every parameter gathered whole (with
    Shampoo every optimizer leaf too)."""
    from repro_torch.configs import get_arch
    from repro_torch.optim import SpinShampooConfig
    from repro_torch.parallel.sharding import lay_out
    from repro_torch.runtime.trainer import (TrainConfig, init_state, make_train_step,
                                             state_shardings)
    from repro_torch.tree import leaves

    mesh = make_worker_mesh(tuple(shape), devices=["cpu"] * devices)
    cfg = get_arch(name).reduced()
    tcfg = TrainConfig(microbatches=2, warmup=1, total_steps=100, optimizer=optimizer,
                       shampoo=SpinShampooConfig(damping=0.1))
    whole = init_state(cfg, tcfg, torch.Generator().manual_seed(seed), "cpu", 4)
    state = lay_out(whole, state_shardings(cfg, tcfg, mesh, model_size_hint=4))
    del whole
    batch = _inputs(cfg, np.random.default_rng(seed), labels=True)
    step = make_train_step(cfg, tcfg)
    col.reset_collective_bytes()
    losses, norms = [], []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    out = {"losses": losses, "grad_norms": norms, **_counts(),
           "held": _held_bytes(state), "own": _own_bytes(state),
           "local": mesh.local_coords()}
    out["params"] = [col.gather(p) for p in leaves(state.params)]
    if optimizer != "adamw":
        out["opt"] = [col.gather(x) for x in leaves(state.opt)]
    return out


def serve(shape, devices: int, name: str = "olmo-1b", cache_len: int = 48, steps: int = 3,
          seed: int = 3) -> dict:
    """The partitioned serving path of reduced `name` on parameters laid out
    by the default rules' specs over `shape`: a prefill of 8 x 32 positions
    (its cache laid out by `cache_specs`), the cache padded to `cache_len`
    (`pad_cache`), then `steps` decode steps fed their argmax. Every
    logits tensor, the final cache gathered whole, the bytes and calls by
    kind, and after each phase the cache bytes held beside those of the
    process's own regions (and the parameters' at the end)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import NamedSharding, lay_out

    def named(specs):
        return {k: named(v) if isinstance(v, dict) else NamedSharding(mesh, v)
                for k, v in specs.items()}

    mesh = make_worker_mesh(tuple(shape), devices=["cpu"] * devices)
    cfg = get_arch(name).reduced()
    whole = T.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    params = lay_out(whole, named(T.param_specs(cfg, mesh=mesh)))
    del whole
    prompt = _inputs(cfg, np.random.default_rng(seed), labels=False)
    col.reset_collective_bytes()
    logits, _, _, cache = T.prefill(params, prompt, cfg)
    out = {"logits": [logits], "held": [_held_bytes(cache)], "own": [_own_bytes(cache)]}
    cache = T.pad_cache(cache, cfg, cache_len)
    tok = torch.argmax(logits[:, -1], -1)
    for _ in range(steps):
        out["held"].append(_held_bytes(cache))
        out["own"].append(_own_bytes(cache))
        lg, cache = T.decode_step(params, cache, tok, cfg)
        out["logits"].append(lg)
        tok = torch.argmax(lg, -1)
    out["held"].append(_held_bytes(cache))
    out["own"].append(_own_bytes(cache))
    out["params_held"], out["params_own"] = _held_bytes(params), _own_bytes(params)
    out.update(_counts())
    out["cache"] = {k: col.gather(v) for k, v in cache.items()}
    out["local"] = mesh.local_coords()
    return out


def moe(shape, devices: int, name: str = "qwen2-moe-a2.7b", seed: int = 3) -> dict:
    """The partitioned MoE body: `partition`'s two AdamW steps and `serve`'s
    prefill and decode of reduced `name` (expert-parallel dispatch on
    laid-out experts in each), each with its own counts."""
    return {"step": partition(shape, devices, name=name, seed=seed),
            "serve": serve(shape, devices, name=name, seed=seed)}


def hybrid(shape, devices: int, name: str = "hymba-1.5b", seed: int = 3) -> dict:
    """The partitioned hybrid body, as `moe` runs the MoE one: attention
    and the SSD heads on a laid-out state, the decode on the rolling cache
    (reduced hymba's window of 32 slots: the prompt fills it, and every
    step writes across its wrap into the first slice)."""
    return moe(shape, devices, name=name, seed=seed)


def vlm(shape, devices: int, name: str = "phi-3-vision-4.2b", seed: int = 3) -> dict:
    """The partitioned VLM body, as `moe` runs the MoE one: 8 patch stubs
    before each row's text in the step and the prefill, the decode going
    on after them."""
    return moe(shape, devices, name=name, seed=seed)


def fail_early() -> dict:
    """Rank 1 raises before any collective."""
    from repro_torch.launch.mesh import worker_info

    if worker_info().process_index == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return {"ok": True}


def fail_mid_collective() -> dict:
    """Rank 1 raises between two collectives; rank 0 waits in the second."""
    from repro_torch.launch.mesh import worker_info

    mesh = make_worker_mesh((2,), ("data",), devices=["cpu"])
    xs = col.split(torch.ones(2, 3), ("data", None), mesh)
    col.psum(xs, "data", mesh)
    if worker_info().process_index == 1:
        raise RuntimeError("rank 1 fails between two collectives")
    col.psum(xs, "data", mesh)
    return {"ok": True}


def skip_collective() -> dict:
    """Rank 1 returns without the second collective: rank 0 waits on it."""
    from repro_torch.launch.mesh import worker_info

    mesh = make_worker_mesh((2,), ("data",), devices=["cpu"])
    xs = col.split(torch.ones(2, 3), ("data", None), mesh)
    col.psum(xs, "data", mesh)
    if worker_info().process_index == 0:
        col.psum(xs, "data", mesh)
    return {"ok": True}


CASES = {"spin": spin, "regions": regions, "lm": lm, "train": train, "partition": partition,
         "serve": serve, "moe": moe, "hybrid": hybrid, "vlm": vlm, "fail_early": fail_early,
         "fail_mid_collective": fail_mid_collective, "skip_collective": skip_collective}


def run_here(case: str, **kwargs) -> dict:
    """`CASES[case]` in this process, on one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return CASES[case](**kwargs)
    finally:
        torch.set_num_threads(threads)


if __name__ == "__main__":
    from repro_torch.launch.procs import rank_main

    case, kwargs = sys.argv[1], json.loads(sys.argv[2])
    rank_main(lambda: run_here(case, **kwargs),
              backend=None if case == "train" else "gloo", timeout_s=GROUP_TIMEOUT_S)
