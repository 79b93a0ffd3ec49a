"""Trace an LM's serving path or the dense LM's training path on the card,
or sweep the dense LM's decode drift.

    PYTHONPATH=src python -m repro_torch.profile_lm [--arch <name>]  # trace
    PYTHONPATH=src python -m repro_torch.profile_lm --consistency    # drift
    PYTHONPATH=src python -m repro_torch.profile_lm --routes --arch qwen2-moe-a2.7b
    PYTHONPATH=src python -m repro_torch.profile_lm --train [--optimizer spin_shampoo]

`--arch` (default granite-8b) at full width, random weights from seed 0,
a batch of 4 x 2048 positions from `data.synthetic.make_batch` (numpy seed
0: 4 prompts of 2048 tokens; audio 2048 frame embeddings and their mask,
VLM 576 patch embeddings and 1472 tokens), as `chip_smoke.py` drives it.

Trace: one `prefill`, then (where the config decodes) 4 greedy
`decode_step`s from the padded cache, each after a warm-up, each under
`torch.profiler`. For both it
prints the device time by kernel class (the B6 flash attention kernel,
cuBLAS GEMMs, the rest) and by kernel, and the idle share of the traced
range (`profile_spin.device_breakdown`), with the untraced wall time;
the Chrome traces are kept under ``build/profile_lm/``.

Train: olmo-1b at full width and depth, random weights from seed 0,
`TokenStream` batches of 8 x 2048 tokens (seed 0), 2 microbatches, full
remat, as `chip_smoke.py` phase 18 drives it. AdamW: one warm-up step,
then one traced step. SPIN-Shampoo: step 1 (which refreshes every
factor's inverse) and step 2, each traced. Device time by class (B6,
B6-bwd, the SPIN kernels, cuBLAS GEMMs, the rest) and idle share.

Routes (an MoE config): the prefill, 8 greedy decode steps, `forward`
over the prompt plus the fed tokens, and that forward again with the
plain attention (`attention_ref`) in place of B6. For each pair of paths
(decode against forward, decode against the plain forward, forward
against the plain forward) and each layer, over the checked tokens whose
routes agreed at every earlier layer: how many part ways there, the
median and largest router-logit difference, the median relative
difference of the router's input, and the median and least gap between
the 4th and 5th expert's logits; then how many tokens agree at every
layer. It shows how far two correctly rounded paths drift apart.

Consistency: the largest and the root-mean-square difference between
the logits of 8 decode steps and those of `forward` over the prompt plus
the tokens decode was fed, and how many greedy tokens agree, for the
model cut to its first 1, 2, 4, 9, 18 and 36 layers. Everything is bf16
with f32 sums, so the difference is rounding: it shows how rounding
differences between the two paths grow with depth.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .profile_spin import device_breakdown

__all__ = ["main"]

ARCH, BATCH, SEQ, SEED = "granite-8b", 4, 2048, 0
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = "olmo-1b", 8, 2048, 2
DECODE_STEPS = 4          # traced decode steps
CHECK_STEPS = 8           # decode steps held against forward
DEPTHS = (1, 2, 4, 9, 18, 36)
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "profile_lm"


def kernel_class(name: str) -> str:
    if "flash_bwd" in name:
        return "flash_attention_bwd (B6-bwd)"
    if "flash_fwd" in name:
        return "flash_attention (B6)"
    if "gemm_tc" in name or "gemm_pack" in name:
        return "B1/B2 (gemm_pack, gemm_tc)"
    if "bgj_" in name:
        return "B3 (bgj_panel, bgj_update)"
    if any(key in name.lower() for key in ("gemm", "nvjet", "cutlass", "xmma")):
        return "cuBLAS GEMM"
    return "other"


def _sync_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def _traced(name: str, fn) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(name):
            fn()
            torch.cuda.synchronize()
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"{name}.json"
    prof.export_chrome_trace(str(path))
    report = device_breakdown(json.loads(path.read_text()), name)
    classes: dict[str, float] = {}
    for r in report["groups"]:
        key = kernel_class(r["name"])
        classes[key] = classes.get(key, 0.0) + r["device_ms"]
    report.update(call=name, classes=classes, trace=str(path))
    return report


def _print(report: dict, wall_ms: float | None = None) -> None:
    for key, ms in sorted(report["classes"].items(), key=lambda kv: -kv[1]):
        print(f"{report['call']}: {ms:10.3f} ms  {key}")
    for r in report["groups"][:25]:
        print(f"{r['device_ms']:10.3f} ms {r['count']:5d}x  grid {r['grid'] or '-':>12s}  "
              f"{r['name'][:90]}")
    wall = "" if wall_ms is None else f"; untraced wall {wall_ms:.3f} ms"
    print(f"{report['call']}: span {report['span_ms']:.3f} ms, busy {report['busy_ms']:.3f} ms, "
          f"idle share {report['idle_share']:.4f}{wall}", flush=True)


def _prompts(cfg, device) -> torch.Tensor:
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (BATCH, SEQ), dtype=np.int64)).to(device)


def _padded(cache: dict, extra: int) -> dict:
    """The prefill cache with its k, v padded by `extra` slots along S (the
    SSM state passes as it is)."""
    pad = (0, 0, 0, 0, 0, extra)
    return {k: F.pad(v, pad) if k in ("k", "v") else v for k, v in cache.items()}


def trace(params, cfg, device) -> None:
    from .data.synthetic import make_batch
    from .models import transformer as T

    batch = make_batch(cfg, BATCH, SEQ, np.random.default_rng(SEED), "prefill", device)
    T.prefill(params, batch, cfg)
    wall = _sync_ms(lambda: T.prefill(params, batch, cfg))
    report = _traced("prefill", lambda: T.prefill(params, batch, cfg))
    _print(report, wall)
    print(json.dumps({**report, "untraced_wall_ms": wall}))
    if not cfg.decode_capable:
        return

    logits, _, _, cache = T.prefill(params, batch, cfg)
    cache = _padded(cache, 4 * DECODE_STEPS)
    state = {"cache": cache, "tok": torch.argmax(logits[:, -1], -1)}
    del logits

    def steps():
        for _ in range(DECODE_STEPS):
            lg, state["cache"] = T.decode_step(params, state["cache"], state["tok"], cfg)
            state["tok"] = torch.argmax(lg, -1)

    steps()
    wall = _sync_ms(steps) / DECODE_STEPS
    report = _traced("decode", steps)
    _print(report, wall)
    print(json.dumps({**report, "untraced_wall_ms_per_step": wall,
                      "steps": DECODE_STEPS}))


def train_trace(optimizer: str, device) -> None:
    from .configs import get_arch
    from .data.synthetic import TokenStream
    from .runtime.trainer import TrainConfig, init_state, make_train_step

    cfg = get_arch(TRAIN_ARCH)
    tcfg = TrainConfig(microbatches=TRAIN_MICRO, optimizer=optimizer, warmup=1)
    held = {"state": init_state(cfg, tcfg, torch.Generator(device=device).manual_seed(SEED),
                                device)}
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED, device=str(device))
    step = make_train_step(cfg, tcfg)
    print(f"train {cfg.name} {optimizer} on {torch.cuda.get_device_name(0)}", flush=True)

    def one():
        held["state"], metrics = step(held["state"], stream.next())
        float(metrics["loss"])

    calls = ["train_adamw_step"] if optimizer == "adamw" else [
        "train_shampoo_step1", "train_shampoo_step2"]
    if optimizer == "adamw":
        one()                                   # warm-up
    for name in calls:
        report = _traced(name, one)
        _print(report)
        print(json.dumps(report))


def routes(params, cfg, device) -> None:
    from .data.synthetic import make_batch
    from .kernels.flash_attention import ref as fa_ref
    from .models import attention, moe as moe_mod, transformer as T

    if cfg.moe is None:
        raise SystemExit(f"profile_lm --routes: {cfg.name} has no router")
    batch = make_batch(cfg, BATCH, SEQ, np.random.default_rng([SEED, 17, 0]), "prefill",
                       device)
    n_l, top_k, n_real = cfg.n_layers, cfg.moe.top_k, cfg.moe.num_experts
    logits, _, _, cache = T.prefill(params, batch, cfg)
    cache = _padded(cache, CHECK_STEPS)
    tok = torch.argmax(logits[:, -1], -1)
    del logits
    seen, route = [], moe_mod.route

    def recording(x, router_w, c):
        out = route(x, router_w, c)
        seen.append((x.reshape(BATCH, -1, x.shape[-1]).float(),
                     out[0].reshape(BATCH, -1, out[0].shape[-1]),
                     out[3].reshape(BATCH, -1, top_k)))
        return out

    moe_mod.route = recording
    try:
        fed = []
        for _ in range(CHECK_STEPS):
            fed.append(tok)
            lg, cache = T.decode_step(params, cache, tok, cfg)
            tok = torch.argmax(lg, -1)
        decoded = [tuple(torch.cat([seen[i * n_l + layer][j] for i in range(CHECK_STEPS)], 1)
                         for j in range(3)) for layer in range(n_l)]
        seq = {"tokens": torch.cat([batch["tokens"], torch.stack(fed, 1)], 1)}
        forwards = {}
        for name, attend in (("forward", attention.flash_attention),
                             ("forward_plain", fa_ref.attention_ref)):
            seen.clear()
            b6, attention.flash_attention = attention.flash_attention, attend
            try:
                T.forward(params, seq, cfg)
            finally:
                attention.flash_attention = b6
            forwards[name] = [tuple(t[:, SEQ:SEQ + CHECK_STEPS] for t in rec) for rec in seen]
    finally:
        moe_mod.route = route
    paths = {"decode": decoded, **forwards}
    report = {}
    for a, b in (("decode", "forward"), ("decode", "forward_plain"),
                 ("forward", "forward_plain")):
        alive = torch.ones((BATCH, CHECK_STEPS), dtype=torch.bool, device=device)
        rows = []
        for layer in range(n_l):
            (xa, la, ea), (xb, lb, eb) = paths[a][layer], paths[b][layer]
            part = (ea.sort(-1).values != eb.sort(-1).values).any(-1) & alive
            dl = (la - lb)[..., :n_real].abs().amax(-1)[alive]
            dx = ((xa - xb).norm(dim=-1) / xb.norm(dim=-1))[alive]
            top = lb[..., :n_real].topk(top_k + 1, -1).values
            gap = (top[..., top_k - 1] - top[..., top_k])[alive]
            rows.append({"layer": layer, "agreeing": int(alive.sum()), "part": int(part.sum()),
                         "dlogit_median": float(dl.median()), "dlogit_max": float(dl.max()),
                         "dinput_rel_median": float(dx.median()),
                         "gap_median": float(gap.median()), "gap_min": float(gap.min())})
            alive &= ~part
            if not alive.any():
                break
        report[f"{a}_vs_{b}"] = {"layers": rows, "agree_every_layer": int(alive.sum()),
                                 "tokens": alive.numel()}
        print(f"{a} vs {b}: {int(alive.sum())} of {alive.numel()} tokens agree at every "
              f"layer", flush=True)
        for r in rows:
            print(f"  layer {r['layer']:2d}: {r['agreeing']:3d} agreeing, {r['part']} part; "
                  f"logit diff median {r['dlogit_median']:.4f} max {r['dlogit_max']:.4f}; "
                  f"input diff {r['dinput_rel_median']:.5f}; gap median {r['gap_median']:.4f} "
                  f"min {r['gap_min']:.5f}", flush=True)
    print(json.dumps({"routes": report, "arch": cfg.name, "batch": BATCH, "seq": SEQ,
                      "steps": CHECK_STEPS}))


def consistency(params, cfg, device) -> None:
    from .models import transformer as T

    prompts = _prompts(cfg, device)
    rows = []
    for depth in DEPTHS:
        cut = dataclasses.replace(cfg, n_layers=depth)
        p = {**params, "layers": {k: {n: w[:depth] for n, w in v.items()}
                                  for k, v in params["layers"].items()}}
        logits, _, _, cache = T.prefill(p, {"tokens": prompts}, cut)
        cache = _padded(cache, CHECK_STEPS)
        tok = torch.argmax(logits[:, -1], -1)
        del logits
        fed, got = [], []
        for _ in range(CHECK_STEPS):
            fed.append(tok)
            lg, cache = T.decode_step(p, cache, tok, cut)
            got.append(lg)
            tok = torch.argmax(lg, -1)
        del cache
        seq = torch.cat([prompts, torch.stack(fed, 1)], 1)
        full = T.forward(p, {"tokens": seq}, cut)[0][:, SEQ:]
        got = torch.stack(got, 1)
        diff = (got - full).abs()
        top2 = torch.topk(full, 2, dim=-1).values
        row = {"depth": depth, "max_abs_diff": float(diff.max()),
               "rms_diff": float(diff.square().mean().sqrt()),
               "logit_rms": float(full.square().mean().sqrt()),
               "logit_max": float(full.abs().max()),
               "tokens_agree": int((got.argmax(-1) == full.argmax(-1)).sum()),
               "tokens": got.shape[0] * got.shape[1],
               "min_top2_margin": float((top2[..., 0] - top2[..., 1]).min())}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del full, got, diff
        torch.cuda.empty_cache()
    print(json.dumps({"consistency": rows, "arch": cfg.name, "batch": BATCH, "seq": SEQ,
                      "steps": CHECK_STEPS}))


def main(argv=None) -> int:
    from .configs import get_arch
    from .kernels import build
    from .models import transformer as T

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", default=ARCH,
                        help="the config whose prefill (and decode) to trace")
    parser.add_argument("--consistency", action="store_true",
                        help="sweep granite-8b's decode-vs-forward differences over depth")
    parser.add_argument("--routes", action="store_true",
                        help="an MoE config's route divergence between decode and forward")
    parser.add_argument("--train", action="store_true",
                        help="trace olmo-1b training steps instead")
    parser.add_argument("--optimizer", default="adamw", choices=["adamw", "spin_shampoo"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_lm: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    device = torch.device("cuda")
    if args.train:
        train_trace(args.optimizer, device)
        return 0
    cfg = get_arch(ARCH if args.consistency else args.arch)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)
    print(f"{cfg.name} on {torch.cuda.get_device_name(0)}", flush=True)
    run = consistency if args.consistency else routes if args.routes else trace
    run(params, cfg, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
