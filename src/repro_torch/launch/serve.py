"""Serving launcher: batched greedy decode against a KV/SSM cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --batch 4 --steps 64 [--reduced] [--device cpu]

Any decoding family (dense, MoE, SSM, hybrid, VLM on text); an
encoder-only config (hubert-xlarge) exits, as in the reference. Random
weights from seed 0, MoE experts unpadded (model_size_hint 1, as the
reference's launcher); runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import time

import torch


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.decode_capable:
        raise SystemExit(f"{cfg.name} is encoder-only")
    device = resolve_device(args.device)

    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_params(cfg, gen, device, model_size_hint=1)
    cache = T.init_cache(cfg, args.batch, args.cache_len, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    tok = torch.zeros((args.batch,), dtype=torch.int32, device=device)
    logits, cache = T.decode_step(params, cache, tok, cfg)     # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        tok = torch.argmax(logits, dim=-1)
        logits, cache = T.decode_step(params, cache, tok, cfg)
    sync()
    dt = time.perf_counter() - t0
    result = {"arch": cfg.name, "device": str(device), "steps": args.steps,
              "batch": args.batch, "tok_per_s": args.batch * args.steps / dt,
              "ms_per_step": dt / args.steps * 1e3}
    print(f"{cfg.name} on {device}: {args.steps} steps x batch {args.batch} -> "
          f"{result['tok_per_s']:.1f} tok/s, {result['ms_per_step']:.1f} ms/step")
    return result


if __name__ == "__main__":
    main()
