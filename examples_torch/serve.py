"""Serving demo: batched prompt ingest + greedy decode with the KV/SSM cache.

The PyTorch twin of examples/serve.py, on the port (`repro_torch`).

    PYTHONPATH=src python examples_torch/serve.py --arch hymba-1.5b --tokens 32
    PYTHONPATH=src python examples_torch/serve.py --device cpu --batch 2 \\
        --prompt-len 8 --tokens 8

The model is always the config's reduced size, as in the reference. The
matrix-inversion analogue of this loop, the same kind of slot scheduler
serving solve/update requests against a maintained SPIN inverse, is
examples_torch/serve_inverse.py (`repro_torch.serving.SpinService`).

Differences from examples/serve.py:
- `--device` (default cuda); without a card it raises unless `--device cpu`
  is given.
- Random weights come from a `torch.Generator` on the device seeded 0
  (`init_params(..., model_size_hint=1)`), the prompts from numpy's
  `default_rng(0)`, not from `jax.random.PRNGKey(0)` and `PRNGKey(1)`.
  `main(inputs={"params": tree of arrays, "prompts": (batch, prompt_len)})`
  takes them instead (the reference's parameter tree as numpy,
  `repro_torch.bridge.lm_params_from_numpy`).
- `decode_step` runs eagerly (the reference jit-compiles it); the prompt is
  still ingested token by token through it, as in the reference. Both
  timers end with a device synchronize (the reference's ingest timer
  does not block).
- `main(argv)` returns the printed numbers as a dict, with the generated
  ids under "ids" (batch, tokens) and the logits that chose them under
  "logits" (batch, tokens, vocab).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, *, inputs=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch(args.arch).reduced()
    if not cfg.decode_capable:
        raise SystemExit(f"{args.arch} is encoder-only; no decode step")
    if inputs is None:
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                               model_size_hint=1)
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (args.batch, args.prompt_len))).to(dev)
    else:
        params = bridge.lm_params_from_numpy(inputs["params"], dev)
        prompts = bridge.to_torch(inputs["prompts"], dev).long()
    if tuple(prompts.shape) != (args.batch, args.prompt_len):
        raise ValueError(f"prompts are {tuple(prompts.shape)}, want "
                         f"{(args.batch, args.prompt_len)}")
    max_len = args.prompt_len + args.tokens

    # ---- prompt ingest: build the cache by streaming the prompt ------------
    # (the demo decodes the prompt token by token; `T.prefill` processes
    # the whole prompt in one forward)
    cache = T.init_cache(cfg, args.batch, max_len, dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for i in range(args.prompt_len):
        logits, cache = T.decode_step(params, cache, prompts[:, i], cfg)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    # ---- greedy decode ------------------------------------------------------
    out, chose = [], []
    tok = torch.argmax(logits, dim=-1)
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        out.append(tok)
        chose.append(logits)
        logits, cache = T.decode_step(params, cache, tok, cfg)
        tok = torch.argmax(logits, dim=-1)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen = torch.stack(out, dim=1)
    print(f"arch={cfg.name} batch={args.batch}")
    print(f"prompt ingest: {t_prefill * 1e3:.0f} ms; "
          f"decode: {args.tokens} tokens in {t_decode * 1e3:.0f} ms "
          f"({args.batch * args.tokens / t_decode:.1f} tok/s batched)")
    print("generated ids[0,:16]:", gen[0, :16].tolist())
    return {"arch": cfg.name, "batch": args.batch, "ingest_ms": t_prefill * 1e3,
            "decode_ms": t_decode * 1e3,
            "tok_per_s": args.batch * args.tokens / t_decode,
            "ids": gen, "logits": torch.stack(chose, dim=1)}


if __name__ == "__main__":
    main()
