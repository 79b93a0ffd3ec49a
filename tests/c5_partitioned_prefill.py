"""ROADMAP §C, C5: is the full-width partitioned prefill's logit gap the
port's, or the placed program's?

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/c5_partitioned_prefill.py [--layers 4]

Not a tier-1 test (pytest collects no file of this name). olmo-1b at full
width (d 2048, 16 heads of 128, vocab 50304), cut to `--layers` layers,
random weights from the reference's `init_params(PRNGKey(0))`, a prompt of
B 8 x S 64 tokens from a seeded numpy draw. Two gaps, each the largest
absolute difference of the f32 logits:

  * the reference: its prefill jitted with `in_shardings` from
    `param_specs` and `_batch_specs` on a (data 2, model 4) mesh of 8 fake
    CPU devices, against the same prefill jitted on one device
    (`mesh_harness.run_mesh` child);
  * the port: its prefill on the same weights laid out by `param_specs`
    over a (data 2, model 4) CPU mesh, against its mesh-free prefill.

Both placed programs sum the output projections' partial products over
`model`; a gap of the same size in both says the difference is the
layout's rounding, not a fault of the port. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

B, S = 8, 64

_CHILD = """
import dataclasses, numpy as np, jax, jax.numpy as jnp
from repro.compat import AxisType, jit_shardings, make_mesh, set_mesh
from repro.configs import get_arch
from repro.launch.dryrun import RULES_VARIANTS, _batch_specs
from repro.models import transformer as T

cfg = dataclasses.replace(get_arch("olmo-1b"), n_layers=LAYERS)
rules = RULES_VARIANTS["default"]
params = T.init_params(cfg, jax.random.PRNGKey(0))
batch = {"tokens": jnp.asarray(np.load(TOKENS))}
whole = jax.jit(lambda p, x: T.prefill(p, x, cfg, rules)[0])(params, batch)
mesh = make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                 devices=jax.devices()[:8])
with set_mesh(mesh):
    specs = (T.param_specs(cfg, rules, mesh), _batch_specs(batch, rules, mesh))
    placed = jax.jit(lambda p, x: T.prefill(p, x, cfg, rules)[0],
                     in_shardings=jit_shardings(specs, mesh))(params, batch)
np.save(OUT, np.asarray(whole, np.float32))
emit_result({"gap": float(jnp.abs(placed - whole).max()),
             "scale": float(jnp.abs(whole).max())})
"""


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args(argv)

    import jax
    import torch

    from mesh_harness import run_mesh
    from repro.configs import get_arch as j_get_arch
    from repro.models import transformer as JT
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.models import transformer as T
    from repro_torch.parallel import NamedSharding
    from repro_torch.parallel.sharding import lay_out

    tokens = np.random.default_rng(5).integers(0, 50304, (B, S)).astype(np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "tokens.npy"), tokens)
        out = os.path.join(tmp, "whole.npy")
        code = (_CHILD.replace("LAYERS", str(args.layers))
                .replace("TOKENS", repr(os.path.join(tmp, "tokens.npy")))
                .replace("OUT", repr(out)))
        (ref,) = run_mesh(code, devices=8, timeout=1800)
        ref_whole = np.load(out)

    jcfg = dataclasses.replace(j_get_arch("olmo-1b"), n_layers=args.layers)
    cfg = dataclasses.replace(get_arch("olmo-1b"), n_layers=args.layers)
    whole = bridge.lm_params_from_numpy(
        jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0))), "cpu")
    mesh = make_worker_mesh((2, 4), devices=["cpu"] * 8)

    def named(specs):
        return {k: named(v) if isinstance(v, dict) else NamedSharding(mesh, v)
                for k, v in specs.items()}

    batch = {"tokens": torch.from_numpy(tokens).long()}
    free = T.prefill(whole, batch, cfg)[0]
    laid = T.prefill(lay_out(whole, named(T.param_specs(cfg, mesh=mesh))), batch, cfg)[0]
    res = {"arch": "olmo-1b", "layers": args.layers, "batch": B, "seq": S, "mesh": "data2:model4",
           "reference_placed_vs_whole": ref["gap"], "reference_scale": ref["scale"],
           "port_laid_out_vs_mesh_free": float((laid - free).abs().max()),
           "port_mesh_free_vs_reference_whole": float(np.abs(free.numpy() - ref_whole).max())}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
