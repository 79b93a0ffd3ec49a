"""The LM examples' PyTorch twins (`examples_torch/serve.py`,
`examples_torch/train_lm.py`) against the JAX examples, on the CPU.

Each JAX example runs once, in a child process (`JAX_PLATFORMS=cpu`), at a
small size, while this process drives the twins. The test rebuilds the
reference's weights (`init_params` / `init_state` at `PRNGKey(0)`), prompts
(`PRNGKey(1)`) and batches (`TokenStream`, seed 0) here and hands them to
the twin as numpy through `main(inputs=...)`.

Tolerances:
- decode logits: LOGIT_TOL (2e-2) absolute, `tests/test_torch_models.py`'s
  decode bound (bf16 activations rounded in another order);
- generated ids: equal wherever the reference's top-two margin exceeds
  2·LOGIT_TOL, the least margin that logits each within LOGIT_TOL cannot
  swap (random weights give near-ties: the reference printed 149 eight
  times); after the first step below it the two runs feed different
  tokens, so no later id is compared;
- training losses: within 2e-3 relative, grad norms within 1e-2 relative,
  `tests/test_torch_train.py`'s bounds for one step.
"""

import functools
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.data.synthetic import TokenStream as JTokenStream
from repro.models import transformer as JT
from repro.runtime.trainer import TrainConfig as JTrainConfig
from repro.runtime.trainer import init_state as j_init_state

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = 2e-2
LOSS_REL = 2e-3
GNORM_REL = 1e-2

SERVE = ["--batch", "2", "--prompt-len", "8", "--tokens", "8"]
TRAIN_10M = ["--scale", "10m", "--steps", "3", "--batch", "2", "--seq", "32"]
TRAIN_OLMO = ["--arch", "olmo-1b", "--reduced", "--steps", "2", "--batch", "2",
              "--seq", "32", "--microbatches", "1"]
CPU = ["--device", "cpu"]


@functools.cache
def load(package: str, name: str):
    spec = importlib.util.spec_from_file_location(
        f"{package}_{name}", ROOT / package / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def twin(name: str):
    return load("examples_torch", name)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX examples' stdout (and train_lm's --log-json logs), by run
    name; the children run while the tests drive the twins."""
    tmp = tmp_path_factory.mktemp("ref_lm")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "SPIN_PLAN_CACHE": str(tmp / "plans.json")}
    env.pop("XLA_FLAGS", None)
    runs = {"serve": ["serve", *SERVE],
            "train_10m": ["train_lm", *TRAIN_10M, "--log-json", str(tmp / "train_10m.json")],
            "train_olmo": ["train_lm", *TRAIN_OLMO, "--log-json",
                           str(tmp / "train_olmo.json")]}
    children = {run: subprocess.Popen([sys.executable, f"examples/{args[0]}.py", *args[1:]],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, env=env, cwd=ROOT)
                for run, args in runs.items()}
    outs = {}

    def result(run: str) -> dict:
        if run not in outs:
            out, err = children[run].communicate(timeout=600)
            assert children[run].returncode == 0, err[-4000:]
            log = tmp / f"{run}.json"
            outs[run] = {"stdout": out,
                         "logs": json.loads(log.read_text()) if log.exists() else None}
        return outs[run]

    yield result
    for child in children.values():
        if child.poll() is None:
            child.kill()
        child.communicate()


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# serve.py
# ---------------------------------------------------------------------------


@functools.cache
def serve_case(arch: str):
    """The reference's reduced config, weights (`PRNGKey(0)`) and prompts
    (`PRNGKey(1)`), as examples/serve.py draws them."""
    cfg = j_get_arch(arch).reduced()
    params = JT.init_params(cfg, jax.random.PRNGKey(0), model_size_hint=1)
    prompts = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0, cfg.vocab)
    return cfg, params, prompts


def _reference_logits(arch: str, fed: np.ndarray) -> np.ndarray:
    """The reference's decode logits at each generated position when it is
    fed the prompt and then the ids `fed` (B, T): (B, T, V)."""
    cfg, params, prompts = serve_case(arch)
    decode = jax.jit(lambda p, c, t: JT.decode_step(p, c, t, cfg))
    cache = JT.init_cache(cfg, prompts.shape[0], prompts.shape[1] + fed.shape[1])
    for i in range(prompts.shape[1]):
        logits, cache = decode(params, cache, prompts[:, i])
    out = [logits]
    for t in range(fed.shape[1] - 1):
        logits, cache = decode(params, cache, jnp.asarray(fed[:, t], jnp.int32))
        out.append(logits)
    return np.stack([np.asarray(x, np.float32) for x in out], axis=1)


@pytest.mark.parametrize("arch", ["olmo-1b", "hymba-1.5b"])
def test_serve_logits_match_the_reference(arch):
    """Dense and hybrid (attention + SSD state) caches, decoded token by
    token through the prompt and 8 greedy steps."""
    _, params, prompts = serve_case(arch)
    out = twin("serve").main(SERVE + ["--arch", arch] + CPU,
                             inputs={"params": _numpy_tree(params),
                                     "prompts": np.asarray(prompts)})
    ids = out["ids"].numpy()
    assert ids.shape == (2, 8) and tuple(out["logits"].shape)[:2] == (2, 8)
    want = _reference_logits(arch, ids)
    assert float(np.abs(out["logits"].numpy() - want).max()) < LOGIT_TOL
    assert np.array_equal(ids, out["logits"].argmax(-1).numpy())


def test_serve_ids_match_the_reference_where_the_margin_is_clear(ref):
    _, params, prompts = serve_case("olmo-1b")
    out = twin("serve").main(SERVE + CPU, inputs={"params": _numpy_tree(params),
                                                  "prompts": np.asarray(prompts)})
    text = ref("serve")["stdout"]
    assert f"arch={out['arch']} batch=2" in text
    m = re.search(r"generated ids\[0,:16\]: \[([\d, ]+)\]", text)
    assert m, text
    want_ids = [int(v) for v in m.group(1).split(",")]
    got_ids = out["ids"][0].tolist()
    assert len(want_ids) == len(got_ids) == 8
    logits = _reference_logits("olmo-1b", out["ids"].numpy())[0]
    compared = 0
    for t in range(8):
        top2 = np.sort(logits[t])[-2:]
        if top2[1] - top2[0] <= 2 * LOGIT_TOL:
            break
        assert got_ids[t] == want_ids[t], (t, got_ids, want_ids)
        compared += 1
    assert compared >= 1, "no generated id had a clear margin"


def test_serve_draws_its_own_weights_and_refuses_encoders():
    out = twin("serve").main(SERVE + ["--arch", "mamba2-130m"] + CPU)
    assert tuple(out["ids"].shape) == (2, 8)
    assert bool(torch.isfinite(out["logits"]).all())
    with pytest.raises(SystemExit, match="encoder-only"):
        twin("serve").main(SERVE + ["--arch", "hubert-xlarge"] + CPU)


# ---------------------------------------------------------------------------
# train_lm.py
# ---------------------------------------------------------------------------


def test_train_lm_scales_are_the_reference_configs():
    ours, theirs = twin("train_lm").SCALES, load("examples", "train_lm").SCALES
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        for field in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                      "head_dim", "d_ff", "vocab", "tie_embeddings"):
            assert getattr(ours[k], field) == getattr(theirs[k], field), (k, field)
        assert ours[k].param_count() == theirs[k].param_count()


def _train_inputs(cfg, steps: int, batch: int, seq: int) -> dict:
    jtcfg = JTrainConfig(microbatches=2, optimizer="adamw", warmup=10, total_steps=100)
    state = j_init_state(cfg, jtcfg, jax.random.PRNGKey(0), model_size_hint=1)
    stream = JTokenStream(cfg, batch, seq, seed=0)
    return {"params": _numpy_tree(state.params),
            "batches": [_numpy_tree(stream.next()) for _ in range(steps)]}


@pytest.mark.parametrize("run,args", [
    pytest.param("train_10m", TRAIN_10M, id="scale-10m"),
    pytest.param("train_olmo", TRAIN_OLMO, id="olmo-1b-reduced")])
def test_train_lm_losses_match_the_reference(ref, run, args):
    steps = int(args[args.index("--steps") + 1])
    if run == "train_10m":
        cfg = load("examples", "train_lm").SCALES["10m"]
    else:
        cfg = j_get_arch("olmo-1b").reduced()
    out = twin("train_lm").main(args + CPU, inputs=_train_inputs(cfg, steps, 2, 32))
    want = ref(run)["logs"]
    assert out["steps"] == len(out["logs"]) == len(want) == steps
    for got, w in zip(out["logs"], want):
        assert got["step"] == w["step"]
        assert got["lr_scale"] == pytest.approx(w["lr_scale"], rel=1e-6)
        assert abs(got["loss"] - w["loss"]) <= LOSS_REL * w["loss"], (got, w)
        assert abs(got["grad_norm"] - w["grad_norm"]) <= GNORM_REL * w["grad_norm"]
    final = re.search(r"final loss (\S+) \(start (\S+)\)", ref(run)["stdout"])
    assert abs(out["final_loss"] - float(final.group(1))) <= LOSS_REL * out["final_loss"]
    assert abs(out["start_loss"] - float(final.group(2))) <= LOSS_REL * out["start_loss"]


def test_train_lm_spin_shampoo_and_log_json(tmp_path):
    """The twin's SPIN-Shampoo path on the reduced model, from its own
    draws, and the --log-json file the reference writes too."""
    log = tmp_path / "logs.json"
    out = twin("train_lm").main(["--arch", "olmo-1b", "--reduced", "--optimizer",
                                 "spin_shampoo", "--steps", "2", "--batch", "2", "--seq",
                                 "32", "--microbatches", "1", "--log-json", str(log)] + CPU)
    logs = json.loads(log.read_text())
    assert out["steps"] == 2 and [entry["step"] for entry in logs] == [1, 2]
    assert all(np.isfinite(entry["loss"]) for entry in logs)
    assert out["losses"] == [entry["loss"] for entry in logs]
