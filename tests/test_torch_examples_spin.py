"""The SPIN examples' PyTorch twins (`examples_torch/`) against the JAX
examples (`examples/`), on the CPU.

Each JAX example runs once, in a child process (`JAX_PLATFORMS=cpu`;
invert_at_scale.py fakes its own 16 devices), at a small size; the
children start together and run while this process drives the twins. The
test rebuilds the reference's inputs here from the same `jax.random` keys
and hands them to the twin as numpy through `main(inputs=...)`, so both
see the same bits. The twin is held to the child's printed numbers and
to the JAX functions called here on the same inputs.

Tolerances:
- residuals: at most `verify.residual_tolerance(f32)` (1e-3), and within
  RESID_FACTOR of the reference's printed residual (two frameworks round
  in another order; the residual is a few ulps either way);
- inverses and solutions: within CLOSE (1e-4) of the largest entry of the
  JAX function's result, `tests/test_torch_spin.py`'s and
  `test_torch_solve.py`'s bound at κ ≈ 10;
- a number printed with `:.2e` (three digits): within PRINTED (1e-2)
  relative;
- op counts, update splits, batch counts and the roofline's flops and
  bytes: equal.

The reference's `--sharded` paths raise under jax 0.9.0 (`AbstractMesh
does not implement devices`), so the twins' sharded runs are held to the
reference's dense run and to the port's own dense twin.
"""

import functools
import importlib.util
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

from repro.core import BlockMatrix as JBlockMatrix
from repro.core import newton_schulz_polish as j_newton_schulz_polish
from repro.core import spin_inverse as j_spin_inverse
from repro.core import spin_inverse_dense as j_spin_inverse_dense
from repro.core import spin_solve as j_spin_solve
from repro.core import testing as j_testing
from repro.core.costmodel import tpu_roofline_cost
from repro_torch.core import LEAF_SOLVERS, verify
from repro_torch.core.multiply import ENGINES

ROOT = Path(__file__).resolve().parents[1]
TOL = verify.residual_tolerance(torch.float32)
RESID_FACTOR = 10.0
CLOSE = 1e-4
PRINTED = 1e-2

QS = ["--n", "256", "--block", "64"]
RIDGE = ["--samples", "1024", "--features", "256", "--block", "64"]
RIDGE_SOLVE = RIDGE + ["--multi-target", "4"]
RIDGE_INV = RIDGE + ["--inverse"]
SCALE = ["--n", "256", "--block", "64"]
SERVE = ["--samples", "512", "--features", "128", "--requests", "8", "--block", "32"]
REF_RUNS = {"quickstart": ("quickstart", QS),
            "ridge_solve": ("ridge_regression", RIDGE_SOLVE),
            "ridge_inverse": ("ridge_regression", RIDGE_INV),
            "invert_at_scale": ("invert_at_scale", SCALE + ["--engine", "ring"]),
            "serve_inverse": ("serve_inverse", SERVE)}
CPU = ["--device", "cpu"]


@functools.cache
def twin(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX examples' stdout, by run name; the children run while the
    tests drive the twins."""
    plans = tmp_path_factory.mktemp("ref_plans") / "plans.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "SPIN_PLAN_CACHE": str(plans)}
    env.pop("XLA_FLAGS", None)
    children = {
        run: subprocess.Popen([sys.executable, f"examples/{script}.py", *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT)
        for run, (script, args) in REF_RUNS.items()}
    outs = {}

    def result(run: str) -> str:
        if run not in outs:
            out, err = children[run].communicate(timeout=600)
            assert children[run].returncode == 0, err[-4000:]
            outs[run] = out
        return outs[run]

    yield result
    for child in children.values():
        if child.poll() is None:
            child.kill()
        child.communicate()


@pytest.fixture(autouse=True)
def _plans(tmp_path, monkeypatch):
    monkeypatch.setenv("SPIN_PLAN_CACHE", str(tmp_path / "plans.json"))


def _num(pattern: str, text: str) -> float:
    m = re.search(pattern, text)
    assert m, (pattern, text)
    return float(m.group(1))


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got: torch.Tensor, want) -> float:
    want = _np(want)
    return float(np.abs(got.detach().numpy() - want).max() / np.abs(want).max())


def _same_residual(got: float, printed: float) -> None:
    assert got <= TOL and printed <= TOL
    assert printed / RESID_FACTOR <= got <= printed * RESID_FACTOR, (got, printed)


def _printed_equal(got: float, printed: float) -> None:
    assert abs(got - printed) <= PRINTED * abs(printed), (got, printed)


# ---------------------------------------------------------------------------
# The reference's inputs, from its own keys
# ---------------------------------------------------------------------------


@functools.cache
def spd_256():
    """make_spd(256, PRNGKey(0)) and its JAX inverse at bs 64, linalg leaf."""
    a = j_testing.make_spd(256, jax.random.PRNGKey(0))
    return np.asarray(a), j_spin_inverse_dense(a, 64, "linalg")


def ridge_inputs(samples: int, features: int, targets: int) -> dict:
    kx, kw, kn = jax.random.split(jax.random.PRNGKey(0), 3)
    x = jax.random.normal(kx, (samples, features)) / features ** 0.5
    w_true = jax.random.normal(kw, (features, targets))
    noise = jax.random.normal(kn, (samples, targets))
    return {"x": np.asarray(x), "w_true": np.asarray(w_true), "noise": np.asarray(noise)}


def serve_inputs(samples: int, n: int, requests: int, rank: int, every: int) -> dict:
    kx, kw = jax.random.split(jax.random.PRNGKey(0))
    x = jax.random.normal(kx, (samples, n)) / n ** 0.5
    noise, xk = [], []
    for i in range(requests):
        ky, kb = jax.random.split(jax.random.PRNGKey(10 + i))
        noise.append(np.asarray(jax.random.normal(ky, (samples,))))
        if (i + 1) % every == 0:
            xk.append(np.asarray(jax.random.normal(kb, (rank, n)) / n ** 0.5))
    return {"x": np.asarray(x), "w_true": np.asarray(jax.random.normal(kw, (n,))),
            "noise": np.stack(noise), "xk": np.stack(xk)}


# ---------------------------------------------------------------------------
# quickstart.py
# ---------------------------------------------------------------------------


def test_quickstart_matches_the_reference(ref):
    a, want = spd_256()
    out = twin("quickstart").main(QS + CPU, inputs={"a": a})
    text = ref("quickstart")
    _same_residual(out["residual"], _num(r"\|\|AX-I\|\|/sqrt\(n\) = (\S+)", text))
    assert out["multiplies"] == _num(r"multiplies: (\d+)", text) == 18
    assert out["leaf_inversions"] == _num(r"leaf inversions: (\d+)", text) == 4
    _same_residual(out["polished_residual"],
                   _num(r"Newton–Schulz sweep: (\S+)", text))
    assert _close(out["inverse"], want) < CLOSE
    assert out["speedup"] > 0 and out["lu_ms"] > 0


def test_quickstart_planner_branch():
    """The packages' planners measure on different backends, so the plan
    may differ from the reference's: a valid plan and the residual bound."""
    a, _ = spd_256()
    out = twin("quickstart").main(["--n", "256"] + CPU, inputs={"a": a})
    plan, grid = out["plan"], 256 // out["block"]
    assert 256 % out["block"] == 0 and grid & (grid - 1) == 0
    assert plan["leaf_solver"] in LEAF_SOLVERS and plan["multiply_engine"] in ENGINES
    assert out["leaf"] == plan["leaf_solver"]
    assert out["residual"] <= TOL and out["polished_residual"] <= TOL
    want = verify.expected_spin_counts(grid)
    assert (out["multiplies"], out["leaf_inversions"]) == (want.multiplies,
                                                          want.leaf_inversions)


def test_quickstart_draws_its_own_matrix_without_inputs():
    out = twin("quickstart").main(["--n", "128", "--block", "32"] + CPU)
    assert out["residual"] <= TOL and (out["multiplies"], out["leaf_inversions"]) == (18, 4)


# ---------------------------------------------------------------------------
# ridge_regression.py
# ---------------------------------------------------------------------------


def _ridge_reference(inputs: dict, inverse: bool):
    x, w_true, noise = (jnp.asarray(inputs[k]) for k in ("x", "w_true", "noise"))
    y = x @ w_true + 0.01 * noise
    gram = x.T @ x + 1e-2 * jnp.eye(x.shape[1])
    rhs = x.T @ y
    a = JBlockMatrix.from_dense(gram, 64)
    if inverse:
        inv = j_newton_schulz_polish(a, j_spin_inverse(a), sweeps=1)
        return inv.to_dense() @ rhs
    return j_spin_solve(a, rhs)


@pytest.mark.parametrize("run,args,targets", [
    pytest.param("ridge_solve", RIDGE_SOLVE, 4, id="solve-4-targets"),
    pytest.param("ridge_inverse", RIDGE_INV, 1, id="inverse")])
def test_ridge_regression_matches_the_reference(ref, run, args, targets):
    inputs = ridge_inputs(1024, 256, targets)
    out = twin("ridge_regression").main(args + CPU, inputs=inputs)
    text = ref(run)
    assert f"targets={targets} [{out['mode']}]" in text
    _same_residual(out["residual"], _num(r"normal-eq residual=(\S+)", text))
    _printed_equal(out["rel"], _num(r"\|\|w-w\*\|\|/\|\|w\*\|\|=(\S+)", text))
    assert tuple(out["w_hat"].shape) == (256, targets)
    assert _close(out["w_hat"], _ridge_reference(inputs, run == "ridge_inverse")) < CLOSE


def test_ridge_regression_planner_branch():
    out = twin("ridge_regression").main(RIDGE[:4] + CPU, inputs=ridge_inputs(1024, 256, 1))
    assert 256 % out["block"] == 0 and out["plan"]["block_size"] == out["block"]
    assert out["residual"] < 1e-3


# ---------------------------------------------------------------------------
# invert_at_scale.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["ring", "allgather", "cuda", "einsum", "pallas"])
def test_invert_at_scale_matches_the_reference(ref, engine):
    """Every engine's dense run against the reference's ring run on the
    same matrix ("pallas", the reference's name, runs the port's cuda)."""
    a, want = spd_256()
    out = twin("invert_at_scale").main(SCALE + ["--engine", engine] + CPU,
                                       inputs={"a": a})
    text = ref("invert_at_scale")
    assert "grid=4x4 on mesh {'data': 4, 'model': 4}" in text
    assert (out["grid"], out["mesh"], out["path"]) == (4, {"data": 4, "model": 4}, "dense")
    assert out["engine"] == ("cuda" if engine == "pallas" else engine)
    _same_residual(out["residual"], _num(r"inverted in \d+ ms  residual (\S+)", text))
    assert _close(out["inverse"], want) < CLOSE


@pytest.mark.parametrize("engine", ["cuda", "ring", "allgather"])
def test_invert_at_scale_sharded_against_the_dense_runs(ref, engine):
    """The reference's --sharded run raises under jax 0.9.0: the twin's
    mesh-resident run is held to the reference's dense run and the twin's
    own dense run on the same matrix."""
    a, want = spd_256()
    sharded = twin("invert_at_scale").main(SCALE + ["--engine", engine, "--sharded"] + CPU,
                                           inputs={"a": a})
    dense = twin("invert_at_scale").main(SCALE + ["--engine", engine] + CPU,
                                         inputs={"a": a})
    assert sharded["path"] == "sharded"
    _same_residual(sharded["residual"],
                   _num(r"inverted in \d+ ms  residual (\S+)", ref("invert_at_scale")))
    assert _close(sharded["inverse"], want) < CLOSE
    assert _close(sharded["inverse"], dense["inverse"].numpy()) < CLOSE


def test_invert_at_scale_roofline_counts_the_reference_work():
    """Same formulas, other hardware: flops and bytes equal the reference's
    `tpu_roofline_cost`, the times are the H100's."""
    a, _ = spd_256()
    out = twin("invert_at_scale").main(SCALE + ["--engine", "einsum"] + CPU,
                                       inputs={"a": a})
    assert [(r["n"], r["b"], r["chips"]) for r in out["rooflines"]] == [
        (2 ** 17, 16, 256), (2 ** 18, 16, 256)]
    for r in out["rooflines"]:
        want = tpu_roofline_cost(n=r["n"], b=r["b"], chips=r["chips"])
        for key in ("flops", "bytes_hbm", "bytes_ici"):
            assert r[key] == want[key], key
        assert r["bottleneck"] in ("compute", "memory", "collective")


def test_invert_at_scale_planner_branch():
    a, _ = spd_256()
    out = twin("invert_at_scale").main(["--n", "256"] + CPU, inputs={"a": a})
    assert out["plan"]["block_size"] == out["block"] and out["engine"] in ENGINES
    assert out["residual"] <= TOL


# ---------------------------------------------------------------------------
# serve_inverse.py
# ---------------------------------------------------------------------------


def _serve_numbers(text: str) -> dict:
    m = re.search(r"updates: (\d+) SMW folds, (\d+) re-factorizations "
                  r"\(pending rank (\d+)", text)
    assert m, text
    b = re.search(r"(\d+) batches, (\d+) coalesced cols", text)
    return {"smw": int(m.group(1)), "refactorizations": int(m.group(2)),
            "pending_rank": int(m.group(3)), "batches": int(b.group(1)),
            "coalesced_cols": int(b.group(2)),
            "residual": _num(r"normal-eq residual = (\S+)", text),
            "rel": _num(r"\|\|w-w\*\|\|/\|\|w\*\|\| = (\S+)", text)}


@functools.cache
def serve_case():
    return serve_inputs(512, 128, 8, 8, 4)


def test_serve_inverse_matches_the_reference(ref):
    out = twin("serve_inverse").main(SERVE + CPU, inputs=serve_case())
    want = _serve_numbers(ref("serve_inverse"))
    assert out["placement"] == "dense" and out["updates"] == 2
    for key in ("smw", "refactorizations", "pending_rank", "batches", "coalesced_cols"):
        assert out[key] == want[key], key
    assert (out["smw"], out["refactorizations"]) == (2, 0)
    _same_residual(out["residual"], want["residual"])
    _printed_equal(out["rel"], want["rel"])


def test_serve_inverse_sharded_against_the_dense_runs(ref):
    """The reference's --sharded run raises under jax 0.9.0 (and with fewer
    than 8 devices it would serve from a (1, 1) mesh): the twin's 4×2 run
    is held to the reference's dense run and the twin's dense run."""
    sharded = twin("serve_inverse").main(SERVE + ["--sharded"] + CPU, inputs=serve_case())
    dense = twin("serve_inverse").main(SERVE + CPU, inputs=serve_case())
    want = _serve_numbers(ref("serve_inverse"))
    assert sharded["placement"] == "sharded"
    for key in ("smw", "refactorizations", "pending_rank", "batches", "coalesced_cols"):
        assert sharded[key] == want[key] == dense[key], key
    _same_residual(sharded["residual"], want["residual"])
    _printed_equal(sharded["rel"], want["rel"])
    assert _close(sharded["w_hat"], dense["w_hat"].numpy()) < CLOSE


def test_serve_inverse_updates_off_and_drawn_inputs():
    """--update-every 0 streams solves only; without inputs the twin draws
    its own data."""
    out = twin("serve_inverse").main(SERVE + ["--update-every", "0"] + CPU)
    assert (out["updates"], out["smw"], out["refactorizations"]) == (0, 0, 0)
    assert out["residual"] < 1e-2
