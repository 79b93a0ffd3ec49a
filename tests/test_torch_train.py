"""The port's training path against the JAX package, on the CPU, and the
twins of tests/test_trainer_checkpoint.py.

Weights and optimizer states are the JAX package's, carried across by
`repro_torch.bridge`; batches are drawn with numpy and handed to both
packages. The trainer twins run the port alone: restart equivalence is
bitwise, torch to torch.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import transformer as JT
from repro.optim import SpinShampooConfig as JSpinShampooConfig
from repro.runtime.trainer import TrainConfig as JTrainConfig
from repro.runtime.trainer import init_state as j_init_state
from repro.runtime.trainer import make_train_step as j_make_train_step
from repro_torch import bridge, tree
from repro_torch.checkpoint.ckpt import (async_save, latest_step, list_steps,
                                         restore, save)
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import TokenStream, host_shard, make_batch
from repro_torch.models import transformer as T
from repro_torch.optim import SpinShampooConfig
from repro_torch.runtime.trainer import TrainConfig, Trainer, init_state, make_train_step

ARCHS = ["olmo-1b", "granite-8b"]   # reduced: MHA, tied head / MQA, untied


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _batch(cfg, b: int, s: int, seed: int):
    """One numpy batch, as int32 for JAX and int64 tensors for the port;
    some labels are -1 (masked)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[:, :3] = -1
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    return jb, tb


def _requiring_grad(params: dict) -> tuple[dict, list]:
    flat = [p.detach().requires_grad_() for p in tree.leaves(params)]
    return tree.unflatten(params, flat), flat


def _rel_err(got: torch.Tensor, want) -> float:
    w = _f32(want)
    return float(np.abs(got.detach().float().numpy() - w).max()) / max(
        float(np.abs(w).max()), 1e-30)


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, cfg = j_get_arch(request.param).reduced(), get_arch(request.param).reduced()
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), model_size_hint=1)
    params = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jb, tb = _batch(cfg, 2, 32, 3)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, jcfg, remat=True), has_aux=True)(jparams)
    return dict(cfg=cfg, params=params, tb=tb, jloss=jloss, jmetrics=jmetrics,
                jgrads=jgrads)


def _loss_and_grads(model, **kw):
    params, flat = _requiring_grad(model["params"])
    loss, metrics = T.loss_fn(params, model["tb"], model["cfg"], **kw)
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def test_loss_fn_and_gradients_match_the_reference(model):
    loss, metrics, grads = _loss_and_grads(model)
    # f32 loss over bf16 activations: the two frameworks round the layers'
    # bf16 outputs at the same places but sum in another order.
    assert abs(float(loss) - float(model["jloss"])) <= 2e-3 * abs(float(model["jloss"]))
    for k in ("ce", "aux", "z", "tokens"):
        assert abs(float(metrics[k]) - float(model["jmetrics"][k])) <= \
            2e-3 * max(abs(float(model["jmetrics"][k])), 1e-6), k
    assert float(metrics["tokens"]) == 2 * (32 - 3)
    # bf16 gradients through 2 layers: each rounding that flips by one ulp
    # carries on; 2^-5 (8 bf16 ulps) of each leaf's largest entry.
    want = jax.tree.leaves(model["jgrads"])
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16
        assert _rel_err(g, w) <= 2.0 ** -5, _rel_err(g, w)


def test_remat_choices_give_the_same_gradients(model):
    """remat off, full and dots recompute the same bf16 operations on the
    CPU, so the gradients agree bit for bit."""
    _, _, base = _loss_and_grads(model, remat=False)
    for remat, policy in ((True, "full"), (True, "dots")):
        loss, _, grads = _loss_and_grads(model, remat=remat, remat_policy=policy)
        for a, b in zip(base, grads):
            assert torch.equal(a, b), (remat, policy)
    with pytest.raises(ValueError, match="remat_policy"):
        _loss_and_grads(model, remat_policy="offload")


def test_loss_fn_without_grad_takes_the_inference_path(model):
    loss, _ = T.loss_fn(model["params"], model["tb"], model["cfg"])
    assert not loss.requires_grad
    assert abs(float(loss) - float(model["jloss"])) <= 2e-3 * abs(float(model["jloss"]))


# ---------------------------------------------------------------------------
# One train step against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["adamw", "spin_shampoo"])
def test_train_step_matches_the_reference(optimizer):
    """microbatches=2. SPIN-Shampoo at damping 0.1, where the two packages'
    f32 inverses agree to 1e-5 (tests/test_torch_optim.py)."""
    jcfg, cfg = j_get_arch("olmo-1b").reduced(), get_arch("olmo-1b").reduced()
    jtcfg = JTrainConfig(microbatches=2, optimizer=optimizer, warmup=2, total_steps=100,
                         shampoo=JSpinShampooConfig(damping=0.1))
    tcfg = TrainConfig(microbatches=2, optimizer=optimizer, warmup=2, total_steps=100,
                       shampoo=SpinShampooConfig(damping=0.1))
    jstate = j_init_state(jcfg, jtcfg, jax.random.PRNGKey(0), 1)
    state = bridge.train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(j_make_train_step(jcfg, jtcfg))
    step = make_train_step(cfg, tcfg)
    for i in range(2):                          # lr_scale 0, then 0.5
        jb, tb = _batch(cfg, 4, 32, 20 + i)
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        assert int(state.step) == int(jstate.step) == i + 1
        assert m["lr_scale"] == pytest.approx(float(jm["lr_scale"]), rel=1e-6)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 2e-3 * float(jm["loss"])
        # the norm of bf16 gradients that agree to 2^-5 of each leaf's max
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-2 * float(jm["grad_norm"])
        # new bf16 params: master - lr·direction, lr ≤ 1.5e-4 (AdamW) or
        # 5e-4: the directions' differences move them by less than an ulp
        # mostly; 2 bf16 ulps of each leaf's largest entry.
        for g, w in zip(tree.leaves(state.params), jax.tree.leaves(jstate.params)):
            assert g.dtype == torch.bfloat16
            assert _rel_err(g, w) <= 2.0 ** -7, _rel_err(g, w)


# ---------------------------------------------------------------------------
# Twins of tests/test_trainer_checkpoint.py (the port alone)
# ---------------------------------------------------------------------------


def _tiny():
    cfg = get_arch("olmo-1b").reduced()
    tcfg = TrainConfig(microbatches=2, total_steps=100, warmup=2)
    return cfg, tcfg


def _gen(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _stream(cfg, seed=7, **kw) -> TokenStream:
    return TokenStream(cfg, 4, 32, seed=seed, device="cpu", **kw)


def test_restart_equivalence():
    """kill-after-2-steps + restore must equal an uninterrupted 4-step run,
    bit for bit."""
    cfg, tcfg = _tiny()
    with tempfile.TemporaryDirectory() as d:
        s_ref = init_state(cfg, tcfg, _gen(), "cpu")
        tr = Trainer(cfg, tcfg, _stream(cfg))
        s_ref, _ = tr.run(s_ref, 4, log_every=0)

        s = init_state(cfg, tcfg, _gen(), "cpu")
        tr1 = Trainer(cfg, tcfg, _stream(cfg), ckpt_dir=d, ckpt_every=2)
        s, _ = tr1.run(s, 2, log_every=0)
        del s  # "crash"

        s2 = init_state(cfg, tcfg, _gen(), "cpu")
        tr2 = Trainer(cfg, tcfg, _stream(cfg), ckpt_dir=d, ckpt_every=100)
        s2 = tr2.maybe_restore(s2)
        assert int(s2.step) == 2
        assert tr2.stream.step == 2            # data position restored
        s2, _ = tr2.run(s2, 2, log_every=0)

        for a, b in zip(tree.leaves(s_ref), tree.leaves(s2)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_loss_decreases_on_memorizable_data():
    cfg, tcfg = _tiny()
    tcfg = dataclasses.replace(tcfg, warmup=1,
                               adamw=dataclasses.replace(tcfg.adamw, lr=3e-3))

    class FixedStream(TokenStream):
        def next(self):                        # the same batch every step
            return make_batch(self.cfg, self.batch, self.seq,
                              np.random.default_rng(123), "train", "cpu")

        def state_dict(self):
            return {"seed": 0, "step": 0}

    s = init_state(cfg, tcfg, _gen(), "cpu")
    tr = Trainer(cfg, tcfg, FixedStream(cfg, 4, 32, device="cpu"))
    s, logs = tr.run(s, 30, log_every=0)
    assert logs[-1]["loss"] < logs[0]["loss"] - 0.5, \
        f"{logs[0]['loss']} -> {logs[-1]['loss']}"


def test_checkpoint_atomicity_and_bf16():
    state = {"w": torch.ones((4, 4), dtype=torch.bfloat16) * 1.5,
             "n": torch.arange(3, dtype=torch.int32),
             "s": torch.tensor(2.5, dtype=torch.float32)}
    with tempfile.TemporaryDirectory() as d:
        save(d, 10, state, extra={"stream": {"seed": 1, "step": 10}})
        save(d, 20, state)
        assert list_steps(d) == [10, 20]
        assert latest_step(d) == 20
        got, extra = restore(d, 10, state)
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"], state["w"])
        assert torch.equal(got["n"], state["n"]) and got["s"].shape == ()
        assert extra["stream"]["step"] == 10
        # no tmp dirs left behind
        assert not [f for f in os.listdir(d) if f.startswith("tmp.")]


def test_stream_determinism_and_restore(monkeypatch):
    cfg, _ = _tiny()
    s1 = TokenStream(cfg, 4, 32, seed=3, device="cpu")
    batches = [s1.next() for _ in range(3)]
    s2 = TokenStream(cfg, 4, 32, seed=3, device="cpu")
    s2.load_state_dict({"seed": 3, "step": 2})
    b2 = s2.next()
    assert torch.equal(b2["tokens"], batches[2]["tokens"])
    assert not torch.equal(batches[0]["tokens"], batches[1]["tokens"])
    assert sorted(b2) == ["labels", "tokens"] and b2["tokens"].shape == (4, 32)
    assert int(b2["tokens"].max()) < cfg.vocab and int(b2["tokens"].min()) >= 0
    half = host_shard(b2, 1, 2)
    assert torch.equal(half["labels"], b2["labels"][2:])
    # the card is the default, and a box without one raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TokenStream(cfg, 4, 32).next()


def test_straggler_watchdog_flags_slow_steps():
    cfg, tcfg = _tiny()
    tr = Trainer(cfg, tcfg, _stream(cfg))
    tr._watch(1.0, 1)
    for i in range(5):
        tr._watch(1.0, i + 2)
    tr._watch(10.0, 99)                       # 10x slower than EWMA
    assert tr.straggler_events and tr.straggler_events[-1]["step"] == 99


def test_spin_shampoo_trains():
    cfg, _ = _tiny()
    tcfg = TrainConfig(microbatches=2, optimizer="spin_shampoo",
                       total_steps=100, warmup=2)
    s = init_state(cfg, tcfg, _gen(), "cpu")
    tr = Trainer(cfg, tcfg, _stream(cfg, seed=1))
    s, logs = tr.run(s, 3, log_every=0)
    assert all(np.isfinite(l["loss"]) for l in logs)
    # factor state exists for matrix params
    n_factors = sum(f is not None for f in s.opt.factors)
    assert n_factors > 0


def test_async_save_overlaps_and_persists():
    state = {"w": torch.arange(16.0).reshape(4, 4)}
    with tempfile.TemporaryDirectory() as d:
        t = async_save(d, 3, state)
        state["w"].add_(1)                    # the snapshot was taken already
        t.join(timeout=30)
        assert not t.is_alive()
        assert latest_step(d) == 3
        got, _ = restore(d, 3, state)
        assert torch.equal(got["w"], torch.arange(16.0).reshape(4, 4))


def test_train_launcher_cuts_the_depth(tmp_path, monkeypatch):
    """`--layers N` trains the config's first N layers at full width (the
    depth cut of the configs whose AdamW state does not fit one card), and
    refuses a depth the config does not have."""
    from repro_torch.launch import train

    monkeypatch.setenv("SPIN_PLAN_CACHE", str(tmp_path / "plans.json"))
    args = ["--arch", "hymba-1.5b", "--reduced", "--device", "cpu", "--steps", "1",
            "--batch", "2", "--seq", "32", "--microbatches", "1"]
    out = train.main(args + ["--layers", "1"])
    assert out["layers"] == 1 and out["steps"] == 1 and np.isfinite(out["loss"])
    with pytest.raises(ValueError, match="--layers 3"):
        train.main(args + ["--layers", "3"])


def test_profile_lm_cuts_the_depth_of_a_training_trace_only():
    from repro_torch import profile_lm

    with pytest.raises(SystemExit):
        profile_lm.main(["--arch", "hymba-1.5b", "--layers", "2"])   # no --train


def test_profile_lm_times_training_steps_only():
    from repro_torch import profile_lm

    with pytest.raises(SystemExit):
        profile_lm.main(["--arch", "hubert-xlarge", "--steps", "4"])   # no --train


def test_launchers_smoke(tmp_path):
    """The CLI launchers run end to end on reduced configs on the CPU."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
               SPIN_PLAN_CACHE=str(tmp_path / "plans.json"))
    for extra in ([], ["--optimizer", "spin_shampoo", "--ckpt-dir",
                       str(tmp_path / "ck"), "--ckpt-every", "3"]):
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "olmo-1b",
             "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
             "--seq", "32", "--microbatches", "1", *extra],
            capture_output=True, text=True, timeout=300, env=env)
        assert r.returncode == 0, r.stderr[-500:]
        assert "done: step 3" in r.stdout
    assert list_steps(str(tmp_path / "ck")) == [3]
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "granite-8b",
         "--reduced", "--device", "cpu", "--batch", "2", "--steps", "4"],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-500:]
    assert "tok/s" in r.stdout
    # the production mesh, laid over the CPU
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "olmo-1b",
         "--reduced", "--device", "cpu", "--steps", "1", "--mesh", "single"],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-500:]
    assert "done: step 1" in r.stdout
