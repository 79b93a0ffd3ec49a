"""Checkpoints cross between the JAX package and the port.

A `TrainState` saved by the JAX package's `checkpoint.ckpt.save` restores
in the port's `checkpoint.ckpt.restore` with every leaf equal, and the
reverse, for AdamW and SPIN-Shampoo states (whose None factors have no
leaves in either package): one `.npz` keyed by the tree path, bf16 as
uint16 under `BF16:`, and the JSON sidecar.
"""

import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as j_ckpt
from repro.configs import get_arch as j_get_arch
from repro.runtime.trainer import TrainConfig as JTrainConfig
from repro.runtime.trainer import init_state as j_init_state
from repro.runtime.trainer import make_train_step as j_make_train_step
from repro_torch import bridge, tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_arch
from repro_torch.runtime.trainer import TrainConfig, init_state


def _stepped_jax_state(optimizer: str):
    """A reference state one step in, so that no leaf is its init value."""
    cfg = j_get_arch("olmo-1b").reduced()
    tcfg = JTrainConfig(microbatches=1, optimizer=optimizer, warmup=1)
    state = j_init_state(cfg, tcfg, jax.random.PRNGKey(2), 1)
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
             for k in ("labels", "tokens")}
    state, _ = jax.jit(j_make_train_step(cfg, tcfg))(state, batch)
    return state


def _template(optimizer: str):
    cfg = get_arch("olmo-1b").reduced()
    return init_state(cfg, TrainConfig(optimizer=optimizer),
                      torch.Generator().manual_seed(9), "cpu")


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("optimizer", ["adamw", "spin_shampoo"])
def test_a_jax_checkpoint_restores_in_the_port(tmp_path, optimizer):
    jstate = _stepped_jax_state(optimizer)
    j_ckpt.save(str(tmp_path), 1, jstate, extra={"stream": {"seed": 3, "step": 1}})
    assert ckpt.latest_step(str(tmp_path)) == 1
    template = _template(optimizer)
    state, extra = ckpt.restore(str(tmp_path), 1, template)
    assert extra == {"stream": {"seed": 3, "step": 1}}
    assert type(state) is type(template) and type(state.opt) is type(template.opt)
    got, want = tree.leaves(state), jax.tree.leaves(jstate)
    assert len(got) == len(want) > 0
    for g, w, t in zip(got, want, tree.leaves(template)):
        assert g.dtype == t.dtype and g.device == t.device
        assert _same_bits(bridge.to_numpy(g), w)
    assert int(state.step) == 1 and int(state.opt.step) == 1


@pytest.mark.parametrize("optimizer", ["adamw", "spin_shampoo"])
def test_a_port_checkpoint_restores_in_jax(tmp_path, optimizer):
    jstate = _stepped_jax_state(optimizer)
    state = bridge.train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    ckpt.save(str(tmp_path), 1, state, extra={"stream": {"seed": 3, "step": 1}})
    assert not [f for f in os.listdir(tmp_path) if f.startswith("tmp.")]
    template = j_init_state(j_get_arch("olmo-1b").reduced(),
                            JTrainConfig(optimizer=optimizer), jax.random.PRNGKey(5), 1)
    restored, extra = j_ckpt.restore(str(tmp_path), 1, template)
    assert extra["stream"]["step"] == 1
    got, want = jax.tree.leaves(restored), jax.tree.leaves(jstate)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _same_bits(g, w)
    # and back into the port: the round trip keeps every bit
    again, _ = ckpt.restore(str(tmp_path), 1, _template(optimizer))
    for a, b in zip(tree.leaves(again), tree.leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_keys_are_the_reference_paths(tmp_path):
    state = _template("spin_shampoo")
    ckpt.save(str(tmp_path), 0, state)
    with np.load(tmp_path / "step_0" / "leaves.npz") as f:
        keys = set(f.files)
    assert "BF16:.params|embed" in keys
    assert ".opt|.factors|0|.linv" in keys and ".opt|.step" in keys and ".step" in keys
    jkeys = set(j_ckpt._flatten(j_init_state(
        j_get_arch("olmo-1b").reduced(), JTrainConfig(optimizer="spin_shampoo"),
        jax.random.PRNGKey(0), 1)))
    assert keys == jkeys
