"""The port's dense LM serving path against the JAX package, on the CPU.

Weights are the JAX package's `init_params`, carried across bit for bit
by `repro_torch.bridge.lm_params_from_numpy`; inputs are drawn with numpy
from a seed and handed to both packages. On the CPU the port's attention
runs the flash attention kernel's plain version. Logits are held to the
reference's own bound for decode against forward (2e-2,
tests/test_models.py); layer outputs in bf16 to a few bf16 ulps of their
largest entry, since the two frameworks round their f32 sums apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_arch as j_get_arch, list_archs as j_list_archs
from repro.models import attention as j_attention, layers as j_layers
from repro.models import transformer as JT
from repro.models.embedding import embed_lookup as j_embed_lookup
from repro_torch import bridge
from repro_torch.configs import get_arch, list_archs
from repro_torch.models import attention, layers, transformer as T
from repro_torch.models.embedding import embed_lookup

LOGIT_TOL = 2e-2          # tests/test_models.py:66, decode vs forward
BF16_REL = 2.0 ** -6      # two bf16 ulps of the largest entry
B, S, MAX_LEN = 2, 12, 20


def _gqa2(cfg):
    return dataclasses.replace(cfg, n_kv_heads=2)


# name -> (JAX config, port config): reduced granite-8b is MQA (4 heads,
# 1 KV head), reduced olmo-1b MHA with non-parametric LN and tied
# embeddings, and the GQA-2 variant groups 2 query heads a KV head.
MODELS = {
    "granite-8b": (j_get_arch("granite-8b").reduced(), get_arch("granite-8b").reduced()),
    "olmo-1b": (j_get_arch("olmo-1b").reduced(), get_arch("olmo-1b").reduced()),
    "gqa2": (_gqa2(j_get_arch("granite-8b").reduced()),
             _gqa2(get_arch("granite-8b").reduced())),
}


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(_np(x).copy())


def _err(got: torch.Tensor, want) -> float:
    return float((got.float() - _t(want)).abs().max())


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    """The JAX reference's logits and caches for one model, built once."""
    jcfg, cfg = MODELS[request.param]
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), model_size_hint=1)
    params = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng([1, len(request.param)]).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    jlogits, _, _, jcache = JT.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    jc = JT.init_cache(jcfg, B, MAX_LEN)
    jdecode = []
    for t in range(S):
        lg, jc = JT.decode_step(jparams, jc, jnp.asarray(tokens[:, t]), jcfg)
        jdecode.append(lg)
    return dict(name=request.param, jcfg=jcfg, cfg=cfg, jparams=jparams,
                params=params, tokens=tokens, jlogits=jlogits, jcache=jcache,
                jdecode=jdecode)


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------


def test_configs_match_the_reference():
    assert list_archs() == j_list_archs()
    for name in list_archs():
        for port, ref in ((get_arch(name), j_get_arch(name)),
                          (get_arch(name).reduced(), j_get_arch(name).reduced())):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), name
            assert port.param_count() == ref.param_count()


def _shapes(tree, prefix=()):
    """{path: (shape, dtype name)} of a nested dict of arrays or defs."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, prefix + (k,)))
        else:
            dt = v.dtype or layers.PARAM_DTYPE if isinstance(v, layers.ParamDef) else v.dtype
            out[prefix + (k,)] = (tuple(v.shape), str(dt).split(".")[-1])
    return out


@pytest.mark.parametrize("name", list_archs())
def test_param_defs_match_the_reference_at_full_size(name):
    """Every config's tree, key for key and shape for shape, at the default
    model_size_hint (MoE experts padded to a multiple of 16: qwen2-moe's 60
    to 64); the dense configs' counts also equal `param_count`."""
    want = _shapes(JT.abstract_params(j_get_arch(name)))
    assert _shapes(T.param_defs(get_arch(name))) == want
    if get_arch(name).family == "dense":
        assert sum(np.prod(s) for s, _ in want.values()) == pytest.approx(
            get_arch(name).param_count(), rel=1e-3)


def test_init_params_tree_matches_the_reference(model):
    params = T.init_params(model["cfg"], torch.Generator().manual_seed(0), "cpu")
    assert _shapes(params) == _shapes(model["jparams"])
    leaves = [v for v in bridge.lm_params_to_numpy(params)["layers"]["mlp"].values()]
    assert all(float(np.std(np.asarray(x, np.float32))) == pytest.approx(0.02, rel=0.1)
               for x in leaves)


def test_bridge_round_trips_lm_params_bit_for_bit(model):
    back = bridge.lm_params_to_numpy(model["params"])
    flat = jax.tree.leaves(jax.tree.map(np.asarray, model["jparams"]))
    for got, want in zip(jax.tree.leaves(back), flat):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _bf16_pair(*shape, seed, scale=1.0):
    x = jnp.asarray(scale * np.random.default_rng(seed).standard_normal(shape),
                    jnp.float32).astype(jnp.bfloat16)
    return x, bridge.to_torch(np.asarray(x), "cpu")


def _close_bf16(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.bfloat16
    assert _err(got, want) <= BF16_REL * float(np.abs(_np(want)).max())


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norm_apply_matches_the_reference(kind):
    xj, xt = _bf16_pair(2, 5, 64, seed=1, scale=3.0)
    sj, st = _bf16_pair(64, seed=2)
    bj, bt = _bf16_pair(64, seed=3)
    jp = {"rmsnorm": {"scale": sj}, "layernorm": {"scale": sj, "bias": bj},
          "nonparam_ln": {}}[kind]
    tp = {"rmsnorm": {"scale": st}, "layernorm": {"scale": st, "bias": bt},
          "nonparam_ln": {}}[kind]
    _close_bf16(layers.norm_apply(kind, tp, xt), j_layers.norm_apply(kind, jp, xj))
    assert set(layers.norm_params(kind, 64)) == set(j_layers.norm_params(kind, 64))


def test_rotary_matches_the_reference():
    xj, xt = _bf16_pair(2, 7, 4, 16, seed=4)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [5, 9, 100, 2047, 2048, 7, 3]], np.int32)
    want = j_layers.rotary(xj, jnp.asarray(pos), 10000.0)
    _close_bf16(layers.rotary(xt, torch.from_numpy(pos), 10000.0), want)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_mlp_apply_matches_the_reference(activation):
    xj, xt = _bf16_pair(2, 5, 64, seed=5)
    defs = j_layers.mlp_params(64, 128, activation)
    jp = {k: _bf16_pair(*d.shape, seed=6 + i, scale=0.125)[0]
          for i, (k, d) in enumerate(sorted(defs.items()))}
    tp = {k: bridge.to_torch(np.asarray(v), "cpu") for k, v in jp.items()}
    assert set(layers.mlp_params(64, 128, activation)) == set(defs)
    _close_bf16(layers.mlp_apply(tp, xt, activation), j_layers.mlp_apply(jp, xj, activation))


def test_embed_lookup_matches_the_reference():
    ej, et = _bf16_pair(50, 8, seed=9)
    tok = np.random.default_rng(10).integers(0, 50, (3, 7)).astype(np.int32)
    got = embed_lookup(et, torch.from_numpy(tok))
    want = np.asarray(j_embed_lookup(ej, jnp.asarray(tok)))
    np.testing.assert_array_equal(bridge.to_numpy(got).view(np.uint16), want.view(np.uint16))


def _layer0(model, key):
    jlp = jax.tree.map(lambda a: a[0], model["jparams"]["layers"][key])
    return jlp, {k: v[0] for k, v in model["params"]["layers"][key].items()}


def test_attn_apply_matches_the_reference(model):
    jlp, lp = _layer0(model, "attn")
    xj, xt = _bf16_pair(B, 24, model["cfg"].d_model, seed=11)
    want = j_attention.attn_apply(jlp, xj, model["jcfg"], q_chunk=8, kv_chunk=8)
    got, k, v = attention.attn_apply(lp, xt, model["cfg"], want_kv=True)
    _close_bf16(got, want)
    assert torch.equal(attention.attn_apply(lp, xt, model["cfg"]), got)
    assert tuple(k.shape) == tuple(v.shape) == (B, 24, model["cfg"].n_kv_heads,
                                                model["cfg"].head_dim)


@pytest.mark.parametrize("where", ["inside", "at_s_max", "past_s_max"])
def test_attn_decode_matches_the_reference(model, where):
    """pos < S writes slot pos; at pos >= S the reference's one-hot row is
    all zero, so nothing is written and every slot counts as valid."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    jlp, lp = _layer0(model, "attn")
    s_max = 10
    pos = {"inside": [3, 9], "at_s_max": [s_max, 4], "past_s_max": [s_max + 5, 0]}[where]
    pos = np.array(pos, np.int32)
    xj, xt = _bf16_pair(B, 1, cfg.d_model, seed=12)
    kj, kt = _bf16_pair(B, s_max, cfg.n_kv_heads, cfg.head_dim, seed=13)
    vj, vt = _bf16_pair(B, s_max, cfg.n_kv_heads, cfg.head_dim, seed=14)
    want, wk, wv = j_attention.attn_decode(jlp, xj, kj, vj, jnp.asarray(pos), jcfg)
    got, gk, gv = attention.attn_decode(lp, xt, kt, vt, torch.from_numpy(pos), cfg)
    assert gk is kt and gv is vt                      # written in place
    _close_bf16(got, want)
    for g, w, old in ((gk, wk, kj), (gv, wv, vj)):
        # the written row is the port's own k/v projection: one bf16 ulp
        # from the reference's at most; every other slot is untouched.
        np.testing.assert_array_equal(g.float().numpy() != _np(old), _np(w) != _np(old))
        assert _err(g, w) <= BF16_REL * float(np.abs(_np(w)).max())


def test_sliding_window_and_other_families_raise(monkeypatch):
    """What still raises now that every family runs: MoE on a mesh with a
    `model` axis (the expert-parallel path comes with sharding, ROADMAP
    A.2); serving the encoder-only hubert-xlarge; and a training forward on
    the card with a sliding window or at hd 80, where B6-bwd does not take
    them yet. The card's training route (`FlashAttentionFn`) is what the
    mock below sends the CPU tensors to."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import Mesh, set_mesh
    from repro_torch.models import moe
    from repro_torch.tree import leaves

    cfg = get_arch("qwen2-moe-a2.7b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu", 1)
    lp = {k: v[0] for k, v in params["layers"]["moe"].items() if k != "shared"}
    lp["shared"] = {k: v[0] for k, v in params["layers"]["moe"]["shared"].items()}
    x = torch.zeros(1, 4, cfg.d_model, dtype=torch.bfloat16)
    with set_mesh(Mesh([["cpu", "cpu"]], ("data", "model"))):
        with pytest.raises(ValueError, match="ROADMAP A.2"):
            moe.moe_apply(lp, x, cfg)

    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device", "cpu"])

    def on_the_card(q, k, v, *, causal=True, window=0):
        return fa.FlashAttentionFn.apply(q, k, v, causal, window)

    monkeypatch.setattr(attention, "flash_attention", on_the_card)
    cfg = get_arch("hymba-1.5b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu", 1)
    for p in leaves(params):
        p.requires_grad_()
    batch = {"tokens": torch.zeros(1, 16, dtype=torch.int64),
             "labels": torch.zeros(1, 16, dtype=torch.int64)}
    with pytest.raises(ValueError, match="window 32 on the card"):
        T.loss_fn(params, batch, cfg)
    q = torch.zeros(1, 2, 8, 80, requires_grad=True)
    with pytest.raises(ValueError, match="head_dim 80 on the card"):
        on_the_card(q, q, q, causal=False)


def test_lm_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("granite-8b").reduced()
    for call in (lambda: T.init_params(cfg, torch.Generator()),
                 lambda: T.init_cache(cfg, 1, 8),
                 lambda: bridge.lm_params_from_numpy({"w": np.zeros(2, np.float32)}),
                 lambda: serve.main(["--arch", "granite-8b", "--reduced"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# The serving path: forward, prefill, decode
# ---------------------------------------------------------------------------


def test_forward_matches_the_reference(model):
    logits, aux, z, cache = T.forward(model["params"], {"tokens": torch.from_numpy(
        model["tokens"])}, model["cfg"])
    assert cache is None and float(aux) == float(z) == 0.0
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (B, S, model["cfg"].vocab)
    assert _err(logits, model["jlogits"]) < LOGIT_TOL


def test_prefill_matches_the_reference(model):
    cfg = model["cfg"]
    logits, _, _, cache = T.prefill(model["params"], {"tokens": torch.from_numpy(
        model["tokens"])}, cfg)
    assert _err(logits, model["jlogits"]) < LOGIT_TOL
    assert torch.equal(cache["pos"], torch.full((B,), S, dtype=torch.int32))
    for key in ("k", "v"):
        want = model["jcache"][key]
        assert cache[key].dtype == torch.bfloat16
        assert tuple(cache[key].shape) == (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
        assert tuple(cache[key].shape) == tuple(want.shape)
        assert _err(cache[key], want) <= BF16_REL * float(np.abs(_np(want)).max())


def test_decode_step_matches_the_reference(model):
    cfg = model["cfg"]
    cache = T.init_cache(cfg, B, MAX_LEN, "cpu")
    for t in range(S):
        lg, cache = T.decode_step(model["params"], cache,
                                  torch.from_numpy(model["tokens"][:, t]), cfg)
        assert lg.dtype == torch.float32 and tuple(lg.shape) == (B, cfg.vocab)
        assert _err(lg, model["jdecode"][t]) < LOGIT_TOL
        assert _err(lg, model["jlogits"][:, t]) < LOGIT_TOL
    assert torch.equal(cache["pos"], torch.full((B,), S, dtype=torch.int32))


def test_prefill_then_decode_matches_decode_from_scratch(model):
    """Inside the port: the prefill cache, padded to MAX_LEN, continues
    where a token-by-token decode from scratch would be."""
    cfg, params = model["cfg"], model["params"]
    tokens = torch.from_numpy(model["tokens"])
    logits, _, _, cache = T.prefill(params, {"tokens": tokens}, cfg)
    pad = (0, 0, 0, 0, 0, MAX_LEN - S)
    cache = {"k": F.pad(cache["k"], pad), "v": F.pad(cache["v"], pad), "pos": cache["pos"]}
    scratch = T.init_cache(cfg, B, MAX_LEN, "cpu")
    for t in range(S):
        _, scratch = T.decode_step(params, scratch, tokens[:, t], cfg)
    nxt = torch.argmax(logits[:, -1], dim=-1)
    for _ in range(3):
        lg_a, cache = T.decode_step(params, cache, nxt, cfg)
        lg_b, scratch = T.decode_step(params, scratch, nxt, cfg)
        assert float((lg_a - lg_b).abs().max()) < LOGIT_TOL
        nxt = torch.argmax(lg_b, dim=-1)
    assert torch.equal(cache["pos"], scratch["pos"])
