"""The port's MoE, SSM, hybrid, audio and VLM families against the JAX
package, on the CPU, and the twins of the reference's family tests.

Weights are the JAX package's `init_params` (model_size_hint 1), carried
across bit for bit by `repro_torch.bridge.lm_params_from_numpy`; batches
come from the port's `data.synthetic.make_batch` (numpy, seeded) and are
handed to both packages. Logits are held to the reference's own bound for
decode against forward (2e-2, tests/test_models.py); caches in bf16 and
the f32 SSM state (computed from bf16 activations) to 2e-2 of the largest
entry.

MoE's forward and prefill are held to the reference's prefill run op by
op (`jax.disable_jit`). Under jit, XLA fuses the reference's bf16 adds
and norms and rounds them apart from its own op-by-op run; at one token
of the reduced qwen2-moe that moves a router near-tie to another expert
in layer 1, and that token's logits then differ by 0.025 where every
other token's are within 0.004 (the port follows the op-by-op rounding to
1e-3). The loss (a mean over every token) and the one-token decode steps
are held to the jitted reference. On the card, `chip_smoke.py` counts
such route flips and holds the tokens whose routes agree.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_arch as j_get_arch
from repro.models import transformer as JT
from repro.models.attention import _attend_chunked, _kv_band
from repro_torch import bridge, tree
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import TokenStream, make_batch
from repro_torch.kernels.flash_attention.ref import attention_mask, attention_ref
from repro_torch.models import transformer as T
from repro_torch.runtime.trainer import TrainConfig, Trainer, init_state
from repro_torch.serving import Request, ServingEngine

LOGIT_TOL = 2e-2          # tests/test_models.py:66, decode vs forward
CACHE_RTOL = 2e-2
B = 2
FAMILIES = {"moe": "qwen2-moe-a2.7b", "ssm": "mamba2-130m", "hybrid": "hymba-1.5b",
            "audio": "hubert-xlarge", "vlm": "phi-3-vision-4.2b"}
DECODING = [f for f in FAMILIES if f != "audio"]   # hubert is encoder-only
SEQ = 32                  # a multiple of the reduced SSD chunk (16); VLM: 8 patches + 24 tokens
DECODE_STEPS = 6


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _abs_err(got: torch.Tensor, want) -> float:
    return float(np.abs(got.detach().float().numpy() - _np(want)).max())


def _rel(got: torch.Tensor, want) -> float:
    return _abs_err(got, want) / max(float(np.abs(_np(want)).max()), 1e-30)


def _to_jax(batch: dict) -> dict:
    out = {}
    for k, v in batch.items():
        a = bridge.to_numpy(v)
        out[k] = jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
    return out


def _reference_prefill(jparams, jbatch, jcfg):
    """The reference's prefill, op by op for MoE (see the module docstring)."""
    if jcfg.family != "moe":
        return JT.prefill(jparams, jbatch, jcfg)
    with jax.disable_jit():
        return JT.prefill(jparams, jbatch, jcfg)


@pytest.fixture(scope="module", params=list(FAMILIES))
def fam(request):
    """One reduced family: both packages' params, a batch, the reference's
    forward, prefill, loss and greedy decode, computed once."""
    name = FAMILIES[request.param]
    jcfg, cfg = j_get_arch(name).reduced(), get_arch(name).reduced()
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), model_size_hint=1)
    params = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    batch = make_batch(cfg, B, SEQ, np.random.default_rng([5, len(name)]), "train", "cpu")
    if "labels" in batch:
        batch["labels"][:, :2] = -1                      # some labels carry no loss
    jbatch = _to_jax(batch)
    out = dict(name=name, jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
               batch=batch, jbatch=jbatch)
    out["jprefill"] = _reference_prefill(jparams, jbatch, jcfg)
    out["jloss"] = JT.loss_fn(jparams, jbatch, jcfg)
    if cfg.decode_capable:
        step = jax.jit(lambda p, c, t: JT.decode_step(p, c, t, jcfg))
        toks = np.asarray(jbatch["tokens"])
        jc = JT.init_cache(jcfg, B, 64)
        out["jdecode"] = []
        for t in range(DECODE_STEPS):
            lg, jc = step(jparams, jc, jnp.asarray(toks[:, t]))
            out["jdecode"].append(lg)
        # decode from the reference's prefill cache, one step
        nxt = jnp.argmax(out["jprefill"][0][:, -1], axis=-1)
        out["jnext"] = np.array(nxt)
        out["jfrom_prefill"] = step(jparams, _pad_j(out["jprefill"][3], jcfg), nxt)[0]
    return out


def _pad_j(cache: dict, jcfg, extra: int = 8) -> dict:
    """The reference's prefill cache with room for `extra` more tokens."""
    pad = ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))
    return {k: jnp.pad(v, pad) if k in ("k", "v") else v for k, v in cache.items()}


# ---------------------------------------------------------------------------
# Each family, reduced, against the reference
# ---------------------------------------------------------------------------


def test_forward_matches_the_reference(fam):
    logits, aux, z, cache = T.forward(fam["params"], fam["batch"], fam["cfg"])
    jlogits, jaux, jz, _ = fam["jprefill"]
    assert cache is None and logits.dtype == torch.float32
    assert tuple(logits.shape) == tuple(jlogits.shape)
    assert _abs_err(logits, jlogits) < LOGIT_TOL
    assert abs(float(aux) - float(jaux)) <= 1e-2 * max(abs(float(jaux)), 1e-6)
    assert abs(float(z) - float(jz)) <= 1e-2 * max(abs(float(jz)), 1e-6)
    if fam["cfg"].moe is None:
        assert float(aux) == float(z) == 0.0


def test_prefill_matches_the_reference(fam):
    cfg = fam["cfg"]
    logits, _, _, cache = T.prefill(fam["params"], fam["batch"], cfg)
    jlogits, _, _, jcache = fam["jprefill"]
    assert _abs_err(logits, jlogits) < LOGIT_TOL
    assert sorted(cache) == sorted(jcache)
    s = jlogits.shape[1]
    assert torch.equal(cache["pos"], torch.full((B,), s, dtype=torch.int32))
    for key in set(cache) - {"pos"}:
        want = jcache[key]
        assert tuple(cache[key].shape) == tuple(want.shape), key
        assert str(cache[key].dtype).split(".")[-1] == str(want.dtype), key
        assert _rel(cache[key], want) <= CACHE_RTOL, (key, _rel(cache[key], want))


def test_loss_fn_matches_the_reference(fam):
    loss, metrics = T.loss_fn(fam["params"], fam["batch"], fam["cfg"])
    jloss, jmetrics = fam["jloss"]
    assert abs(float(loss) - float(jloss)) <= 2e-3 * abs(float(jloss))
    assert float(metrics["tokens"]) == float(jmetrics["tokens"])
    for k in ("ce", "aux", "z"):
        assert abs(float(metrics[k]) - float(jmetrics[k])) <= \
            1e-2 * max(abs(float(jmetrics[k])), 1e-6), k


@pytest.mark.parametrize("fam", DECODING, indirect=True)
def test_decode_step_matches_the_reference(fam):
    cfg = fam["cfg"]
    cache = T.init_cache(cfg, B, 64, "cpu")
    for t in range(DECODE_STEPS):
        lg, cache = T.decode_step(fam["params"], cache, fam["batch"]["tokens"][:, t], cfg)
        assert lg.dtype == torch.float32 and tuple(lg.shape) == (B, cfg.vocab)
        assert _abs_err(lg, fam["jdecode"][t]) < LOGIT_TOL
    assert torch.equal(cache["pos"], torch.full((B,), DECODE_STEPS, dtype=torch.int32))


@pytest.mark.parametrize("fam", DECODING, indirect=True)
def test_decode_from_the_reference_prefill_cache(fam):
    """The reference's prefill cache (k, v, ssm_h, ssm_conv, pos), carried
    across by `bridge.lm_cache_from_numpy`, feeds the port's decode_step."""
    cfg = fam["cfg"]
    jcache = _pad_j(fam["jprefill"][3], fam["jcfg"])
    cache = bridge.lm_cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    back = bridge.lm_cache_to_numpy(cache)
    for k, v in jcache.items():
        np.testing.assert_array_equal(np.asarray(back[k]).view(np.uint8),
                                      np.asarray(v).view(np.uint8))
    lg, cache = T.decode_step(fam["params"], cache,
                              torch.from_numpy(fam["jnext"]).long(), cfg)
    assert _abs_err(lg, fam["jfrom_prefill"]) < LOGIT_TOL


def test_bridge_round_trips_the_family_params_bit_for_bit(fam):
    back = bridge.lm_params_to_numpy(fam["params"])
    want = jax.tree.leaves(jax.tree.map(np.asarray, fam["jparams"]))
    got = jax.tree.leaves(back)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    if fam["cfg"].moe is not None:
        assert fam["params"]["layers"]["moe"]["router"].dtype == torch.float32


def test_init_params_tree_matches_the_reference(fam):
    params = T.init_params(fam["cfg"], torch.Generator().manual_seed(0), "cpu", 1)
    got = jax.tree_util.tree_flatten_with_path(bridge.lm_params_to_numpy(params))[0]
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, fam["jparams"]))[0]
    assert [(jax.tree_util.keystr(p), a.shape, a.dtype) for p, a in got] == \
        [(jax.tree_util.keystr(p), a.shape, a.dtype) for p, a in want]


# ---------------------------------------------------------------------------
# The sliding window: the plain attention against the reference's scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (True, 5), (True, 40),
                                           (True, 64), (True, 1), (False, 0)])
def test_attention_ref_window_matches_attend_chunked(causal, window):
    rng = np.random.default_rng(window + causal)
    b, s, h, kv, hd = 2, 64, 8, 2, 16
    q, k, v = (rng.standard_normal((b, s, n, hd)).astype(np.float32) for n in (h, kv, kv))
    want = _attend_chunked(*map(jnp.asarray, (q, k, v)), causal=causal, window=window,
                           q_chunk=16, kv_chunk=16)
    got = attention_ref(*(torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)),
                        causal=causal, window=window).transpose(1, 2)
    assert _abs_err(got, want) <= 2e-5


@pytest.mark.parametrize("qi,qc,kc,nkv,causal,window", [
    (3, 16, 16, 8, True, 0), (3, 16, 16, 8, True, 16), (3, 16, 16, 8, False, 0),
    (5, 16, 16, 8, True, 40), (7, 8, 16, 4, True, 3), (2, 32, 16, 8, True, 17)])
def test_window_mask_lives_inside_the_reference_band(qi, qc, kc, nkv, causal, window):
    """The reference's `_kv_band` cases: for q chunk qi, every key the mask
    keeps lies in the band's kv chunks, and each chunk of the band holds a
    kept key. The kernels walk the same band (from its first tile)."""
    start, end = _kv_band(qi, qc, kc, nkv, causal, window)
    mask = attention_mask(nkv * kc, nkv * kc, causal, window, "cpu")
    if mask is None:
        mask = torch.ones(nkv * kc, nkv * kc, dtype=torch.bool)
    rows = mask[qi * qc:(qi + 1) * qc].reshape(qc, nkv, kc).any(dim=(0, 2))
    assert rows.nonzero().flatten().tolist() == list(range(start, end))


def test_window_without_causal_raises():
    z = torch.zeros(1, 2, 8, 16)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    with pytest.raises(ValueError, match="causal"):
        flash_attention(z, z, z, causal=False, window=4)


# ---------------------------------------------------------------------------
# Twins of the reference's family tests (the port alone)
# ---------------------------------------------------------------------------


def _port(name: str):
    cfg = get_arch(name).reduced()
    jparams = JT.init_params(j_get_arch(name).reduced(), jax.random.PRNGKey(0),
                             model_size_hint=1)
    return cfg, bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("name", ["mamba2-130m", "hymba-1.5b", "dbrx-132b"])
def test_decode_matches_forward(name):
    """Twin of tests/test_models.py::test_decode_matches_forward."""
    cfg, params = _port(name)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, 16)))
    full = T.forward(params, {"tokens": tokens}, cfg, remat=False)[0]
    cache = T.init_cache(cfg, B, 64, "cpu")
    errs = []
    for t in range(16):
        lg, cache = T.decode_step(params, cache, tokens[:, t], cfg)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < LOGIT_TOL, (name, max(errs))


def test_swa_rolling_cache_wraparound():
    """Twin of tests/test_models_extra.py::test_swa_rolling_cache_wraparound:
    decode past the window matches the windowed forward; the ring buffer's
    slots are overwritten, not masked out."""
    cfg, params = _port("hymba-1.5b")
    assert cfg.sliding_window == 32
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (1, 48)))
    full = T.forward(params, {"tokens": tokens}, cfg, remat=False)[0]
    cache = T.init_cache(cfg, 1, 64, "cpu")
    assert cache["k"].shape[2] == 32                     # ring buffer = window
    errs = []
    for t in range(48):
        lg, cache = T.decode_step(params, cache, tokens[:, t], cfg)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < LOGIT_TOL, max(errs)


@pytest.mark.parametrize("name", ["olmo-1b", "mamba2-130m", "hymba-1.5b"])
def test_prefill_cache_feeds_decode(name):
    """Twin of tests/test_models_extra.py::test_prefill_cache_feeds_decode:
    prefill, its k and v padded, then decode continues where a decode from
    scratch would be (hymba's 20-slot cache rolls, as init_cache's does)."""
    cfg, params = _port(name)
    s, max_len = 16, 20
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, s)))
    logits_p, _, _, cache_p = T.prefill(params, {"tokens": tokens}, cfg)
    pad = (0, 0, 0, 0, 0, max_len - s)
    cache = {k: F.pad(v, pad) if k in ("k", "v") else v for k, v in cache_p.items()}
    nxt = torch.argmax(logits_p[:, -1], dim=-1)
    lg_a, _ = T.decode_step(params, cache, nxt, cfg)
    cache_b = T.init_cache(cfg, B, max_len, "cpu")
    for t in range(s):
        _, cache_b = T.decode_step(params, cache_b, tokens[:, t], cfg)
    lg_b, _ = T.decode_step(params, cache_b, nxt, cfg)
    assert float((lg_a - lg_b).abs().max()) < LOGIT_TOL


def test_vlm_loss_masks_image_prefix():
    """Twin of tests/test_models.py::test_vlm_loss_masks_image_prefix: the
    image prefix carries no labels, so the tokens counted are the text's."""
    cfg, params = _port("phi-3-vision-4.2b")
    batch = make_batch(cfg, 2, 24, np.random.default_rng(1), "train", "cpu")
    assert tuple(batch["patch_embeds"].shape) == (2, cfg.n_frontend_tokens, cfg.d_model)
    assert tuple(batch["tokens"].shape) == (2, 24 - cfg.n_frontend_tokens)
    loss, metrics = T.loss_fn(params, batch, cfg)
    assert torch.isfinite(loss)
    assert float(metrics["tokens"]) == batch["labels"].numel()


def test_audio_loss_scores_masked_frames_only():
    cfg, params = _port("hubert-xlarge")
    batch = make_batch(cfg, 2, 40, np.random.default_rng(2), "train", "cpu")
    assert batch["mask"].dtype == torch.bool and 0 < int(batch["mask"].sum()) < 80
    _, metrics = T.loss_fn(params, batch, cfg)
    assert float(metrics["tokens"]) == float(batch["mask"].sum())


@pytest.mark.parametrize("name", ["olmo-1b", "dbrx-132b", "mamba2-130m", "hymba-1.5b",
                                  "hubert-xlarge", "phi-3-vision-4.2b"])
def test_end_to_end_two_steps(name):
    """Twin of tests/test_system.py::test_end_to_end_two_steps: every
    family trains two full steps (data -> loss -> grads -> AdamW -> new
    params) with 2 microbatches, without NaNs and with changing masters;
    the MoE losses reach the step's metrics."""
    cfg = get_arch(name).reduced()
    tcfg = TrainConfig(microbatches=2, total_steps=100, warmup=1)
    state = init_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu", 1)
    masters0 = [m.clone() for m in tree.leaves(state.opt.master)]
    tr = Trainer(cfg, tcfg, TokenStream(cfg, 4, 32, seed=0, device="cpu"))
    state, logs = tr.run(state, 2, log_every=0)
    assert all(np.isfinite(log["loss"]) for log in logs)
    assert all((log["aux"] > 0) == (cfg.moe is not None) for log in logs)
    changed = sum(not torch.equal(a, b)
                  for a, b in zip(masters0, tree.leaves(state.opt.master)))
    assert changed > len(masters0) // 2


# ---------------------------------------------------------------------------
# The engine on the SSM and hybrid families
# ---------------------------------------------------------------------------


def _solo(cfg, params, prompt, n_new, max_len=64):
    """Greedy decode of one request alone, from a fresh cache."""
    cache = T.init_cache(cfg, 1, max_len, "cpu")
    for t in prompt:
        logits, cache = T.decode_step(params, cache, torch.tensor([t]), cfg)
    out = []
    for _ in range(n_new):
        out.append(int(torch.argmax(logits[0])))
        logits, cache = T.decode_step(params, cache, torch.tensor([out[-1]]), cfg)
    return out


@pytest.mark.parametrize("name", ["mamba2-130m", "hymba-1.5b"])
def test_engine_zeroes_the_ssm_state_on_admit(name):
    """Three requests through one slot: each later occupant starts from a
    zero SSM state and gets what it gets alone from scratch."""
    cfg, params = _port(name)
    eng = ServingEngine(cfg, params, slots=1, max_len=64)
    reqs = [Request(uid=i, prompt=[3 + i, 8, 5 + 2 * i], max_new_tokens=5) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.tick()
    assert float(eng.cache["ssm_h"].abs().max()) > 0
    eng._reset_slot(0)
    assert float(eng.cache["ssm_h"].abs().max()) == 0.0
    assert float(eng.cache["ssm_conv"].abs().max()) == 0.0
    eng = ServingEngine(cfg, params, slots=1, max_len=64)
    for r in reqs:
        r.output, r.done = [], False
        eng.submit(r)
    eng.run_until_done()
    for r in reqs:
        assert r.output == _solo(cfg, params, r.prompt, 5), r.uid


def test_engine_refuses_an_encoder_only_config():
    cfg = get_arch("hubert-xlarge").reduced()
    with pytest.raises(ValueError, match="no decode step"):
        ServingEngine(cfg, {}, slots=1)
