"""Gradients through the port's attention, against the JAX package.

On the CPU the port's attention is the flash kernel's plain version,
which autograd differentiates; its gradients (w.r.t. x, wq, wk, wv and
wo) are held to `jax.grad` of the reference's `attn_apply`, weights
carried across by `repro_torch.bridge`, inputs drawn with numpy. The
plain backward `attention_bwd_ref` is held to `jax.grad` of the JAX
package's `attention_ref`.

The plain version of the tensor-core backward's arithmetic,
`attention_bwd_rounded_ref` (P and dS rounded to the operand dtype), is
held to `jax.grad` of the same reference in bf16 and f16. Both are also
held, with a sliding window at S above it (hymba's band) and at hd 80
(hubert's head dim), to `jax.vjp` of the reference's chunked scan
`_attend_chunked`, whose gradient the JAX package's models take.

The `cuda`-marked tests need the card: `FlashAttentionFn` (B6 with its
log-sum-exp, then the B6-bwd kernels) against `attention_bwd_ref` and, in
bf16 and f16, against `attention_bwd_rounded_ref` 4x tighter, also with
a window and at hd 80, and `attn_apply`'s weight gradients on the card
against the plain path. They
need no JAX, so the file imports it only where it is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_attention_grad.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge, kernels
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import kernel as fa, ref as fa_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import attention, transformer as T

try:  # the card's machine has no JAX; the parity tests skip there
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as j_get_arch
    from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
    from repro.models import attention as j_attention, transformer as JT
    from repro.models.attention import _attend_chunked as j_attend_chunked
except ImportError:
    jax = None

ARCHS = ["olmo-1b", "granite-8b"]   # reduced: MHA (4/4 heads) and MQA (4/1)


@pytest.fixture
def ref():
    if jax is None:
        pytest.skip("needs the JAX package (the reference)")


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(got: torch.Tensor, want) -> float:
    return float(np.abs(got.detach().float().numpy() - _f32(want)).max())


# ---------------------------------------------------------------------------
# CPU: the port's gradients against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 1), (6, 2)])
def test_attention_bwd_ref_matches_jax_grad(ref, h, kv, causal):
    rng = np.random.default_rng([h, kv, causal])
    q = rng.standard_normal((2, h, 13, 16), dtype=np.float32)
    k = rng.standard_normal((2, kv, 13, 16), dtype=np.float32)
    v = rng.standard_normal((2, kv, 13, 16), dtype=np.float32)
    do = rng.standard_normal((2, h, 13, 16), dtype=np.float32)
    _, vjp = jax.vjp(lambda a, b, c: j_attention_ref(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = fa_ref.attention_bwd_ref(*(torch.from_numpy(t) for t in (q, k, v, do)),
                                   causal=causal)
    # f32 both sides: summation order only (13 keys, hd 16).
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _err(g, w) <= 1e-5 * max(1.0, float(np.abs(_f32(w)).max()))
    # the wrapper's CPU path is the plain version, bit for bit
    again = fa.flash_attention_bwd_cuda(*(torch.from_numpy(t) for t in (q, k, v)),
                                        None, torch.from_numpy(do), causal=causal)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


# The tensor-core backward's arithmetic (P and dS rounded to the operand
# dtype before their products) against jax.grad of the reference's f32
# softmax on the same rounded inputs, relative to each gradient's largest
# entry: the card tests' tolerance (`_BWD_TOL`), bf16 keeping 8 mantissa
# bits and f16 11.
_ROUNDED_TOL = {"bfloat16": 2e-2, "float16": 1e-2}


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 1), (6, 2)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_attention_bwd_rounded_ref_matches_jax_grad(ref, dtype, h, kv, causal, hd):
    rng = np.random.default_rng([h, kv, causal, hd])
    jdt = jnp.dtype(dtype)
    q, k, v, do = (jnp.asarray(rng.standard_normal(shape, dtype=np.float32), jdt)
                   for shape in ((2, h, 13, hd), (2, kv, 13, hd), (2, kv, 13, hd),
                                 (2, h, 13, hd)))
    _, vjp = jax.vjp(lambda a, b, c: j_attention_ref(a, b, c, causal=causal), q, k, v)
    want = vjp(do)
    got = fa_ref.attention_bwd_rounded_ref(
        *(bridge.to_torch(np.asarray(t), "cpu") for t in (q, k, v, do)), causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        scale = float(np.abs(_f32(w)).max())
        assert _err(g, w) <= _ROUNDED_TOL[dtype] * scale, (_err(g, w), scale)


# (H, KV, hd, causal, window) at S 96: hymba's GQA group of 5 under a
# window of 32 (so the band masks keys, as the reduced configs' S 32 never
# does) at hd 16 and at its own hd 64; hubert's hd 80, bidirectional, and
# hd 80 under a window.
_BAND_CASES = [(5, 1, 16, True, 32), (5, 1, 64, True, 32), (4, 4, 80, False, 0),
               (4, 2, 80, True, 40)]
_BAND_S = 96


def _chunked_vjp(q, k, v, do, causal: bool, window: int) -> list:
    """jax.vjp of the reference's `_attend_chunked` (16-row q and kv chunks,
    its (B, S, H, hd) layout) at numpy f32 (B, H, S, hd) inputs: (dq, dk,
    dv) as numpy f32 (B, H, S, hd)."""
    t = lambda x: jnp.asarray(np.swapaxes(x, 1, 2))
    _, vjp = jax.vjp(lambda a, b, c: j_attend_chunked(a, b, c, causal=causal, window=window,
                                                      q_chunk=16, kv_chunk=16),
                     t(q), t(k), t(v))
    return [np.swapaxes(_f32(g), 1, 2) for g in vjp(t(do))]


def _band_inputs(h, kv, hd, window, seed=0):
    rng = np.random.default_rng([h, kv, hd, window, seed])
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((2, h, _BAND_S, hd), (2, kv, _BAND_S, hd), (2, kv, _BAND_S, hd),
                          (2, h, _BAND_S, hd))]


@pytest.mark.parametrize("h,kv,hd,causal,window", _BAND_CASES)
def test_attention_bwd_ref_with_a_window_and_at_hd80_matches_jax_grad(ref, h, kv, hd, causal,
                                                                      window):
    q, k, v, do = _band_inputs(h, kv, hd, window)
    want = _chunked_vjp(q, k, v, do, causal, window)
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    got = fa_ref.attention_bwd_ref(tq, tk, tv, tdo, causal=causal, window=window)
    # f32 both sides: summation order only (96 keys, the scan's 16-key chunks).
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        scale = float(np.abs(w).max())
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * max(1.0, scale)
    # the rounded version is the exact gradient in f32, and the wrapper's
    # CPU path is the plain version, bit for bit
    rounded = fa_ref.attention_bwd_rounded_ref(tq, tk, tv, tdo, causal=causal, window=window)
    again = fa.flash_attention_bwd_cuda(tq, tk, tv, None, tdo, causal=causal, window=window)
    for g, r, a in zip(got, rounded, again):
        assert float((g - r).abs().max()) <= 1e-5 * float(g.abs().max())
        assert torch.equal(g, a)
    if window:  # at this S the band masks keys: the gradient is not the causal one
        causal_only = fa_ref.attention_bwd_ref(tq, tk, tv, tdo, causal=True)
        assert float((got[0] - causal_only[0]).abs().max()) > 1e-2 * float(got[0].abs().max())


@pytest.mark.parametrize("h,kv,hd,causal,window", _BAND_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_attention_bwd_rounded_ref_with_a_window_and_at_hd80_matches_jax_grad(
        ref, dtype, h, kv, hd, causal, window):
    """The tensor-core arithmetic under the band against the reference's
    exact f32 gradient on the same rounded inputs, `_ROUNDED_TOL`."""
    jdt = jnp.dtype(dtype)
    rounded_in = [np.asarray(jnp.asarray(t, jdt)) for t in _band_inputs(h, kv, hd, window, 1)]
    want = _chunked_vjp(*(t.astype(np.float32) for t in rounded_in), causal, window)
    got = fa_ref.attention_bwd_rounded_ref(
        *(bridge.to_torch(t, "cpu") for t in rounded_in), causal=causal, window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= _ROUNDED_TOL[dtype] * scale, (err, scale)


def test_rounded_ref_is_the_exact_gradient_in_f32():
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(shape, generator=g) for shape in
                   ((2, 6, 13, 16), (2, 2, 13, 16), (2, 2, 13, 16), (2, 6, 13, 16)))
    for causal in (True, False):
        for a, b in zip(fa_ref.attention_bwd_rounded_ref(q, k, v, do, causal=causal),
                        fa_ref.attention_bwd_ref(q, k, v, do, causal=causal)):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_tma_rule_of_the_wrappers():
    """`_tma_ok`: a 16-byte aligned base and 16-byte strides on B, H, S
    (an axis of extent 1 is never stepped); `_check_tma` applies it to bf16
    and f16 operands only."""
    x = torch.zeros(2, 3, 5, 16, dtype=torch.bfloat16)
    assert fa._tma_ok(x) and fa._tma_ok(x.transpose(1, 2))
    shifted = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(x.shape)
    assert not fa._tma_ok(shifted)
    narrow = torch.zeros(2, 3, 5, 20, dtype=torch.bfloat16)[..., :16]
    assert not fa._tma_ok(narrow)                       # rows 40 bytes apart
    assert fa._tma_ok(torch.zeros(1, 1, 1, 24, dtype=torch.bfloat16)[..., :16])
    with pytest.raises(ValueError, match="TMA"):
        fa._check_tma(("dout", shifted))
    fa._check_tma(("dout", shifted.float()))            # f32 runs FFMA: no rule


# The reduced configs' changes for the families' layers: hymba at S 96,
# above its reduced window of 32 (at S <= 32 the window masks nothing), and
# hubert at its own head dim, 80 (the reduced configs set 16).
_ATTN_SEQ = {"hymba-1.5b": 96}
_ATTN_HEAD_DIM = {"hubert-xlarge": 80}


@pytest.mark.parametrize("arch,kv", [("olmo-1b", None), ("granite-8b", None),
                                     ("granite-8b", 2),     # MHA, MQA, GQA (2 a group)
                                     ("hymba-1.5b", None),  # the window, a group of 4
                                     ("hubert-xlarge", None)])  # hd 80, bidirectional
def test_attn_apply_gradients_match_jax(ref, arch, kv):
    jcfg, cfg = j_get_arch(arch).reduced(), get_arch(arch).reduced()
    if kv:
        jcfg = dataclasses.replace(jcfg, n_kv_heads=kv)
        cfg = dataclasses.replace(cfg, n_kv_heads=kv)
    if arch in _ATTN_HEAD_DIM:
        jcfg = dataclasses.replace(jcfg, head_dim=_ATTN_HEAD_DIM[arch])
        cfg = dataclasses.replace(cfg, head_dim=_ATTN_HEAD_DIM[arch])
    seq = _ATTN_SEQ.get(arch, 24)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(4), model_size_hint=1)
    jlp = jax.tree.map(lambda a: np.asarray(a[0]), jparams["layers"]["attn"])
    rng = np.random.default_rng([7, len(arch)])
    x = rng.standard_normal((2, seq, cfg.d_model), dtype=np.float32)
    ct = rng.standard_normal((2, seq, cfg.d_model), dtype=np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    ctj = jnp.asarray(ct, jnp.bfloat16)

    def j_loss(xx, p):
        out = j_attention.attn_apply(p, xx, jcfg, q_chunk=8, kv_chunk=8)
        return jnp.sum(out.astype(jnp.float32) * ctj.astype(jnp.float32))

    jgx, jgp = jax.grad(j_loss, argnums=(0, 1))(
        xj, jax.tree.map(jnp.asarray, jlp))

    lp = {n: bridge.to_torch(w, "cpu").requires_grad_() for n, w in jlp.items()}
    xt = bridge.to_torch(np.asarray(xj), "cpu").requires_grad_()
    out = attention.attn_apply(lp, xt, cfg)
    loss = (out.float() * bridge.to_torch(np.asarray(ctj), "cpu").float()).sum()
    names = sorted(lp)
    grads = torch.autograd.grad(loss, [xt] + [lp[n] for n in names])
    # bf16 gradients: both frameworks round the projections, the rotary and
    # the attention output to bf16 at the same places but sum in f32 in
    # another order, so a rounding may flip by one ulp and carry on; hold
    # each gradient to 4 bf16 ulps (2^-6 relative) of its largest entry.
    for got, want, name in zip(grads, [jgx] + [jgp[n] for n in names], ["x"] + names):
        assert got.dtype == torch.bfloat16, name
        scale = float(np.abs(_f32(want)).max())
        assert scale > 0, name
        assert _err(got, want) <= 2.0 ** -6 * scale, (name, _err(got, want), scale)


# ---------------------------------------------------------------------------
# The card: FlashAttentionFn (B6 + B6-bwd) against the plain backward
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# Relative to the largest entry of each gradient. f32: summation order
# only (the plain version sums P·dO over every key at once, the kernel a
# tile at a time). bf16 / f16: each gradient rounds once to 8 / 11
# mantissa bits, and the kernel's D = rowsum(dO o O) reads the rounded O,
# the forward's tolerance (tests/test_flash_attention.py).
_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 1e-2}
# Against `attention_bwd_rounded_ref` on the forward's own output, the
# tensor-core kernels' arithmetic, 4x tighter: the kernel's one rounding of
# each gradient (half a bf16 ulp is at most 2^-8 of the largest entry) and
# f32 sums in another order, so that a layout fault smaller than
# `_BWD_TOL` shows.
_ROUNDED_CARD_TOL = {dtype: tol / 4 for dtype, tol in _BWD_TOL.items()}


def _qkv_do(b, h, kv, sq, skv, hd, dtype, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, sq, h, hd, generator=g).to(device, dtype).transpose(1, 2)
    k = torch.randn(b, skv, kv, hd, generator=g).to(device, dtype).transpose(1, 2)
    v = torch.randn(b, skv, kv, hd, generator=g).to(device, dtype).transpose(1, 2)
    do = torch.randn(b, sq, h, hd, generator=g).to(device, dtype).transpose(1, 2)
    return q, k, v, do


def _rel_err(got, want, scale_of=None) -> float:
    """Largest |got - want| relative to the largest entry of `scale_of`
    (default `want`), or absolute where that is zero."""
    ref = want if scale_of is None else scale_of
    scale = float(ref.float().abs().max()) or 1.0
    return float((got.float() - want.float()).abs().max()) / scale


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("h,kv,sq,skv,hd,layout", [
    (4, 4, 200, 200, 64, "model"), (8, 2, 130, 130, 128, "model"),
    (6, 1, 77, 130, 32, "model"), (4, 2, 130, 77, 16, "model"),
    (2, 2, 1, 1, 160, "model"), (4, 4, 64, 64, 96, "model"),
    (8, 8, 300, 300, 96, "model"),       # phi-3-vision's head dim over several tiles, ragged
    (8, 2, 300, 300, 128, "model"),      # a GQA group of 4, S not a multiple of 128
    (4, 2, 200, 200, 160, "model"),
    (16, 16, 300, 300, 80, "model"),     # hubert's head dim: the 32-byte swizzle, 5 chunks
    (4, 2, 77, 130, 80, "model"),
    (4, 2, 130, 130, 64, "hd_major")])   # autograd hands dout with hd strided
def test_flash_attention_fn_gradients_match_plain(cuda_device, h, kv, sq, skv, hd, layout,
                                                  dtype, causal):
    q, k, v, do = _qkv_do(2, h, kv, sq, skv, hd, dtype, sq * hd + h, cuda_device)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    kernels.reset_launch_counts()
    out = fa.FlashAttentionFn.apply(*leaves, causal)
    if layout == "model":
        got = torch.autograd.grad(out, leaves, do)
    else:  # the loss reads out as (B, H, hd, S): its gradient comes back so
        got = torch.autograd.grad(out.transpose(2, 3), leaves,
                                  do.transpose(2, 3).contiguous())
    assert kernels.launch_counts()["flash_attention"] == 1
    assert kernels.launch_counts()["flash_attention_bwd"] == 1
    assert torch.equal(out, fa.flash_attention_cuda(q, k, v, causal=causal))
    want = fa_ref.attention_bwd_ref(q, k, v, do, causal=causal)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape and g.stride() == t.stride()
        assert bool(torch.isfinite(g.float()).all())
        assert _rel_err(g, w) <= _BWD_TOL[dtype], _rel_err(g, w)
    if dtype != torch.float32:
        rounded = fa_ref.attention_bwd_rounded_ref(q, k, v, do, causal=causal,
                                                   out=out.detach())
        # relative to the exact gradient's scale: where P o (dP - D) cancels
        # to rounding noise (one key a query), the rounded version's own
        # largest entry is that noise
        for g, r, w in zip(got, rounded, want):
            assert _rel_err(g, r, w) <= _ROUNDED_CARD_TOL[dtype], _rel_err(g, r, w)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("s", [2048, 2000, 300])        # whole tiles, ragged at the band's end
@pytest.mark.parametrize("window", [16, 200, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_attention_fn_window_gradients_match_plain(cuda_device, dtype, window, s, hd):
    """The sliding window in the backward (hymba's attention): the dQ
    kernels start at the band's first kv tile, the dK/dV kernels stop at the
    last query that sees the kv tile, both mask the band's far edge; a GQA
    group of 5, as hymba's (H 25, KV 5)."""
    q, k, v, do = _qkv_do(1, 10, 2, s, s, hd, dtype, s + window + hd, cuda_device)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    kernels.reset_launch_counts()
    out = fa.FlashAttentionFn.apply(*leaves, True, window)
    got = torch.autograd.grad(out, leaves, do)
    assert kernels.launch_counts()["flash_attention"] == 1
    assert kernels.launch_counts()["flash_attention_bwd"] == 1
    assert torch.equal(out, fa.flash_attention_cuda(q, k, v, causal=True, window=window))
    want = fa_ref.attention_bwd_ref(q, k, v, do, causal=True, window=window)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape and g.stride() == t.stride()
        assert bool(torch.isfinite(g.float()).all())
        assert _rel_err(g, w) <= _BWD_TOL[dtype], _rel_err(g, w)
    if dtype != torch.float32:
        rounded = fa_ref.attention_bwd_rounded_ref(q, k, v, do, causal=True, window=window,
                                                   out=out.detach())
        for g, r, w in zip(got, rounded, want):
            assert _rel_err(g, r, w) <= _ROUNDED_CARD_TOL[dtype], _rel_err(g, r, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("h,kv,hd,causal,window", [(25, 5, 64, True, 1024),   # hymba's layer
                                                   (16, 16, 80, False, 0),    # hubert's
                                                   (32, 32, 96, True, 0)])    # phi-3-vision's
def test_flash_attention_bwd_repeats_its_bits_at_the_family_layers(cuda_device, h, kv, hd,
                                                                   causal, window, dtype):
    q, k, v, do = _qkv_do(2, h, kv, 2048, 2048, hd, dtype, 11, cuda_device)
    out, lse = fa._forward(q, k, v, causal, want_lse=True, window=window)
    first = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse, causal=causal, window=window)
    for _ in range(2):
        again = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse, causal=causal,
                                            window=window)
        for a, b in zip(first, again):
            assert torch.equal(a, b)   # one summation order, no atomics


@pytest.mark.cuda
def test_the_backward_runs_as_the_autograd_threads_first_cuda_work(cuda_device):
    """A backward whose first launch is B6-bwd runs on PyTorch's autograd
    worker thread before that thread has bound the device's context; the
    tensor maps must still encode (they were refused, CUDA error 1, before
    `encode_tiled` bound the context). A fresh process, so that the thread
    is new."""
    code = (
        "import sys, torch; sys.path.insert(0, 'src')\n"
        "from repro_torch.kernels.flash_attention import kernel as fa, ref as fa_ref\n"
        "g = torch.Generator().manual_seed(0)\n"
        "q, k, v, do = (torch.randn(2, n, 300, 64, generator=g).cuda().bfloat16()\n"
        "               for n in (10, 2, 2, 10))\n"
        "leaves = [t.detach().requires_grad_() for t in (q, k, v)]\n"
        "got = torch.autograd.grad(fa.FlashAttentionFn.apply(*leaves, True, 16), leaves, do)\n"
        "want = fa_ref.attention_bwd_ref(q, k, v, do, causal=True, window=16)\n"
        "print(max(float((a.float() - b.float()).abs().max() / b.float().abs().max())\n"
        "          for a, b in zip(got, want)))\n")
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    assert float(run.stdout.split()[-1]) <= _BWD_TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("h,kv", [(8, 2), (32, 8)])   # the second: granite-8b's layer
def test_flash_attention_bwd_is_deterministic_and_checks_its_inputs(cuda_device, h, kv,
                                                                    dtype):
    q, k, v, do = _qkv_do(2, h, kv, 300, 300, 128, dtype, 3, cuda_device)
    out, lse = fa._forward(q, k, v, True, want_lse=True)
    first = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse)
    for _ in range(2):
        again = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse)
        for a, b in zip(first, again):
            assert torch.equal(a, b)   # one summation order, no atomics
    with pytest.raises(ValueError, match="log-sum-exp"):
        fa.flash_attention_bwd_cuda(q, k, v, out, do, None)
    with pytest.raises(ValueError, match="head_dim"):
        q48, k48, v48, do48 = _qkv_do(1, 2, 2, 64, 64, 48, torch.bfloat16, 0, cuda_device)
        fa.flash_attention_bwd_cuda(q48, k48, v48, q48, do48,
                                    torch.zeros(1, 2, 64, device=cuda_device))
    # the log-sum-exp is each row's, in natural-log units
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(h // kv, 1)) * 128 ** -0.5
    s = s.masked_fill(torch.ones(300, 300, dtype=torch.bool,
                                 device=cuda_device).triu(1), float("-inf"))
    assert float((lse - torch.logsumexp(s, -1)).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_misaligned_dout_is_copied_by_the_function_or_refused_by_the_wrapper(cuda_device):
    q, k, v, do = _qkv_do(2, 4, 2, 130, 130, 64, torch.bfloat16, 6, cuda_device)
    # the same values at a base 2 bytes past a 16-byte boundary
    bad = torch.empty(do.numel() + 1, dtype=do.dtype, device=cuda_device)[1:].view(do.shape)
    bad.copy_(do)
    assert bad.data_ptr() % 16
    out, lse = fa._forward(q, k, v, True, want_lse=True)
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention_bwd_cuda(q, k, v, out, bad, lse)
    want = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fa.FlashAttentionFn.apply(*leaves, True), leaves, bad)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("hd", fa.BWD_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tensor_core_backward_keeps_its_registers(cuda_device, dtype, hd, window):
    # The consumers grow to 240 registers by setmaxnreg; hd 160 takes
    # 32-row query tiles in the dK/dV kernel so that dK and dV fit; hd 80
    # (five 32-byte chunks a row) and the sliding-window builds spill none.
    attrs = fa.flash_attention_bwd_attributes(dtype, hd, window=window)
    assert [a["kernel"] for a in attrs.values()] == ["flash_bwd_dkdv_tc", "flash_bwd_dq_tc"]
    for a in attrs.values():
        assert a["local_bytes"] == 0 and a["dynamic_smem"] <= 232448, attrs


@pytest.mark.cuda
def test_ops_route_through_the_autograd_function_only_when_grad_is_needed(cuda_device):
    q, k, v, _ = _qkv_do(1, 4, 2, 64, 64, 64, torch.bfloat16, 1, cuda_device)
    kernels.reset_launch_counts()
    plain = flash_attention(q, k, v)
    assert plain.grad_fn is None
    qg = q.detach().requires_grad_()
    out = flash_attention(qg, k, v)
    assert isinstance(out.grad_fn, torch.autograd.function.BackwardCFunction)
    assert torch.equal(out, plain)
    with torch.no_grad():
        assert flash_attention(qg, k, v).grad_fn is None
    assert kernels.launch_counts()["flash_attention"] == 3
    assert kernels.launch_counts()["flash_attention_bwd"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_attn_apply_weight_gradients_on_the_card(cuda_device, arch):
    """The C2 repro: on the card a backward through attn_apply gives wq, wk
    and wv their gradients through attention, equal to the plain path's."""
    cfg = get_arch(arch).reduced()
    lp = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")["layers"]["attn"]
    lp = {name: w[0] for name, w in lp.items()}
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 100, cfg.d_model, generator=g).to(torch.bfloat16)
    ct = torch.randn(2, 100, cfg.d_model, generator=g).to(torch.bfloat16)

    def grads(device):
        p = {n: w.to(device).requires_grad_() for n, w in lp.items()}
        xx = x.to(device).requires_grad_()
        out = attention.attn_apply(p, xx, cfg)
        names = sorted(p)
        return dict(zip(["x"] + names, torch.autograd.grad(
            out, [xx] + [p[n] for n in names], ct.to(device))))

    want = grads("cpu")                      # attention_ref, autograd
    kernels.reset_launch_counts()
    got = grads(cuda_device)
    assert kernels.launch_counts()["flash_attention"] == 1
    assert kernels.launch_counts()["flash_attention_bwd"] == 1
    for name in ("x", "wq", "wk", "wv", "wo"):
        gw, ww = got[name].cpu().float(), want[name].float()
        assert float(gw.abs().max()) > 0, name
        # bf16 gradients two roundings apart (kernel and plain version)
        assert float((gw - ww).abs().max()) <= 2e-2 * float(ww.abs().max()), name


@pytest.mark.cuda
def test_training_forward_keeps_the_serving_logits(cuda_device):
    cfg = get_arch("olmo-1b").reduced()
    params = T.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(3)).to(cuda_device)
    served, *_ = T.forward(params, {"tokens": tokens}, cfg)
    kernels.reset_launch_counts()
    for remat in (False, True):
        trained = T.forward(_requiring_grad(params), {"tokens": tokens}, cfg,
                            remat=remat)[0]
        assert trained.requires_grad
        assert torch.equal(served, trained.detach())
    assert kernels.launch_counts()["flash_attention"] == 2 * cfg.n_layers


def _requiring_grad(tree: dict) -> dict:
    return {k: _requiring_grad(v) if isinstance(v, dict)
            else v.detach().requires_grad_() for k, v in tree.items()}


@pytest.mark.cuda
def test_loss_gradients_on_the_card_are_deterministic_under_every_remat(cuda_device):
    """B6-bwd sums in one order (no atomics) and the embedding's backward
    sorts, so a training step's gradients repeat bit for bit; remat off,
    full and dots recompute the same kernels, so they agree too."""
    cfg = get_arch("olmo-1b").reduced()
    params = T.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    g = torch.Generator().manual_seed(4)
    batch = {k: torch.randint(0, cfg.vocab, (2, 128), generator=g).to(cuda_device)
             for k in ("tokens", "labels")}

    def grads(**kw):
        p = _requiring_grad(params)
        loss, _ = T.loss_fn(p, batch, cfg, **kw)
        flat = [p["embed"], p["layers"]["attn"]["wq"], p["layers"]["attn"]["wk"],
                p["layers"]["mlp"]["wi"]]
        return [loss] + list(torch.autograd.grad(loss, flat))

    kernels.reset_launch_counts()
    base = grads(remat=False)
    assert kernels.launch_counts()["flash_attention"] == cfg.n_layers
    assert kernels.launch_counts()["flash_attention_bwd"] == cfg.n_layers
    assert float(base[2].float().abs().max()) > 0          # wq gets its gradient
    for kw in ({"remat": False}, {"remat": True}, {"remat": True, "remat_policy": "dots"}):
        for a, b in zip(base, grads(**kw)):
            assert torch.equal(a, b), kw
