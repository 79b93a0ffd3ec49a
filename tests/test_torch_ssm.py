"""The port's Mamba-2 SSD block and scan against the JAX package, on the CPU.

Parameters come from the JAX package's initializer (with `a_log` and
`dt_bias` drawn away from their constant init, so every head decays at
its own rate), carried across bit for bit by `repro_torch.bridge`; inputs
are drawn with numpy from a seed and handed to both packages. f32 is held
to rtol 1e-4 of the largest entry (the two frameworks sum in another
order); bf16 to 2e-2 of the largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import scan_util as j_scan_util, ssm as j_ssm
from repro.models import transformer as JT
from repro.models.layers import init_tree as j_init_tree
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import scan_util, ssm
from repro_torch.models import transformer as T

F32_RTOL = 1e-4
BF16_RTOL = 2e-2
ARCHS = ["mamba2-130m", "hymba-1.5b"]   # reduced: d_inner 128, N 16, P 32, chunk 16


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got: torch.Tensor, want) -> float:
    w = _np(want)
    return float(np.abs(got.detach().float().numpy() - w).max()) / max(
        float(np.abs(w).max()), 1e-30)


def _params(name: str, dtype):
    """(JAX params, port params) of one SSM block at `dtype`."""
    jcfg = j_get_arch(name).reduced()
    jp = dict(j_init_tree(j_ssm.ssm_params(jcfg), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(len(name))
    for key in ("a_log", "dt_bias"):
        jp[key] = jnp.asarray(0.5 * rng.standard_normal(jp[key].shape), jnp.bfloat16)
    jp = {k: v.astype(dtype) for k, v in jp.items()}
    return jp, bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, dtype, seed):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape), jnp.float32)
    x = x.astype(dtype)
    return x, bridge.to_torch(np.asarray(x), "cpu")


# ---------------------------------------------------------------------------
# scan_util
# ---------------------------------------------------------------------------


def test_scan_matches_lax_scan_and_stacks_outputs():
    xs = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)

    def jbody(c, x):
        return c * 0.5 + x, (c.sum(), {"x2": x * 2})

    def tbody(c, x):
        return c * 0.5 + x, (c.sum(), {"x2": x * 2})

    jc, (js, jd) = j_scan_util.scan(jbody, jnp.zeros(3), jnp.asarray(xs))
    tc, (ts, td) = scan_util.scan(tbody, torch.zeros(3), torch.from_numpy(xs))
    np.testing.assert_allclose(tc.numpy(), _np(jc), rtol=1e-6)
    np.testing.assert_allclose(ts.numpy(), _np(js), rtol=1e-6)
    assert tuple(td["x2"].shape) == (5, 3)
    assert scan_util.scan(lambda c, _: (c + 1, None), 0, length=4) == (4, None)


def test_unroll_flag_is_a_context_variable():
    assert not scan_util.unrolling()
    with scan_util.unroll_scans():
        assert scan_util.unrolling()
        with scan_util.unroll_scans():
            assert scan_util.unrolling()
        assert scan_util.unrolling()
    assert not scan_util.unrolling()


# ---------------------------------------------------------------------------
# The pieces of the block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_causal_conv_and_gated_norm_match_the_reference(dtype):
    tol = F32_RTOL if dtype == jnp.float32 else BF16_RTOL
    xj, xt = _x((2, 9, 24), dtype, 1)
    wj, wt = _x((4, 24), dtype, 2)
    ij, it = _x((2, 3, 24), dtype, 3)
    assert _rel(ssm._causal_conv(xt, wt), j_ssm._causal_conv(xj, wj)) <= tol
    assert _rel(ssm._causal_conv(xt, wt, it), j_ssm._causal_conv(xj, wj, ij)) <= tol
    zj, zt = _x((2, 9, 24), dtype, 4)
    assert _rel(ssm._gated_norm(xt, zt, wt[0]), j_ssm._gated_norm(xj, zj, wj[0])) <= tol


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s,chunk", [(32, 8), (32, 16), (16, 32), (24, 8)])
def test_ssd_chunked_matches_the_reference(s, chunk, with_h0):
    """f32 in, f32 state out: y and the final state to rtol 1e-4."""
    rng = np.random.default_rng(s * chunk + with_h0)
    b, h, p, n = 2, 3, 8, 4
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.standard_normal((b, s, h)).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    bi = rng.standard_normal((b, s, n)).astype(np.float32)
    ci = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, n, p)).astype(np.float32) if with_h0 else None
    jy, jh = j_ssm._ssd_chunked(*map(jnp.asarray, (x, dt, a, bi, ci)), chunk,
                                h0=None if h0 is None else jnp.asarray(h0))
    ty, th = ssm._ssd_chunked(*map(torch.from_numpy, (x, dt, a, bi, ci)), chunk,
                              h0=None if h0 is None else torch.from_numpy(h0))
    assert ty.dtype == torch.float32 and th.dtype == torch.float32
    assert _rel(ty, jy) <= F32_RTOL and _rel(th, jh) <= F32_RTOL


def test_ssd_chunked_needs_whole_chunks():
    """The reference reshapes S into S // Q chunks, so S must be a multiple
    of min(chunk, S); the port says so."""
    z = torch.zeros(1, 20, 2, 4)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm._ssd_chunked(z, z[..., 0], -torch.ones(2), z[:, :, 0], z[:, :, 0], 8)


def test_ssd_chunked_keeps_its_gradient_finite():
    """The masked decay entries are exp(-inf) = 0 before the product, so a
    chunk long enough to overflow exp on the masked side (dt·|A|·Q > 88)
    still has a finite gradient."""
    b, s, h, p, n = 1, 64, 2, 4, 4
    g = torch.Generator().manual_seed(0)
    x = torch.randn(b, s, h, p, generator=g, requires_grad=True)
    dt = torch.full((b, s, h), 3.0, requires_grad=True)
    bi, ci = torch.randn(b, s, n, generator=g), torch.randn(b, s, n, generator=g)
    y, hl = ssm._ssd_chunked(x, dt, -torch.ones(h), bi, ci, 64)
    (y.square().sum() + hl.sum()).backward()
    assert bool(torch.isfinite(x.grad).all() and torch.isfinite(dt.grad).all())


# ---------------------------------------------------------------------------
# The block: prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("name", ARCHS)
def test_ssm_apply_matches_the_reference(name, dtype):
    tol = F32_RTOL if dtype == jnp.float32 else BF16_RTOL
    jcfg, cfg = j_get_arch(name).reduced(), get_arch(name).reduced()
    jp, tp = _params(name, dtype)
    xj, xt = _x((2, 32, cfg.d_model), dtype, 5)
    jout, jst = j_ssm.ssm_apply(jp, xj, jcfg)
    out, st = ssm.ssm_apply(tp, xt, cfg)
    assert out.dtype == xt.dtype and st.h.dtype == torch.float32
    assert st.conv.dtype == xt.dtype
    assert _rel(out, jout) <= tol
    assert _rel(st.h, jst.h) <= tol
    # the conv state: the pre-conv xBC projection of the last k - 1 rows
    assert tuple(st.conv.shape) == tuple(jst.conv.shape) == (2, cfg.ssm.d_conv - 1,
                                                            ssm._dims(cfg)[4])
    assert _rel(st.conv, jst.conv) <= tol


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("name", ARCHS)
def test_ssm_decode_matches_the_reference(name, dtype):
    """Three recurrent steps from the prefill state of the reference."""
    tol = F32_RTOL if dtype == jnp.float32 else BF16_RTOL
    jcfg, cfg = j_get_arch(name).reduced(), get_arch(name).reduced()
    jp, tp = _params(name, dtype)
    xj, xt = _x((2, 16, cfg.d_model), dtype, 6)
    _, jst = j_ssm.ssm_apply(jp, xj, jcfg)
    st = ssm.SSMState(bridge.to_torch(np.asarray(jst.h), "cpu"),
                      bridge.to_torch(np.asarray(jst.conv), "cpu"))
    for i in range(3):
        yj, yt = _x((2, 1, cfg.d_model), dtype, 7 + i)
        jout, jst = j_ssm.ssm_decode(jp, yj, jst, jcfg)
        out, st = ssm.ssm_decode(tp, yt, st, cfg)
        assert tuple(out.shape) == (2, 1, cfg.d_model) and out.dtype == yt.dtype
        assert _rel(out, jout) <= tol
        assert _rel(st.h, jst.h) <= tol
        assert _rel(st.conv, jst.conv) <= tol


def test_ssm_decode_continues_ssm_apply():
    """Inside the port, f32: the recurrent step from the prefill state
    gives what the chunked prefill over one more position gives."""
    cfg = get_arch("mamba2-130m").reduced()
    _, tp = _params("mamba2-130m", jnp.float32)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 33, cfg.d_model)).astype(np.float32))
    ssm_cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=1))
    full, _ = ssm.ssm_apply(tp, x, ssm_cfg)
    _, st = ssm.ssm_apply(tp, x[:, :32], cfg)
    step, _ = ssm.ssm_decode(tp, x[:, 32:], st, cfg)
    assert float((step[:, 0] - full[:, 32]).abs().max()) <= \
        F32_RTOL * float(full[:, 32].abs().max())


def test_ssd_chunk_invariance():
    """Twin of tests/test_models.py::test_ssd_chunk_invariance: the model's
    output does not depend on the chunk size (duality consistency), with
    the reference's weights and bound."""
    cfg = get_arch("mamba2-130m").reduced()
    jparams = JT.init_params(j_get_arch("mamba2-130m").reduced(), jax.random.PRNGKey(0),
                             model_size_hint=1)
    params = bridge.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 32)))
    out16 = T.forward(params, {"tokens": tokens}, cfg, remat=False)[0]
    cfg8 = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=8))
    out8 = T.forward(params, {"tokens": tokens}, cfg8, remat=False)[0]
    assert torch.allclose(out16, out8, atol=2e-2)
