"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060].

The port of `repro.models.ssm`. Prefill and training use the chunked SSD
algorithm: within a chunk of length Q the recurrence is expanded into an
attention-like masked product (the "duality"); across chunks a (H, N, P)
state is carried by a scan. Decode is the O(1) recurrent update. Block
layout, as in the reference:

    in_proj -> [z | xBC | dt];  causal depthwise conv on xBC;
    split x (H·P), B (N), C (N);  SSD;  y·silu(z) gated RMSNorm;  out_proj

`dt`, `log_a`, the decay tensor and the state h are f32, as in the
reference; the conv state stays in the activation dtype. The reference's
products are XLA einsums outside any Pallas kernel, so they stay
`torch.matmul` here. Its `shard` constraints resolve and record the
reference's layouts (`parallel.sharding.shard`); nothing moves.

`ssm_apply_laid_out` and `ssm_decode_laid_out` are the block in the
partitioned program (`parallel.sharding.Program`). The SSD runs head by
head, so a coordinate runs it as it is on the heads its layout gives it
(the resolved spec of the reference's `shard` site on x: `ssm_inner` over
`model` where it divides the heads). `wxbc`, `wdt`, `conv_w` and the
per-head leaves lie whole along `model`, so every coordinate computes the
whole xBC, conv and dt of its rows, as the reference's placed program
does. Only two things couple the heads: the gated RMSNorm's mean over all
of d_inner (its f32 sum of squares `psum`'d over the heads' axis) and the
output projection (partial products `psum`'d, Megatron's row-parallel
sum). Where `model` keeps the heads whole but splits `wz` and `wo`
mid-head (hymba's 50 heads on 4), both are gathered whole and nothing is
summed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.registry import ArchConfig, SSMConfig
from ..parallel import collectives as col
from ..parallel.sharding import DEFAULT_RULES, REALISED, Program, ShardingRules, shard
from . import scan_util
from .layers import ParamDef, gathered

__all__ = ["ssm_params", "ssm_apply", "ssm_decode", "ssm_apply_laid_out",
           "ssm_decode_laid_out", "SSMState"]


class SSMState(NamedTuple):
    h: torch.Tensor       # (B, H, N, P) f32 recurrent state
    conv: torch.Tensor    # (B, d_conv - 1, conv_dim) rolling conv inputs


def _dims(cfg: ArchConfig) -> tuple[int, int, int, int, int]:
    s: SSMConfig = cfg.ssm
    di = s.d_inner or 2 * cfg.d_model
    n_heads = di // s.head_dim
    conv_dim = di + 2 * s.state_size      # x, B, C all pass the conv (G=1)
    return di, n_heads, s.head_dim, s.state_size, conv_dim


def ssm_params(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    di, h, p, n, conv_dim = _dims(cfg)
    return {
        "wz": ParamDef((d, di), ("embed_w", "ssm_inner")),
        "wxbc": ParamDef((d, conv_dim), ("embed_w", None)),
        "wdt": ParamDef((d, h), ("embed_w", None)),
        "dt_bias": ParamDef((h,), (None,), init="zeros"),
        "a_log": ParamDef((h,), (None,), init="zeros"),   # A = -exp(a_log)
        "d_skip": ParamDef((h,), (None,), init="ones"),
        "conv_w": ParamDef((cfg.ssm.d_conv, conv_dim), (None, None),
                           scale=0.1),
        "norm_scale": ParamDef((di,), (None,), init="ones"),
        "wo": ParamDef((di, d), ("ssm_inner", "embed_w")),
    }


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor,
                 init: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv along seq. xbc: (B, S, C); conv_w: (K, C);
    `init` (B, K - 1, C) the inputs before the first, zeros by default."""
    k, s = conv_w.shape[0], xbc.shape[1]
    if init is None:
        init = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]), dtype=xbc.dtype,
                           device=xbc.device)
    xpad = torch.cat([init, xbc], dim=1)
    out = xpad[:, 0:s] * conv_w[0]
    for i in range(1, k):
        out = out + xpad[:, i:i + s] * conv_w[i]
    return F.silu(out.float()).to(xbc.dtype)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    yf = y.float() * F.silu(z.float())
    rms = torch.sqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6)
    return (yf / rms * scale.float()).to(y.dtype)


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
                 h0: torch.Tensor | None = None,
                 rules: ShardingRules = DEFAULT_RULES
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x: (B, S, H, P); dt: (B, S, H); a: (H,) negative;
    b_in, c_in: (B, S, N). Returns (y (B, S, H, P) in x's dtype, final
    state (B, H, N, P) f32). S must be a multiple of min(chunk, S), as in
    the reference.

    The largest intermediate is the (B, nc, H, Q, Q) f32 decay tensor,
    built in that layout so that the intra-chunk product is one batched
    matmul and, without autograd, the score product C Bᵀ multiplies into
    it in place. Its
    masked entries are exp(-inf) = 0 (the reference's `where` after the
    exp: the same values, and no inf where a gradient could meet it)."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"the chunked SSD needs S ({s}) to be a multiple of the "
                         f"chunk ({q})")
    nc = s // q

    dt = F.softplus(dt.float())
    log_a = dt * a[None, None, :]                       # (B, S, H)  <= 0
    xdt = x.float() * dt[..., None]

    # chunked views: (B, nc, Q, ...), chunk-sharded
    def ck(t, *ax):
        return shard(t, "batch", "ssm_chunk", *ax, rules=rules)
    xc = ck(xdt.reshape(bsz, nc, q, h, p), None, None, None)
    lac = ck(log_a.reshape(bsz, nc, q, h), None, None)
    bc = ck(b_in.float().reshape(bsz, nc, q, n), None, None)
    cc = ck(c_in.float().reshape(bsz, nc, q, n), None, None)

    cum = torch.cumsum(lac, dim=2)                      # (B, nc, Q, H)
    cum_h = cum.transpose(2, 3)                         # (B, nc, H, Q)
    seg = cum_h[..., :, None] - cum_h[..., None, :]     # (B, nc, H, Q_i, Q_j)
    iq = torch.arange(q, device=x.device)
    causal = iq[:, None] >= iq[None, :]
    decay = torch.exp(seg.masked_fill_(~causal, float("-inf")))
    del seg

    # intra-chunk ("attention" term): ((C Bᵀ) ⊙ L) X
    cb = ck(torch.matmul(cc, bc.transpose(-1, -2)), None, None)[:, :, None]  # (B, nc, 1, Q, Q)
    # in place unless autograd keeps exp's output for the backward
    decay = decay * cb if decay.requires_grad else decay.mul_(cb)
    y_intra = torch.matmul(decay, xc.permute(0, 1, 3, 2, 4))   # (B, nc, H, Q, P)
    del decay
    y_intra = ck(y_intra.permute(0, 1, 3, 2, 4), None, None, None)   # (B, nc, Q, H, P)

    # each chunk's contribution to the carried state
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B, nc, Q, H)
    w = (xc * decay_to_end[..., None]).reshape(bsz, nc, q, h * p)
    chunk_states = torch.matmul(bc.transpose(-1, -2), w).reshape(
        bsz, nc, n, h, p).permute(0, 1, 3, 2, 4)        # (B, nc, H, N, P)
    chunk_decay = torch.exp(torch.sum(lac, dim=2))      # (B, nc, H)

    # inter-chunk recurrence (scan over chunks)
    def step(hprev, ins):
        states, dec = ins                               # (B, H, N, P), (B, H)
        return hprev * dec[..., None, None] + states, hprev

    h_init = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
              if h0 is None else h0.float())
    hlast, hprevs = scan_util.scan(step, h_init, (chunk_states.transpose(0, 1),
                                                  chunk_decay.transpose(0, 1)))
    hprevs = hprevs.transpose(0, 1)                     # (B, nc, H, N, P)

    # inter-chunk output: C_t · h_{chunk start} · decay(0..t)
    ch = torch.matmul(cc[:, :, None], hprevs)           # (B, nc, H, Q, P)
    y_inter = ck(ch.permute(0, 1, 3, 2, 4) * torch.exp(cum)[..., None], None, None, None)

    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y.to(x.dtype), hlast


def ssm_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
              rules: ShardingRules = DEFAULT_RULES,
              h0: torch.Tensor | None = None, conv0: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, SSMState]:
    """Full-sequence SSD. x: (B, S, d) -> (out, final SSMState). The conv
    state is the pre-conv xBC projection of the last k - 1 positions (zeros
    when S < k - 1), as in the reference."""
    bsz, s, _ = x.shape
    di, h, p, n, conv_dim = _dims(cfg)
    z = torch.matmul(x, params["wz"])
    xbc_in = torch.matmul(x, params["wxbc"])
    dt = torch.matmul(x, params["wdt"]) + params["dt_bias"].float()
    xbc = _causal_conv(xbc_in, params["conv_w"], conv0)
    xs, b_in, c_in = torch.split(xbc, [di, n, n], dim=-1)
    xs = shard(xs.reshape(bsz, s, h, p), "batch", "seq", "ssm_inner", None, rules=rules)
    a = -torch.exp(params["a_log"].float())
    y, hlast = _ssd_chunked(xs, dt, a, b_in, c_in, cfg.ssm.chunk, h0=h0, rules=rules)
    y = y + params["d_skip"].to(y.dtype)[None, None, :, None] * xs
    y = _gated_norm(y.reshape(bsz, s, di), z, params["norm_scale"])
    out = torch.matmul(y, params["wo"])
    k = cfg.ssm.d_conv
    conv_state = (xbc_in[:, s - (k - 1):, :] if s >= k - 1 else
                  torch.zeros((bsz, k - 1, conv_dim), dtype=x.dtype, device=x.device))
    return out, SSMState(h=hlast, conv=conv_state)


def ssm_decode(params: dict, x: torch.Tensor, state: SSMState, cfg: ArchConfig
               ) -> tuple[torch.Tensor, SSMState]:
    """One-token recurrent update. x: (B, 1, d). Returns (out (B, 1, d),
    the new state); `state` is not written."""
    bsz = x.shape[0]
    di, h, p, n, conv_dim = _dims(cfg)
    x0 = x[:, 0]
    z = torch.matmul(x0, params["wz"])
    xbc_new = torch.matmul(x0, params["wxbc"])
    dt = torch.matmul(x0, params["wdt"]) + params["dt_bias"].float()

    # rolling conv state: window = last (k-1) inputs + current
    window = torch.cat([state.conv, xbc_new[:, None, :]], dim=1)
    conv_out = torch.sum(window * params["conv_w"][None], dim=1)
    xbc = F.silu(conv_out.float()).to(x.dtype)
    xs, b_in, c_in = torch.split(xbc, [di, n, n], dim=-1)
    xs = xs.reshape(bsz, h, p).float()

    dt = F.softplus(dt.float())                         # (B, H)
    a = -torch.exp(params["a_log"].float())
    da = torch.exp(dt * a[None])                        # (B, H)
    bn, cn = b_in.float(), c_in.float()                 # (B, N)
    hnew = state.h * da[..., None, None] \
        + bn[:, None, :, None] * (xs * dt[..., None])[:, :, None, :]
    y = torch.matmul(cn[:, None, None, :], hnew)[:, :, 0]   # (B, H, P)
    y = y + params["d_skip"].float()[None, :, None] * xs
    y = _gated_norm(y.reshape(bsz, di).to(x.dtype), z, params["norm_scale"])
    out = torch.matmul(y, params["wo"])[:, None, :]
    return out, SSMState(h=hnew, conv=window[:, 1:, :])


# ---------------------------------------------------------------------------
# The partitioned program
# ---------------------------------------------------------------------------


def _heads_laid_out(cfg: ArchConfig, prog: Program):
    """The SSD heads' mesh axis (the resolved spec of the reference's
    `shard` site on x (B, S, H, P)), and a function that cuts a
    coordinate's tensor to its heads along a dim (itself where the heads
    are whole)."""
    _, h, p, _, _ = _dims(cfg)
    ax = prog.spec((prog.batch, prog.seq, h, p), ("batch", "seq", "ssm_inner", None))[2]
    if not ax:
        return None, lambda c, t, dim, width=1: t
    h_loc = h // col.axis_size(ax, prog.mesh)
    first = col.axis_index(ax, prog.mesh)

    def heads(c, t, dim, width=1):
        return t.narrow(dim, first[c] * h_loc * width, h_loc * width)

    return ax, heads


def _leaves(params: dict) -> dict:
    """Every coordinate's tensor of the leaves that lie whole along
    `model` and d (conv_w and the per-head and per-channel vectors)."""
    return {k: col.per_coord(params[k])
            for k in ("conv_w", "dt_bias", "a_log", "d_skip", "norm_scale")}


def _in_laid_out(params: dict, x: dict, ax) -> tuple[dict, dict, dict]:
    """Each coordinate's z on its heads' columns, and its whole pre-conv
    xBC and dt, from its rows x (..., d): `wz` gathered to (None, ax),
    `wxbc` and `wdt` gathered whole (FSDP's gathers)."""
    out = []
    for name, want in (("wz", (None, ax)), ("wxbc", (None, None)), ("wdt", (None, None))):
        w = gathered(params[name], want)
        out.append({c: torch.matmul(t, w[c]) for c, t in x.items()})
        del w
    return tuple(out)


def _out_laid_out(params: dict, y: dict, z: dict, leaves: dict, cfg: ArchConfig,
                  prog: Program, ax, heads) -> dict:
    """The gated RMSNorm over all of d_inner and the output projection, from
    each coordinate's y and z (..., di_loc): the f32 sum of squares
    `psum`'d over the heads' axis before the mean, `wo` gathered to (ax,
    None), the partial products `psum`'d over it."""
    di, p = _dims(cfg)[0], cfg.ssm.head_dim
    yf = {c: t.float() * F.silu(z[c].float()) for c, t in y.items()}
    ss = {c: torch.sum(t * t, dim=-1, keepdim=True) for c, t in yf.items()}
    if ax:
        ss = col.psum(ss, ax, prog.mesh)
    scale = leaves["norm_scale"]
    normed = {c: (t / torch.sqrt(ss[c] / di + 1e-6)
                  * heads(c, scale[c], 0, p).float()).to(y[c].dtype)
              for c, t in yf.items()}
    del yf, ss
    wo = gathered(params["wo"], (ax, None))
    out = {c: torch.matmul(t, wo[c]) for c, t in normed.items()}
    return col.psum(out, ax, prog.mesh) if ax else out


def ssm_apply_laid_out(params: dict, x: dict, cfg: ArchConfig, prog: Program
                       ) -> tuple[dict, SSMState]:
    """`ssm_apply` in the partitioned program: `params` laid out
    (DistArrays), `x` each coordinate's rows (B_loc, S, d). Returns each
    coordinate's output (B_loc, S, d) and its state: h (B_loc, H_loc, N, P)
    f32 on its heads and the conv state (B_loc, k - 1, conv_dim) whole,
    the regions `transformer.cache_specs` gives it of `ssm_h` and
    `ssm_conv` (module docstring). Each phase runs over every coordinate
    before the next."""
    di, h, p, n, conv_dim = _dims(cfg)
    b, s = prog.batch, prog.seq
    q = min(cfg.ssm.chunk, s)
    cut = prog.spec((b, s // q, q, h, p), ("batch", "ssm_chunk", None, None, None))[1]
    if cut is not None:
        raise ValueError(f"the partitioned program does not realise the logical axis "
                         f"'ssm_chunk' over {cut!r}: it splits only {REALISED}")
    ax, heads = _heads_laid_out(cfg, prog)
    leaves = _leaves(params)
    z, xbc_in, dt = _in_laid_out(params, x, ax)
    xs, bc = {}, {}
    for c, t in xbc_in.items():
        xbc = _causal_conv(t, leaves["conv_w"][c])
        xc, b_in, c_in = torch.split(xbc, [di, n, n], dim=-1)
        xs[c] = heads(c, xc.reshape(t.shape[0], s, h, p), 2)
        bc[c] = (b_in, c_in)
    xs = prog.shard(xs, (b, s, h, p), "batch", "seq", "ssm_inner", None)
    y, hlast = {}, {}
    for c, xc in xs.items():
        a = -torch.exp(heads(c, leaves["a_log"][c], 0).float())
        yc, hlast[c] = _ssd_chunked(xc, heads(c, dt[c] + leaves["dt_bias"][c].float(), 2),
                                    a, *bc[c], cfg.ssm.chunk)
        yc = yc + heads(c, leaves["d_skip"][c], 0).to(yc.dtype)[None, None, :, None] * xc
        y[c] = yc.reshape(yc.shape[0], s, -1)
    del xs, bc, dt
    out = _out_laid_out(params, y, z, leaves, cfg, prog, ax, heads)
    k = cfg.ssm.d_conv
    conv = {c: t[:, s - (k - 1):, :] if s >= k - 1 else
            torch.zeros((t.shape[0], k - 1, conv_dim), dtype=t.dtype, device=t.device)
            for c, t in xbc_in.items()}
    return out, SSMState(h=hlast, conv=conv)


def ssm_decode_laid_out(params: dict, x: dict, state: SSMState, cfg: ArchConfig,
                        prog: Program) -> tuple[dict, SSMState]:
    """`ssm_decode` in the partitioned program: `params` laid out, `x` each
    coordinate's rows (B_loc, 1, d), `state` each coordinate's h (B_loc,
    H_loc, N, P) and conv state (B_loc, k - 1, conv_dim) (dicts coordinate
    -> tensor, the regions `ssm_apply_laid_out` returns). Returns each
    coordinate's output (B_loc, 1, d) and its new state; `state` is not
    written, and every coordinate's new state is made before any returns,
    so a caller may write them into tensors that coordinates share."""
    di, h, p, n, conv_dim = _dims(cfg)
    ax, heads = _heads_laid_out(cfg, prog)
    leaves = _leaves(params)
    z, xbc_new, dt = _in_laid_out(params, {c: t[:, 0] for c, t in x.items()}, ax)
    y, h_new, conv_new = {}, {}, {}
    for c, t in xbc_new.items():
        bsz = t.shape[0]
        window = torch.cat([state.conv[c], t[:, None, :]], dim=1)
        conv_out = torch.sum(window * leaves["conv_w"][c][None], dim=1)
        xbc = F.silu(conv_out.float()).to(t.dtype)
        xc, b_in, c_in = torch.split(xbc, [di, n, n], dim=-1)
        xc = heads(c, xc.reshape(bsz, h, p), 1).float()
        dtc = F.softplus(heads(c, dt[c] + leaves["dt_bias"][c].float(), 1).float())
        a = -torch.exp(heads(c, leaves["a_log"][c], 0).float())
        da = torch.exp(dtc * a[None])
        h_new[c] = state.h[c] * da[..., None, None] \
            + b_in.float()[:, None, :, None] * (xc * dtc[..., None])[:, :, None, :]
        yc = torch.matmul(c_in.float()[:, None, None, :], h_new[c])[:, :, 0]
        yc = yc + heads(c, leaves["d_skip"][c], 0).float()[None, :, None] * xc
        y[c] = yc.reshape(bsz, -1).to(t.dtype)
        conv_new[c] = window[:, 1:, :]
    del xbc_new, dt
    out = _out_laid_out(params, y, z, leaves, cfg, prog, ax, heads)
    return {c: t[:, None, :] for c, t in out.items()}, SSMState(h=h_new, conv=conv_new)
