"""Mixture of experts: top-k routing, two-level capacity dispatch, grouped
SwiGLU experts, shared experts, and the aux losses; expert-parallel under
a mesh.

The port of `repro.models.moe`. The reference's per-shard body
`_moe_local` runs in phases, line for line:

  1. router top-k over the real experts (the phantom experts that pad E to
     the model-axis multiple are masked to -1e30);
  2. first level: each (token, choice) takes the next slot of its
     destination shard's capacity-`cap` send buffer, cap = max(8,
     int(cf·t·k / M)) with M the `model` axis (1 without a mesh); past it
     the choice is dropped;
  3. second level: the received rows go to per-expert buffers of `cap2`
     rows (the running count per local expert); past it a row is dropped;
  4. the grouped SwiGLU expert products `ecd,edf->ecf` (`torch.matmul`
     over the expert axis, as the reference leaves them to XLA), gathered
     back and combined with the renormalised gates; a dropped choice
     contributes nothing, so its token rides the residual stream;
  5. the shared experts (a dense SwiGLU), and the Switch load-balance loss
     over `num_experts` and the router z-loss.

The reference's `.at[...].set(mode="drop")` and `.get(mode="fill")` become
writes and reads of one extra slot past the end of each buffer, which the
dropped rows point at: a write there is thrown away and a read there finds
zeros. No dropped row is clamped into a real slot, and the device never
waits on the host for a count.

Expert parallelism: under a mesh whose `model` axis is longer than 1,
`moe_apply` runs the reference's `shard_map` program per coordinate
(`parallel.collectives.region`) with the reference's layout: tokens split
over the batch axes and the sequence over `model`, experts over `model`
(E_loc = E/M a coordinate) and their width over `data` (FSDP). Each
coordinate all-gathers its experts over `data`, routes its own tokens,
fills (M, cap, d) send buffers, and an `all_to_all` over `model` delivers
each buffer to the shard that holds its experts; the second-level
dispatch, the expert products and a reverse `all_to_all` follow, then the
gated combine. The capacities are per shard, so EP drops the tokens the
reference's EP drops, which differ from the mesh-free drops. aux and z
are each group's losses, `pmean`'d over the batch axes and `model`.
The shared experts take each coordinate's own tokens through the WHOLE
shared FFN (its weights all-gathered over `model`): the mesh-free
semantics. The reference instead multiplies each coordinate's tokens by
its `model` slice of the shared FFN and `psum`s the slices over `model`,
which adds partial sums of different tokens once the sequence is split
over `model` (ROADMAP §C, reference caveats). The EP phases run inside
profiler ranges "moe:fsdp_gather", "moe:dispatch", "moe:experts" and
"moe:combine" (`profile_lm --train --mesh`).

`moe_apply_laid_out` is the MoE of the partitioned program
(`parallel.sharding.Program`: laid-out parameters, each coordinate's
rows): the same region and the same `_moe_ep`, its inputs moved from the
program's layout to the region's and its output back (see its
docstring); on a mesh whose `model` axis is 1, `_moe_local` on the batch
gathered whole, as `moe_apply` runs it there.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.autograd.profiler import record_function

from ..configs.registry import ArchConfig, MoEConfig
from ..launch.mesh import current_mesh
from ..parallel import collectives as col
from ..parallel.sharding import DEFAULT_RULES, PartitionSpec as P, Program, ShardingRules
from .layers import ParamDef, gathered

__all__ = ["moe_params", "moe_apply", "moe_apply_laid_out"]


def _padded_experts(moe: MoEConfig, model_size: int) -> int:
    return math.ceil(moe.num_experts / model_size) * model_size


def moe_params(cfg: ArchConfig, model_size_hint: int = 16) -> dict:
    """Weight table. E is padded to a multiple of `model_size_hint`, as the
    reference pads it for its model axis; the router masks the phantom
    experts. The router is f32."""
    moe, d = cfg.moe, cfg.d_model
    e_pad = _padded_experts(moe, model_size_hint)
    f = moe.d_ff_expert
    p = {
        "router": ParamDef((d, e_pad), (None, None), scale=0.02,
                           dtype=torch.float32),
        "wi": ParamDef((e_pad, d, f), ("experts", "embed_w", None)),
        "wg": ParamDef((e_pad, d, f), ("experts", "embed_w", None)),
        "wo": ParamDef((e_pad, f, d), ("experts", None, "embed_w")),
    }
    if moe.num_shared_experts:
        fs = moe.shared_d_ff
        p["shared"] = {
            "wi": ParamDef((d, fs), (None, "ffn")),
            "wg": ParamDef((d, fs), (None, "ffn")),
            "wo": ParamDef((fs, d), ("ffn", None)),
        }
    return p


def _positions_by_dest(dest_flat: torch.Tensor, n_dest: int) -> torch.Tensor:
    """Running per-destination slot index for each row (one-hot cumsum);
    a row whose destination is out of range gets an arbitrary value, which
    its caller masks, as in the reference. The one-hot is built (n_dest,
    rows), so that the scan runs along its contiguous axis: along the rows
    axis of a (rows, n_dest) one-hot the card scans in one block."""
    dest = dest_flat.long()
    rows = torch.arange(dest.shape[0], device=dest.device)
    oh = (torch.arange(n_dest, device=dest.device)[:, None] == dest[None, :]).int()
    cs = torch.cumsum(oh, dim=1) - 1
    return cs[dest.clamp(0, n_dest - 1), rows].long()


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: ArchConfig):
    """The router: (logits (t, E) f32 with the phantom experts at -1e30,
    probs, gate (t, k) renormalised, eidx (t, k)) of x (B, S, d)."""
    moe = cfg.moe
    e_pad = router_w.shape[1]
    logits = x.reshape(-1, x.shape[-1]).float() @ router_w.float()
    real = torch.arange(e_pad, device=x.device) < moe.num_experts
    logits = torch.where(real[None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, moe.top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate, eidx


def first_level(eidx: torch.Tensor, cfg: ArchConfig, m_size: int = 1,
                e_loc: int | None = None):
    """(pos (t, k), dropped (t, k), cap) of the first-level dispatch over
    `m_size` model shards of `e_loc` experts each (one shard holding every
    expert by default): each (token, choice) in row-major order takes the
    next of `cap` slots of its destination shard."""
    t, k = eidx.shape
    cap = max(8, int(cfg.moe.capacity_factor * t * k / max(m_size, 1)))
    if m_size == 1:
        dest = torch.zeros(t * k, dtype=torch.long, device=eidx.device)
    else:
        dest = (eidx // e_loc).reshape(-1)
    pos = _positions_by_dest(dest, m_size).reshape(t, k)
    pos = torch.where(pos < cap, pos, cap)
    return pos, pos >= cap, cap


def _dispatch(x: torch.Tensor, router_w, cfg: ArchConfig, m_size: int, e_loc: int):
    """Route one shard's tokens and fill its (M, cap, d) send buffers and
    their local-expert indices (e_loc marks an empty slot)."""
    bsz, s, d = x.shape
    t, k = bsz * s, cfg.moe.top_k
    tokens = x.reshape(t, d)
    logits, probs, gate, eidx = route(x, router_w, cfg)
    pos, dropped, cap = first_level(eidx, cfg, m_size, e_loc)
    dest = eidx // e_loc
    send_x = torch.zeros((m_size, cap + 1, d), dtype=x.dtype, device=x.device)
    send_le = torch.full((m_size, cap + 1), e_loc, dtype=torch.long, device=x.device)
    for j in range(k):
        send_x[dest[:, j], pos[:, j]] = tokens
        send_le[dest[:, j], pos[:, j]] = eidx[:, j] % e_loc
    return dict(tokens=tokens, logits=logits, probs=probs, gate=gate, eidx=eidx,
                dest=dest, pos=pos, dropped=dropped, cap=cap,
                send_x=send_x[:, :cap], send_le=send_le[:, :cap])


def second_level(recv_le: torch.Tensor, e_loc: int):
    """(pos2 (M·cap,), dropped (M·cap,), cap2) of the second-level dispatch
    of one shard's (M, cap) received rows into its `e_loc` experts' cap2
    slots: a row's slot is the running count of its expert; an empty row
    (marker e_loc) or one past cap2 takes slot cap2, which drops."""
    m_size, cap = recv_le.shape
    rle = recv_le.reshape(m_size * cap)
    cap2 = m_size * cap if e_loc == 1 else max(8, int(2 * m_size * cap / e_loc))
    pos2 = _positions_by_dest(rle, e_loc)
    live = rle < e_loc
    pos2 = torch.where(live & (pos2 < cap2), pos2, cap2)
    return pos2, live & (pos2 >= cap2), cap2


def _experts(recv_x: torch.Tensor, recv_le: torch.Tensor, wi, wg, wo) -> torch.Tensor:
    """Second-level dispatch of the (M, cap, d) received rows into
    (E_loc, cap2, d) expert buffers, the grouped SwiGLU products, and the
    rows gathered back into (M, cap, d) (zeros where a row was dropped)."""
    m_size, cap, d = recv_x.shape
    e_loc = wi.shape[0]
    rows = recv_x.reshape(m_size * cap, d)
    rle = recv_le.reshape(m_size * cap)
    pos2, _, cap2 = second_level(recv_le, e_loc)
    ex = rle.clamp(0, e_loc - 1)
    buf = torch.zeros((e_loc, cap2 + 1, d), dtype=recv_x.dtype, device=recv_x.device)
    buf[ex, pos2] = rows
    buf = buf[:, :cap2]

    h = torch.matmul(buf, wi)
    g = torch.matmul(buf, wg)
    h = F.silu(g.float()).to(h.dtype) * h
    y = F.pad(torch.matmul(h, wo), (0, 0, 0, 1))          # slot cap2 reads zeros
    return y[ex, pos2].reshape(m_size, cap, d)


def _combine(ret: torch.Tensor, r: dict) -> torch.Tensor:
    """The gated sum (t, d) f32 of each token's returned choices."""
    ret = F.pad(ret, (0, 0, 0, 1))                        # slot cap reads zeros
    dest, pos = r["dest"], r["pos"]
    out = torch.zeros(r["tokens"].shape, dtype=torch.float32, device=ret.device)
    for j in range(dest.shape[1]):
        got = ret[dest[:, j], pos[:, j]]
        w = torch.where(r["dropped"][:, j], 0.0, r["gate"][:, j])
        out = out + w[:, None] * got.float()
    return out


def _shared(tokens: torch.Tensor, shared: dict) -> torch.Tensor:
    hs = torch.matmul(tokens, shared["wi"])
    gs = torch.matmul(tokens, shared["wg"])
    hs = F.silu(gs.float()).to(hs.dtype) * hs
    return torch.matmul(hs, shared["wo"]).float()


def _losses(r: dict, cfg: ArchConfig):
    """(load-balance aux, router z) of one group's tokens, 0-dim f32."""
    e_pad = r["probs"].shape[1]
    me = r["probs"].mean(0)                               # (E,)
    ce = F.one_hot(r["eidx"][:, 0], e_pad).float().mean(0)
    aux = cfg.moe.num_experts * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(r["logits"], dim=-1) ** 2)
    return aux, z


def _moe_local(x: torch.Tensor, router_w, wi, wg, wo, shared, *, cfg: ArchConfig):
    """The reference's per-shard body with one model shard. x: (B, S, d)."""
    r = _dispatch(x, router_w, cfg, 1, wi.shape[0])
    out = _combine(_experts(r["send_x"], r["send_le"], wi, wg, wo), r)
    if shared is not None:
        out = out + _shared(r["tokens"], shared)
    aux, z = _losses(r, cfg)
    return out.reshape(x.shape).to(x.dtype), aux, z


def _moe_ep(mesh, x, router_w, wi, wg, wo, shared, *, cfg: ArchConfig,
            data_axis, reduce_axes):
    """The expert-parallel body over every coordinate of `mesh`: dicts
    coordinate -> local tensor in, (out, aux, z) dicts out."""
    coords = mesh.coords()
    m_size = mesh.shape["model"]
    c0 = coords[0]
    e_loc = wi[c0].shape[0]
    with record_function("moe:fsdp_gather"):
        # FSDP: the experts arrive d-split over `data`; gather them before use
        if data_axis:
            wi = col.all_gather(wi, data_axis, 1, mesh)
            wg = col.all_gather(wg, data_axis, 1, mesh)
            wo = col.all_gather(wo, data_axis, 2, mesh)
        if shared is not None:
            # the whole shared FFN on every coordinate: its own tokens through it
            shared = {"wi": col.all_gather(shared["wi"], "model", 1, mesh),
                      "wg": col.all_gather(shared["wg"], "model", 1, mesh),
                      "wo": col.all_gather(shared["wo"], "model", 0, mesh)}
    with record_function("moe:dispatch"):
        r = {c: _dispatch(x[c], router_w[c], cfg, m_size, e_loc) for c in coords}
    recv_x = col.all_to_all({c: r[c]["send_x"] for c in coords}, "model", 0, 0, mesh)
    recv_le = col.all_to_all({c: r[c]["send_le"] for c in coords}, "model", 0, 0, mesh)
    with record_function("moe:experts"):
        back = {c: _experts(recv_x[c], recv_le[c], wi[c], wg[c], wo[c]) for c in coords}
    del recv_x, recv_le
    ret = col.all_to_all(back, "model", 0, 0, mesh)
    out, aux, z = {}, {}, {}
    with record_function("moe:combine"):
        for c in coords:
            o = _combine(ret[c], r[c])
            if shared is not None:
                o = o + _shared(r[c]["tokens"], {k: v[c] for k, v in shared.items()})
            out[c] = o.reshape(x[c].shape).to(x[c].dtype)
            aux[c], z[c] = _losses(r[c], cfg)
    if reduce_axes:
        aux, z = col.pmean(aux, reduce_axes, mesh), col.pmean(z, reduce_axes, mesh)
    return out, aux, z


def _region(mesh, b: int, s: int) -> dict:
    """The reference's shard_map layout for (b, s, d) tokens on `mesh`: the
    batch axes among ("pod", "data") that divide b (the whole tuple only
    if it divides), the sequence over `model` where `model` divides s
    (decode, s = 1, keeps it whole, so that every model coordinate routes
    the same rows), the experts over `model` and their width over `data`
    (FSDP), the shared experts' columns over `model`; aux and z are
    pmean'd over the batch axes and the sequence's."""
    axes = dict(mesh.shape)
    batch_axes = tuple(a for a in ("pod", "data") if a in axes and b % axes[a] == 0)
    # keep batch sharding only if the full tuple divides evenly
    if batch_axes and b % math.prod(axes[a] for a in batch_axes):
        batch_axes = batch_axes[:1]
    data_axis = "data" if axes.get("data", 1) > 1 else None
    seq_axis = "model" if s % axes["model"] == 0 else None
    x = P(batch_axes if batch_axes else None, seq_axis, None)
    return {"x": x, "data_axis": data_axis,
            "reduce_axes": batch_axes + ((seq_axis,) if seq_axis else ()),
            "router": P(None, None), "wi": P("model", data_axis, None),
            "wg": P("model", data_axis, None), "wo": P("model", None, data_axis),
            "shared": {"wi": P(None, "model"), "wg": P(None, "model"),
                       "wo": P("model", None)}}


def moe_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
              rules: ShardingRules = DEFAULT_RULES
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, load_balance_aux, router_z_loss); aux and z are
    0-dim f32. Under an ambient mesh with a `model` axis longer than 1 it
    runs expert-parallel (see the module docstring); the padded expert
    count and the experts' width must split over `model` and `data` then,
    as the reference's shard_map requires."""
    mesh = current_mesh()
    shared = params.get("shared")
    if mesh is None or not mesh.shape or mesh.shape.get("model", 1) == 1:
        return _moe_local(x, params["router"], params["wi"], params["wg"], params["wo"],
                          shared, cfg=cfg)
    lay = _region(mesh, x.shape[0], x.shape[1])

    def body(x, router, wi, wg, wo, shared):
        return _moe_ep(mesh, x, router, wi, wg, wo, shared, cfg=cfg,
                       data_axis=lay["data_axis"], reduce_axes=lay["reduce_axes"])

    return col.region(
        body, mesh,
        (lay["x"], lay["router"], lay["wi"], lay["wg"], lay["wo"],
         lay["shared"] if shared is not None else None),
        (lay["x"], P(), P()),
    )(x, params["router"], params["wi"], params["wg"], params["wo"], shared)


def moe_apply_laid_out(params: dict, x: dict, cfg: ArchConfig, prog: Program):
    """`moe_apply` in the partitioned program: `params` laid out
    (DistArrays), `x` each coordinate's rows (B_loc, S, d), whole along
    `model`. The region is `moe_apply`'s: each coordinate's rows are cut
    to its slice of the sequence (a narrow: x is whole along `model`),
    each weight moves from its `param_specs` layout to the region's
    (`layers.gathered`: under the default rules the experts already lie
    so; under `dp_only` their `model` part of the width moves to the
    expert axis by one all_to_all, and the shared experts are cut to
    their columns), `_moe_ep` runs as under a mesh, and its output is
    all-gathered over `model` along the sequence, back to the program's
    layout. Returns (out, aux, z) as dicts coordinate -> tensor; aux and
    z are pmean'd (0-dim f32, the same at every coordinate).

    Without a `model` axis longer than 1 `moe_apply` runs `_moe_local` on
    the whole batch (its capacities and losses over every token, as the
    reference's placed program computes them): each coordinate gathers
    the batch and every weight whole, runs it, and keeps its own rows."""
    mesh = prog.mesh
    have = prog.spec((prog.batch, prog.seq, cfg.d_model), ("batch", "seq", "embed"))
    if col.axis_size("model", mesh) == 1:
        return _moe_whole_batch(params, x, cfg, mesh, have)
    lay = _region(mesh, prog.batch, prog.seq)
    xs = col.to_spec(x, have, lay["x"], mesh)
    w = {k: gathered(params[k], lay[k]) for k in ("router", "wi", "wg", "wo")}
    shared = None
    if "shared" in params:
        shared = {k: gathered(v, lay["shared"][k]) for k, v in params["shared"].items()}
    out, aux, z = _moe_ep(mesh, xs, w["router"], w["wi"], w["wg"], w["wo"], shared,
                          cfg=cfg, data_axis=lay["data_axis"],
                          reduce_axes=lay["reduce_axes"])
    return col.to_spec(out, lay["x"], have, mesh), aux, z


def _moe_whole_batch(params: dict, x: dict, cfg: ArchConfig, mesh, have) -> tuple:
    """`moe_apply_laid_out` on a mesh whose `model` axis is 1: `_moe_local`
    at every coordinate on the batch and weights gathered whole, each
    coordinate's rows cut from its output (the gathers' backward, the
    reduce-scatter, sums the coordinates' cotangents)."""
    whole = (None,) * 3
    xs = col.to_spec(x, have, whole, mesh)

    def w(t):
        return gathered(t, (None,) * len(t.shape))

    router, wi, wg, wo = (w(params[k]) for k in ("router", "wi", "wg", "wo"))
    shared = {k: w(t) for k, t in params["shared"].items()} if "shared" in params else None
    out, aux, z = {}, {}, {}
    for c in mesh.coords():
        out[c], aux[c], z[c] = _moe_local(
            xs[c], router[c], wi[c], wg[c], wo[c],
            None if shared is None else {k: t[c] for k, t in shared.items()}, cfg=cfg)
    return col.to_spec(out, whole, have, mesh), aux, z
