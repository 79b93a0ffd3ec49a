"""Mixture of experts: top-k routing, two-level capacity dispatch, grouped
SwiGLU experts, shared experts, and the aux losses.

The port of `repro.models.moe` on one device: the reference's per-shard
body `_moe_local` with one model shard (m_size = 1), line for line:

  1. router top-k over the real experts (the phantom experts that pad E to
     the model-axis multiple are masked to -1e30);
  2. first level: each (token, choice) takes the next slot of a
     capacity-`cap` send buffer, cap = max(8, int(cf·t·k)); past it the
     choice is dropped;
  3. second level: the buffer's rows go to per-expert buffers of
     `cap2` rows (the running count per expert); past it a row is dropped;
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
waits on the host for a count. The expert-parallel path (`all_to_all`
over the `model` axis) comes with the port of sharding (ROADMAP A.2).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.registry import ArchConfig, MoEConfig
from .layers import ParamDef

__all__ = ["moe_params", "moe_apply"]


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


def first_level(eidx: torch.Tensor, cfg: ArchConfig):
    """(pos (t, k), dropped (t, k), cap) of the first-level dispatch with
    one model shard: each (token, choice) in row-major order takes the next
    of `cap` slots."""
    t, k = eidx.shape
    cap = max(8, int(cfg.moe.capacity_factor * t * k))
    pos = _positions_by_dest(torch.zeros(t * k, dtype=torch.long, device=eidx.device),
                             1).reshape(t, k)
    pos = torch.where(pos < cap, pos, cap)
    return pos, pos >= cap, cap


def _moe_local(x: torch.Tensor, router_w, wi, wg, wo, shared, *, cfg: ArchConfig):
    """The reference's per-shard body with one model shard. x: (B, S, d)."""
    moe = cfg.moe
    e_pad = e_loc = wi.shape[0]
    bsz, s, d = x.shape
    t, k = bsz * s, moe.top_k
    dev = x.device

    tokens = x.reshape(t, d)
    logits, probs, gate, eidx = route(x, router_w, cfg)

    # ---- first level: (token, choice) -> send slots; slot `cap` drops -----
    pos, dropped, cap = first_level(eidx, cfg)
    dest = eidx // e_loc                                  # all 0: one shard
    send_x = torch.zeros((1, cap + 1, d), dtype=x.dtype, device=dev)
    send_le = torch.full((1, cap + 1), e_loc, dtype=torch.long, device=dev)
    for j in range(k):
        send_x[dest[:, j], pos[:, j]] = tokens
        send_le[dest[:, j], pos[:, j]] = eidx[:, j] % e_loc

    # ---- second level: rows -> per-expert buffers; slot `cap2` drops ------
    rows = send_x[:, :cap].reshape(cap, d)
    rle = send_le[:, :cap].reshape(cap)
    cap2 = cap if e_loc == 1 else max(8, int(2 * cap / e_loc))
    pos2 = _positions_by_dest(rle, e_loc)
    pos2 = torch.where((rle < e_loc) & (pos2 < cap2), pos2, cap2)
    ex = rle.clamp(0, e_loc - 1)
    buf = torch.zeros((e_loc, cap2 + 1, d), dtype=x.dtype, device=dev)
    buf[ex, pos2] = rows
    buf = buf[:, :cap2]

    # ---- grouped expert FFN (swiglu) --------------------------------------
    h = torch.matmul(buf, wi)
    g = torch.matmul(buf, wg)
    h = F.silu(g.float()).to(h.dtype) * h
    y = F.pad(torch.matmul(h, wo), (0, 0, 0, 1))          # slot cap2 reads zeros

    # ---- gather back + combine --------------------------------------------
    ret = F.pad(y[ex, pos2].reshape(1, cap, d), (0, 0, 0, 1))   # slot cap: zeros
    out = torch.zeros((t, d), dtype=torch.float32, device=dev)
    for j in range(k):
        got = ret[dest[:, j], pos[:, j]]
        w = torch.where(dropped[:, j], 0.0, gate[:, j])
        out = out + w[:, None] * got.float()

    # ---- shared experts (dense) -------------------------------------------
    if shared is not None:
        hs = torch.matmul(tokens, shared["wi"])
        gs = torch.matmul(tokens, shared["wg"])
        hs = F.silu(gs.float()).to(hs.dtype) * hs
        out = out + torch.matmul(hs, shared["wo"]).float()

    # ---- aux losses --------------------------------------------------------
    me = probs.mean(0)                                    # (E,)
    ce = F.one_hot(eidx[:, 0], e_pad).float().mean(0)
    aux = moe.num_experts * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return out.reshape(bsz, s, d).to(x.dtype), aux, z


def moe_apply(params: dict, x: torch.Tensor, cfg: ArchConfig
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, load_balance_aux, router_z_loss); aux and z are
    0-dim f32. Under an ambient mesh with a `model` axis longer than 1 it
    raises: expert parallelism comes with sharding (ROADMAP A.2)."""
    from ..launch.mesh import current_mesh

    mesh = current_mesh()
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        raise ValueError(f"moe_apply on a mesh with model axis {mesh.shape['model']}: "
                         "the expert-parallel path (all_to_all over `model`) comes "
                         "with the port of sharding, ROADMAP A.2")
    return _moe_local(x, params["router"], params["wi"], params["wg"], params["wo"],
                      params.get("shared"), cfg=cfg)
