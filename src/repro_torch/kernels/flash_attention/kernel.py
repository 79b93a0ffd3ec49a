"""Wrapper of the flash attention kernel (csrc/flash_attention.cu).

`flash_attention_cuda` replaces `flash_attention_pallas`
(src/repro/kernels/flash_attention/kernel.py): causal or full softmax
attention with an online softmax and grouped-query heads, f32
accumulation, output in q's dtype. Causal attention may take a sliding
`window` (the hybrid family's), with the reference's meaning: query i
sees key j iff 0 <= i - j < window; the kernels walk only the band.
Unlike the Pallas kernel it takes any sequence length (the last tile is
masked) and any strides on the B, H and S axes, with unit stride on hd,
so the model's (B, S, H, hd) activations pass as ``transpose(1, 2)``
views without a copy.

bf16 and f16 run on the tensor cores (wgmma, operands loaded by TMA,
which needs 16-byte aligned rows); f32 runs the FFMA kernel.

`flash_attention_bwd_cuda` is the gradient: dQ, dK and dV from the
forward's output and its rows' log-sum-exp, in three launches, every sum
in f32 and in one fixed order: D = rowsum(dO o O) (`flash_bwd_delta`);
dK and dV a kv tile, summed over the group's query heads; dQ a query
tile. In bf16 and f16 the last two are tensor-core kernels
(`flash_bwd_dkdv_tc`, `flash_bwd_dq_tc`: wgmma on TMA-loaded tiles, P and
dS rounded to the operand dtype before their products, as
`ref.attention_bwd_rounded_ref` computes them); in f32 they are FFMA
kernels (`flash_bwd_dkdv`, `flash_bwd_dq`), chosen by dtype as the
forward chooses. It takes the forward's sliding window and walks only
the band, and every head dim the forward takes. The JAX package has no
backward kernel: its models differentiate the chunked scan
`_attend_chunked` (src/repro/models/attention.py:77-143).
`FlashAttentionFn` ties the two kernels into autograd.

On ``meta`` operands (the dry run) the wrappers and `FlashAttentionFn`
return empty outputs of the kernels' shapes and dtypes (out; lse f32
(B, H, Sq); dq, dk, dv) and book the kernels' work (`kernels.book`):
4·hd operations for each (q, k) pair inside the tiles the forward visits
(`_visited_pairs`: causal tiles above the diagonal, and tiles outside the
window, are skipped), 10·hd for each pair the backward's dK/dV walk
visits, and the bytes of q, k, v, out and lse, plus dout, dq, dk and dv
for the backward. Nothing is built or launched.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import DTYPE_CODES, LAUNCHES, book, check_operand, stream_of
from ..build import check, load
from .ref import attention_bwd_ref, attention_ref

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda",
           "FlashAttentionFn", "flash_attention_work",
           "flash_attention_attributes",
           "flash_attention_bwd_attributes", "flash_attention_bwd_kernels",
           "SUPPORTED_HEAD_DIMS", "BWD_HEAD_DIMS"]

SUPPORTED_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 160)  # launch_hd in the source
BWD_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 160)       # launch_bwd_hd in the source


def _tiles(dtype: torch.dtype, hd: int, backward: bool) -> tuple[int, int]:
    """(query rows, key rows) of the tile a kernel walks: the f32 FFMA
    kernels 64 x 64 (kBQ, kBK); the tensor-core forward 128 x 128 (kTcBQ,
    kTcBK); the tensor-core dK/dV kernel 64 (32 above hd 128) x 128."""
    if dtype == torch.float32:
        return 64, 64
    if backward:
        return (64 if hd <= 128 else 32), 128
    return 128, 128


@functools.lru_cache(maxsize=None)
def _visited_pairs(sq: int, skv: int, causal: bool, window: int, bq: int, bk: int,
                  kv_outer: bool = False) -> int:
    """(q, k) pairs inside the tiles a kernel visits for one (batch, head):
    the forward's walk (a block of `bq` query rows over the key tiles of
    `bk` rows, up to the diagonal tile when causal, from the band's first
    tile under a window), or with `kv_outer` the backward's dK/dV walk (a
    tile of `bk` keys over the query blocks from its first row k0 when
    causal, up to k0 + bk - 1 + window under a window). Pairs past Sq or
    Skv do not count."""
    pairs = 0
    if kv_outer:
        for k0 in range(0, skv, bk):
            q_begin = k0 if causal else 0
            q_end = min(sq, k0 + bk - 1 + window) if window else sq
            if q_end <= q_begin:
                continue
            blocks = -(-(q_end - q_begin) // bq)
            pairs += (min(q_begin + blocks * bq, sq) - q_begin) * min(bk, skv - k0)
        return pairs
    n_all = -(-skv // bk)
    for q0 in range(0, sq, bq):
        n_tiles = n_all
        if causal:
            n_tiles = min(n_tiles, (min(q0 + bq, sq) - 1) // bk + 1)
        t_lo = max(0, q0 - window + 1) // bk if window else 0
        if n_tiles > t_lo:
            pairs += min(bq, sq - q0) * (min(n_tiles * bk, skv) - t_lo * bk)
    return pairs


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def flash_attention_work(q_shape, k_shape, dtype: torch.dtype, *, causal: bool,
                         window: int = 0, backward: bool = False) -> int:
    """Operations of one B6 launch (4·hd a visited pair), or of one B6-bwd
    launch with `backward` (10·hd a pair of its dK/dV walk), over every
    (batch, head) of q (B, H, Sq, hd) against k (B, KV, Skv, hd)."""
    b, h, sq, hd = q_shape
    bq, bk = _tiles(dtype, hd, backward)
    pairs = _visited_pairs(sq, k_shape[2], bool(causal), int(window), bq, bk,
                          kv_outer=backward)
    return (10 if backward else 4) * hd * pairs * b * h


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q, k, v are operands of the kernels or their plain
    versions: one dtype and device, k and v alike, H a multiple of KV."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(t, name, 4, meta_ok=True)
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    b, h, _, hd = q.shape
    n_kv = k.shape[1]
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if n_kv == 0 or h % n_kv:
        raise ValueError(f"H={h} must be a multiple of KV={n_kv}")
    if k.shape[2] == 0:
        raise ValueError("attention over an empty key sequence")


def _check_window(causal: bool, window: int) -> None:
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if window and not causal:
        raise ValueError("a sliding window needs causal attention; no config "
                         "asks for a bidirectional window")


def _check_kernel_layout(*named: tuple[str, torch.Tensor]) -> None:
    """Raise unless every CUDA operand has a head dim the kernels are built
    for and unit stride on it."""
    hd = named[0][1].shape[3]
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the kernel's {SUPPORTED_HEAD_DIMS}")
    for name, t in named:
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the flash attention kernels need unit "
                             "stride on hd")


def _tma_ok(t: torch.Tensor) -> bool:
    """Whether TMA can load `t`: a 16-byte aligned base and 16-byte
    multiples of the strides of its B, H and S axes (of those longer
    than 1)."""
    return not (t.data_ptr() % 16 or any(t.stride(i) * t.element_size() % 16
                                         for i in range(3) if t.shape[i] > 1))


def _check_tma(*named: tuple[str, torch.Tensor]) -> None:
    """Raise unless every operand of a bf16 or f16 (tensor-core) kernel
    meets TMA's rule."""
    if named[0][1].dtype == torch.float32:
        return
    for name, t in named:
        if not _tma_ok(t):
            raise ValueError(f"{name}: the tensor-core kernel loads by TMA, "
                             "which needs a 16-byte aligned base and strides")


def _forward(q, k, v, causal: bool, want_lse: bool, window: int = 0):
    """Launch the forward kernel on CUDA operands: (out, lse or None); on
    meta operands, book it and return empty outputs."""
    _check_kernel_layout(("q", q), ("k", k), ("v", v))
    if q.device.type == "meta":
        out = torch.empty_like(q)
        lse = (torch.empty((q.shape[0], q.shape[1], q.shape[2]), dtype=torch.float32,
                           device=q.device) if want_lse else None)
        book("flash_attention",
             flash_attention_work(q.shape, k.shape, q.dtype, causal=causal, window=window),
             _nbytes(q, k, v, out, *(() if lse is None else (lse,))))
        return out, lse
    _check_tma(("q", q), ("k", k), ("v", v))
    b, h, sq, hd = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)  # keeps q's layout when q is dense
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        err = load("flash_attention").repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if want_lse else None,
            b, h, n_kv, sq, skv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(causal), int(window), hd ** -0.5, DTYPE_CODES[q.dtype], stream_of(q))
    check(err, "flash_attention kernel")
    LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KV, Skv, hd); H % KV == 0; `window` > 0
    needs `causal`. The result carries no autograd history on CUDA:
    `FlashAttentionFn` differentiates."""
    _check_qkv(q, k, v)
    _check_window(causal, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    return _forward(q, k, v, causal, want_lse=False, window=window)[0]


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, dout: torch.Tensor,
                             lse: torch.Tensor | None = None, *,
                             causal: bool = True, window: int = 0):
    """(dq, dk, dv) of ``out = attention(q, k, v)`` given ``dout``, in the
    operands' dtype and layouts; `window` as the forward's. `lse` is the
    forward's (B, H, Sq) f32 log-sum-exp (`FlashAttentionFn` keeps it). On
    the CPU it is the plain version, `attention_bwd_ref`, which needs
    neither `out` nor `lse`."""
    _check_qkv(q, k, v)
    _check_window(causal, window)
    if tuple(dout.shape) != tuple(q.shape) or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not match "
                         f"q {tuple(q.shape)} {q.dtype}")
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, dout, causal=causal, window=window)
    b, h, sq, hd = q.shape
    n_kv, skv = k.shape[1], k.shape[2]
    if (lse is None or tuple(lse.shape) != (b, h, sq) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("the backward kernel needs the forward's (B, H, Sq) f32 "
                         "contiguous log-sum-exp")
    if tuple(out.shape) != tuple(q.shape) or out.dtype != q.dtype:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} does not match q")
    if any(t.device != q.device for t in (out, dout, lse)):
        raise ValueError("out, dout and lse must lie on q's device")
    named = (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout))
    _check_kernel_layout(*named)
    if q.device.type == "meta":
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        book("flash_attention_bwd",
             flash_attention_work(q.shape, k.shape, q.dtype, causal=causal,
                                  window=window, backward=True),
             _nbytes(q, k, v, out, lse, dout, dq, dk, dv))
        return dq, dk, dv
    _check_tma(*named)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dq, dk, dv
    if sq == 0:  # no query row: dK and dV are zero, and nothing launches
        return dq, dk.zero_(), dv.zero_()
    # D, then lse·log2(e), each (B, H, Sq padded to 128 rows) f32 (bwd_ld in the source)
    delta = torch.empty(2 * b * h * (-(-sq // 128) * 128), dtype=torch.float32,
                        device=q.device)
    with torch.cuda.device(q.device):
        err = load("flash_attention").repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(),
            b, h, n_kv, sq, skv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            *dout.stride()[:3], *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            int(causal), int(window), hd ** -0.5, DTYPE_CODES[q.dtype], stream_of(q))
    check(err, "flash_attention backward kernel")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention on CUDA operands with its backward kernel: the
    forward launches B6 with the log-sum-exp output and keeps (q, k, v, out,
    lse); the backward launches B6-bwd with the same `window`.
    ``FlashAttentionFn.apply(q, k, v, causal, window=0)``. A head dim the
    kernels are not built for raises before the forward launches."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window=0):
        _check_qkv(q, k, v)
        _check_window(bool(causal), window)
        if q.shape[3] not in BWD_HEAD_DIMS:
            raise ValueError(f"attention with a gradient at head_dim {q.shape[3]}: "
                             f"the backward kernels take {BWD_HEAD_DIMS}")
        if q.device.type not in ("cuda", "meta"):
            raise ValueError("FlashAttentionFn runs the CUDA kernels (or books "
                             "them on meta); on the CPU autograd differentiates "
                             "attention_ref")
        out, lse = _forward(q, k, v, bool(causal), want_lse=True, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = bool(causal), window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd picks dout's layout; the kernels read rows, by TMA in bf16 and f16
        # (a fresh copy: `contiguous` keeps a dense tensor's misaligned base)
        if dout.stride(3) != 1 or (dout.dtype != torch.float32 and not _tma_ok(dout)):
            dout = dout.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                              causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_attributes(dtype: torch.dtype, hd: int) -> dict:
    """Registers a thread, shared memory a block (static and dynamic) and
    spilled bytes of the kernel that `dtype` and `hd` launch, as the CUDA
    runtime reports them. Needs the card's toolkit: it builds the kernels."""
    out = (ctypes.c_int * 4)()
    check(load("flash_attention").repro_flash_attention_attributes(
        DTYPE_CODES[dtype], hd, out), "flash_attention attributes")
    return {"registers": out[0], "static_smem": out[1], "dynamic_smem": out[2],
            "local_bytes": out[3]}


def flash_attention_bwd_kernels(dtype: torch.dtype) -> dict:
    """The dK/dV and dQ kernels that `dtype` launches (besides
    `flash_bwd_delta`): {"dkdv": name, "dq": name}."""
    tc = "" if dtype == torch.float32 else "_tc"
    return {"dkdv": f"flash_bwd_dkdv{tc}", "dq": f"flash_bwd_dq{tc}"}


def flash_attention_bwd_attributes(dtype: torch.dtype, hd: int, *,
                                   window: bool = False) -> dict:
    """Registers, shared memory and spills of the backward's dK/dV and dQ
    kernels that `dtype` launches at `hd` (with `window`, their
    sliding-window builds): {"dkdv": {"kernel": name, ...}, "dq": {...}}."""
    lib = load("flash_attention")
    got = {}
    for which, (name, kernel) in enumerate(flash_attention_bwd_kernels(dtype).items()):
        out = (ctypes.c_int * 4)()
        check(lib.repro_flash_attention_bwd_attributes(
            DTYPE_CODES[dtype], hd, which + 2 * window, out),
            "flash_attention backward attributes")
        got[name] = {"kernel": kernel, "registers": out[0], "static_smem": out[1],
                     "dynamic_smem": out[2], "local_bytes": out[3]}
    return got
