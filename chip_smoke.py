#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build, check and time it.

    python3 chip_smoke.py            # full width: n = 16384, bs = 1024, f32;
                                     # granite-8b at B = 4, S = 2048

Phases, each of which fails the run (non-zero exit) on any fault:

  1. the card's name and power limit, from nvidia-smi;
  2. build every CUDA kernel of the port from src/repro_torch/kernels/csrc,
     and print the registers, shared memory and spills of the tensor-core
     GEMM body (f32, bf16, f16; 64- and 128-row tiles), of the tensor-core
     flash attention kernel (every head dim), of the in-place
     Gauss-Jordan kernel, and of the blocked leaves' kernels: the
     triangular solve's tensor-core sweep (every strip width), its
     diagonal-block inverse and pack, and the blocked Gauss-Jordan's panel
     and tensor-core update;
  3. hold each kernel against its plain PyTorch version on the card, at the
     main paths' shapes, in f32 and bf16, and time kernel, plain version
     and the one PyTorch library call that computes the same function
     (the GEMM at 8192³, the inversion's top-level product, and at 4096³,
     2048³ and 1024³, its deeper levels, with the pack pre-pass of its
     tensor-core body timed apart, and its bf16 body at 8192³ and 4096³,
     the bf16 preset's top levels; the blocked Gauss-Jordan, in place with
     one 3xTF32 wgmma update a panel, at 1 x 1024²; the scalar
     Gauss-Jordan at 1 x 128² and 16 x 128²; the triangular solve, which
     inverts the diagonal blocks first and then runs one 3xTF32 wgmma
     product a panel, on a 1024 x 1024 packed LU against the 15616
     right-hand sides of the solve's widest leaf, both sweeps, and timed
     at k = 256, 4352 and 15616 beside torch.linalg.solve_triangular; the
     LU baseline's leaf, torch.linalg.lu_factor_ex(pivot=False), against
     its plain loop at 1024²; flash attention at the granite-8b layer,
     B = 4, H = 32, KV = 8, S = 2048, hd = 128, causal, in bf16, f16 and
     f32, plus a ragged S = 2000 and a non-causal case);
  4. SPIN inversion, `spin_inverse_dense(engine="cuda", leaf_solver="cuda")`,
     at n = 16384, block_size = 1024: residual ‖AX − I‖∞ ≤ 1e-3, op counts
     equal to the paper's oracle, and the kernels it launched; in this
     phase and the next five every matmul and schur_update launch must
     have taken the GEMM's tensor-core body;
  5. the paper's baseline, `lu_inverse_dense`, at the same size, timed
     beside SPIN, and SPIN ÷ LU from this run;
  6. the inverse-free solve, `spin_solve_dense(engine="cuda",
     leaf_solver="cuda")`, of the same matrix against 256 right-hand
     sides: residual ‖AX − B‖∞ / ‖B‖∞ ≤ 1e-3, the inverse-free op profile
     (no multiply, arrange or leaf inversion), and the kernels it launched
     (the GEMM and the triangular solve, nothing else);
  7. the bf16 preset on the same matrix, `spin_inverse_dense(...,
     precision="bf16")`: the raw bf16 recursion (no polish) and the
     polished call, each timed, bf16 out, residual ≤ the preset's bound
     (2e-2); 30 schur_update and 60 matmul launches on bf16 operands plus
     2 f32 matmul launches a polish sweep, 16 blocked Gauss-Jordan leaves;
     and a small `spin_solve_dense(..., precision="bf16")` that returns at
     b's dtype;
  8. the Strassen engine on the same matrix, `spin_inverse_dense(...,
     engine="strassen")` at the default cutoff: residual ≤ 1e-3, the
     paper's op counts, the Strassen counters equal to
     `verify.expected_spin_strassen_counts` ((2862, 8316) at cutoff 512),
     and one GEMM launch a classical leaf, split between schur_update (the
     Schur updates that are one leaf) and matmul as
     `fused_strassen_leaves` derives it;
  9. the planner on the same matrix: `spin_inverse_dense(engine="cuda",
     leaf_solver="cuda")` timed at block sizes 512, 1024, 2048 and 4096
     (turns of 2 calls) beside the CUDA pricing's prediction for each;
     then `spin_inverse_dense(a)` with no block size: it must rank once,
     write the port's plan file, pick engine `cuda` and a block size
     within 1.10x of the sweep's fastest, meet the residual bound, launch
     B1, B2 and B3, and give the same bits as the explicit call with the
     plan, which a fresh cache object recalls from the file without
     ranking again; and the planned solve, `spin_solve_dense(a, b)` of
     256 right-hand sides (B2 and B5);
 10. the SMW update of that inverse: dense and BlockMatrix at rank 64, and
     a replaced symmetric block row at bs = 1024 (rank 2048), each timed,
     ‖A'X' − I‖∞ ≤ 1e-3, `smw_update_solve`'s residual on the 256
     right-hand sides ≤ 1e-3 and `estimate_inverse_residual` beside the
     true residual; the refactor policy's crossover rank beside the one
     measured (the re-inversion over a rank-1 update's time);
 11. the sketched inverse, `sketched_approx_inverse` under the kernel
     engine: sweeps, seconds, residual_est ≤ 1e-3, two GEMM launches a
     sweep;
 12. `CheckpointedSpin(leaf_solver="cuda")` under the kernel engine at
     n = 4096, bs = 512, interrupted from `on_op` at node "0/VI" and
     resumed by a fresh object: the same bits as an uninterrupted run,
     with loaded_ops > 0; and the inverse through `save_blockmatrix` /
     `load_blockmatrix` in f32 and bf16, bit for bit (the files in a
     temporary directory that the phase removes);
 13. the online inverse server, `SpinService(slots=8)`, on the same
     matrix: `add_matrix("gram", a)` recalls phase 9's plan from the plan
     file without ranking (bs 1024, the `cuda` engine and leaf; 30 B1, 60
     B2, 16 B3); 4 ticks of 8 requests of 32 columns, each one coalesced
     solve (30 B2, 32 B5) bitwise the offline `spin_solve_dense` on the
     stacked panel; a rank-64 update (reason "smw") and 4 ticks on the
     maintained path; rank-64 updates until the refactor policy
     re-factorizes, at exactly its modeled crossover, and a tick bitwise
     the offline solve on A'; a bf16 tenant served from its bf16 inverse
     (one B2 bf16 launch a tick, residuals ≤ 2e-2); the dashboard
     (latency percentiles, counters); on the leading 4096² block at bs
     512: residency with one resident matrix (4 evictions, 3
     rehydrations, the same bits), snapshot / restore and an async
     snapshot followed by an update, a straggler past a 0.5 s deadline
     served degraded from the sketch and recovered after it lands, a
     transient failure retried once; and, traced, one planned inversion
     (15 spin.level and 16 spin.leaf spans, one planner.plan event, one
     ledger.solve entry: predicted over measured seconds) and two
     serve.tick spans. Every residual ≤ its bound, every time from CUDA
     events (the service's own timestamps are dispatch latencies);
 14. the crossover: the dense `strassen_matmul` with one split (cutoff
     n/2) against one GEMM launch at n = 8192, 16384 and 32768, f32, timed
     in turns, beside `costmodel.strassen_crossover_n()`;
 15. a smaller inversion with `leaf_solver="gauss_jordan"`, the path of
     the scalar Gauss-Jordan kernel;
 16. the dense LM serving path at full width and depth: granite-8b with
     random weights from SEED, `prefill` of 4 prompts of 2048 tokens (36
     flash attention launches and no other kernel of the port), 32 greedy
     `decode_step`s from the padded cache, the decode logits of the first
     8 steps against `forward` over prompt plus those tokens, and a
     `ServingEngine` (4 slots, max_len 256) answering 8 requests, one of
     which must equal the same request served alone;
 17. one JSON line with every path's times and residual, and one with
     every kernel's launches, error and times (the GEMM's, blocked
     Gauss-Jordan's and triangular solve's launches on every path beside
     them).

The last line is {"ok": true, "device": {...}}. The script imports only
the PyTorch port; it exits non-zero without a result when CUDA is missing
or when it is not run from a checkout of the repository. The planner's
plan file lies in a temporary directory of the run's own
(SPIN_PLAN_CACHE), removed at the end.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM (NVIDIA's data sheet; dense, 700 W).
PEAK_F32_FLOPS = 67e12        # f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12      # TF32 on the tensor cores
PEAK_BF16_FLOPS = 989e12      # bf16 and f16 on the tensor cores
PEAK_BYTES = 3.35e12          # HBM3

RESIDUAL_BOUND = 1e-3         # f32 residual bound of the conformance table
SEED = 0
REPS = 2                      # timed runs of each inversion path
N, BLOCK_SIZE = 16384, 1024      # the main path: grid 16, four levels
GEMM_SIZES = (8192, 4096, 2048, 1024)   # the inversion's products, level by level
BF16_GEMM_SIZES = (8192, 4096)    # the bf16 body timed: the two top levels
CROSSOVER_SIZES = (8192, 16384, 32768)  # one Strassen split against one GEMM launch
SOLVE_BF16_N, SOLVE_BF16_RHS = 4096, 16  # the small bf16 solve
N_RHS = 256                       # right-hand sides of the solve path
TRI_TIMED_K = (256, 4352, N_RHS + N - BLOCK_SIZE)  # B5 widths timed: narrowest leaf .. widest
GJ_N, GJ_BLOCK_SIZE = 2048, 128   # the scalar Gauss-Jordan leaf's path
SWEEP_BLOCK_SIZES = (512, 1024, 2048, 4096)  # the U-shape timed beside the planner
PLAN_WITHIN = 1.10                # the planned block size's time over the sweep's best
SMW_RANK = 64                     # the SMW update's rank k
SMW_BLOCK_ROW = 3                 # the block row replaced at bs = BLOCK_SIZE (rank 2 bs)
CKPT_N, CKPT_BLOCK_SIZE = 4096, 512  # the checkpointed inversion (bounds the disk)
CKPT_STOP = "0/VI"                # the node at which it is interrupted
SERVICE_SLOTS = 8                 # SpinService slots: one tick coalesces them all
SERVICE_REQUESTS, SERVICE_COLS = 8, 32  # requests a tick, columns a request (256 a tick)
SERVICE_TICKS = 4                 # ticks timed on each serving path
SERVICE_SIDE_N, SERVICE_SIDE_BLOCK_SIZE = 4096, 512  # residency, snapshots, degraded mode
SERVICE_DEADLINE_S, SERVICE_STRAGGLE_S = 0.5, 2.0    # the solve deadline and the straggler

LM_ARCH = "granite-8b"            # the LM serving path, full width and depth
LM_BATCH, LM_SEQ = 4, 2048        # prefill: 4 prompts of 2048 tokens
LM_DECODE_STEPS = 32              # greedy decode steps after the prefill
LM_CHECK_STEPS = 8                # decode steps held against `forward`
# Largest |decode logit - forward logit| allowed at those steps (PERF.md
# §6, PR 13). The two paths round the same bf16 activations at different
# places (one-token GEMMs against full-sequence ones, plain attention
# against the kernel): about one bf16 ulp (2^-8 relative) of each
# activation a layer, ≈ 0.004 rms a logit through the f32 head (‖h‖ = 64,
# weights of scale 0.02). `python -m repro_torch.profile_lm --consistency`
# measures that drift growing as depth^0.72 to ≈ 0.05 rms at 36 layers,
# and the largest of the 1.6M logits compared sits ≈ 5.5 rms out: ≈ 0.3.
# The bound keeps a margin of about 1.7 over that.
LM_CONSISTENCY_BOUND = 0.5
SERVE_SLOTS, SERVE_MAX_LEN = 4, 256
SERVE_REQUESTS, SERVE_NEW_TOKENS = 8, 16
SERVE_PROMPT_LENS = (16, 64)      # prompt lengths drawn from this range
# Flash attention tolerances of the reference's own test
# (tests/test_flash_attention.py): bf16 keeps 8 mantissa bits, f16 11.
FLASH_TOL = {"float32": 2e-3, "bfloat16": 2e-2, "float16": 1e-2}


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` calls, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def gemm_bound_ms(m: int, n: int, k: int, with_c: bool, itemsize: int) -> tuple[float, str]:
    """The f32 product on the FFMA units: 2mnk operations at 67 TFLOP/s."""
    flops = 2.0 * m * n * k + (2.0 * m * n if with_c else 0.0)
    nbytes = itemsize * (m * k + k * n + m * n * (2 if with_c else 1))
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def gemm_tc_bound_ms(m: int, n: int, k: int, with_c: bool, itemsize: int) -> tuple[float, str]:
    """The product as the tensor-core body does it: f32 as three TF32
    products (3·2mnk operations at 495 TFLOP/s), bf16 and f16 as one (at
    989). Bytes: each input read once, the output written once."""
    products, peak = (3, PEAK_TF32_FLOPS) if itemsize == 4 else (1, PEAK_BF16_FLOPS)
    flops = products * 2.0 * m * n * k
    nbytes = itemsize * (m * k + k * n + m * n * (2 if with_c else 1))
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def gauss_jordan_bound_ms(batch: int, bs: int, itemsize: int,
                          peak_flops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    # Inverting a bs x bs matrix takes bs³ multiply-adds, 2·bs³ operations,
    # once the sweep skips the columns of [A | I] that are still zero or
    # identity; as 3xTF32 products (peak_flops the TF32 peak), three times
    # as many.
    flops = 2.0 * batch * bs ** 3 * (3 if peak_flops == PEAK_TF32_FLOPS else 1)
    nbytes = 2.0 * itemsize * batch * bs * bs
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def triangular_solve_bound_ms(batch: int, bs: int, k: int, itemsize: int,
                              peak_flops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    # bs²/2 multiply-adds a right-hand side, bs²·k operations, at
    # `peak_flops` (the kernel's 3xTF32 products: 3·bs²·k at the TF32
    # peak); T read once, B read once and X written once.
    flops = float(batch) * bs * bs * k * (3 if peak_flops == PEAK_TF32_FLOPS else 1)
    nbytes = itemsize * batch * (bs * bs + 2.0 * bs * k)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def flash_bound_ms(b: int, h: int, kv: int, sq: int, skv: int, hd: int,
                   causal: bool, itemsize: int, peak_flops: float) -> tuple[float, str]:
    # 4·hd operations a live (q, k) pair (the score and the weighted sum);
    # causal rows see kv positions 0..q only. q and o, k and v once each.
    n = min(sq, skv)
    pairs = n * (n + 1) // 2 + (sq - n) * skv if causal else sq * skv
    flops = 4.0 * hd * b * h * pairs
    nbytes = itemsize * hd * (2.0 * b * h * sq + 2.0 * b * kv * skv)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def max_abs(x, y) -> float:
    return float((x.float() - y.float()).abs().max())


def check_kernels(torch, rng, n_gemm: int, bs: int, gj_bs: int, tri_k: int) -> dict:
    """Phase 3: every kernel against its plain version, and its times."""
    from repro_torch.kernels.leaf_inverse import kernel as gj, ref as gj_ref
    from repro_torch.kernels.matmul import kernel as mm, ref as mm_ref
    from repro_torch.core.testing import make_spd
    import numpy as np

    dev = torch.device("cuda")
    report = {}

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    m = n = k = n_gemm
    a32, b32, c32 = normal(m, k), normal(k, n), normal(m, n)
    for dtype in (torch.float32, torch.bfloat16):
        a, b, c = a32.to(dtype), b32.to(dtype), c32.to(dtype)
        cases = {
            "matmul": (lambda: mm.matmul_cuda(a, b), lambda: mm_ref.matmul_ref(a, b),
                       lambda: torch.matmul(a, b)),
            "schur_update": (lambda: mm.schur_update_cuda(c, a, b, alpha=1.0, beta=-1.0),
                             lambda: mm_ref.schur_update_ref(c, a, b, 1.0, -1.0),
                             lambda: torch.addmm(c, a, b, beta=-1.0, alpha=1.0)),
            "schur_update_c11": (lambda: mm.schur_update_cuda(c, a, b, alpha=-1.0, beta=1.0),
                                 lambda: mm_ref.schur_update_ref(c, a, b, -1.0, 1.0),
                                 None),
        }
        for name, (kern, plain, _lib) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = max_abs(got, want)
            scale = float(want.float().abs().max())
            # f32: the two differ only in summation order, ≈ √k·ε of the
            # largest entry; bf16: both round the f32 sum once, so at most
            # one bf16 ulp (2^-7 relative) of the largest entry.
            tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * scale
            print(f"check {name} {str(dtype)[6:]} {m}x{k}x{n}: max_abs_err={err!r} "
                  f"tol={tol!r}", flush=True)
            require(got.dtype == want.dtype and got.shape == want.shape,
                    f"{name} {dtype}: dtype/shape differ from the plain version")
            require(err <= tol, f"{name} {dtype}: max_abs_err {err} > {tol}")
            if dtype == torch.float32 and name in ("matmul", "schur_update"):
                report[name] = {"max_abs_err": err}
        del got, want
    # f32 times at each level's product size, the first on the inputs above:
    # kernel (pack pre-pass included), its pack pre-pass alone, the plain
    # version and the library call; bound_ms is the tensor-core body's
    # (3 TF32 products), ffma_bound_ms the f32 FFMA one.
    for size in GEMM_SIZES:
        if size == n_gemm:
            a, b, c = a32, b32, c32
        else:
            a, b, c = normal(size, size), normal(size, size), normal(size, size)
        for name, with_c, kern, plain, lib in (
                ("matmul", False, lambda: mm.matmul_cuda(a, b),
                 lambda: mm_ref.matmul_ref(a, b), lambda: torch.matmul(a, b)),
                ("schur_update", True, lambda: mm.schur_update_cuda(c, a, b),
                 lambda: mm_ref.schur_update_ref(c, a, b),
                 lambda: torch.addmm(c, a, b, beta=-1.0, alpha=1.0))):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = max_abs(got, want)
            tol = 1e-5 * float(want.abs().max())
            print(f"check {name} float32 {size}^3: max_abs_err={err!r} tol={tol!r}", flush=True)
            require(err <= tol, f"{name} {size}^3: max_abs_err {err} > {tol}")
            del got, want
            bound, by = gemm_tc_bound_ms(size, size, size, with_c, 4)
            times = {"ms": time_ms(kern, 5), "pack_ms": time_ms(lambda: mm.gemm_pack_cuda(a, b), 5),
                     "plain_ms": time_ms(plain, 5), "library_ms": time_ms(lib, 5),
                     "bound_ms": bound, "bound_by": by,
                     "ffma_bound_ms": gemm_bound_ms(size, size, size, with_c, 4)[0],
                     "max_abs_err": err}
            print(f"time {name} float32 {size}^3: {times}", flush=True)
            if size == n_gemm:
                report[name].update(times, shape=f"{size}x{size}x{size} f32")
            report[name].setdefault("by_size", {})[str(size)] = times
        del a, b, c
    del a32, b32, c32
    torch.cuda.empty_cache()
    # bf16 times (the bf16 preset's recursion runs on this body) at the
    # inversion's two top levels, on inputs of their own so that the later
    # phases' draws stay as they were: kernel, pack, plain version, library
    # call and the bound of one bf16 tensor-core product (989 TFLOP/s).
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for size in BF16_GEMM_SIZES:
        a, b, c = (torch.randn(size, size, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        for name, with_c, kern, plain, lib in (
                ("matmul", False, lambda: mm.matmul_cuda(a, b),
                 lambda: mm_ref.matmul_ref(a, b), lambda: torch.matmul(a, b)),
                ("schur_update", True, lambda: mm.schur_update_cuda(c, a, b),
                 lambda: mm_ref.schur_update_ref(c, a, b),
                 lambda: torch.addmm(c, a, b, beta=-1.0, alpha=1.0))):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = max_abs(got, want)
            tol = 2.0 ** -7 * float(want.float().abs().max())
            print(f"check {name} bfloat16 {size}^3: max_abs_err={err!r} tol={tol!r}", flush=True)
            require(got.dtype == torch.bfloat16 and err <= tol,
                    f"{name} bf16 {size}^3: max_abs_err {err} > {tol}")
            del got, want
            bound, by = gemm_tc_bound_ms(size, size, size, with_c, 2)
            times = {"ms": time_ms(kern, 5), "pack_ms": time_ms(lambda: mm.gemm_pack_cuda(a, b), 5),
                     "plain_ms": time_ms(plain, 5), "library_ms": time_ms(lib, 5),
                     "bound_ms": bound, "bound_by": by, "max_abs_err": err}
            print(f"time {name} bfloat16 {size}^3: {times}", flush=True)
            report[name].setdefault("bf16_by_size", {})[str(size)] = times
        del a, b, c
    torch.cuda.empty_cache()

    # Leaf kernels on SPD blocks, the matrices SPIN's leaves see.
    for name, size, kern, plain in (
            ("blocked_gauss_jordan", bs, gj.blocked_leaf_inverse_cuda,
             lambda x: gj_ref.blocked_gauss_jordan_ref(x, gj.default_panel(x.shape[1]))),
            ("gauss_jordan", gj_bs, gj.leaf_inverse_cuda, gj_ref.gauss_jordan_ref)):
        blocks32 = make_spd(size, rng, device=dev)[None].contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            blocks = blocks32.to(dtype)
            got, want = kern(blocks), plain(blocks)
            torch.cuda.synchronize()
            err = max_abs(got, want)
            scale = float(want.float().abs().max())
            # f32: the sweeps round as the plain version does; the blocked
            # kernel's rank-t updates sum in another order, amplified by the
            # block's condition (≈ 10). bf16: one ulp of the final cast.
            tol = (1e-4 if dtype == torch.float32 else 2.0 ** -7) * scale
            print(f"check {name} {str(dtype)[6:]} 1x{size}x{size}: max_abs_err={err!r} "
                  f"tol={tol!r}", flush=True)
            require(got.dtype == want.dtype and got.shape == want.shape,
                    f"{name} {dtype}: dtype/shape differ from the plain version")
            require(bool(torch.isfinite(got.float()).all()), f"{name} {dtype}: non-finite")
            require(err <= tol, f"{name} {dtype}: max_abs_err {err} > {tol}")
            if dtype == torch.float32:
                # The blocked sweep's O(bs³) work is 3xTF32 products; the
                # scalar sweep's is f32 FFMA.
                tc = name == "blocked_gauss_jordan"
                bound, by = gauss_jordan_bound_ms(
                    1, size, 4, PEAK_TF32_FLOPS if tc else PEAK_F32_FLOPS)
                report[name] = {
                    "max_abs_err": err, "ms": time_ms(lambda: kern(blocks), 5),
                    "plain_ms": time_ms(lambda: plain(blocks), 2),
                    "library_ms": time_ms(lambda: torch.linalg.inv(blocks), 5),
                    "bound_ms": bound, "bound_by": by, "shape": f"1x{size}x{size} f32"}
                if tc:
                    report[name]["ffma_bound_ms"] = gauss_jordan_bound_ms(1, size, 4)[0]

    # The scalar Gauss-Jordan at batch 16 (16 blocks, one SM each), held
    # step-exact: the kernel rounds every step as the plain version does.
    brng = np.random.default_rng([SEED, 2])
    blocks = torch.stack([make_spd(gj_bs, brng, device=dev) for _ in range(16)])
    got, want = gj.leaf_inverse_cuda(blocks), gj_ref.gauss_jordan_ref(blocks)
    torch.cuda.synchronize()
    err = max_abs(got, want)
    tol = 1e-5 * float(want.abs().max())
    print(f"check gauss_jordan float32 16x{gj_bs}x{gj_bs}: max_abs_err={err!r} tol={tol!r}",
          flush=True)
    require(got.shape == want.shape and bool(torch.isfinite(got).all()),
            "gauss_jordan batch 16: shape or non-finite")
    require(err <= tol, f"gauss_jordan batch 16: max_abs_err {err} > {tol}")
    report["gauss_jordan"].update(
        batch16_ms=time_ms(lambda: gj.leaf_inverse_cuda(blocks), 5),
        batch16_library_ms=time_ms(lambda: torch.linalg.inv(blocks), 5),
        batch16_max_abs_err=err)
    del blocks, got, want

    # The triangular solve at the solve path's widest leaf: the packed LU
    # of an SPD block as torch.linalg.lu_factor_ex leaves it (column-major),
    # and the widest right-hand side the recursion hands a leaf.
    spd = make_spd(bs, rng, device=dev)
    t32 = torch.linalg.lu_factor_ex(spd)[0][None]
    b32 = normal(1, bs, tri_k)
    panel = gj.default_panel(bs)
    sweeps = {"lower_unit": (True, True), "upper": (False, False)}
    f32_errs = []
    for dtype in (torch.float32, torch.bfloat16):
        t, b = t32.to(dtype), b32.to(dtype)
        for sweep, (lower, unit) in sweeps.items():
            got = gj.triangular_solve_cuda(t, b, lower=lower, unit_diagonal=unit)
            want = gj_ref.blocked_triangular_solve_ref(t, b, panel, lower=lower,
                                                       unit_diagonal=unit)
            torch.cuda.synchronize()
            err = max_abs(got, want)
            scale = float(want.float().abs().max())
            # f32: the kernel applies the inverted diagonal blocks as 3xTF32
            # products, where the plain version runs Gauss-Jordan sweeps and
            # rank-t updates: the same solution, rounded in another order.
            # bf16: one ulp of the final cast.
            tol = (1e-4 if dtype == torch.float32 else 2.0 ** -7) * scale
            print(f"check triangular_solve {sweep} {str(dtype)[6:]} 1x{bs}x{bs} "
                  f"k={tri_k}: max_abs_err={err!r} tol={tol!r}", flush=True)
            require(got.dtype == want.dtype and got.shape == want.shape,
                    f"triangular_solve {sweep} {dtype}: dtype/shape differ")
            require(bool(torch.isfinite(got.float()).all()),
                    f"triangular_solve {sweep} {dtype}: non-finite")
            require(err <= tol, f"triangular_solve {sweep} {dtype}: "
                                f"max_abs_err {err} > {tol}")
            if dtype == torch.float32:
                f32_errs.append(err)
        del got, want
    # Times at the leaves' narrowest, a middle and the widest k (the solve's
    # leaves see 256, 1280, ..., 15616): kernel, plain version (widest only,
    # it is slow) and the library call, each sweep. The row reports the
    # unit-lower sweep at the widest k; the rest rides along in by_k.
    by_k = {}
    for k in TRI_TIMED_K:
        t, b = t32, (b32 if k == tri_k else normal(1, bs, k))
        row = {"strip": gj.tri_strip(k, 1, torch.cuda.get_device_properties(0).multi_processor_count)}
        for sweep, (lower, unit) in sweeps.items():
            if k != tri_k:
                got = gj.triangular_solve_cuda(t, b, lower=lower, unit_diagonal=unit)
                want = gj_ref.blocked_triangular_solve_ref(t, b, panel, lower=lower,
                                                           unit_diagonal=unit)
                torch.cuda.synchronize()
                err = max_abs(got, want)
                tol = 1e-4 * float(want.abs().max())
                print(f"check triangular_solve {sweep} float32 1x{bs}x{bs} k={k}: "
                      f"max_abs_err={err!r} tol={tol!r}", flush=True)
                require(err <= tol, f"triangular_solve {sweep} k={k}: max_abs_err {err} > {tol}")
                f32_errs.append(err)
                del got, want
            row[sweep] = {
                "ms": time_ms(lambda: gj.triangular_solve_cuda(
                    t, b, lower=lower, unit_diagonal=unit), 5),
                "library_ms": time_ms(lambda: torch.linalg.solve_triangular(
                    t, b, upper=not lower, unitriangular=unit), 5)}
            if k == tri_k:
                row[sweep]["plain_ms"] = time_ms(
                    lambda: gj_ref.blocked_triangular_solve_ref(
                        t, b, panel, lower=lower, unit_diagonal=unit), 1)
        row["bound_ms"], _ = triangular_solve_bound_ms(1, bs, k, 4, PEAK_TF32_FLOPS)
        print(f"time triangular_solve float32 1x{bs}x{bs} k={k}: {row}", flush=True)
        by_k[str(k)] = row
    wide = by_k[str(tri_k)]
    bound, by = triangular_solve_bound_ms(1, bs, tri_k, 4, PEAK_TF32_FLOPS)
    report["triangular_solve"] = {
        "max_abs_err": max(f32_errs), "ms": wide["lower_unit"]["ms"],
        "plain_ms": wide["lower_unit"]["plain_ms"],
        "library_ms": wide["lower_unit"]["library_ms"], "upper_ms": wide["upper"]["ms"],
        "upper_plain_ms": wide["upper"]["plain_ms"],
        "upper_library_ms": wide["upper"]["library_ms"], "bound_ms": bound, "bound_by": by,
        "ffma_bound_ms": triangular_solve_bound_ms(1, bs, tri_k, 4)[0],
        "shape": f"1x{bs}x{bs} k={tri_k} f32", "by_k": by_k}
    del t32, b32, t, b

    # The LU baseline's leaf: one unpivoted LU on the card against the plain
    # column-by-column loop, on the same SPD block.
    lu_mod = importlib.import_module("repro_torch.core.lu_inverse")
    got = torch.linalg.lu_factor_ex(spd, pivot=False)[0]
    want = lu_mod._local_lu_plain(spd)
    torch.cuda.synchronize()
    err = max_abs(got, want)
    # Both sweep unpivoted in f32, in another order: the rounding of bs
    # steps at the block's condition (≈ 10).
    tol = 1e-4 * float(want.abs().max())
    print(f"check lu_leaf float32 {bs}x{bs}: max_abs_err={err!r} tol={tol!r}", flush=True)
    require(bool(torch.isfinite(got).all()) and err <= tol,
            f"lu_leaf: max_abs_err {err} > {tol}")
    report["lu_leaf"] = {
        "max_abs_err": err, "shape": f"{bs}x{bs} f32",
        "ms": time_ms(lambda: lu_mod._local_lu(spd), 5),
        "factor_ms": time_ms(lambda: torch.linalg.lu_factor_ex(spd, pivot=False), 5),
        "plain_ms": time_ms(lambda: lu_mod._local_lu_plain(spd), 2)}
    print(f"time lu_leaf float32 {bs}x{bs}: {report['lu_leaf']}", flush=True)
    del spd, got, want
    return report


def check_flash(torch, rng, b: int, h: int, kv: int, s: int, hd: int) -> dict:
    """Phase 3, flash attention: the kernel against its plain version at the
    LM layer's shape, made in the model's (B, S, H, hd) layout and passed
    as (B, H, S, hd) views as attn_apply passes them."""
    from repro_torch.kernels.flash_attention import kernel as fa, ref as fa_ref
    import numpy as np
    import torch.nn.functional as F

    dev = torch.device("cuda")

    def qkv(sq, dtype):
        def one(heads):
            x = rng.standard_normal((b, sq, heads, hd), dtype=np.float32)
            return torch.from_numpy(x).to(dev, dtype).transpose(1, 2)
        return one(h), one(kv), one(kv)

    row = {}
    for dtype, peak in ((torch.bfloat16, PEAK_BF16_FLOPS), (torch.float32, PEAK_F32_FLOPS),
                        (torch.float16, PEAK_BF16_FLOPS)):
        name = str(dtype)[6:]
        if dtype == torch.float16:  # its own inputs: the later phases' draws stay as they were
            rng = np.random.default_rng([SEED, 3])
        cases = [("causal", s, True)]
        if dtype == torch.bfloat16:
            cases += [("ragged", s - 48, True), ("full", s, False)]
        for case, sq, causal in cases:
            q, k, v = qkv(sq, dtype)
            got = fa.flash_attention_cuda(q, k, v, causal=causal)
            want = fa_ref.attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = max_abs(got, want)
            tol = FLASH_TOL[name]
            print(f"check flash_attention {case} {name} B={b} H={h} KV={kv} S={sq} "
                  f"hd={hd}: max_abs_err={err!r} tol={tol!r}", flush=True)
            require(got.dtype == dtype and got.shape == q.shape,
                    f"flash_attention {case} {name}: dtype/shape differ")
            require(bool(torch.isfinite(got.float()).all()),
                    f"flash_attention {case} {name}: non-finite")
            require(err <= tol, f"flash_attention {case} {name}: max_abs_err {err} > {tol}")
            del got, want
            if case != "causal":
                continue
            bound, by = flash_bound_ms(b, h, kv, sq, sq, hd, True, q.element_size(), peak)
            times = {
                "ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True), 5),
                "plain_ms": time_ms(lambda: fa_ref.attention_ref(q, k, v, causal=True), 2),
                # the yardstick; the port never calls it
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), 5),
                "bound_ms": bound, "bound_by": by, "max_abs_err": err}
            print(f"time flash_attention {name}: {times}", flush=True)
            if dtype == torch.bfloat16:
                row.update(times, shape=f"B={b} H={h} KV={kv} S={sq} hd={hd} causal bf16")
            else:
                prefix = "f32" if dtype == torch.float32 else "f16"
                row.update({f"{prefix}_{key}": val for key, val in times.items()})
        del q, k, v
        torch.cuda.empty_cache()
    return row


def print_kernel_resources(torch) -> None:
    """Phase 2: registers, shared memory and spills of the tensor-core GEMM
    body, of the tensor-core flash attention kernel at every head dim, of
    the in-place Gauss-Jordan kernel and of the blocked leaves' kernels,
    as the CUDA runtime reports them."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.leaf_inverse import kernel as gj
    from repro_torch.kernels.matmul import kernel as mm

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for block_m in (64, 128):
            attrs = mm.gemm_tc_attributes(dtype, block_m)
            print(f"resources gemm_tc {str(dtype)[6:]} block_m={block_m}: {attrs}", flush=True)
            require(attrs["local_bytes"] == 0, f"gemm_tc {dtype} block_m={block_m} spills")

    for dtype in (torch.bfloat16, torch.float16):
        for hd in fa.SUPPORTED_HEAD_DIMS:
            attrs = fa.flash_attention_attributes(dtype, hd)
            print(f"resources flash_attention {str(dtype)[6:]} hd={hd}: {attrs}", flush=True)
    for bs in (128, gj.GJ_INPLACE_MAX_BS):
        print(f"resources gauss_jordan bs={bs}: {gj.gauss_jordan_attributes(bs)}", flush=True)
    # The blocked leaves' kernels: no spill allowed.
    kernels = [("tri_tc", n) for n in gj.TRI_STRIPS] + [
        (name, 0) for name in ("tri_dinv", "tri_pack", "bgj_panel", "bgj_update")]
    for name, strip in kernels:
        attrs = gj.blocked_attributes(name, strip or 64)
        print(f"resources {name}{f' strip={strip}' if strip else ''}: {attrs}", flush=True)
        require(attrs["local_bytes"] == 0, f"{name} strip={strip} spills")


def timed(torch, fn):
    """(result, device ms) of one call of `fn`."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def run_path(torch, name, fn, a, grid, *, expect_launches, op_oracle, reps, b=None,
             bound=RESIDUAL_BOUND, out_dtype=None):
    """Drive one path: one warm-up run, then one counted and timed run and
    `reps - 1` more timed runs. With `b` the path solves A X = B and is
    held to the solve residual, else it inverts A; the result must have
    `out_dtype` (default: that of A, or of B) and a residual ≤ `bound`."""
    from repro_torch import kernels
    from repro_torch.core import count_ops, verify

    fn()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with count_ops() as counts:
        x, ms = timed(torch, fn)
    launches = kernels.launch_counts()
    times = [ms] + [timed(torch, fn)[1] for _ in range(reps - 1)]
    res = verify.inverse_residual(a, x) if b is None else verify.solve_residual(a, x, b)
    want = a if b is None else b
    print(f"path {name}: n={a.shape[0]} grid={grid} ms={times!r} residual={res!r} "
          f"launches={launches}", flush=True)
    require(tuple(x.shape) == tuple(want.shape) and x.dtype == (out_dtype or want.dtype),
            f"{name}: result shape/dtype {tuple(x.shape)} {x.dtype}")
    require(bool(torch.isfinite(x.float()).all()), f"{name}: non-finite entries")
    require(res <= bound, f"{name}: residual {res} > {bound}")
    if op_oracle:
        verify.assert_paper_op_counts(grid, counts)
    for kern, want in expect_launches.items():
        require(launches[kern] == want,
                f"{name}: {kern} launched {launches[kern]} times, want {want}")
    products = launches["matmul"] + launches["schur_update"]
    require(launches["gemm_tensor_core"] == products and launches["gemm_ffma"] == 0,
            f"{name}: {products} GEMM launches, {launches['gemm_tensor_core']} of them "
            f"on the tensor-core body and {launches['gemm_ffma']} on the FFMA one")
    return {"ms": times, "residual": res, "launches": launches,
            "op_counts": counts.as_dict()}


def fused_strassen_leaves(grid: int, bs: int, cutoff: int) -> int:
    """Schur updates that are one classical leaf under engine="strassen":
    the two of every SPIN node whose half-grid h has h == 1 or h·bs at or
    below the cutoff. Each is one schur_update launch (B1); every other
    Strassen leaf is one matmul launch (B2)."""
    fused, nodes, h = 0, 1, grid // 2
    while h >= 1:
        if h == 1 or h * bs <= cutoff:
            fused += 2 * nodes
        nodes, h = nodes * 2, h // 2
    return fused


def run_crossover(torch) -> dict:
    """Phase 14: the dense Strassen multiply with one split (cutoff n/2: 7
    B2 launches of (n/2)³ and 18 elementwise passes) against one B2 launch
    of n³, f32, timed in turns (B2, Strassen, Strassen, B2), beside the cost
    model's crossover."""
    from repro_torch import kernels
    from repro_torch.core import costmodel, count_ops, strassen_matmul
    from repro_torch.kernels.matmul import kernel as mm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}
    for size in CROSSOVER_SIZES:
        x = torch.randn(size, size, generator=gen, device=dev)
        y = torch.randn(size, size, generator=gen, device=dev)

        def split():
            return strassen_matmul(x, y, cutoff=size // 2)

        kernels.reset_launch_counts()
        with count_ops() as counts:
            got = split()
        launches = kernels.launch_counts()
        want = mm.matmul_cuda(x, y)
        torch.cuda.synchronize()
        err = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
        del got, want
        torch.cuda.empty_cache()
        require(launches["matmul"] == 7 and launches["gemm_tensor_core"] == 7
                and (counts.strassen_base_multiplies, counts.strassen_adds) == (7, 18),
                f"crossover {size}: launches {launches}, counts {counts.as_dict()}")
        # Both round f32 sums of k = n terms (≈ √(n/32)·2⁻²⁴ relative, 2e-6 at
        # n = 32768), and the split adds its 18 passes' roundings: 1e-4 keeps
        # a margin, while a wrong quadrant would be O(1).
        require(err <= 1e-4, f"crossover {size}: relative error {err} > 1e-4")
        mm_ms = [time_ms(lambda: mm.matmul_cuda(x, y), 2)]
        st_ms = [time_ms(split, 2), time_ms(split, 2)]
        mm_ms.append(time_ms(lambda: mm.matmul_cuda(x, y), 2))
        row = {"matmul_ms": mm_ms, "strassen_ms": st_ms,
               "strassen_over_matmul": min(st_ms) / min(mm_ms), "rel_err": err,
               "bound_ms": gemm_tc_bound_ms(size, size, size, False, 4)[0]}
        print(f"time crossover float32 {size}^3: {row}", flush=True)
        rows[str(size)] = row
        del x, y
        torch.cuda.empty_cache()
    wins = [int(n) for n, r in rows.items() if r["strassen_over_matmul"] < 1.0]
    out = {"by_size": rows, "model_crossover_n": costmodel.strassen_crossover_n(),
           "measured_first_win": min(wins) if wins else None}
    print(f"path strassen_crossover: model_crossover_n={out['model_crossover_n']} "
          f"measured_first_win={out['measured_first_win']}", flush=True)
    return out



class Interrupted(RuntimeError):
    """Raised from CheckpointedSpin's on_op hook to stop an inversion."""


def run_planner(torch, a, rhs, n: int) -> dict:
    """Phase 9: the bs sweep against the planner's CUDA pricing, the planned
    inversion (`block_size=None`), its recall from the plan file, and the
    planned solve."""
    from repro_torch import planner
    from repro_torch.core import spin_inverse_dense, spin_solve_dense
    from repro_torch.planner import autotune

    dev = a.device
    sig = planner.signature_for("inverse", n, a.dtype, backend=dev.type)
    runs = {bs: (lambda bs=bs: spin_inverse_dense(a, bs, "cuda", engine="cuda", device=dev))
            for bs in SWEEP_BLOCK_SIZES}
    for run in runs.values():
        run()
    sweep_ms = {bs: [] for bs in SWEEP_BLOCK_SIZES}
    for _ in range(REPS):
        for bs, run in runs.items():
            sweep_ms[bs].append(timed(torch, run)[1])
    predicted_ms = {bs: 1e3 * planner.predict_cost(sig, planner.Plan(
        block_size=bs, leaf_solver="cuda", multiply_engine="cuda")) for bs in SWEEP_BLOCK_SIZES}
    for bs in SWEEP_BLOCK_SIZES:
        print(f"time bs_sweep n={n} bs={bs}: measured_ms={sweep_ms[bs]!r} "
              f"predicted_ms={predicted_ms[bs]!r}", flush=True)
    best_bs = min(SWEEP_BLOCK_SIZES, key=lambda bs: min(sweep_ms[bs]))

    # The planned call: it ranks once and writes the port's plan file; a
    # fresh cache object on that file then recalls the plan, and the
    # counted, timed calls of run_path rank nothing.
    ranks = []
    rank_plans = autotune.rank_plans
    autotune.rank_plans = lambda *args, **kw: ranks.append(1) or rank_plans(*args, **kw)
    try:
        first = spin_inverse_dense(a, device=dev)
        require(len(ranks) == 1, f"spin_planned: ranked {len(ranks)} times, want 1")
        with open(planner.default_cache_path()) as f:
            require(sig.key() in json.load(f)["plans"],
                    f"spin_planned: no plan under {sig.key()} in {planner.default_cache_path()}")
        plan = planner.get_plan("inverse", n, a.dtype, backend=dev.type,
                                cache=planner.PlanCache())
        require(len(ranks) == 1, "spin_planned: the plan was ranked again, not recalled")
        grid = n // plan.block_size
        planned = run_path(
            torch, "spin_planned", lambda: spin_inverse_dense(a, device=dev), a, grid,
            op_oracle=True, reps=REPS,
            expect_launches={"schur_update": 2 * (grid - 1), "matmul": 4 * (grid - 1),
                             "blocked_gauss_jordan": grid, "gauss_jordan": 0})
        require(len(ranks) == 1, "spin_planned: a later call ranked again")
        x = spin_inverse_dense(a, device=dev)
        require(torch.equal(x, first), "spin_planned: two planned calls differ")
        explicit = spin_inverse_dense(a, plan.block_size, plan.leaf_solver,
                                      engine=plan.multiply_engine, device=dev)
        require(torch.equal(x, explicit),
                "spin_planned: differs from the explicit call with the chosen plan")
        del first, explicit
        plan_ms = min(sweep_ms.get(plan.block_size, planned["ms"]))
        ratio = plan_ms / min(sweep_ms[best_bs])
        print(f"path spin_planned: plan={plan.to_dict()} measured_ms={plan_ms!r} "
              f"best_bs={best_bs} best_ms={min(sweep_ms[best_bs])!r} ratio={ratio!r} "
              f"cache={planner.default_cache_path()}", flush=True)
        require(plan.multiply_engine == "cuda",
                f"spin_planned: engine {plan.multiply_engine}, want cuda")
        require(ratio <= PLAN_WITHIN,
                f"spin_planned: bs={plan.block_size} takes {ratio:.3f}x the sweep's best")

        # the planned solve
        solve_plan = planner.get_plan("solve", n, a.dtype, backend=dev.type,
                                      measure=False)
        require((solve_plan.leaf_solver, solve_plan.multiply_engine) == ("cuda", "cuda"),
                f"spin_solve_planned: plan {solve_plan.to_dict()} would not run B2 and B5")
        sgrid = n // solve_plan.block_size
        solve = run_path(
            torch, "spin_solve_planned", lambda: spin_solve_dense(a, rhs, device=dev),
            a, sgrid, op_oracle=False, reps=REPS, b=rhs,
            expect_launches={"triangular_solve": 2 * sgrid, "matmul": 2 * (sgrid - 1),
                             "schur_update": 0, "blocked_gauss_jordan": 0,
                             "gauss_jordan": 0})
    finally:
        autotune.rank_plans = rank_plans
    return {"x": x, "sweep": {"n": n, "measured_ms": sweep_ms, "predicted_ms": predicted_ms,
                              "best_bs": best_bs},
            "planned": {**planned, "plan": plan.to_dict(), "ratio_to_best": ratio,
                        "ranked": len(ranks)},
            "solve": {**solve, "plan": solve_plan.to_dict()}}


def run_smw(torch, a, x, rhs, reinvert_ms: float) -> dict:
    """Phase 10: the SMW update of the maintained inverse `x` of `a`, dense
    and BlockMatrix at rank SMW_RANK, a replaced block row (rank 2 bs), and
    the refactor policy's crossover rank beside the measured one."""
    import numpy as np
    from repro_torch.core import (BlockMatrix, add_low_rank, block_update_factors,
                                  estimate_inverse_residual, smw_update_inverse,
                                  smw_update_solve, verify)
    from repro_torch.planner import RefactorPolicy

    dev, n = a.device, a.shape[0]
    rng = np.random.default_rng([SEED, 10])
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    # U Uᵀ with U = G/√n: A + U Uᵀ stays SPD, its spectrum moved by ≈ 1.
    u = normal(n, SMW_RANK) / n ** 0.5
    # A symmetric block-row replacement of norm ≲ 0.5 (A's spectrum is
    # [1, 5]): W with entries of scale 0.25/(√bs + √n).
    w = normal(BLOCK_SIZE, n) * (0.25 / (BLOCK_SIZE ** 0.5 + n ** 0.5))
    lo, hi = SMW_BLOCK_ROW * BLOCK_SIZE, (SMW_BLOCK_ROW + 1) * BLOCK_SIZE
    w[:, lo:hi] = (w[:, lo:hi] + w[:, lo:hi].T) / 2
    bu, bv = block_update_factors(w, SMW_BLOCK_ROW, n)
    xb = BlockMatrix.from_dense(x, BLOCK_SIZE)
    cases = {
        "dense_k64": (lambda: smw_update_inverse(x, u, u), u, u, x),
        "blockmatrix_k64": (lambda: smw_update_inverse(xb, u, u).to_dense(), u, u, xb),
        f"block_row_bs{BLOCK_SIZE}": (lambda: smw_update_inverse(x, bu, bv), bu, bv, x),
    }
    out = {}
    for name, (fn, uu, vv, inv) in cases.items():
        fn()
        times = [timed(torch, fn)[1] for _ in range(REPS)]
        x2 = fn()
        a2 = add_low_rank(a, uu, vv)
        res = verify.inverse_residual(a2, x2)
        xs = smw_update_solve(inv, uu, vv, rhs)
        sres = verify.solve_residual(a2, xs, rhs)
        est = estimate_inverse_residual(lambda p: a2 @ p, x2, gen, n)
        print(f"path smw {name}: n={n} rank={uu.shape[1]} ms={times!r} residual={res!r} "
              f"solve_residual={sres!r} residual_est={est!r}", flush=True)
        require(tuple(x2.shape) == (n, n) and bool(torch.isfinite(x2).all()),
                f"smw {name}: shape or non-finite")
        require(res <= RESIDUAL_BOUND, f"smw {name}: residual {res} > {RESIDUAL_BOUND}")
        require(sres <= RESIDUAL_BOUND,
                f"smw {name}: solve residual {sres} > {RESIDUAL_BOUND}")
        out[name] = {"rank": uu.shape[1], "ms": times, "residual": res,
                     "solve_residual": sres, "residual_est": est}
        del x2, a2, xs
    # Rank 1: the step the crossover is priced in.
    u1 = u[:, :1]
    smw_update_inverse(x, u1, u1)
    rank1_ms = [timed(torch, lambda: smw_update_inverse(x, u1, u1))[1] for _ in range(REPS)]
    policy = RefactorPolicy()
    model_rank = policy.crossover_rank(n, a.dtype, backend=dev.type)
    measured_rank = int(-(-reinvert_ms // min(rank1_ms)))
    print(f"path smw crossover: model_crossover_rank={model_rank} "
          f"measured_crossover_rank={measured_rank} rank1_ms={rank1_ms!r} "
          f"reinvert_ms={reinvert_ms!r} "
          f"model_reinvert_ms={1e3 * policy.reinversion_cost(n, a.dtype, backend=dev.type)!r}",
          flush=True)
    out["crossover"] = {"model_rank": model_rank, "measured_rank": measured_rank,
                        "rank1_ms": rank1_ms, "reinvert_ms": reinvert_ms}
    return out


def run_sketched(torch, a) -> dict:
    """Phase 11: the sketched inverse under the kernel engine: every
    Newton-Schulz sweep is two launches of the GEMM over the whole grid."""
    from repro_torch import kernels
    from repro_torch.core import multiply_engine, sketched_approx_inverse, verify

    gen = torch.Generator(device=a.device).manual_seed(SEED)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with multiply_engine("cuda"):
        got = sketched_approx_inverse(a, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    res = verify.inverse_residual(a, got.inverse)
    print(f"path sketched: n={a.shape[0]} sweeps={got.sweeps} s={seconds!r} "
          f"residual_est={got.residual_est!r} residual={res!r} converged={got.converged} "
          f"launches={launches}", flush=True)
    require(got.converged and got.residual_est <= RESIDUAL_BOUND,
            f"sketched: residual_est {got.residual_est} after {got.sweeps} sweeps")
    require(bool(torch.isfinite(got.inverse).all()), "sketched: non-finite entries")
    require(launches["matmul"] == 2 * got.sweeps and launches["schur_update"] == 0,
            f"sketched: launches {launches} for {got.sweeps} sweeps")
    return {"sweeps": got.sweeps, "s": seconds, "residual_est": got.residual_est,
            "residual": res, "launches": launches}


def run_checkpoint(torch, a) -> dict:
    """Phase 12: CheckpointedSpin at n = CKPT_N, interrupted at CKPT_STOP and
    resumed by a fresh object on the same directory, against an
    uninterrupted run; then the inverse through save/load_blockmatrix in
    f32 and bf16. The node files live in a temporary directory that the
    phase removes."""
    from repro_torch import kernels
    from repro_torch.core import (BlockMatrix, CheckpointedSpin, load_blockmatrix,
                                  multiply_engine, save_blockmatrix, verify)

    a4 = a[:CKPT_N, :CKPT_N].contiguous()
    bm = BlockMatrix.from_dense(a4, CKPT_BLOCK_SIZE)
    grid = CKPT_N // CKPT_BLOCK_SIZE

    def stop(name: str) -> None:
        if name == CKPT_STOP:
            raise Interrupted(name)

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        with multiply_engine("cuda"):
            # the uninterrupted run persists nothing (min_grid above the grid)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            whole = CheckpointedSpin(root + "/whole", leaf_solver="cuda",
                                     min_grid=grid + 1).inverse(bm)
            torch.cuda.synchronize()
            whole_s = time.perf_counter() - t0
            launches = kernels.launch_counts()
            run_dir = root + "/run"
            t0 = time.perf_counter()
            try:
                CheckpointedSpin(run_dir, leaf_solver="cuda", on_op=stop).inverse(bm)
                require(False, f"checkpoint: the run was not interrupted at {CKPT_STOP}")
            except Interrupted:
                pass
            interrupted_s = time.perf_counter() - t0
            node_bytes = sum(f.stat().st_size for f in Path(run_dir).iterdir())
            resumed = CheckpointedSpin(run_dir, leaf_solver="cuda")
            t0 = time.perf_counter()
            x = resumed.inverse(bm)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
        res = verify.inverse_residual(a4, x.to_dense())
        same = torch.equal(x.blocks, whole.blocks)
        print(f"path checkpoint: n={CKPT_N} bs={CKPT_BLOCK_SIZE} stop={CKPT_STOP} "
              f"whole_s={whole_s!r} interrupted_s={interrupted_s!r} resume_s={resume_s!r} "
              f"loaded_ops={resumed.loaded_ops} computed_ops={resumed.computed_ops} "
              f"node_bytes={node_bytes} residual={res!r} same_bits={same} "
              f"launches={launches}", flush=True)
        require(same, "checkpoint: the resumed inverse differs from the uninterrupted run")
        require(resumed.loaded_ops > 0, "checkpoint: the resume loaded no node")
        require(res <= RESIDUAL_BOUND, f"checkpoint: residual {res} > {RESIDUAL_BOUND}")
        require(launches["matmul"] == 6 * (grid - 1) and
                launches["blocked_gauss_jordan"] == grid,
                f"checkpoint: launches {launches}")
        # the inverse through the block-matrix files, f32 and bf16
        for dtype in (torch.float32, torch.bfloat16):
            out = BlockMatrix(x.blocks.to(dtype))
            d = f"{root}/io_{str(dtype)[6:]}"
            save_blockmatrix(d, out)
            back = load_blockmatrix(d, device=a.device)
            require(back.dtype == dtype and torch.equal(back.blocks, out.blocks),
                    f"checkpoint: {dtype} blocks changed through save/load_blockmatrix")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"n": CKPT_N, "block_size": CKPT_BLOCK_SIZE, "stop": CKPT_STOP,
            "whole_s": whole_s, "interrupted_s": interrupted_s, "resume_s": resume_s,
            "loaded_ops": resumed.loaded_ops, "computed_ops": resumed.computed_ops,
            "node_bytes": node_bytes, "residual": res, "launches": launches}


def run_service(torch, a, planned_plan: dict, smw: dict, reinvert_ms: float) -> dict:
    """Phase 13: the online inverse server, `SpinService`, on the phase-4
    matrix: admission (the phase-9 plan recalled from the plan file),
    coalesced exact ticks, the maintained path after an SMW fold, rank-64
    folds up to the refactor policy's crossover, a bf16 tenant, the
    dashboard; side checks on the leading SERVICE_SIDE_N² block (residency,
    snapshots, degraded mode); and a traced planned inversion. The launch
    counts are read over the main drive (admission to the bf16 ticks); the
    offline solves the answers are held to run after that."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core import (PRECISION_PRESETS, spin_inverse_dense, spin_solve_dense,
                                  verify)
    from repro_torch.obs import TRACER, tracing
    from repro_torch.obs import ledger as obs_ledger
    from repro_torch.parallel import FaultPlan
    from repro_torch.planner import RefactorPolicy, autotune
    from repro_torch.serving import SpinService

    dev, n = a.device, a.shape[0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng([SEED, 13])
    bf16_bound = PRECISION_PRESETS["bf16"].bound(torch.float32)

    def rank_k(rows: int, k: int):
        # U Uᵀ with U = G/√n, as in phase 10: A + U Uᵀ stays SPD
        return torch.from_numpy(rng.standard_normal((rows, k), dtype=np.float32)).to(dev) \
            / rows ** 0.5

    def drain(svc, mid: str, path: str, ticks: int) -> list[dict]:
        """`ticks` ticks of SERVICE_REQUESTS requests of SERVICE_COLS
        columns: each tick one coalesced batch, timed by CUDA events
        (the host's finish_t stamps come before the kernels end)."""
        out = []
        for _ in range(ticks):
            rhs = [torch.randn(n, SERVICE_COLS, generator=gen, device=dev)
                   for _ in range(SERVICE_REQUESTS)]
            reqs = [svc.solve(mid, b) for b in rhs]
            batches = svc.stats["batches"]
            before = kernels.launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            svc.tick()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            after = kernels.launch_counts()
            require(all(r.done and not r.failed and r.path == path for r in reqs),
                    f"spin_service {mid}: paths {[r.path for r in reqs]}, want {path}")
            require(svc.stats["batches"] == batches + 1,
                    f"spin_service {mid}: a tick ran {svc.stats['batches'] - batches} batches")
            out.append({"rhs": torch.cat(rhs, dim=1), "x": torch.cat([r.x for r in reqs], dim=1),
                        "residual_est": [r.residual_est for r in reqs], "ms": ms,
                        "requests_per_s": SERVICE_REQUESTS / (ms / 1e3),
                        "launches": {k: after[k] - before[k] for k in after}})
        return out

    def summary(ticks: list[dict]) -> dict:
        return {"ms": [t["ms"] for t in ticks],
                "requests_per_s": [t["requests_per_s"] for t in ticks],
                "residual": [t["residual"] for t in ticks],
                "residual_est": [None if t["residual_est"][0] is None else max(t["residual_est"])
                                 for t in ticks]}

    peaks = {}

    def peak() -> float:
        """GiB of device memory at the high-water mark since the last call."""
        gib = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        return gib

    torch.cuda.synchronize()
    peaks["before"] = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    # 1. admission: the phase-9 plan, recalled from the plan file (no ranking)
    ranks = []
    rank_plans = autotune.rank_plans
    autotune.rank_plans = lambda *args, **kw: ranks.append(1) or rank_plans(*args, **kw)
    try:
        svc = SpinService(slots=SERVICE_SLOTS)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        st = svc.add_matrix("gram", a)
        dispatch_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        admit_s = time.perf_counter() - t0
    finally:
        autotune.rank_plans = rank_plans
    admit = kernels.launch_counts()
    grid = n // st.block_size
    print(f"path spin_service admit: plan={st.plan.to_dict()} ranked={len(ranks)} "
          f"dispatch_s={dispatch_s!r} s={admit_s!r} launches={admit}", flush=True)
    require(not ranks and st.plan.to_dict() == planned_plan,
            f"spin_service: plan {st.plan.to_dict()} is not phase 9's {planned_plan}")
    require((st.block_size, st.leaf_solver, st.engine) == (BLOCK_SIZE, "cuda", "cuda"),
            f"spin_service: bs {st.block_size}, leaf {st.leaf_solver}, engine {st.engine}")
    require((admit["schur_update"], admit["matmul"], admit["blocked_gauss_jordan"])
            == (2 * (grid - 1), 4 * (grid - 1), grid), f"spin_service admit: {admit}")

    peaks["admit"] = peak()

    # 2. the exact path: each tick one coalesced 256-column solve (B2 + B5)
    exact = drain(svc, "gram", "recursion", SERVICE_TICKS)
    want = {"matmul": 2 * (grid - 1), "triangular_solve": 2 * grid, "schur_update": 0,
            "blocked_gauss_jordan": 0}
    for t in exact:
        require(all(t["launches"][k] == v for k, v in want.items()),
                f"spin_service exact tick: launches {t['launches']}, want {want}")

    peaks["exact"] = peak()

    # 3. the maintained path after one rank-64 SMW fold
    up = svc.update("gram", rank_k(n, SMW_RANK))
    svc.tick()
    require(up.done and not up.refactored and up.reason == "smw",
            f"spin_service: the first rank-{SMW_RANK} update gave {up.reason}")
    maintained = drain(svc, "gram", "maintained", SERVICE_TICKS)
    for t in maintained:      # no kernel of the port runs here: plain f32 products
        t["residual"] = verify.solve_residual(st.a, t["x"], t["rhs"])
    peaks["maintained"] = peak()

    # 4. rank-64 folds until the refactor policy re-factorizes
    folds = 1
    while True:
        up = svc.update("gram", rank_k(n, SMW_RANK))
        svc.tick()
        if up.refactored:
            break
        require(up.reason == "smw" and folds < 256, f"spin_service: update gave {up.reason}")
        folds += 1
    model_rank = RefactorPolicy().crossover_rank(n, a.dtype, step_rank=SMW_RANK,
                                                 backend=dev.type)
    smw_ms = min(smw["dense_k64"]["ms"])
    print(f"path spin_service refactor: folds={folds} reason={up.reason} "
          f"model_crossover_rank={model_rank} model_folds={model_rank // SMW_RANK - 1} "
          f"phase10_rank64_ms={smw_ms!r} reinvert_ms={reinvert_ms!r} "
          f"measured_folds={reinvert_ms / smw_ms!r}", flush=True)
    require(up.reason == "crossover" and (folds + 1) * SMW_RANK == model_rank,
            f"spin_service: refactored ({up.reason}) after {folds} folds, the policy's "
            f"crossover is rank {model_rank}")
    a2 = st.a
    recovered = drain(svc, "gram", "recursion", 1)
    peaks["refactor"] = peak()

    # 5. a bf16 tenant on the same matrix, served from its bf16 inverse (B2's bf16 body)
    lowp = svc.add_matrix("gram_bf16", a, precision="bf16")
    require(lowp.inv.dtype == torch.bfloat16 and lowp.drift.residual_est <= bf16_bound,
            f"spin_service bf16: {lowp.inv.dtype}, certified {lowp.drift.residual_est}")
    bf16 = drain(svc, "gram_bf16", "maintained", SERVICE_TICKS)
    for t in bf16:
        require(t["launches"]["matmul"] == 1 and t["launches"]["triangular_solve"] == 0,
                f"spin_service bf16 tick: launches {t['launches']}")
        require(max(t["residual_est"]) <= bf16_bound,
                f"spin_service bf16: residual_est {max(t['residual_est'])} > {bf16_bound}")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    drive_s = time.perf_counter() - t_phase
    peaks["bf16"] = peak()
    for name in ("schur_update", "matmul", "blocked_gauss_jordan", "triangular_solve"):
        require(launches[name] > 0, f"spin_service: {name} was never launched")

    # the answers against the offline calls
    for t in exact:
        offline = spin_solve_dense(a, t["rhs"], st.block_size, st.leaf_solver,
                                   engine=st.engine)
        require(torch.equal(t["x"], offline),
                "spin_service: a coalesced tick differs from the offline solve")
        t["residual"] = verify.solve_residual(a, t["x"], t["rhs"])
    offline = spin_solve_dense(a2, recovered[0]["rhs"], st.block_size, st.leaf_solver,
                               engine=st.engine)
    require(torch.equal(recovered[0]["x"], offline),
            "spin_service: the tick after the refactor differs from the offline solve on A'")
    recovered[0]["residual"] = verify.solve_residual(a2, recovered[0]["x"], recovered[0]["rhs"])
    for t in bf16:
        t["residual"] = verify.solve_residual(a, t["x"], t["rhs"])
    del offline
    paths = {"exact": summary(exact), "maintained": summary(maintained),
             "recovered": summary(recovered), "bf16": summary(bf16)}
    for label, bound in (("exact", RESIDUAL_BOUND), ("maintained", RESIDUAL_BOUND),
                         ("recovered", RESIDUAL_BOUND), ("bf16", bf16_bound)):
        print(f"path spin_service {label}: {paths[label]}", flush=True)
        require(max(paths[label]["residual"]) <= bound,
                f"spin_service {label}: residual {max(paths[label]['residual'])} > {bound}")

    speedup = min(paths["maintained"]["ms"]) / min(paths["bf16"]["ms"])
    print(f"path spin_service bf16_vs_f32_maintained: {speedup!r}x the requests a second",
          flush=True)

    # 6. the dashboard
    m = svc.metrics()
    dashboard = {stage: {q: 1e3 * m["latency_s"][stage][q] for q in ("p50", "p95", "p99")}
                 for stage in ("queue_wait", "solve", "total")}
    print(f"path spin_service dashboard (ms; dispatch latencies): {dashboard} "
          f"counters={m['counters']} stats={m['stats']}", flush=True)

    # 7. side checks on the leading block, in a temporary directory
    a4 = a[:SERVICE_SIDE_N, :SERVICE_SIDE_N].contiguous()
    b4 = a[SERVICE_SIDE_N:2 * SERVICE_SIDE_N, SERVICE_SIDE_N:2 * SERVICE_SIDE_N].contiguous()
    rhs4 = torch.randn(SERVICE_SIDE_N, SERVICE_COLS, generator=gen, device=dev)
    sbs = SERVICE_SIDE_BLOCK_SIZE

    def serve(s, mid):
        req = s.solve(mid, rhs4)
        s.run_until_done()
        require(req.done and not req.failed, f"spin_service side {mid}: {req.error}")
        return req

    root = tempfile.mkdtemp(prefix="chip_smoke_service_")
    try:
        # residency: one resident matrix, two tenants served alternately
        res = SpinService(slots=2, max_resident=1, spill_dir=root + "/spill")
        res.add_matrix("r0", a4, block_size=sbs)
        first = {"r0": serve(res, "r0").x}
        res.add_matrix("r1", b4, block_size=sbs)
        first["r1"] = serve(res, "r1").x
        for mid in ("r0", "r1", "r0"):
            require(torch.equal(serve(res, mid).x, first[mid]),
                    f"spin_service residency: {mid}'s answer changed through its spill")
        residency = {k: res.stats[k] for k in ("evictions", "rehydrations")}
        require(residency == {"evictions": 4, "rehydrations": 3},
                f"spin_service residency: {residency}")
        del res, first

        # snapshot / restore, and an async snapshot followed at once by an update
        snap = SpinService(slots=2)
        s4 = snap.add_matrix("s", a4, block_size=sbs)
        u4 = rank_k(SERVICE_SIDE_N, 8)
        snap.update("s", u4)
        snap.run_until_done()
        snap.snapshot(root + "/snap")
        back = SpinService.restore(root + "/snap")
        require(torch.equal(back.matrix("s").a, s4.a) and torch.equal(back.matrix("s").inv, s4.inv)
                and torch.equal(serve(back, "s").x, serve(snap, "s").x),
                "spin_service snapshot: restore changed the bits")
        a_before, inv_before = s4.a.clone(), s4.inv.clone()
        task = snap.snapshot_async(root + "/async")
        snap.update("s", u4)
        snap.run_until_done()
        task.wait(120.0)
        back = SpinService.restore(root + "/async").matrix("s")
        require(s4.smw_applied == 2 and back.smw_applied == 1
                and torch.equal(back.a, a_before) and torch.equal(back.inv, inv_before),
                "spin_service snapshot_async: the capture saw the later update")
        del snap, back, a_before, inv_before

        # degraded mode: a straggler past the deadline, then its landing
        plan = FaultPlan().inject_straggler(0, SERVICE_STRAGGLE_S)
        deg = SpinService(slots=2, solve_deadline_s=SERVICE_DEADLINE_S, fault_plan=plan)
        d4 = deg.add_matrix("d", a4, block_size=sbs)
        before = kernels.launch_counts()["matmul"]
        reqs = [deg.solve("d", rhs4[:, i]) for i in range(3)]
        deg.run_until_done()
        sketch_launches = kernels.launch_counts()["matmul"] - before
        degraded = {"paths": [r.path for r in reqs],
                    "residual_est": [r.residual_est for r in reqs],
                    "tolerance": d4.drift.tolerance, "sweeps": d4.sketch.sweeps,
                    "b2_launches": sketch_launches,
                    "shard_timeouts": deg.stats["shard_timeouts"]}
        require(all(r.done and r.path == "degraded" and r.residual_est <= d4.drift.tolerance
                    for r in reqs) and deg.stats["shard_timeouts"] == 1
                and sketch_launches == 2 * d4.sketch.sweeps > 0,
                f"spin_service degraded: {degraded}")
        d4.background.wait(120.0)
        plan.stragglers.clear()
        r = serve(deg, "d")
        offline = spin_solve_dense(a4, rhs4, sbs, d4.leaf_solver, engine=d4.engine)
        degraded["recovered_path"] = r.path
        require(r.path == "recursion" and not d4.degraded and deg.stats["recoveries"] == 1
                and torch.equal(r.x, offline),
                f"spin_service degraded: after the landing path {r.path}")
        # a transient failure, retried once
        rt = SpinService(slots=2, solve_deadline_s=30.0,
                         fault_plan=FaultPlan().inject_failure(0, count=1))
        rt.add_matrix("t", a4, block_size=sbs)
        r = serve(rt, "t")
        degraded["retries"] = rt.stats["retries"]
        require(r.path == "recursion" and rt.stats["retries"] == 1,
                f"spin_service retry: path {r.path}, retries {rt.stats['retries']}")
        print(f"path spin_service side: n={SERVICE_SIDE_N} bs={sbs} residency={residency} "
              f"degraded={degraded}", flush=True)
        del deg, rt, offline
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del a4, b4, rhs4
    peaks["side"] = peak()

    # 8. tracing: one planned inversion at n, and a short drain
    with tracing(True, clear=True):
        spin_inverse_dense(a)
        nodes = (len(TRACER.spans(kind="recursion_level", name="spin.level")),
                 len(TRACER.spans(kind="recursion_level", name="spin.leaf")))
        plans = TRACER.spans(kind="planner_decision", name="planner.plan")
        ledger_spans = TRACER.spans(kind="cost_ledger", name="ledger.solve")
        drain(svc, "gram", "recursion", 2)
        ticks = TRACER.spans(kind="serve_tick", name="serve.tick")
    TRACER.clear()
    entry = obs_ledger.ledger().entries("inverse")[-1]
    traced = {"spin_level": nodes[0], "spin_leaf": nodes[1], "planner_plan": len(plans),
              "ledger_solve": len(ledger_spans), "serve_tick": len(ticks),
              "predicted_s": entry.predicted_s, "measured_s": entry.measured_s,
              "predicted_over_measured": entry.ratio}
    print(f"path spin_service traced: {traced}", flush=True)
    require(nodes == (grid - 1, grid) and len(plans) == 1 and len(ledger_spans) == 1
            and len(ticks) == 2 and entry.n == n and entry.ratio,
            f"spin_service traced: {traced}")
    peaks["traced"] = peak()
    phase_s = time.perf_counter() - t_phase
    print(f"path spin_service: drive_s={drive_s!r} phase_s={phase_s!r} "
          f"peak_gib={peaks!r} launches={launches}", flush=True)
    del svc, st, lowp, exact, maintained, recovered, bf16, a2
    return {"n": n, "block_size": BLOCK_SIZE, "slots": SERVICE_SLOTS,
            "requests_per_tick": SERVICE_REQUESTS, "cols_per_request": SERVICE_COLS,
            "plan": planned_plan, "admit": {"dispatch_s": dispatch_s, "s": admit_s,
                                            "launches": admit},
            **paths, "bf16_over_f32_maintained": speedup,
            "refactor": {"folds": folds, "model_crossover_rank": model_rank,
                         "phase10_rank64_ms": smw_ms, "reinvert_ms": reinvert_ms},
            "dashboard_ms": dashboard, "stats": m["stats"],
            "residency": residency, "degraded": degraded, "traced": traced,
            "drive_s": drive_s, "phase_s": phase_s, "peak_gib": peaks,
            "launches": launches}


def run_lm(torch, rng, cfg, dev) -> dict:
    """Phase 16: the dense LM serving path, `cfg` on `dev`."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServingEngine

    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"lm: {cfg.name} {n_params} parameters on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)

    # prefill: one warm-up, then a counted and timed run and one more timed run
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (LM_BATCH, LM_SEQ), dtype=np.int64)).to(dev)
    batch = {"tokens": prompts}
    T.prefill(params, batch, cfg)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    (logits, _, _, cache), ms = timed(torch, lambda: T.prefill(params, batch, cfg))
    launches = kernels.launch_counts()
    prefill_ms = [ms, timed(torch, lambda: T.prefill(params, batch, cfg))[1]]
    tokens_per_s = LM_BATCH * LM_SEQ / (min(prefill_ms) / 1e3)
    print(f"path lm_prefill: {cfg.name} B={LM_BATCH} S={LM_SEQ} ms={prefill_ms!r} "
          f"tokens_per_s={tokens_per_s!r} launches={launches}", flush=True)
    require(tuple(logits.shape) == (LM_BATCH, LM_SEQ, cfg.vocab)
            and logits.dtype == torch.float32, f"lm_prefill: logits {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits).all()), "lm_prefill: non-finite logits")
    require(tuple(cache["k"].shape) == (cfg.n_layers, LM_BATCH, LM_SEQ, cfg.n_kv_heads,
                                         cfg.head_dim), f"lm_prefill: cache {cache['k'].shape}")
    for kern, n in launches.items():
        want = cfg.n_layers if kern == "flash_attention" else 0
        require(n == want, f"lm_prefill: {kern} launched {n} times, want {want}")

    # greedy decode from the prefill cache, padded to the decode length
    pad = (0, 0, 0, 0, 0, LM_DECODE_STEPS)
    cache = {"k": F.pad(cache["k"], pad), "v": F.pad(cache["v"], pad), "pos": cache["pos"]}
    tok = torch.argmax(logits[:, -1], dim=-1)
    del logits
    fed, step_logits, step_ms = [], [], []
    for i in range(LM_DECODE_STEPS):
        fed.append(tok)
        (lg, cache), ms = timed(torch, lambda: T.decode_step(params, cache, tok, cfg))
        step_ms.append(ms)
        if i < LM_CHECK_STEPS:
            step_logits.append(lg)
        require(bool(torch.isfinite(lg).all()), f"lm_decode: non-finite logits at step {i}")
        tok = torch.argmax(lg, dim=-1)
    require(torch.equal(cache["pos"].cpu(), torch.full((LM_BATCH,), LM_SEQ + LM_DECODE_STEPS,
                                                       dtype=torch.int32)),
            f"lm_decode: pos {cache['pos'].tolist()}")
    del cache
    decode_ms = sum(step_ms) / len(step_ms)

    # the decode logits against forward over prompt + the tokens decode was fed
    seq = torch.cat([prompts, torch.stack(fed[:LM_CHECK_STEPS], 1)], 1)
    full = T.forward(params, {"tokens": seq}, cfg)[0][:, LM_SEQ:]
    got = torch.stack(step_logits, 1)
    err = max_abs(got, full)
    rms = float((got - full).square().mean().sqrt())
    top2 = torch.topk(full, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > LM_CONSISTENCY_BOUND
    agree = torch.argmax(got, -1) == torch.argmax(full, -1)
    print(f"path lm_decode: steps={LM_DECODE_STEPS} ms_per_step={decode_ms!r} "
          f"ms={step_ms!r} consistency_err={err!r} rms={rms!r} bound={LM_CONSISTENCY_BOUND!r} "
          f"tokens_agree={int(agree.sum())}/{agree.numel()} "
          f"margin_above_bound={int(clear.sum())}", flush=True)
    require(err <= LM_CONSISTENCY_BOUND,
            f"lm_decode: decode vs forward logits differ by {err} > {LM_CONSISTENCY_BOUND}")
    require(bool(agree[clear].all()), "lm_decode: a token differs where the top-2 "
                                      f"margin exceeds {LM_CONSISTENCY_BOUND}")
    del full, got, step_logits
    torch.cuda.empty_cache()

    # continuous batching: 8 requests through 4 slots
    prng = np.random.default_rng([SEED, 1])
    lens = prng.integers(SERVE_PROMPT_LENS[0], SERVE_PROMPT_LENS[1] + 1, SERVE_REQUESTS)
    reqs = [Request(uid=i, prompt=prng.integers(0, cfg.vocab, n).tolist(),
                    max_new_tokens=SERVE_NEW_TOKENS) for i, n in enumerate(lens)]
    eng = ServingEngine(cfg, params, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_until_done()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    generated = sum(len(r.output) for r in reqs)
    require(all(r.done and len(r.output) == SERVE_NEW_TOKENS for r in reqs),
            "lm_serve: a request did not finish with all its tokens")
    # The first request served alone, in an engine of the same width (the
    # same GEMM shapes, so the same rounding), must get the same tokens;
    # alone at batch 1 it is reported, since other GEMM shapes round apart.
    solo = {}
    for width in (SERVE_SLOTS, 1):
        alone = Request(uid=0, prompt=list(reqs[0].prompt), max_new_tokens=SERVE_NEW_TOKENS)
        one = ServingEngine(cfg, params, slots=width, max_len=SERVE_MAX_LEN)
        one.submit(alone)
        one.run_until_done()
        solo[width] = sum(a == b for a, b in zip(alone.output, reqs[0].output))
    print(f"path lm_serve: requests={SERVE_REQUESTS} slots={SERVE_SLOTS} ticks={eng.ticks} "
          f"generated={generated} s={serve_s!r} tokens_per_s={generated / serve_s!r} "
          f"solo_match_same_width={solo[SERVE_SLOTS]}/{SERVE_NEW_TOKENS} "
          f"solo_match_batch1={solo[1]}/{SERVE_NEW_TOKENS}", flush=True)
    require(solo[SERVE_SLOTS] == SERVE_NEW_TOKENS,
            "lm_serve: the first request differs from the same request served alone")
    ticks = eng.ticks
    del params, eng, one
    return {
        "launches": launches,
        "lm_prefill": {"arch": cfg.name, "batch": LM_BATCH, "seq": LM_SEQ, "ms": prefill_ms,
                       "tokens_per_s": tokens_per_s},
        "lm_decode": {"steps": LM_DECODE_STEPS, "ms_per_step": decode_ms,
                      "tokens_per_s": LM_BATCH / (decode_ms / 1e3),
                      "consistency_err": err, "consistency_rms": rms,
                      "consistency_bound": LM_CONSISTENCY_BOUND},
        "lm_serve": {"requests": SERVE_REQUESTS, "slots": SERVE_SLOTS,
                     "max_len": SERVE_MAX_LEN, "ticks": ticks, "generated": generated,
                     "s": serve_s, "tokens_per_s": generated / serve_s,
                     "solo_match_batch1": solo[1]}}


def _leaves(tree: dict):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_arch
    from repro_torch.core import (PRECISION_PRESETS, lu_inverse_dense,
                                  spin_inverse_dense, spin_solve_dense,
                                  strassen_cutoff, testing, verify)
    from repro_torch.kernels import build

    # 1. card
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.load(name)
    print(f"build: {time.perf_counter() - t0:.1f} s for {list(build.SOURCES)}", flush=True)
    print_kernel_resources(torch)

    rng = np.random.default_rng(SEED)
    n, bs = N, BLOCK_SIZE
    grid = n // bs

    # 3. kernels against their plain versions, at the main paths' shapes:
    # the top-level products are (n/2)³, the leaves bs; the solve's widest
    # leaf sees k = N_RHS + n - bs right-hand sides (the A12 columns of
    # every level ride along).
    report = check_kernels(torch, rng, n // 2, bs, GJ_BLOCK_SIZE, N_RHS + n - bs)
    lm_cfg = get_arch(LM_ARCH)
    report["flash_attention"] = check_flash(
        torch, rng, LM_BATCH, lm_cfg.n_heads, lm_cfg.n_kv_heads, LM_SEQ, lm_cfg.head_dim)

    # 4. SPIN at full width
    a = testing.make_spd(n, rng, device="cuda")
    spin = run_path(
        torch, "spin", lambda: spin_inverse_dense(a, bs, "cuda", engine="cuda"),
        a, grid, op_oracle=True, reps=REPS,
        expect_launches={"schur_update": 2 * (grid - 1), "matmul": 4 * (grid - 1),
                         "blocked_gauss_jordan": grid, "gauss_jordan": 0})
    require(spin["op_counts"] == verify.expected_spin_counts(grid).as_dict(),
            "spin: op counts differ from expected_spin_counts")

    # 5. LU baseline at the same size (multiplies through the matmul kernel)
    lu = run_path(torch, "lu", lambda: lu_inverse_dense(a, bs, engine="cuda"),
                  a, grid, op_oracle=False, reps=REPS,
                  expect_launches={"schur_update": 0, "blocked_gauss_jordan": 0,
                                   "gauss_jordan": 0})
    require(lu["launches"]["matmul"] > 0, "lu: the matmul kernel never ran")
    spin_over_lu = min(spin["ms"]) / min(lu["ms"])
    print(f"path lu: spin_over_lu={spin_over_lu!r}", flush=True)

    # 6. the inverse-free solve of the same matrix, 256 right-hand sides
    rhs = torch.from_numpy(rng.standard_normal((n, N_RHS), dtype=np.float32)).cuda()
    solve = run_path(
        torch, "spin_solve", lambda: spin_solve_dense(a, rhs, bs, "cuda", engine="cuda"),
        a, grid, op_oracle=False, reps=REPS, b=rhs,
        expect_launches={"triangular_solve": 2 * grid, "matmul": 2 * (grid - 1),
                         "schur_update": 0, "blocked_gauss_jordan": 0,
                         "gauss_jordan": 0})
    oc = solve["op_counts"]
    require(oc["multiplies"] == oc["arranges"] == oc["leaf_inversions"] == 0,
            f"spin_solve: not inverse-free: {oc}")
    require(oc["leaf_solves"] == grid and oc["splits"] == grid - 1
            and oc["solve_applies"] == oc["subtracts"] == 3 * (grid - 1),
            f"spin_solve: op profile {oc}")
    torch.cuda.empty_cache()

    # 7. the bf16 preset on the same matrix: the recursion in bf16 (B1/B2's
    # bf16 body, B3 on bf16 blocks), then f32 Newton-Schulz sweeps (B2's f32
    # body at n³), then the bf16 store; the raw recursion timed apart.
    bf16 = PRECISION_PRESETS["bf16"]
    sweeps = bf16.polish_sweeps
    bf16_bound = bf16.bound(torch.float32)
    recursion = {"schur_update": 2 * (grid - 1), "matmul": 4 * (grid - 1),
                 "blocked_gauss_jordan": grid, "gauss_jordan": 0}
    raw = run_path(
        torch, "spin_bf16_raw",
        lambda: spin_inverse_dense(a, bs, "cuda", engine="cuda",
                                   precision=dataclasses.replace(bf16, polish_sweeps=0)),
        a, grid, op_oracle=True, reps=REPS, bound=bf16_bound, out_dtype=torch.bfloat16,
        expect_launches=recursion)
    polished = run_path(
        torch, "spin_bf16", lambda: spin_inverse_dense(a, bs, "cuda", engine="cuda",
                                                       precision="bf16"),
        a, grid, op_oracle=False, reps=REPS, bound=bf16_bound, out_dtype=torch.bfloat16,
        expect_launches={**recursion, "matmul": recursion["matmul"] + 2 * sweeps})
    # By body: the raw run's products all took bf16 operands (the recursion
    # runs on the bf16 cast of A), and the polished run adds exactly the
    # sweeps' f32 products; run_path has checked every one took the
    # tensor-core body.
    gemm_bf16 = raw["launches"]["gemm_tensor_core"]
    gemm_f32 = polished["launches"]["gemm_tensor_core"] - gemm_bf16
    require(gemm_bf16 == 6 * (grid - 1) and gemm_f32 == 2 * sweeps,
            f"spin_bf16: {gemm_bf16} bf16 and {gemm_f32} f32 tensor-core launches")
    want_ops = verify.expected_spin_counts(grid)
    want_ops.multiplies += 2 * sweeps
    want_ops.block_gemms += 2 * sweeps * grid ** 3
    want_ops.subtracts += sweeps
    want_ops.scalar_muls += 1                     # the polish's 2I
    require(polished["op_counts"] == want_ops.as_dict(),
            f"spin_bf16: op counts {polished['op_counts']}")
    print(f"path spin_bf16: raw_residual={raw['residual']!r} "
          f"polished_residual={polished['residual']!r} bound={bf16_bound!r} "
          f"gemm_bf16={gemm_bf16} gemm_f32={gemm_f32}", flush=True)
    # ... and one small solve under the preset: it returns at b's dtype.
    srng = np.random.default_rng([SEED, 5])
    sn = SOLVE_BF16_N
    s_rhs = torch.from_numpy(srng.standard_normal((sn, SOLVE_BF16_RHS),
                                                  dtype=np.float32)).cuda()
    sgrid = sn // bs
    solve_bf16 = run_path(
        torch, "spin_solve_bf16",
        lambda: spin_solve_dense(a[:sn, :sn], s_rhs, bs, "cuda", engine="cuda",
                                 precision="bf16"),
        a[:sn, :sn], sgrid, op_oracle=False, reps=REPS, b=s_rhs, bound=bf16_bound,
        expect_launches={"triangular_solve": 2 * sgrid, "matmul": 2 * (sgrid - 1),
                         "schur_update": 0, "blocked_gauss_jordan": 0, "gauss_jordan": 0})
    del s_rhs

    # 8. the Strassen engine on the same matrix: 7/18 recursion over the
    # grid, classical leaves on B2, the bottom level's Schur updates on B1.
    cutoff = strassen_cutoff()
    st_base, st_adds = verify.expected_spin_strassen_counts(grid, bs, cutoff)
    fused = fused_strassen_leaves(grid, bs, cutoff)
    strassen = run_path(
        torch, "spin_strassen", lambda: spin_inverse_dense(a, bs, "cuda", engine="strassen"),
        a, grid, op_oracle=True, reps=REPS,
        expect_launches={"schur_update": fused, "matmul": st_base - fused,
                         "blocked_gauss_jordan": grid, "gauss_jordan": 0})
    oc = strassen["op_counts"]
    got_st = (oc["strassen_base_multiplies"], oc["strassen_adds"])
    print(f"path spin_strassen: cutoff={cutoff} strassen_counts={got_st} "
          f"expected={(st_base, st_adds)} fused_leaves={fused}", flush=True)
    require(got_st == (st_base, st_adds),
            f"spin_strassen: Strassen counts {got_st}, want {(st_base, st_adds)}")

    # 9. the planner: the bs sweep beside its pricing, the planned inversion
    # and solve (block_size=None), the plan recalled from the port's file
    plan_run = run_planner(torch, a, rhs, n)
    x_planned = plan_run.pop("x")
    # 10. the SMW update of that inverse, and the refactor crossover
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    smw = run_smw(torch, a, x_planned, rhs, min(plan_run["planned"]["ms"]))
    smw["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"path smw: peak_gib={smw['peak_gib']!r}", flush=True)
    del x_planned, rhs
    gc.collect()
    torch.cuda.empty_cache()
    # 11. the sketched inverse under the kernel engine
    sketched = run_sketched(torch, a)
    gc.collect()
    torch.cuda.empty_cache()
    # 12. checkpoint and resume at n = CKPT_N, and the block-matrix files
    ckpt = run_checkpoint(torch, a)
    # 13. the online inverse server on the same matrix
    service = run_service(torch, a, plan_run["planned"]["plan"], smw,
                          min(plan_run["planned"]["ms"]))
    del a
    gc.collect()
    torch.cuda.empty_cache()

    # 14. where one Strassen split pays on the card: the dense recursion cut
    # at n/2 (7 GEMM launches and 18 add passes) against one GEMM launch
    crossover = run_crossover(torch)

    # 15. the scalar Gauss-Jordan leaf's path
    gn, gbs = GJ_N, GJ_BLOCK_SIZE
    ggrid = gn // gbs
    a_gj = testing.make_spd(gn, rng, device="cuda")
    gjp = run_path(
        torch, "spin_gauss_jordan",
        lambda: spin_inverse_dense(a_gj, gbs, "gauss_jordan", engine="cuda"),
        a_gj, ggrid, op_oracle=True, reps=REPS,
        expect_launches={"schur_update": 2 * (ggrid - 1), "matmul": 4 * (ggrid - 1),
                         "gauss_jordan": ggrid, "blocked_gauss_jordan": 0})

    del a_gj
    gc.collect()
    torch.cuda.empty_cache()

    # 16. the dense LM serving path
    lm = run_lm(torch, rng, lm_cfg, torch.device("cuda"))
    gc.collect()
    torch.cuda.empty_cache()

    print(json.dumps({"paths": {
        "spin": {"n": n, "block_size": bs, "ms": spin["ms"], "residual": spin["residual"]},
        "lu": {"n": n, "block_size": bs, "ms": lu["ms"], "residual": lu["residual"],
               "spin_over_lu": spin_over_lu, "leaf": report["lu_leaf"]},
        "spin_solve": {"n": n, "block_size": bs, "n_rhs": N_RHS, "ms": solve["ms"],
                       "residual": solve["residual"]},
        "spin_bf16_raw": {"n": n, "block_size": bs, "ms": raw["ms"],
                          "residual": raw["residual"], "bound": bf16_bound,
                          "launches": raw["launches"]},
        "spin_bf16": {"n": n, "block_size": bs, "polish_sweeps": sweeps, "ms": polished["ms"],
                      "residual": polished["residual"], "bound": bf16_bound,
                      "launches": polished["launches"], "gemm_bf16": gemm_bf16,
                      "gemm_f32": gemm_f32},
        "spin_solve_bf16": {"n": sn, "block_size": bs, "n_rhs": SOLVE_BF16_RHS,
                            "ms": solve_bf16["ms"], "residual": solve_bf16["residual"],
                            "launches": solve_bf16["launches"]},
        "spin_strassen": {"n": n, "block_size": bs, "cutoff": cutoff, "ms": strassen["ms"],
                          "residual": strassen["residual"], "strassen_counts": got_st,
                          "launches": strassen["launches"]},
        "bs_sweep": plan_run["sweep"],
        "spin_planned": {"n": n, "plan": plan_run["planned"]["plan"],
                         "ms": plan_run["planned"]["ms"],
                         "residual": plan_run["planned"]["residual"],
                         "ratio_to_best": plan_run["planned"]["ratio_to_best"]},
        "spin_solve_planned": {"n": n, "n_rhs": N_RHS, "plan": plan_run["solve"]["plan"],
                               "ms": plan_run["solve"]["ms"],
                               "residual": plan_run["solve"]["residual"]},
        "smw": smw, "sketched": sketched, "checkpoint": ckpt, "spin_service": service,
        "strassen_crossover": crossover,
        "spin_gauss_jordan": {"n": gn, "block_size": gbs, "ms": gjp["ms"],
                              "residual": gjp["residual"]},
        "lm_prefill": lm["lm_prefill"], "lm_decode": lm["lm_decode"],
        "lm_serve": lm["lm_serve"]},
        "card": card}), flush=True)

    # 17. the kernels line
    rows = []
    gemm_body = "gemm_tc: pack pre-pass, then 3xTF32 wgmma on a TMA ring (f32)"
    report["schur_update"]["body"] = report["matmul"]["body"] = gemm_body
    report["blocked_gauss_jordan"]["body"] = (
        "in place on bs x bs: a panel launch inverts the pivot block and packs W and R^T "
        "as TF32 hi/lo, then M += W R as 3xTF32 wgmma, panel rows and columns zeroed")
    report["triangular_solve"]["body"] = (
        "diagonal blocks inverted first, P = [-Dinv T | Dinv] and B^T packed as TF32 hi/lo, "
        "then one 3xTF32 wgmma product a panel on a TMA ring, strip columns a block")
    for name, source, replaces, path in (
            ("schur_update", "src/repro_torch/kernels/csrc/matmul.cu",
             "src/repro/kernels/matmul/kernel.py:131", spin),
            ("matmul", "src/repro_torch/kernels/csrc/matmul.cu",
             "src/repro/kernels/matmul/kernel.py:78", spin),
            ("blocked_gauss_jordan", "src/repro_torch/kernels/csrc/leaf_inverse.cu",
             "src/repro/kernels/leaf_inverse/kernel.py:171", spin),
            ("gauss_jordan", "src/repro_torch/kernels/csrc/leaf_inverse.cu",
             "src/repro/kernels/leaf_inverse/kernel.py:77", gjp),
            ("triangular_solve", "src/repro_torch/kernels/csrc/leaf_inverse.cu",
             "src/repro/kernels/leaf_inverse/kernel.py:270", solve),
            ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:74", lm)):
        r = report[name]
        require(path["launches"][name] > 0, f"{name}: no launch on its path")
        if name in ("matmul", "schur_update", "blocked_gauss_jordan", "triangular_solve"):
            r["launches_by_path"] = {p: run["launches"][name] for p, run in (
                ("spin", spin), ("lu", lu), ("spin_solve", solve), ("spin_bf16_raw", raw),
                ("spin_bf16", polished), ("spin_solve_bf16", solve_bf16),
                ("spin_strassen", strassen), ("spin_planned", plan_run["planned"]),
                ("spin_solve_planned", plan_run["solve"]), ("sketched", sketched),
                ("checkpoint", ckpt), ("spin_service", service))}
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": path["launches"][name], **r})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    # The planner's plan file lies in a directory of this run's own, so that
    # no plan of an earlier run is recalled; it is removed at the end.
    plan_dir = tempfile.mkdtemp(prefix="chip_smoke_plans_")
    os.environ["SPIN_PLAN_CACHE"] = os.path.join(plan_dir, "plans.json")
    try:
        code = main()
    finally:
        shutil.rmtree(plan_dir, ignore_errors=True)
    sys.exit(code)
