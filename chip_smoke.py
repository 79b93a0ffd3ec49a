#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build, check and time it.

    python3 chip_smoke.py            # full width: n = 16384, bs = 1024, f32;
                                     # granite-8b at B = 4, S = 2048;
                                     # qwen2-moe, hymba, mamba2, phi-3-vision,
                                     # hubert at B = 4, S = 2048;
                                     # olmo-1b and the five families trained
                                     # at 8 x 2048 tokens a step

Phases, each of which fails the run (non-zero exit) on any fault:

  1. the card's name and power limit, from nvidia-smi;
  2. build every CUDA kernel of the port from src/repro_torch/kernels/csrc,
     and print the registers, shared memory and spills of the tensor-core
     GEMM body (f32, bf16, f16; 64- and 128-row tiles), of the tensor-core
     flash attention kernel (every head dim; no spill at hd 80), of the in-place
     Gauss-Jordan kernel, and of the blocked leaves' kernels: the
     triangular solve's tensor-core sweep (every strip width), its
     diagonal-block inverse and pack, and the blocked Gauss-Jordan's panel
     and tensor-core update; and of the flash attention backward's dK/dV
     and dQ kernels: the tensor-core ones (bf16, f16) at every head dim,
     hd 80 included, and their sliding-window builds, no spill at any, and
     the f32 FFMA ones (no spill at hd = 64, 80 and 128);
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
     f32, plus a ragged S = 2000 and a non-causal case, and with a sliding
     window at the hymba-1.5b layer (B = 4, H = 25, KV = 5, S = 2048,
     hd = 64, window 1024) in bf16 and f32 and at a ragged S = 2000, and at
     hd = 80 at the hubert-xlarge layer (H = KV = 16, non-causal) and at
     hd = 96 at the phi-3-vision-4.2b layer (H = KV = 32, causal) in bf16,
     each timed beside SDPA (with the same boolean mask under the window)
     and a bound that counts the live pairs only; its backward,
     B6-bwd, against torch.autograd.grad of the plain version at the
     olmo-1b layer, B = 4, H = KV = 16, S = 2048, hd = 128, and the
     granite-8b layer, causal in bf16 and f32 (and f16 at the olmo-1b
     layer), plus a ragged S = 2000 and a non-causal case, timed beside
     SDPA's backward; at the hymba-1.5b layer (B = 4, H = 25, KV = 5,
     S = 2048, hd = 64, window 1024, SDPA given the same boolean mask),
     the hubert-xlarge layer (H = KV = 16, hd = 80, non-causal) and the
     phi-3-vision-4.2b layer (H = KV = 32, hd = 96, causal), in bf16 and
     f32, with a bound that counts the live pairs only; at the olmo-1b,
     hymba, hubert and phi-3-vision layers in bf16 (and f16 at olmo-1b's) also
     against its own arithmetic, `attention_bwd_rounded_ref`, and repeated
     bit for bit);
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
 14. the sharded placement on the same matrix: `spin_inverse_sharded(a,
     1024, leaf_solver="cuda", engine="cuda")` on a 1×1 mesh, bit for bit
     the dense inverse with its launches (60 B2, 30 B1, 16 B3); on a 2×2
     mesh of the one card (`make_worker_mesh((2, 2), devices=["cuda:0"] *
     4)`) under the cuda, allgather and ring engines: residual ≤ 1e-3, the
     largest deviation from the dense inverse, CUDA-event ms, launches
     (cuda: 144 B2, 72 B1, 16 B3, `sharded_spin_launches`), the bytes
     copied between mesh coordinates, peak memory and the spec ledger
     (`assert_mesh_resident`); the sharded solve of 256 right-hand sides
     (B2 and B5 as `sharded_solve_launches` counts them); the planned
     sharded inversion (block_size=None) and its plan recalled from the
     plan file; then at n = 4096, bs = 512, `SpinService` holding the
     matrix sharded beside a dense tenant of the same matrix (an exact
     tick, a maintained tick, rank-64 updates to the refactor, a tick
     after it, each answer within 1e-3 of the dense tenant's, and a
     snapshot round trip), and the coded inversion (4 workers, any 3
     decode) with a 2 s straggler on rank 0: decoded from ranks 1-3, wall
     time under the delay, residual ≤ 1e-3;
 15. the crossover: the dense `strassen_matmul` with one split (cutoff
     n/2) against one GEMM launch at n = 8192, 16384 and 32768, f32, timed
     in turns, beside `costmodel.strassen_crossover_n()`;
 16. a smaller inversion with `leaf_solver="gauss_jordan"`, the path of
     the scalar Gauss-Jordan kernel;
 17. the dense LM serving path at full width and depth: granite-8b with
     random weights from SEED, `prefill` of 4 prompts of 2048 tokens (36
     flash attention launches and no other kernel of the port), 32 greedy
     `decode_step`s from the padded cache, the decode logits of the first
     8 steps against `forward` over prompt plus those tokens, and a
     `ServingEngine` (4 slots, max_len 256) answering 8 requests, one of
     which must equal the same request served alone;
 17b. the other five families at full width and depth, random weights
     from SEED, one at a time and each freed before the next: qwen2-moe
     (64 experts after padding, top-4, 4 shared), hymba-1.5b (window 1024,
     SSD heads), mamba2-130m, phi-3-vision-4.2b (576 patch embeddings and
     1472 tokens) and hubert-xlarge (2048 masked frame embeddings, forward
     only): the prefill of 4 x 2048 positions with B6 launched once a layer
     (24, 32, 0, 32, 48) and no other kernel of the port, 32 greedy decode
     steps (hymba's from a prefill of exactly its window, so that the cache
     rolls and its first step overwrites slot 0), the first 8 against
     `forward` over the prompt plus the fed tokens (SSM and hybrid padded to
     whole SSD chunks; MoE: the route flips between the two paths counted
     by layer, the bound held on the tokens whose routes agree at every
     layer, at least one, and at least 90 % of the tokens routed alike at
     the first layer), and the engine (8 requests, 4 slots); ms,
     tokens/s, launches and peak GiB of each;
 18b. training the five families with AdamW, random weights from SEED,
     `TokenStream` batches of 8 x 2048 positions (the modality batches for
     audio and VLM), 2 microbatches, full remat, one at a time and each
     freed before the next and before phase 18: qwen2-moe-a2.7b cut to its
     first 4 layers, phi-3-vision-4.2b cut to 28, hymba-1.5b, hubert-xlarge
     and mamba2-130m whole; the cuts printed, and running out of memory
     fails the phase. Each: one warm-up and 3 timed steps (ms, tokens/s,
     the caching allocator's retries a step),
     B6 launched 2·L·2 times and B6-bwd L·2 times a step (L the layers
     that ran; 0 for mamba2) and no other kernel of the port, 3 steps on
     one repeated batch whose loss must fall, and peak GiB;
 18. training the dense LM at full width and depth: olmo-1b with random
     weights from SEED, `TokenStream` batches of 8 x 2048 tokens, 2
     microbatches, full remat. AdamW: one warm-up and 3 timed steps (ms,
     tokens/s, loss, grad norm, peak memory; 64 B6 and 32 B6-bwd launches
     a step and no other kernel of the port), 5 steps on one repeated
     batch whose loss must fall, the state saved and restored bit for bit
     through `checkpoint.ckpt` in a temporary directory that the phase
     removes, and one more step from the restored state equal to the same
     step from the live one. SPIN-Shampoo at its default config: step 1
     refreshes (the refresh timed apart; its B1, B2 and B3 launches equal
     to the plans' counts times the factors' layers), step 2 does not
     (none of them); the residual of layer 0's largest factor's inverse
     (8192²) against 4·n·2^-24·κ with κ its condition; peak memory; the
     depth cut only if 80 GB cannot hold it, and then printed;
 19. one JSON line with every path's times and residual, and one with
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
CODED_STRAGGLE_S = 2.0            # the coded inversion's injected straggler

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
# B6-bwd against torch.autograd.grad of the plain version, relative to each
# gradient's largest entry: f32 differs in summation order only; bf16
# rounds each gradient once to 8 mantissa bits, and the kernel's
# D = rowsum(dO o O) reads the rounded O (tests/test_torch_attention_grad.py).
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 1e-2}
# The tensor-core kernels against their own arithmetic (P and dS rounded to
# the operand dtype, D from the forward's output), 4x tighter: the one
# rounding of each gradient (half an ulp, at most 2^-8 of the largest
# entry in bf16) and f32 sums in another order
# (tests/test_torch_attention_grad.py).
FLASH_BWD_ROUNDED_TOL = {name: tol / 4 for name, tol in FLASH_BWD_TOL.items()}

# Phase 17b: the other five families at full width and depth, in this order:
# (config, path name). B6 launches once a layer on every attention path.
FAMILY_RUNS = (("qwen2-moe-a2.7b", "lm_prefill_moe"), ("hymba-1.5b", "lm_prefill_hybrid"),
               ("mamba2-130m", "lm_prefill_ssm"), ("phi-3-vision-4.2b", "lm_prefill_vlm"),
               ("hubert-xlarge", "lm_forward_audio"))
FAMILY_HD = 80                    # hubert-xlarge's head dim, new in B6
# MoE decode against forward: a bf16 near-tie in the router may send a
# token to another expert in one path than in the other, and from there its
# hidden state parts ways. The bound holds the tokens whose top-k sets agree
# at every layer (there must be one), and at the first MoE layer, where both
# paths route the same embeddings through one attention layer, at least this
# share of the checked tokens must route alike. At full depth the share that
# agrees at every layer is no test (`python -m repro_torch.profile_lm
# --routes` measures it on an H100 at qwen2-moe's full width): two forwards
# that differ only in the attention kernel (B6 against plain f32 softmax)
# move the router's input by 0.3 % at layer 0 and 3 % at layer 23, its
# logits by 0.007 and 0.05-0.08, against a median gap of 0.06-0.1 between
# the 4th and 5th expert: 5-15 % of the routes left flip at each layer,
# and 4-5 of 32 tokens keep theirs at all 24 layers.
MOE_ROUTE_AGREE_MIN = 0.9
GRANITE_B6_BEFORE_MS = 0.4290     # B6 bf16 at the granite-8b layer before the window (H100 80GB HBM3, 700 W)

TRAIN_ARCH = "olmo-1b"            # the training phase, full width and depth
TRAIN_BATCH, TRAIN_SEQ = 8, 2048  # 16384 tokens a step
TRAIN_MICRO = 2                   # microbatches of 4 x 2048
TRAIN_TIMED_STEPS = 3             # AdamW steps timed after one warm-up
TRAIN_FALL_STEPS = 5              # AdamW steps on one repeated batch
TRAIN_DEPTH_CUTS = (12, 8)        # SPIN-Shampoo's depth if 80 GB cannot hold all 16 layers
# Phase 18b: the five families trained with AdamW, in this order, each with
# its depth (None: whole). At 20 B a parameter (bf16 weights and
# gradients, the f32 master, m, v and gradient sums) qwen2-moe's 24 layers
# (14.3 B parameters with 64 padded experts) need 267 GiB and
# phi-3-vision's 32 layers 71 GiB before activations; 4 layers of
# qwen2-moe (3.04 B, 67.5 GiB peak) and 28 of phi-3-vision (3.37 B, 65.9
# GiB) leave room for a step's activations and f32 logits.
FAMILY_TRAIN_RUNS = (("qwen2-moe-a2.7b", 4), ("phi-3-vision-4.2b", 28),
                     ("hymba-1.5b", None), ("hubert-xlarge", None), ("mamba2-130m", None))
FAMILY_TRAIN_TIMED_STEPS = 3      # steps timed after one warm-up
FAMILY_TRAIN_FALL_STEPS = 3       # steps on one repeated batch
U_F32 = 2.0 ** -24                # f32 unit roundoff
# The refresh residual's bound: c·n·u·κ, the first-order bound on an
# inverse's residual by elimination, with c = 4 over the 1.3 measured at
# n = 256, κ = 8e3 for both packages (tests/test_torch_optim.py).
REFRESH_RESIDUAL_C = 4.0


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
                   causal: bool, itemsize: int, peak_flops: float,
                   window: int = 0) -> tuple[float, str]:
    # 4·hd operations a live (q, k) pair (the score and the weighted sum);
    # causal rows see kv positions 0..q only, and with a window the last
    # `window` of them: S·w - w(w - 1)/2 pairs at S >= w (sq = skv). q and
    # o, k and v once each.
    n = min(sq, skv)
    pairs = n * (n + 1) // 2 + (sq - n) * skv if causal else sq * skv
    if window:
        n = min(sq, window)
        pairs = n * (n + 1) // 2 + (sq - n) * window
    flops = 4.0 * hd * b * h * pairs
    nbytes = itemsize * hd * (2.0 * b * h * sq + 2.0 * b * kv * skv)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def flash_bwd_bound_ms(b: int, h: int, kv: int, s: int, hd: int, causal: bool,
                       itemsize: int, peak_flops: float, window: int = 0) -> tuple[float, str]:
    # 10·hd operations a live (q, k) pair: S = Q Kᵀ again, dP = dO Vᵀ,
    # dV += Pᵀ dO, dK += dSᵀ Q, dQ += dS K; a window keeps the pairs
    # 0 <= i - j < window, S·w - w(w - 1)/2 of them at S >= w. q, o, dO and
    # k, v read once, dq, dk, dv written once, the f32 log-sum-exp read once.
    pairs = s * (s + 1) // 2 if causal else s * s
    if window:
        w = min(s, window)
        pairs = w * (w + 1) // 2 + (s - w) * window
    flops = 10.0 * hd * b * h * pairs
    nbytes = itemsize * hd * (4.0 * b * h * s + 4.0 * b * kv * s) + 4.0 * b * h * s
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


def check_flash_families(torch, hybrid, audio, vlm) -> dict:
    """Phase 3, B6 on the new families' layers: `hybrid`'s sliding window
    (hymba-1.5b: B = 4, H = 25, KV = 5, S = 2048, hd = 64, window 1024) in
    bf16 and f32 and at a ragged S = 2000, `audio`'s hd 80 (hubert-xlarge:
    B = 4, H = KV = 16, S = 2048, non-causal) and `vlm`'s hd 96
    (phi-3-vision-4.2b: B = 4, H = KV = 32, S = 2048, causal) in bf16, each
    against attention_ref, timed beside its bound (the live pairs only) and
    SDPA (given the same boolean mask under the window, told `is_causal`
    without one). Its own draws, so that the later
    phases' stay as they were."""
    from repro_torch.kernels.flash_attention import kernel as fa, ref as fa_ref
    import numpy as np
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rng = np.random.default_rng([SEED, 7])
    out = {}
    cases = (("window", hybrid, LM_SEQ, torch.bfloat16, True),
             ("window_f32", hybrid, LM_SEQ, torch.float32, True),
             ("window_ragged", hybrid, LM_SEQ - 48, torch.bfloat16, False),
             ("hd80", audio, LM_SEQ, torch.bfloat16, True),
             ("hd96", vlm, LM_SEQ, torch.bfloat16, True))
    for case, cfg, sq, dtype, timed_case in cases:
        b, h, kv, hd = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        causal, window = cfg.causal, cfg.sliding_window

        def one(heads):
            x = rng.standard_normal((b, sq, heads, hd), dtype=np.float32)
            return torch.from_numpy(x).to(dev, dtype).transpose(1, 2)
        q, k, v = one(h), one(kv), one(kv)
        name = str(dtype)[6:]
        got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
        want = fa_ref.attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err, tol = max_abs(got, want), FLASH_TOL[name]
        shape = (f"B={b} H={h} KV={kv} S={sq} hd={hd} "
                 f"{'causal' if causal else 'full'} window={window} {name}")
        print(f"check flash_attention {case} {shape}: max_abs_err={err!r} tol={tol!r}",
              flush=True)
        require(got.dtype == dtype and got.shape == q.shape and
                bool(torch.isfinite(got.float()).all()),
                f"flash_attention {case}: dtype, shape or non-finite")
        require(err <= tol, f"flash_attention {case}: max_abs_err {err} > {tol}")
        del got, want
        row = {"shape": shape, "max_abs_err": err}
        if timed_case:
            peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
            bound, by = flash_bound_ms(b, h, kv, sq, sq, hd, causal, q.element_size(), peak,
                                       window=window)
            # SDPA takes a boolean mask only for the window: a causal mask
            # it is given rather than told of keeps it off its flash path
            mask = fa_ref.attention_mask(sq, sq, causal, window, dev) if window else None
            row.update(
                ms=time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=causal,
                                                           window=window), 5),
                plain_ms=time_ms(lambda: fa_ref.attention_ref(q, k, v, causal=causal,
                                                              window=window), 2),
                # the yardstick; the port never calls it
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, is_causal=causal and not window,
                    enable_gqa=True), 5),
                bound_ms=bound, bound_by=by)
            print(f"time flash_attention {case}: {row}", flush=True)
        out[case] = row
        del q, k, v
        torch.cuda.empty_cache()
    return out


def check_flash_bwd(torch, shapes) -> dict:
    """Phase 3, B6-bwd: dq, dk, dv of the kernel against torch.autograd.grad
    of the plain version at the LM layers' shapes (`shapes`: name -> (B, H,
    KV, S, hd, causal, window)), in bf16 and f32, plus a ragged S and a
    non-causal case in bf16 at the granite-8b layer, a ragged S in bf16
    at the families' layers (under the window at hymba's), and f16 at the
    training layer; timed beside its
    bound (the live pairs only) and SDPA's backward (given the same
    boolean mask under a window). In bf16 and f16 at every layer but
    granite-8b's the tensor-core kernels are also held to their own
    arithmetic (`attention_bwd_rounded_ref`) and repeated bit for bit. Its
    own inputs, so that the later phases' draws stay as they were."""
    from repro_torch.kernels.flash_attention import kernel as fa, ref as fa_ref
    import numpy as np
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rng = np.random.default_rng([SEED, 21])
    row = {}
    for shape_name, (b, h, kv, s, hd, causal, window) in shapes.items():
        dtypes = [(torch.bfloat16, PEAK_BF16_FLOPS), (torch.float32, PEAK_F32_FLOPS)]
        if shape_name == TRAIN_ARCH:
            dtypes.append((torch.float16, PEAK_BF16_FLOPS))
        main = "window" if window else "causal" if causal else "full"
        for dtype, peak in dtypes:
            name = str(dtype)[6:]
            cases = [(main, s, causal)]
            if dtype == torch.bfloat16 and shape_name == LM_ARCH:
                cases += [("ragged", s - 48, True), ("full", s, False)]
            if dtype == torch.bfloat16 and window:
                cases.append(("window_ragged", s - 48, True))
            elif dtype == torch.bfloat16 and shape_name not in (LM_ARCH, TRAIN_ARCH):
                cases.append(("ragged", s - 48, causal))
            for case, sq, cs in cases:
                def one(heads):
                    x = rng.standard_normal((b, sq, heads, hd), dtype=np.float32)
                    return torch.from_numpy(x).to(dev, dtype).transpose(1, 2)
                q, k, v, do = one(h), one(kv), one(kv), one(h)
                out, lse = fa._forward(q, k, v, cs, want_lse=True, window=window)
                got = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse, causal=cs,
                                                  window=window)
                want = fa_ref.attention_bwd_ref(q, k, v, do, causal=cs, window=window)
                torch.cuda.synchronize()
                errs = [max_abs(g, w) for g, w in zip(got, want)]
                rels = [e / float(w.float().abs().max()) for e, w in zip(errs, want)]
                tol = FLASH_BWD_TOL[name]
                print(f"check flash_attention_bwd {shape_name} {case} {name} B={b} H={h} "
                      f"KV={kv} S={sq} hd={hd} window={window}: "
                      f"max_abs_err(dq,dk,dv)={errs!r} rel={rels!r} tol={tol!r}", flush=True)
                for g, t in zip(got, (q, k, v)):
                    require(g.dtype == dtype and g.shape == t.shape,
                            f"flash_attention_bwd {case} {name}: dtype/shape differ")
                    require(bool(torch.isfinite(g.float()).all()),
                            f"flash_attention_bwd {case} {name}: non-finite")
                require(max(rels) <= tol,
                        f"flash_attention_bwd {shape_name} {case} {name}: rel err "
                        f"{max(rels)} > {tol}")
                del want
                extra = {}
                if shape_name != LM_ARCH and dtype != torch.float32 and case == main:
                    # the kernels' own arithmetic, on the forward's output
                    rounded = fa_ref.attention_bwd_rounded_ref(q, k, v, do, causal=cs,
                                                               window=window, out=out)
                    extra["rounded_rel_err"] = max(
                        max_abs(g, w) / float(w.abs().max()) for g, w in zip(got, rounded))
                    del rounded
                    again = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse, causal=cs,
                                                        window=window)
                    extra["bitwise_repeat"] = all(torch.equal(g, a) for g, a in zip(got, again))
                    del again
                    rtol = FLASH_BWD_ROUNDED_TOL[name]
                    print(f"check flash_attention_bwd {shape_name} {case} {name}: "
                          f"rounded_rel_err={extra['rounded_rel_err']!r} tol={rtol!r} "
                          f"bitwise_repeat={extra['bitwise_repeat']}", flush=True)
                    require(extra["rounded_rel_err"] <= rtol,
                            f"flash_attention_bwd {shape_name} {name}: against its own "
                            f"arithmetic {extra['rounded_rel_err']} > {rtol}")
                    require(extra["bitwise_repeat"],
                            f"flash_attention_bwd {shape_name} {name}: a repeat differs")
                del got
                if case == main:
                    bound, by = flash_bwd_bound_ms(b, h, kv, sq, hd, cs, q.element_size(),
                                                   peak, window=window)
                    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                    # the yardstick; the port never calls it
                    mask = fa_ref.attention_mask(sq, sq, cs, window, dev) if window else None
                    lib_out = F.scaled_dot_product_attention(
                        *leaves, attn_mask=mask, is_causal=cs and not window, enable_gqa=True)
                    # enough launches that the first one's host time (checks,
                    # eight tensor maps) does not count: 20 of the tensor-core
                    # kernels, 3 of the f32 ones (≈ 15 ms each)
                    reps = 3 if dtype == torch.float32 else 20
                    times = {
                        "ms": time_ms(lambda: fa.flash_attention_bwd_cuda(
                            q, k, v, out, do, lse, causal=cs, window=window), reps),
                        "plain_ms": time_ms(lambda: fa_ref.attention_bwd_ref(
                            q, k, v, do, causal=cs, window=window), 1),
                        "library_ms": time_ms(lambda: torch.autograd.grad(
                            lib_out, leaves, do, retain_graph=True), reps),
                        "bound_ms": bound, "bound_by": by, "max_abs_err": max(errs),
                        "rel_err": max(rels), **extra}
                    print(f"time flash_attention_bwd {shape_name} {name}: {times}",
                          flush=True)
                    del lib_out, leaves, mask
                    if dtype == torch.bfloat16 and shape_name == TRAIN_ARCH:
                        row.update(times, shape=f"B={b} H={h} KV={kv} S={sq} hd={hd} "
                                                f"causal bf16 ({shape_name} layer)")
                    else:
                        short = {torch.bfloat16: "bf16", torch.float16: "f16"}.get(dtype, "f32")
                        row.update({f"{shape_name}_{short}_{key}": val
                                    for key, val in times.items()})
                        if shape_name != TRAIN_ARCH:
                            row[f"{shape_name}_shape"] = (
                                f"B={b} H={h} KV={kv} S={s} hd={hd} {main}"
                                + (f" {window}" if window else ""))
                del q, k, v, do, out, lse
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
            if hd == FAMILY_HD:  # hubert-xlarge's: the 32-byte swizzle, 5 chunks a row
                require(attrs["local_bytes"] == 0, f"flash_attention {dtype} hd={hd} spills")
    # B6-bwd: the tensor-core kernels (bf16, f16) at every head dim and
    # their sliding-window builds, no spill allowed; the f32 FFMA kernels
    # (one build), no spill at the trained families' head dims.
    for dtype, hds in ((torch.bfloat16, fa.BWD_HEAD_DIMS),
                       (torch.float16, fa.BWD_HEAD_DIMS), (torch.float32, (64, 80, 96, 128, 160))):
        for hd in hds:
            for window in ((False,) if dtype == torch.float32 else (False, True)):
                attrs = fa.flash_attention_bwd_attributes(dtype, hd, window=window)
                print(f"resources flash_attention_bwd {str(dtype)[6:]} hd={hd}"
                      f"{' window' if window else ''}: {attrs}", flush=True)
                if dtype != torch.float32 or hd != 160:
                    require(all(a["local_bytes"] == 0 for a in attrs.values()),
                            f"flash_attention_bwd {dtype} hd={hd} window={window} spills")
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


def sharded_spin_launches(grid: int, mesh_shape: tuple[int, int]) -> dict:
    """Kernel launches of one sharded inversion on a mesh of ONE card: a
    node whose quadrant grid h divides both mesh axes runs its 4 products
    and 2 Schur updates as SUMMA, one launch a shard; a node whose grid
    does not runs each once (a replicated value is computed once a
    distinct device); the leaves are one B3 launch each."""
    d, m = mesh_shape
    b2 = b1 = 0
    nodes, h = 1, grid // 2
    while h >= 1:
        per = d * m if h % d == 0 and h % m == 0 else 1
        b2 += nodes * 4 * per
        b1 += nodes * 2 * per
        nodes, h = 2 * nodes, h // 2
    return {"matmul": b2, "schur_update": b1, "blocked_gauss_jordan": grid,
            "gauss_jordan": 0}


def sharded_solve_launches(grid: int, bs: int, data: int) -> dict:
    """B2 and B5 launches of one sharded solve on a mesh of one card: each
    of a node's two A21 panel products runs once for each distinct run of
    A21 block rows that the `data` row shards cover; every leaf solve is
    two B5 sweeps, once."""
    b2, nodes, h = 0, 1, grid // 2
    while h >= 1:
        rows = h * bs
        if rows % data:
            spans = 1
        else:
            chunk = rows // data
            spans = len({(i * chunk // bs, -(-(i + 1) * chunk // bs)) for i in range(data)})
        b2 += nodes * 2 * spans
        nodes, h = 2 * nodes, h // 2
    return {"matmul": b2, "triangular_solve": 2 * grid, "schur_update": 0,
            "blocked_gauss_jordan": 0, "gauss_jordan": 0}


def run_sharded(torch, a) -> dict:
    """Phase 14: the sharded placement on the phase-4 matrix. The 1×1 mesh
    bitwise the dense inverse with its launches; a 2×2 mesh of the one card
    under the cuda, allgather and ring engines (residual, deviation from the
    dense inverse, CUDA-event ms, launches, bytes copied between mesh
    coordinates, peak memory, the spec ledger); the sharded solve of the 256
    right-hand sides; the planned sharded inversion recalled from the plan
    file; then at n = SERVICE_SIDE_N, `SpinService` with sharded=True
    against a dense tenant, and the coded inversion with a straggler."""
    import threading

    import numpy as np
    from repro_torch import kernels
    from repro_torch.core import (count_ops, spin_inverse_dense, spin_inverse_sharded,
                                  spin_solve_sharded, verify)
    from repro_torch.launch.mesh import make_worker_mesh, set_mesh
    from repro_torch.parallel import (CodedConfig, FaultPlan, assert_mesh_resident,
                                      collective_bytes, record_specs,
                                      reset_collective_bytes)
    from repro_torch.parallel.straggler import WORKER_THREAD_PREFIX, coded_inverse
    from repro_torch.planner import PlanCache, default_cache_path, get_plan, signature_for

    n, bs = a.shape[0], BLOCK_SIZE
    grid = n // bs
    x_dense = spin_inverse_dense(a, bs, "cuda", engine="cuda")
    rhs = torch.from_numpy(np.random.default_rng([SEED, 14]).standard_normal(
        (n, N_RHS), dtype=np.float32)).to(a.device)
    out: dict = {"mesh": {}}

    def drive(name, fn, *, expect, b=None, bound=RESIDUAL_BOUND):
        """One warm-up run, then one counted run (launches, bytes, peak
        memory, spec ledger) and REPS - 1 more, each timed by CUDA events."""
        fn()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        reset_collective_bytes()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with record_specs() as recs, count_ops() as counts:
            x, ms = timed(torch, fn)
        launches = kernels.launch_counts()
        moved = collective_bytes()
        peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        times = [ms] + [timed(torch, fn)[1] for _ in range(REPS - 1)]
        res = verify.inverse_residual(a, x) if b is None else verify.solve_residual(a, x, b)
        tally = assert_mesh_resident(recs)
        print(f"path {name}: ms={times!r} residual={res!r} launches={launches} "
              f"bytes={moved} peak_gib_above_inputs={peak_gib!r} ledger={tally}", flush=True)
        require(bool(torch.isfinite(x).all()), f"{name}: non-finite entries")
        require(res <= bound, f"{name}: residual {res} > {bound}")
        for kern, want in expect.items():
            require(launches[kern] == want,
                    f"{name}: {kern} launched {launches[kern]} times, want {want}")
        products = launches["matmul"] + launches["schur_update"]
        require(launches["gemm_tensor_core"] == products and launches["gemm_ffma"] == 0,
                f"{name}: {products} GEMM launches, {launches['gemm_tensor_core']} on the "
                "tensor-core body")
        return x, {"ms": times, "residual": res, "launches": launches, "bytes": moved,
                   "peak_gib": peak_gib, "ledger": tally, "op_counts": counts.as_dict()}

    # 1. a 1×1 mesh: the dense path's launches, bit for bit
    with set_mesh(make_worker_mesh((1, 1), devices=["cuda:0"])):
        x, run = drive("sharded_1x1",
                       lambda: spin_inverse_sharded(a, bs, leaf_solver="cuda", engine="cuda"),
                       expect=sharded_spin_launches(grid, (1, 1)))
    require(torch.equal(x, x_dense), "sharded_1x1: differs from the dense inverse")
    require(run["op_counts"] == verify.expected_spin_counts(grid).as_dict(),
            "sharded_1x1: op counts differ from expected_spin_counts")
    out["mesh"]["1x1"] = run
    del x

    # 2. a 2×2 mesh of the one card under each engine
    mesh22 = make_worker_mesh((2, 2), devices=["cuda:0"] * 4)
    for engine in ("cuda", "allgather", "ring"):
        expect = (sharded_spin_launches(grid, (2, 2)) if engine == "cuda" else
                  {"matmul": 0, "schur_update": 0, "blocked_gauss_jordan": grid})
        with set_mesh(mesh22):
            x, run = drive(f"sharded_2x2_{engine}",
                           lambda: spin_inverse_sharded(a, bs, leaf_solver="cuda",
                                                        engine=engine),
                           expect=expect)
        run["max_dev_from_dense"] = float((x - x_dense).abs().max())
        require(run["op_counts"] == verify.expected_spin_counts(grid).as_dict(),
                f"sharded_2x2_{engine}: op counts {run['op_counts']}")
        print(f"path sharded_2x2_{engine}: max_dev_from_dense={run['max_dev_from_dense']!r}",
              flush=True)
        out["mesh"][f"2x2_{engine}"] = run
        del x
        gc.collect()
        torch.cuda.empty_cache()
    del x_dense

    # 3. the sharded solve of the 256 right-hand sides on 2×2
    with set_mesh(mesh22):
        x, run = drive("sharded_solve_2x2",
                       lambda: spin_solve_sharded(a, rhs, bs, leaf_solver="cuda",
                                                  engine="cuda"),
                       expect=sharded_solve_launches(grid, bs, 2), b=rhs)
    out["solve_2x2"] = run
    del x, rhs

    # 4. the planned sharded inversion under the 2×2 mesh, and its recall
    with set_mesh(mesh22):
        x, planned = drive("sharded_planned_2x2", lambda: spin_inverse_sharded(a),
                           expect={})
        plan = get_plan("inverse", n, a.dtype, measure=False, placement="sharded",
                        backend="cuda")
        recalled = PlanCache(default_cache_path()).get(signature_for(
            "inverse", n, a.dtype, backend="cuda", placement="sharded"))
    require(recalled is not None and recalled.execution_key() == plan.execution_key(),
            f"sharded_planned_2x2: the plan file holds {recalled}, want {plan}")
    require(plan.multiply_engine == "cuda", f"sharded_planned_2x2: plan {plan}")
    planned["plan"] = plan.to_dict()
    print(f"path sharded_planned_2x2: plan={plan.to_dict()} recalled from "
          f"{default_cache_path()}", flush=True)
    out["planned_2x2"] = planned
    del x
    gc.collect()
    torch.cuda.empty_cache()

    # 5a. SpinService with sharded=True on 2×2 beside a dense tenant
    from repro_torch.serving import SpinService

    sn, sbs = SERVICE_SIDE_N, SERVICE_SIDE_BLOCK_SIZE
    a4 = a[:sn, :sn].contiguous()
    gen = torch.Generator(device=a.device).manual_seed(SEED)
    rng = np.random.default_rng([SEED, 15])

    def rank_k(k: int):
        return torch.from_numpy(rng.standard_normal((sn, k), dtype=np.float32)).to(
            a.device) / sn ** 0.5

    def tick(svc, tag, a_now):
        rhs_ = [torch.randn(sn, SERVICE_COLS, generator=gen, device=a.device)
                for _ in range(SERVICE_REQUESTS)]
        reqs = {m: [svc.solve(m, b) for b in rhs_] for m in ("sharded", "dense")}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        svc.run_until_done()
        end.record()
        end.synchronize()
        xs = {m: torch.cat([r.x for r in rs], dim=1) for m, rs in reqs.items()}
        paths = {m: {r.path for r in rs} for m, rs in reqs.items()}
        require(all(len(p_) == 1 for p_ in paths.values()),
                f"sharded service {tag}: one tick took paths {paths}")
        dev_ = float((xs["sharded"] - xs["dense"]).abs().max()
                     / xs["dense"].abs().max())
        require(dev_ <= RESIDUAL_BOUND, f"sharded service {tag}: sharded and dense "
                f"answers differ by {dev_}")
        res = verify.solve_residual(a_now, xs["sharded"], torch.cat(rhs_, dim=1))
        require(res <= RESIDUAL_BOUND, f"sharded service {tag}: residual {res}")
        return {"tag": tag, "path": paths["sharded"].pop(),
                "dense_path": paths["dense"].pop(), "ms": start.elapsed_time(end),
                "rel_dev_vs_dense": dev_, "residual": res}

    t_svc = time.perf_counter()
    with set_mesh(mesh22):
        svc = SpinService(slots=2 * SERVICE_REQUESTS)
        st = svc.add_matrix("sharded", a4, block_size=sbs, leaf_solver="cuda",
                            engine="cuda", sharded=True)
        svc.add_matrix("dense", a4, block_size=sbs, leaf_solver="cuda", engine="cuda")
        require(st.placement == "sharded" and type(st.inv).__name__ == "ShardedBlockMatrix",
                "sharded service: the matrix is not held sharded")
        ticks = [tick(svc, "exact", a4)]
        a_cur, updates, refactored = a4, 0, False
        while not refactored and updates < 400:
            u = rank_k(SMW_RANK)
            ups = [svc.update(m, u) for m in ("sharded", "dense")]
            svc.run_until_done()
            a_cur = a_cur + u @ u.T
            updates += 1
            refactored = bool(ups[0].refactored)
            if updates == 1:
                ticks.append(tick(svc, "maintained", a_cur))
        require(refactored, "sharded service: no refactor within 400 rank-64 updates")
        ticks.append(tick(svc, "after_refactor", a_cur))
        require([t["path"] for t in ticks] == ["recursion", "maintained", "recursion"],
                f"sharded service: paths {[t['path'] for t in ticks]}")
        snap_dir = tempfile.mkdtemp(prefix="chip_smoke_sharded_snap_")
        try:
            svc.snapshot(snap_dir)
            back = SpinService.restore(snap_dir)
            rst = back.matrix("sharded")
            require(rst.placement == "sharded"
                    and torch.equal(rst.inv.to_dense(), st.inv.to_dense()),
                    "sharded service: the snapshot round trip changed the inverse")
        finally:
            shutil.rmtree(snap_dir, ignore_errors=True)
    service_s = time.perf_counter() - t_svc
    print(f"path sharded_service: n={sn} bs={sbs} updates_to_refactor={updates} "
          f"ticks={ticks} wall_s={service_s!r}", flush=True)
    out["service"] = {"n": sn, "block_size": sbs, "updates_to_refactor": updates,
                      "ticks": ticks, "wall_s": service_s}
    del svc, back, st, rst, ticks
    gc.collect()
    torch.cuda.empty_cache()

    # 5b. the coded inversion on 2×2: 4 workers, any 3 decode; one straggles
    # A worker is overdue past 1 s (or 10 medians): a fault-free run's
    # four solves, sharing the card and the host, all finish inside it.
    cfg = CodedConfig(workers=4, redundancy=1, min_deadline_s=1.0)
    coded = {}
    with set_mesh(mesh22):
        spin_inverse_sharded(a4, sbs, leaf_solver="cuda", engine="cuda", coded=cfg,
                             fault_plan=FaultPlan())
        for tag, plan_ in (("fault_free", FaultPlan()),
                           ("straggler", FaultPlan().inject_straggler(0, CODED_STRAGGLE_S))):
            t0 = time.perf_counter()
            inv, report = coded_inverse(a4, cfg, block_size=sbs, leaf_solver="cuda",
                                        engine="cuda", sharded=True, fault_plan=plan_)
            wall = time.perf_counter() - t0
            res = verify.inverse_residual(a4, inv)
            coded[tag] = {"wall_s": wall, "residual": res, "used_ranks": report.used_ranks,
                          "stragglers": report.stragglers, "failed": report.failed,
                          "attempts": report.attempts, "pool_wall_s": report.wall_s,
                          "median_shard_s": report.median_shard_s}
            print(f"path sharded_coded_{tag}: {coded[tag]}", flush=True)
            require(res <= RESIDUAL_BOUND, f"sharded_coded_{tag}: residual {res}")
    require(coded["straggler"]["used_ranks"] == [1, 2, 3],
            f"sharded_coded: decoded from {coded['straggler']['used_ranks']}")
    require(coded["straggler"]["wall_s"] < CODED_STRAGGLE_S,
            f"sharded_coded: {coded['straggler']['wall_s']} s tracks the "
            f"{CODED_STRAGGLE_S} s straggler")
    # the straggler was not waited on: let it finish before the next phase
    for t in threading.enumerate():
        if t.name.startswith(WORKER_THREAD_PREFIX):
            t.join(timeout=4 * CODED_STRAGGLE_S)
    out["coded"] = coded
    del a4, inv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_lm(torch, rng, cfg, dev) -> dict:
    """Phase 17: the dense LM serving path, `cfg` on `dev`."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.models import transformer as T

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

    serve = serve_requests(torch, cfg, params, "lm_serve")
    del params
    return {
        "launches": launches,
        "lm_prefill": {"arch": cfg.name, "batch": LM_BATCH, "seq": LM_SEQ, "ms": prefill_ms,
                       "tokens_per_s": tokens_per_s},
        "lm_decode": {"steps": LM_DECODE_STEPS, "ms_per_step": decode_ms,
                      "tokens_per_s": LM_BATCH / (decode_ms / 1e3),
                      "consistency_err": err, "consistency_rms": rms,
                      "consistency_bound": LM_CONSISTENCY_BOUND},
        "lm_serve": serve}


def _route_recorder(moe_mod):
    """Record every MoE route (the (t, k) expert indices) while it is
    installed: (list of routes, uninstall)."""
    routes, route = [], moe_mod.route

    def recording(x, router_w, cfg):
        out = route(x, router_w, cfg)
        routes.append(out[3])
        return out
    moe_mod.route = recording

    def uninstall():
        moe_mod.route = route
    return routes, uninstall


def _route_flips(dec_routes: list, fwd_routes: list, n_layers: int, start: int,
                 steps: int, batch: int) -> list:
    """For each MoE layer, (B, steps) bool: where a checked token's top-k
    expert set differs between the decode steps and the forward."""
    import torch

    out = []
    for layer in range(n_layers):
        dec = torch.stack([dec_routes[i * n_layers + layer] for i in range(steps)], 1)
        fwd = fwd_routes[layer].reshape(batch, -1, dec.shape[-1])[:, start:start + steps]
        out.append((dec.sort(-1).values != fwd.sort(-1).values).any(-1))
    return out


def run_lm_family(torch, cfg, path: str, dev, index: int) -> dict:
    """Phase 17b, one family at full width and depth, random weights from
    SEED: the prefill (audio: the forward) of a `make_batch` batch of 4 x
    2048 positions, once to warm up, then counted and timed, and timed
    again; B6 must launch once a layer and no other kernel of the port. A
    decoding family then decodes 32 greedy steps (hymba from a prefill of
    exactly its window, so that the cache rolls and its first step
    overwrites slot 0), holds the first 8 against `forward` over the
    prompt plus the fed tokens (padded to whole SSD chunks; MoE: the
    tokens whose routes agree at every layer, and 90 % of them routed alike
    at the first layer: MOE_ROUTE_AGREE_MIN), and serves 8 requests
    through the engine."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import moe as moe_mod, transformer as T

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"lm_family: {cfg.name} ({cfg.family}) {n_params} parameters on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    batch = make_batch(cfg, LM_BATCH, LM_SEQ, np.random.default_rng([SEED, 17, index]),
                       "prefill", dev)
    if cfg.decode_capable:
        run = lambda: T.prefill(params, batch, cfg)       # noqa: E731
    else:
        run = lambda: T.forward(params, batch, cfg)       # noqa: E731
    run()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    (logits, aux, z, cache), ms = timed(torch, run)
    launches = kernels.launch_counts()
    prefill_ms = [ms, timed(torch, run)[1]]
    b6 = 0 if cfg.attn_free else cfg.n_layers
    tokens_per_s = LM_BATCH * LM_SEQ / (min(prefill_ms) / 1e3)
    print(f"path {path}: {cfg.name} B={LM_BATCH} S={LM_SEQ} ms={prefill_ms!r} "
          f"tokens_per_s={tokens_per_s!r} launches={launches} aux={float(aux)!r} "
          f"z={float(z)!r}", flush=True)
    require(tuple(logits.shape) == (LM_BATCH, LM_SEQ, cfg.vocab)
            and logits.dtype == torch.float32, f"{path}: logits {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits).all()), f"{path}: non-finite logits")
    require(cfg.moe is None or (float(aux) > 0 and np.isfinite(float(z))),
            f"{path}: aux {float(aux)}, z {float(z)}")
    for kern, n in launches.items():
        want = b6 if kern == "flash_attention" else 0
        require(n == want, f"{path}: {kern} launched {n} times, want {want}")
    out = {"arch": cfg.name, "family": cfg.family, "params": n_params, "batch": LM_BATCH,
           "seq": LM_SEQ, "ms": prefill_ms, "tokens_per_s": tokens_per_s,
           "launches": launches}
    if not cfg.decode_capable:
        del logits, cache, params, batch
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"path {path}: peak_gib={out['peak_gib']!r}", flush=True)
        return out

    # greedy decode: hymba from a prefill of exactly its window (the cache
    # rolls), the others from the 2048-token cache padded by the steps
    start = cfg.sliding_window or LM_SEQ
    if cfg.sliding_window:
        del logits, cache
        prompt = {"tokens": batch["tokens"][:, :start]}
        logits, _, _, cache = T.prefill(params, prompt, cfg)
        require(cache["k"].shape[2] == cfg.sliding_window, f"{path}: cache {cache['k'].shape}")
        slot0 = cache["k"][:, :, 0].clone()
    else:
        pad = (0, 0, 0, 0, 0, LM_DECODE_STEPS)
        cache = {k: F.pad(v, pad) if k in ("k", "v") else v for k, v in cache.items()}
    n_prefix = batch["patch_embeds"].shape[1] if cfg.family == "vlm" else 0
    tok = torch.argmax(logits[:, -1], dim=-1)
    del logits
    routes, uninstall = _route_recorder(moe_mod) if cfg.moe is not None else ([], None)
    fed, step_logits, step_ms = [], [], []
    try:
        for i in range(LM_DECODE_STEPS):
            fed.append(tok)
            (lg, cache), ms = timed(torch, lambda: T.decode_step(params, cache, tok, cfg))
            step_ms.append(ms)
            if i < LM_CHECK_STEPS:
                step_logits.append(lg)
            require(bool(torch.isfinite(lg).all()), f"{path}: non-finite decode logits at {i}")
            tok = torch.argmax(lg, dim=-1)
    finally:
        if uninstall:
            uninstall()
    end = start + LM_DECODE_STEPS
    require(torch.equal(cache["pos"].cpu(), torch.full((LM_BATCH,), end, dtype=torch.int32)),
            f"{path}: decode pos {cache['pos'].tolist()}")
    if cfg.sliding_window:   # the first step wrote position `start` into slot 0
        require(not torch.equal(cache["k"][:, :, 0], slot0), f"{path}: slot 0 not rolled")
    del cache
    decode_ms = sum(step_ms) / len(step_ms)

    # decode logits against forward over the prompt plus the fed tokens,
    # padded to whole SSD chunks for the SSM families (causal: the compared
    # positions never see the padding)
    text = batch["tokens"][:, :start - n_prefix] if cfg.sliding_window else batch["tokens"]
    seq = torch.cat([text, torch.stack(fed[:LM_CHECK_STEPS], 1)], 1)
    if cfg.ssm is not None:
        chunk = cfg.ssm.chunk
        seq = F.pad(seq, (0, -(seq.shape[1] + n_prefix) % chunk))
    fbatch = {**{k: v for k, v in batch.items() if k == "patch_embeds"}, "tokens": seq}
    fwd_routes, uninstall = _route_recorder(moe_mod) if cfg.moe is not None else ([], None)
    try:
        full = T.forward(params, fbatch, cfg)[0][:, start:start + LM_CHECK_STEPS]
    finally:
        if uninstall:
            uninstall()
    got = torch.stack(step_logits, 1)
    keep = torch.ones((LM_BATCH, LM_CHECK_STEPS), dtype=torch.bool, device=dev)
    flips_by_layer, first_agree = [], 1.0
    if cfg.moe is not None:
        differ = _route_flips(routes, fwd_routes, cfg.n_layers, start, LM_CHECK_STEPS,
                              LM_BATCH)
        for d in differ:      # the tokens that part ways at this layer first
            flips_by_layer.append(int((d & keep).sum()))
            keep = keep & ~d
        first_agree = 1.0 - float(differ[0].float().mean())
        print(f"path {path}: route flips by layer (tokens parting ways there first): "
              f"{flips_by_layer}; (token, layer) pairs that differ: "
              f"{sum(int(d.sum()) for d in differ)}; first layer agrees on "
              f"{first_agree!r}", flush=True)
    require(first_agree >= MOE_ROUTE_AGREE_MIN and bool(keep.any()),
            f"{path}: the first MoE layer routes {first_agree} of the tokens alike "
            f"(< {MOE_ROUTE_AGREE_MIN}), or no token agrees at every layer")
    agree_share = float(keep.float().mean())
    diff = (got - full).abs().amax(-1)                      # (B, steps)
    err = float(diff[keep].max())
    rms = float((got - full)[keep].square().mean().sqrt())
    top2 = torch.topk(full, 2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1]) > LM_CONSISTENCY_BOUND) & keep
    agree = torch.argmax(got, -1) == torch.argmax(full, -1)
    print(f"path {path.replace('prefill', 'decode')}: from_pos={start} "
          f"steps={LM_DECODE_STEPS} ms_per_step={decode_ms!r} ms={step_ms!r} "
          f"consistency_err={err!r} rms={rms!r} bound={LM_CONSISTENCY_BOUND!r} "
          f"all_tokens_err={float(diff.max())!r} "
          f"route_agree_tokens={int(keep.sum())}/{keep.numel()} "
          f"tokens_agree={int(agree.sum())}/{agree.numel()}", flush=True)
    require(err <= LM_CONSISTENCY_BOUND,
            f"{path}: decode vs forward logits differ by {err} > {LM_CONSISTENCY_BOUND}")
    require(bool(agree[clear].all()), f"{path}: a token differs where the top-2 margin "
                                      f"exceeds {LM_CONSISTENCY_BOUND}")
    del full, got, step_logits, batch, fbatch
    torch.cuda.empty_cache()
    # MoE: another request's tokens share the experts' buffers, so the
    # same-width solo run is reported, not required
    serve = serve_requests(torch, cfg, params, path.replace("prefill", "serve"),
                           require_solo=cfg.moe is None)
    del params
    out.update(decode={"from_pos": start, "steps": LM_DECODE_STEPS, "ms_per_step": decode_ms,
                       "tokens_per_s": LM_BATCH / (decode_ms / 1e3),
                       "consistency_err": err, "consistency_rms": rms,
                       "consistency_bound": LM_CONSISTENCY_BOUND,
                       "route_flips_by_layer": flips_by_layer,
                       "route_first_layer_agree": first_agree,
                       "route_agree_share": agree_share},
               serve=serve, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"path {path}: peak_gib={out['peak_gib']!r}", flush=True)
    return out


def serve_requests(torch, cfg, params, path: str, require_solo: bool = True) -> dict:
    """Continuous batching: 8 requests through a `ServingEngine` of 4 slots
    (max_len 256), then the first request alone in an engine of the same
    width (the same GEMM shapes, so the same rounding), which must give the
    same tokens where `require_solo`, and alone at batch 1, reported."""
    import numpy as np
    from repro_torch.serving import Request, ServingEngine

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
            f"{path}: a request did not finish with all its tokens")
    solo = {}
    for width in (SERVE_SLOTS, 1):
        alone = Request(uid=0, prompt=list(reqs[0].prompt), max_new_tokens=SERVE_NEW_TOKENS)
        one = ServingEngine(cfg, params, slots=width, max_len=SERVE_MAX_LEN)
        one.submit(alone)
        one.run_until_done()
        solo[width] = sum(a == b for a, b in zip(alone.output, reqs[0].output))
    print(f"path {path}: requests={SERVE_REQUESTS} slots={SERVE_SLOTS} ticks={eng.ticks} "
          f"generated={generated} s={serve_s!r} tokens_per_s={generated / serve_s!r} "
          f"solo_match_same_width={solo[SERVE_SLOTS]}/{SERVE_NEW_TOKENS} "
          f"solo_match_batch1={solo[1]}/{SERVE_NEW_TOKENS}", flush=True)
    if require_solo:
        require(solo[SERVE_SLOTS] == SERVE_NEW_TOKENS,
                f"{path}: the first request differs from the same request served alone")
    return {"requests": SERVE_REQUESTS, "slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
            "ticks": eng.ticks, "generated": generated, "s": serve_s,
            "tokens_per_s": generated / serve_s,
            "solo_match_same_width": solo[SERVE_SLOTS], "solo_match_batch1": solo[1]}


def _timed_step(torch, step_fn, state, batch):
    """(new state, metrics as floats, device ms) of one training step."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, metrics = step_fn(state, batch)
    end.record()
    end.synchronize()
    return state, {k: float(v) for k, v in metrics.items()}, start.elapsed_time(end)


def _check_step_launches(name: str, launches: dict, attn_layers: int, spin: dict) -> None:
    """A training step launches B6 twice an attention layer and microbatch
    (forward and the remat's recompute), B6-bwd once, and of the SPIN
    kernels `spin`."""
    want = {k: 0 for k in launches}
    want.update(flash_attention=2 * attn_layers * TRAIN_MICRO,
                flash_attention_bwd=attn_layers * TRAIN_MICRO, **spin)
    want["gemm_tensor_core"] = spin.get("matmul", 0) + spin.get("schur_update", 0)
    for kern, n in launches.items():
        require(n == want[kern], f"{name}: {kern} launched {n} times, want {want[kern]}")


def refresh_launches(opt) -> dict:
    """B1, B2 and B3 launches of one refresh: each factor layer's SPIN
    inversion on its plan's grid (2(g-1) Schur updates, 4(g-1) products
    and g leaves a grid g), the plan the one `invert_spd` asks for."""
    import torch
    from repro_torch.planner import get_plan

    want = {"schur_update": 0, "matmul": 0, "blocked_gauss_jordan": 0}
    for fac in opt.factors:
        if fac is None:
            continue
        for f in (fac.l, fac.r):
            n, count = f.shape[-1], (f.shape[0] if f.ndim == 3 else 1)
            plan = get_plan("inverse", n, torch.float32, measure=False, backend="cuda")
            require(plan.leaf_solver == "cuda" and plan.multiply_engine == "cuda",
                    f"refresh: the plan for n={n} is {plan.to_dict()}, not cuda/cuda")
            g = n // plan.block_size
            want["schur_update"] += count * 2 * (g - 1)
            want["matmul"] += count * 4 * (g - 1)
            want["blocked_gauss_jordan"] += count * g
    return want


def run_train_adamw(torch, cfg, dev) -> dict:
    """Phase 18, AdamW: one warm-up and TRAIN_TIMED_STEPS timed steps (the
    first counted), TRAIN_FALL_STEPS on one repeated batch, then the state
    saved and restored bit for bit, and one step from each equal."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.runtime.trainer import TrainConfig, init_state, make_train_step
    from repro_torch.tree import leaves

    tokens = TRAIN_BATCH * TRAIN_SEQ
    tcfg = TrainConfig(microbatches=TRAIN_MICRO, optimizer="adamw", warmup=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    n_params = sum(p.numel() for p in leaves(state.params))
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED, device=str(dev))
    step = make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    print(f"train: {cfg.name} {n_params} parameters, AdamW state on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)

    state, _, warm_ms = _timed_step(torch, step, state, stream.next())
    steps = []
    for i in range(TRAIN_TIMED_STEPS):
        if i == 0:
            kernels.reset_launch_counts()
        state, m, ms = _timed_step(torch, step, state, stream.next())
        if i == 0:
            launches = kernels.launch_counts()
        steps.append({"ms": ms, "loss": m["loss"], "grad_norm": m["grad_norm"]})
        require(all(np.isfinite(v) for v in m.values() if isinstance(v, float)),
                f"train_adamw: non-finite metrics {m}")
    _check_step_launches("train_adamw", launches, cfg.n_layers, {})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = [st["ms"] for st in steps]
    print(f"path train_adamw: {cfg.name} B={TRAIN_BATCH} S={TRAIN_SEQ} "
          f"microbatches={TRAIN_MICRO} remat=full warmup_ms={warm_ms!r} ms={ms!r} "
          f"tokens_per_s={tokens / (min(ms) / 1e3)!r} steps={steps} peak_gib={peak!r} "
          f"launches={launches}", flush=True)

    fixed = stream.next()
    losses = []
    for _ in range(TRAIN_FALL_STEPS):
        state, m, _ = _timed_step(torch, step, state, fixed)
        losses.append(m["loss"])
    print(f"path train_adamw: repeated batch losses={losses!r}", flush=True)
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"train_adamw: the loss on a repeated batch did not fall: {losses}")

    # the state to disk and back, and one more step from each
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_ckpt_")
    try:
        free = shutil.disk_usage(ckpt_dir).free
        nbytes = sum(t.numel() * t.element_size() for t in leaves(state))
        print(f"train_ckpt: {nbytes / 2**30:.2f} GiB of state, "
              f"{free / 2**30:.1f} GiB free at {ckpt_dir}", flush=True)
        t0 = time.perf_counter()
        ckpt.save(ckpt_dir, int(state.step), state, extra={"stream": stream.state_dict()})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, extra = ckpt.restore(ckpt_dir, int(state.step), state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    require(extra == {"stream": stream.state_dict()}, f"train_ckpt: extra {extra}")
    for a, b in zip(leaves(restored), leaves(state)):
        require(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b),
                "train_ckpt: a restored leaf differs from the live state")
    nxt = stream.next()
    from_restored, m_r, _ = _timed_step(torch, step, restored, nxt)
    del restored
    from_live, m_l, _ = _timed_step(torch, step, state, nxt)
    del state
    same = all(torch.equal(a, b) for a, b in zip(leaves(from_restored), leaves(from_live)))
    print(f"path train_ckpt: save_s={save_s!r} restore_s={restore_s!r} "
          f"bytes={nbytes} step_from_restored_equal={same} loss={m_r['loss']!r} "
          f"{m_l['loss']!r}", flush=True)
    require(same and m_r == m_l, "train_ckpt: a step from the restored state differs")
    del from_restored, from_live
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "microbatches": TRAIN_MICRO, "remat": "full", "n_params": n_params,
            "warmup_ms": warm_ms, "ms": ms, "tokens_per_s": tokens / (min(ms) / 1e3),
            "steps": steps, "peak_gib": peak, "repeated_batch_losses": losses,
            "launches": launches,
            "checkpoint": {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
                           "bitwise": True, "next_step_equal": same}}


def _family_train_run(torch, cfg, dev, cut_from: int) -> dict:
    """Phase 18b, one family: `cfg` trained with AdamW at the depth it
    gives, cut from `cut_from` layers (the cut printed); out of memory
    fails the phase."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.runtime.trainer import TrainConfig, init_state, make_train_step
    from repro_torch.tree import leaves

    positions = TRAIN_BATCH * TRAIN_SEQ
    tcfg = TrainConfig(microbatches=TRAIN_MICRO, optimizer="adamw", warmup=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    n_params = sum(p.numel() for p in leaves(state.params))
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED, device=str(dev))
    step = make_train_step(cfg, tcfg)
    state, _, warm_ms = _timed_step(torch, step, state, stream.next())
    steps = []
    for i in range(FAMILY_TRAIN_TIMED_STEPS):
        if i == 0:
            kernels.reset_launch_counts()
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        state, m, ms = _timed_step(torch, step, state, stream.next())
        if i == 0:
            launches = kernels.launch_counts()
        # a retry frees the allocator's cached blocks and allocates again:
        # a step near the card's capacity pays for it in time
        steps.append({"ms": ms, "loss": m["loss"], "grad_norm": m["grad_norm"],
                      "aux": m["aux"], "alloc_retries":
                      torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries})
        require(all(np.isfinite(v) for v in m.values()),
                f"train {cfg.name}: non-finite metrics {m}")
    attn_layers = 0 if cfg.attn_free else cfg.n_layers
    _check_step_launches(f"train {cfg.name}", launches, attn_layers, {})
    fixed = stream.next()
    losses = []
    for _ in range(FAMILY_TRAIN_FALL_STEPS):
        state, m, _ = _timed_step(torch, step, state, fixed)
        losses.append(m["loss"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = [st["ms"] for st in steps]
    print(f"path train_family: {cfg.name} layers={cfg.n_layers} params={n_params} "
          f"B={TRAIN_BATCH} S={TRAIN_SEQ} microbatches={TRAIN_MICRO} remat=full "
          f"warmup_ms={warm_ms!r} ms={ms!r} tokens_per_s={positions / (min(ms) / 1e3)!r} "
          f"steps={steps} repeated_batch_losses={losses!r} peak_gib={peak!r} "
          f"launches={launches}", flush=True)
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"train {cfg.name}: the loss on a repeated batch did not fall: {losses}")
    if cfg.n_layers != cut_from:
        print(f"train {cfg.name}: depth cut to {cfg.n_layers} of {cut_from} layers (the "
              "optimizer state of every layer does not fit 80 GB)", flush=True)
    del state
    return {"arch": cfg.name, "layers": cfg.n_layers, "depth_cut": cfg.n_layers != cut_from,
            "n_params": n_params,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatches": TRAIN_MICRO,
            "remat": "full", "warmup_ms": warm_ms, "ms": ms,
            "tokens_per_s": positions / (min(ms) / 1e3), "steps": steps,
            "repeated_batch_losses": losses, "peak_gib": peak, "launches": launches}


def first_depth_that_fits(torch, cfg, depths, run, dev) -> dict:
    """`run(torch, cfg, dev)` at full width and the first of `depths` that
    the card holds; a cut printed, and marked in the result."""
    for depth in depths:
        try:
            out = run(torch, dataclasses.replace(cfg, n_layers=depth), dev)
        except torch.cuda.OutOfMemoryError as err:
            print(f"{cfg.name}: {depth} layers do not fit ({str(err)[:120]}); "
                  "cutting the depth for this run", flush=True)
            out = None
        gc.collect()
        torch.cuda.empty_cache()
        if out is not None:
            out["depth_cut"] = depth != cfg.n_layers
            if out["depth_cut"]:
                print(f"{cfg.name}: depth cut to {depth} of {cfg.n_layers} layers (the "
                      "optimizer state of every layer does not fit 80 GB)", flush=True)
            return out
    raise SmokeFailure(f"{cfg.name}: {depths[-1]} layers do not fit either")


def _shampoo_run(torch, cfg, dev) -> dict:
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core import verify
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.optim import spin_shampoo as shampoo
    from repro_torch.runtime.trainer import TrainConfig, init_state, make_train_step

    tcfg = TrainConfig(microbatches=TRAIN_MICRO, optimizer="spin_shampoo", warmup=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED, device=str(dev))
    step = make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    factors = [f for f in state.opt.factors if f is not None]
    n_inversions = sum(f.shape[0] if f.ndim == 3 else 1
                       for fac in factors for f in (fac.l, fac.r))
    want = refresh_launches(state.opt)
    print(f"train_shampoo: {cfg.n_layers} layers, {len(factors)} factored leaves, "
          f"{n_inversions} inversions a refresh, state on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; refresh launches "
          f"want {want}", flush=True)

    # the refresh timed apart inside step 1, with its own launch counts
    refreshes = []
    original = shampoo.refresh_inverses

    def timed_refresh(opt, opt_cfg):
        before = kernels.launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        original(opt, opt_cfg)
        end.record()
        end.synchronize()
        after = kernels.launch_counts()
        refreshes.append({"ms": start.elapsed_time(end),
                          "launches": {k: after[k] - before[k] for k in want}})

    shampoo.refresh_inverses = timed_refresh
    try:
        kernels.reset_launch_counts()
        state, m1, ms1 = _timed_step(torch, step, state, stream.next())
        launches1 = kernels.launch_counts()
        # layer 0's largest factor, against the damping invert_spd applied
        fac = max((f for f in factors if f.l.ndim == 3),
                  key=lambda f: max(f.l.shape[-1], f.r.shape[-1]))
        f, inv = (fac.r, fac.rinv) if fac.r.shape[-1] >= fac.l.shape[-1] else (fac.l, fac.linv)
        f0, x0 = f[0], inv[0]
        n = f0.shape[-1]
        damped = f0 + tcfg.shampoo.damping * (torch.trace(f0) / n + 1e-12) * torch.eye(
            n, device=dev)
        residual = verify.inverse_residual(damped, x0)
        eig = torch.linalg.eigvalsh(damped)
        kappa = float(eig.max() / eig.min())
        bound = REFRESH_RESIDUAL_C * n * U_F32 * kappa
        # the yardstick: cuSOLVER's pivoted LU inverse of the same matrix in
        # f32, which the port never calls here
        lu_residual = verify.inverse_residual(damped, torch.linalg.inv(damped))
        del damped, eig
        kernels.reset_launch_counts()
        state, m2, ms2 = _timed_step(torch, step, state, stream.next())
        launches2 = kernels.launch_counts()
    finally:
        shampoo.refresh_inverses = original
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(len(refreshes) == 1, f"train_shampoo: {len(refreshes)} refreshes in two steps")
    print(f"path train_shampoo: {cfg.name} layers={cfg.n_layers} step1_ms={ms1!r} "
          f"step2_ms={ms2!r} refresh_ms={refreshes[0]['ms']!r} "
          f"refresh_launches={refreshes[0]['launches']} loss={m1['loss']!r} {m2['loss']!r} "
          f"grad_norm={m1['grad_norm']!r} {m2['grad_norm']!r} peak_gib={peak!r}", flush=True)
    print(f"path train_shampoo: layer 0 factor n={n} residual={residual!r} "
          f"condition={kappa!r} bound={bound!r} (4·n·2^-24·κ) "
          f"pivoted_lu_residual={lu_residual!r}", flush=True)
    require(all(np.isfinite([m1["loss"], m2["loss"], m1["grad_norm"], m2["grad_norm"]])),
            "train_shampoo: non-finite metrics")
    require(refreshes[0]["launches"] == want,
            f"train_shampoo: refresh launched {refreshes[0]['launches']}, want {want}")
    _check_step_launches("train_shampoo step 1", launches1, cfg.n_layers, want)
    _check_step_launches("train_shampoo step 2", launches2, cfg.n_layers, {})
    require(residual <= bound, f"train_shampoo: residual {residual} > {bound}")
    del state, fac, f, inv, f0, x0
    return {"arch": cfg.name, "layers": cfg.n_layers, "step1_ms": ms1, "step2_ms": ms2,
            "refresh_ms": refreshes[0]["ms"], "refresh_launches": refreshes[0]["launches"],
            "inversions": n_inversions, "losses": [m1["loss"], m2["loss"]],
            "grad_norms": [m1["grad_norm"], m2["grad_norm"]], "peak_gib": peak,
            "factor_n": n, "factor_residual": residual, "factor_condition": kappa,
            "factor_bound": bound, "factor_pivoted_lu_residual": lu_residual,
            "launches_step1": launches1, "launches_step2": launches2}


def run_train_shampoo(torch, cfg, dev) -> dict:
    """Phase 18, SPIN-Shampoo at the default config: step 1 refreshes every
    factor's inverse through B1, B2 and B3, step 2 does not; full width,
    and full depth unless the card cannot hold it (then printed)."""
    depths = [cfg.n_layers] + [d for d in TRAIN_DEPTH_CUTS if d < cfg.n_layers]
    return first_depth_that_fits(torch, cfg, depths, _shampoo_run, dev)


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
    from repro_torch.kernels.flash_attention import kernel as fa

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
    report["flash_attention"].update(check_flash_families(
        torch, get_arch("hymba-1.5b"), get_arch("hubert-xlarge"),
        get_arch("phi-3-vision-4.2b")))
    print(f"time flash_attention granite-8b layer bf16: ms={report['flash_attention']['ms']!r} "
          f"before_window_ms={GRANITE_B6_BEFORE_MS!r}", flush=True)
    train_cfg = get_arch(TRAIN_ARCH)
    report["flash_attention_bwd"] = check_flash_bwd(torch, {
        name: (TRAIN_BATCH // TRAIN_MICRO, c.n_heads, c.n_kv_heads, TRAIN_SEQ, c.head_dim,
               c.causal, c.sliding_window)
        for name, c in ((TRAIN_ARCH, train_cfg), (LM_ARCH, lm_cfg),
                        ("hymba-1.5b", get_arch("hymba-1.5b")),
                        ("hubert-xlarge", get_arch("hubert-xlarge")),
                        ("phi-3-vision-4.2b", get_arch("phi-3-vision-4.2b")))})

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
    gc.collect()
    torch.cuda.empty_cache()
    # 14. the sharded placement on the same matrix: 1×1 and 2×2 meshes of
    # the card, the sharded solve, the planned sharded inversion, the
    # sharded service and the coded inversion
    sharded = run_sharded(torch, a)
    del a
    gc.collect()
    torch.cuda.empty_cache()

    # 15. where one Strassen split pays on the card: the dense recursion cut
    # at n/2 (7 GEMM launches and 18 add passes) against one GEMM launch
    crossover = run_crossover(torch)

    # 16. the scalar Gauss-Jordan leaf's path
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

    # 17. the dense LM serving path
    lm = run_lm(torch, rng, lm_cfg, torch.device("cuda"))
    gc.collect()
    torch.cuda.empty_cache()

    # 17b. the other five families at full width and depth, one at a time,
    # each freed before the next and before phase 18 (SPIN-Shampoo: 56 GiB)
    families = {}
    for index, (arch, path) in enumerate(FAMILY_RUNS):
        families[path] = run_lm_family(torch, get_arch(arch), path, torch.device("cuda"),
                                       index)
        gc.collect()
        torch.cuda.empty_cache()

    # 18b. training the five families with AdamW, one at a time, each freed
    # before the next and before phase 18
    train_families = {}
    for arch, depth in FAMILY_TRAIN_RUNS:
        cfg = get_arch(arch)
        train_families[arch] = _family_train_run(
            torch, dataclasses.replace(cfg, n_layers=depth or cfg.n_layers),
            torch.device("cuda"), cut_from=cfg.n_layers)
        gc.collect()
        torch.cuda.empty_cache()

    # 18. training the dense LM: AdamW, the checkpoint, SPIN-Shampoo
    train_adamw = run_train_adamw(torch, train_cfg, torch.device("cuda"))
    train_shampoo = run_train_shampoo(torch, train_cfg, torch.device("cuda"))

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
        "lm_serve": lm["lm_serve"], "lm_families": families, "sharded": sharded,
        "train_adamw": train_adamw, "train_shampoo": train_shampoo,
        "train_families": train_families},
        "card": card}), flush=True)

    # 19. the kernels line
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
             "src/repro/kernels/flash_attention/kernel.py:74", lm),
            # no Pallas backward: the reference differentiates its chunked scan
            ("flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/models/attention.py:77", train_adamw)):
        r = report[name]
        require(path["launches"][name] > 0, f"{name}: no launch on its path")
        if name in ("matmul", "schur_update", "blocked_gauss_jordan", "triangular_solve"):
            r["launches_by_path"] = {p: run["launches"][name] for p, run in (
                ("spin", spin), ("lu", lu), ("spin_solve", solve), ("spin_bf16_raw", raw),
                ("spin_bf16", polished), ("spin_solve_bf16", solve_bf16),
                ("spin_strassen", strassen), ("spin_planned", plan_run["planned"]),
                ("spin_solve_planned", plan_run["solve"]), ("sketched", sketched),
                ("checkpoint", ckpt), ("spin_service", service),
                ("sharded_1x1", sharded["mesh"]["1x1"]),
                ("sharded_2x2_cuda", sharded["mesh"]["2x2_cuda"]),
                ("sharded_2x2_allgather", sharded["mesh"]["2x2_allgather"]),
                ("sharded_2x2_ring", sharded["mesh"]["2x2_ring"]),
                ("sharded_solve_2x2", sharded["solve_2x2"]),
                ("sharded_planned_2x2", sharded["planned_2x2"]))}
        if name == "flash_attention":
            r["launches_by_path"] = {
                "lm_prefill": lm["launches"][name],
                **{p: fam["launches"][name] for p, fam in families.items()},
                "train_adamw_step": train_adamw["launches"][name],
                "train_shampoo_step1": train_shampoo["launches_step1"][name],
                **{f"train_{arch}_step": run["launches"][name]
                   for arch, run in train_families.items()}}
        if name in ("matmul", "schur_update", "blocked_gauss_jordan"):
            r["launches_by_path"]["train_shampoo_refresh"] = \
                train_shampoo["refresh_launches"][name]
        if name == "flash_attention_bwd":
            r["launches_by_path"] = {
                "train_adamw_step": train_adamw["launches"][name],
                **{f"train_{arch}_step": run["launches"][name]
                   for arch, run in train_families.items()}}
            r["kernels_by_dtype"] = {
                "bf16, f16": ["flash_bwd_delta",
                              *fa.flash_attention_bwd_kernels(torch.bfloat16).values()],
                "f32": ["flash_bwd_delta",
                        *fa.flash_attention_bwd_kernels(torch.float32).values()]}
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
