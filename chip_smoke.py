#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build, check and time it.

    python3 chip_smoke.py            # full width: n = 16384, bs = 1024, f32;
                                     # granite-8b at B = 4, S = 2048;
                                     # qwen2-moe, hymba, mamba2, phi-3-vision,
                                     # hubert at B = 4, S = 2048;
                                     # olmo-1b and the five families trained
                                     # at 8 x 2048 tokens a step

Phases, each of which fails the run (non-zero exit) on any fault:

  1. the card's name and power limit, from nvidia-smi, and each size cut
     to free the script's time (`TIME_CUTS`) with its reason;
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
     a step and no other kernel of the port), one step under
     `FlopCounterMode` (its aten FLOPs, for phase 20), 5 steps on one repeated
     batch whose loss must fall, the state saved and restored bit for bit
     through `checkpoint.ckpt` in a temporary directory that the phase
     removes, and one more step from the restored state equal to the same
     step from the live one. SPIN-Shampoo at its default config: step 1
     refreshes (the refresh timed apart; its B1, B2 and B3 launches equal
     to the plans' counts times the factors' layers), step 2 does not
     (none of them); the residual of layer 0's largest factor's inverse
     (8192²) against 4·n·2^-24·κ with κ its condition; peak memory; the
     depth cut only if 80 GB cannot hold it, and then printed;
 19. a mesh of the one card, (data 2, model 4) with every coordinate on
     cuda:0 (`make_worker_mesh((2, 4), devices=["cuda:0"] * 8)`), so the
     copies the layout implies are paid and counted: qwen2-moe's MoE block
     at full width (64 padded experts, 16 a model shard, B 4 x S 2048)
     expert-parallel against the mesh-free block at capacity factor 8
     (no drop at either level: bf16 output within 2e-2 of its largest
     entry on the tokens whose top-k set is the same both ways, at most 1 %
     routed apart, z within 1e-3, aux printed beside), then at 1.25 both
     levels' drops, the bytes of each collective kind and the EP call's ms
     beside the mesh-free call's, and peak memory; the sharded embedding of
     qwen2-moe's 151936 x 2048 table, bit for bit `F.embedding`;
     `compressed_psum` over a 4-coordinate `pod` mesh at one expert's
     gradient (2048 x 1408 f32), within 5 % of the exact sum, its bytes
     beside an f32 psum's; AdamW on qwen2-moe cut to 4 layers, a warm-up
     and 3 steps without the mesh (the allocator's retries a step), then a
     warm-up and 3 steps under it through
     `Trainer(rules=DEFAULT_RULES)` (finite losses, B6 and B6-bwd launches
     equal to the mesh-free step's, a `shard` record at every site equal
     to `logical_spec`, ms, bytes by kind, peak GiB), every expert leaf's
     gradient non-zero and finite, and the parameters saved and restored
     by `param_specs` onto the (2, 4) mesh and an 8-way `data` mesh, bit
     for bit; `phase_s["19"]` printed;
 20. the dry run against the card (`repro_torch.launch.dryrun`): the same
     programs run once more on meta tensors under meshes of meta devices,
     through the functions `run_solver_cell` and `run_cell` use, and their
     predictions held against what phases 14, 18 and 19 counted on the
     card in this process: (a) the 2×2 sharded inversion at n = 16384,
     bs 1024 under allgather and ring, bytes by collective kind equal to
     phase 14's (whose dense result adds its densify, "to_dense", which
     the program keeps laid out); (b) qwen2-moe cut to 4 layers, one
     AdamW step of 8 x 2048 under (data 2, model 4), bytes by kind equal
     to phase 19's counted step; (c) olmo-1b whole, mesh-free, phase 18's
     step: the aten FLOPs equal to `FlopCounterMode` over a step on the
     card, the booked B6 and B6-bwd calls and work equal to the step's
     launches times one launch's work, and the meta run's peak live bytes
     plus its arguments printed beside `max_memory_allocated`; (d) one
     production cell, `run_cell("olmo-1b", "train_4k")` on the 16 x 16
     mesh (the global view's full run, and the partitioned program's
     probes at 1 and 2 layers), its record and trace seconds; no kernel
     launches in the phase; `phase_s["20"]` printed;
 21. the examples' twins (examples_torch/), each `main(argv)` called in
     this process on the card at the main path's sizes, with a plan file
     of the phase's own and the cache freed between runs: quickstart at
     n = 16384 planned and at bs 1024, both under `multiply_engine("cuda")`;
     ridge_regression of 65536 samples x 16384 features against 256
     targets and by `--inverse`, under "cuda"; invert_at_scale at n =
     16384, bs 1024 on its 4 x 4 mesh of the card under cuda, ring and
     allgather, and `--sharded` under cuda; serve_inverse of 32768 x 8192,
     32 requests, dense and `--sharded` (its 4 x 2 mesh); serve on reduced
     olmo-1b and hymba-1.5b; train_lm on olmo-1b at full width and depth
     (3 steps of 8 x 256), on the 100m scale (20 steps; the final loss
     below the first) and on the 10m scale with SPIN-Shampoo (20 steps).
     Each run's own lines, its wall time, kernel launches and peak memory
     are printed; the twins' asserts hold, B1 and B2 launch in the SPIN
     runs under the kernel engine, B3 where a plan's leaf is `cuda`, and
     B6 and B6-bwd in olmo-1b's training; `phase_s["21"]` printed;
 22. a mesh that spans processes (`launch.procs.run_ranks`): ranks of
     their own, each `python3 chip_smoke.py --rank-case <case> <dir>` on
     cuda:0 under gloo (SPIN_COORDINATOR=127.0.0.1:<free port>,
     SPIN_NUM_PROCS, SPIN_PROC_ID; NCCL refuses two ranks on one card),
     every wait of a group bounded and every spawn killed at its deadline.
     Four ranks: (a) the 2×2 inversion of phase 4's matrix
     (`spin_inverse_sharded(engine="cuda", leaf_solver="cuda")`, a
     coordinate a rank; a warm-up, 1 timed call and one traced) bitwise
     phase 14's result on every rank, the residual ≤ 1e-3, B2 / B1 / B3
     launched on every rank and summed to phase 14's 144 / 72 / 16, the
     bytes by kind summed to phase 14's ("to_dense" once a rank,
     "replicate" apart), wall and exchange ms, the traced idle share and
     peak GiB of each rank; (b) the 2×2 solve of the 256 right-hand sides
     bitwise phase 14's (44 B2, 32 B5 in sum, B5 on every rank); (c)
     qwen2-moe's EP MoE block at full width on (data 2, model 4), two
     coordinates a rank, forward and backward bitwise the single process's
     mesh of phase 19 (computed in this phase), the bytes of each pass
     summed to its and the forward's to phase 19's; (d) the sharded lookup
     bitwise `F.embedding` and `compressed_psum` over a `pod` mesh of a
     coordinate a rank bitwise the single process's, bytes summed to phase
     19's. Two ranks: (a) with two coordinates a rank; (e) two AdamW steps
     of qwen2-moe through `launch.train`'s multi-process entry (`--mesh
     2x4 --backend gloo`, 2 microbatches of 2 x 2048), cut to one layer
     (a rank holds the whole state,
     `abstract_state`'s bytes printed: four ranks fit one card at no
     depth), the same losses and parameter digests on both ranks, B6 and
     B6-bwd launched as phase 18b's step; `phase_s["22"]` printed;
 23. the partitioned dense step: olmo-1b at full width and depth on an
     AdamW state laid out by the reference's specs
     (`runtime.trainer.state_shardings`) over (data 2, model 4) of
     cuda:0, each coordinate holding and computing only its shards
     (FSDP's gathers, attention and the MLP on its heads and ffn columns,
     a vocabulary-parallel loss), 8 x 2048 tokens in 2 microbatches, full
     remat: the first step's loss and grad norm within 2e-3 of a
     mesh-free step on the same weights and batch, B6 launched 512 and
     B6-bwd 256 times a step and no other kernel, the bytes and calls of
     each collective kind equal to the analytic count
     (`launch.dryrun.partitioned_step_collectives`); a warm-up and 3
     timed steps (ms, tokens/s, peak GiB), every state leaf still a
     DistArray of its spec; B6 and B6-bwd against their plain versions at
     a coordinate's shape (2, 4, 2048, 128), bf16, causal, timed beside
     their bounds, plain versions and SDPA. Then two ranks of their own
     (`python3 chip_smoke.py --rank-case partition <dir>`, gloo on
     cuda:0, process p holding data row p) run 2 steps of olmo-1b cut to
     2 layers: both ranks' losses and parameter digests equal the single
     process's run at that depth, each rank's state GiB beside the single
     process's, wall and exchange ms a step, peak GiB a rank;
     `phase_s["23"]` printed;
 24. partitioned prefill and decode: olmo-1b at full width and depth,
     its parameters laid out by `param_specs` over (data 2, model 4) of
     cuda:0: a prefill of 8 x 2048 (its cache laid out by `cache_specs`,
     B6 launched 128 times: a layer and coordinate, at (4, 4, 2048, 128)),
     the cache padded to 4096 (`pad_cache`: a coordinate holds 1024
     positions of 4 rows, 1/8 of it), a warm-up and 8 timed decode
     steps, each fed the mesh-free run's token; the prefill's and every
     step's logits within phase 17's bound (0.5) of a mesh-free prefill
     and decode on the same weights, the argmax equal where the mesh-free
     top-2 margin exceeds it, printed beside the error of the mesh-free
     path on weights moved by about one bf16 ulp and of a `dp_only`
     prefill (no partial sums), and the prompt cache's error layer by
     layer; one layer's decode attention at full width (one slice wholly
     masked) within 2^-5 of `attn_decode`'s; the bytes and calls by
     collective kind equal to `launch.dryrun.partitioned_serve_collectives`,
     no kernel in decode; prefill ms, decode ms a step, tokens/s and peak
     GiB beside the mesh-free run's; B6 against its plain version at the
     coordinate's shape. Then two ranks of their own (`python3 chip_smoke.py
     --rank-case serve <dir>`, process p holding data row p) run a
     prefill and 4 decode steps of olmo cut to 2 layers: their logits and
     cache digests equal the single process's, each rank holding half its
     cache bytes; `phase_s["24"]` printed;
 25. the partitioned MoE: qwen2-moe-a2.7b at full width on phase 19's
     mesh (data 2, model 4) of cuda:0, 16 experts a model shard, the
     experts laid out by `param_specs` and dispatched expert-parallel by
     `models.moe.moe_apply_laid_out`: (a) the block alone (B 4 x S 2048)
     against the region path `moe_apply` under the same mesh on the same
     bits: out, aux and z bitwise, every gradient within 2^-5 of its
     largest entry, the forward's and backward's bytes and calls equal to
     `launch.dryrun.moe_block_collectives`; (b) the AdamW step cut to 4
     layers, 8 x 2048 tokens in 2 microbatches, full remat, against phase
     19's global-view mesh step on the same weights and first batch (run
     first on the whole state and freed): the loss within 2e-3, the grad
     norm's gap and each layer's share of routes alike printed, B6 32 x L
     and B6-bwd 16 x L launches a step and no other kernel, bytes and calls
     equal to `partitioned_step_collectives`, a warm-up and 2 timed steps
     (ms, tokens/s, peak GiB) beside the mesh step's, every state leaf
     still a DistArray of its spec; (c) prefill and decode cut to 8 of
     24 layers (the script's time), its parameters laid out by
     `param_specs`, against the
     global view under the same mesh (run first, its logits and routes kept
     on the host, then freed): a prefill of 4 x 2048, `pad_cache` to 4096,
     a warm-up and 8 decode steps fed the reference run's tokens, the
     logits within phase 17's bound (0.5) on the tokens routed alike at
     every layer (the first layer's share at least 0.9, decode's pooled
     over its steps), the argmax equal there where the top-2 margin exceeds
     it, B6 8 x L launches a prefill and none in decode, bytes and calls
     equal to `partitioned_serve_collectives`, prefill ms, decode ms a step
     and peak GiB beside the reference's; (d) two ranks of their own
     (`python3 chip_smoke.py --rank-case moe <dir>`, process p holding data
     row p) run 2 steps of 4 x 2048 tokens of qwen2-moe cut to 1 layer,
     then a prefill of
     4 x 512 and 4 decode steps over a 1024-slot cache: losses, parameter,
     logit and cache digests equal the single process's, each rank holding
     its own regions of the state and half the cache; B6 and B6-bwd against
     their plain versions at a coordinate's shape (2, 4, 2048, 128);
     `phase_s["25"]` printed;
 26. the partitioned SSM and hybrid bodies on phase 19's mesh (data 2,
     model 4) of cuda:0: hymba-1.5b (its 50 SSD heads and 25 query heads
     whole at every coordinate, wq, wz and wo gathered whole from their
     mid-head split) and mamba2-130m (6 SSD heads a coordinate, the gated
     norm's squares and the output psum'd over `model`): (a) the SSM block
     alone (B 4 x S 2048) against `ssm_apply` on the same bits: out, state
     and every gradient within 2^-5 of their largest entry, the forward's
     and backward's bytes and calls equal to
     `launch.dryrun.ssm_block_collectives`; (b) AdamW steps of 8 x 2048
     tokens in 2 microbatches, full remat, mamba2 cut to 8 of 24 layers
     (no kernel launched) and hymba to 4 of 32 (B6 32 x L and B6-bwd 16 x
     L a step, window 1024), each cut printed, against a mesh-free step on
     the same
     weights and first batch: the loss within 2e-3, the grad norm's gap
     printed, bytes and calls equal to `partitioned_step_collectives`, 3
     timed steps after that first one, the warm-up (ms, tokens/s, peak
     GiB, beside the mesh-free step's second, warm), every state leaf
     still a DistArray of its spec; (c) prefill and decode against the
     mesh-free path on the same weights, mamba2 at full depth and hymba
     cut to 8 of 32 layers (printed): hymba a prefill of
     4 x 1024 filling its rolling cache of 1024 slots (256 a coordinate),
     mamba2 one of 8 x 2048, then a warm-up and 8 decode steps fed the
     mesh-free run's tokens; the logits within phase 17's 0.5 and the
     argmax equal where the mesh-free top-2 margin exceeds it, the
     prefill's dp_only logits error beside, the prompt's state error layer
     by layer under both rules; every hymba step writes slot pos % 1024 in
     the first `model` coordinate's slice and no other slot moves; B6
     8 x L launches a prefill and none in decode; bytes and calls equal to
     `partitioned_serve_collectives`; prefill ms, decode ms a step and
     peak GiB beside mesh-free; B6 and B6-bwd against their plain versions
     at hymba's coordinate shape (2, 25, 2048, 64, KV 5, window 1024)
     beside SDPA given the window's mask; `phase_s["26"]` printed;
 27. the partitioned audio and VLM bodies on phase 19's mesh (data 2,
     model 4) of cuda:0: hubert-xlarge (4 of its 16 heads of 80 a
     coordinate, bidirectional; frames with `mask_embed` where masked,
     the loss on the masked frames alone, its token table read by
     nothing) and phi-3-vision-4.2b (8 of its 32 heads of 96 a coordinate;
     576 patch stubs before the text, the vocabulary-parallel lookup on
     the text alone): (a) AdamW steps of 8 x 2048 positions in 2
     microbatches, full remat, hubert cut to 8 of 48 layers and
     phi-3-vision to 4 of 32 (printed), each against a mesh-free step on
     the same weights and first batch: the loss within 2e-3, the grad
     norm's gap printed, hubert's token table's gradient zero at every
     coordinate and its masters after the second step the mesh-free
     step's bits (the weight decay alone), B6 32 x L and B6-bwd 16 x L
     launches a step (hubert's unmasked), bytes and calls equal to
     `partitioned_step_collectives`, a warm-up and 3 timed steps (ms,
     tokens/s, peak GiB), every state leaf still a DistArray of its spec;
     (b) at full depth a prefill of 4 x 2048 positions (phi-3-vision: 576
     patches and 1472 tokens) against the mesh-free path (hubert's
     `forward`), its cache laid out by `cache_specs` (GiB a coordinate
     printed); phi-3-vision's cache then padded to 4096, a warm-up and 8
     decode steps fed the mesh-free run's tokens; the logits within phase
     17's 0.5 and the argmax equal where the mesh-free top-2 margin
     exceeds it, phi-3-vision's dp_only prefill error beside; B6 8 x L
     launches a prefill and none in decode; bytes and calls equal to
     `partitioned_serve_collectives`; prefill ms, decode ms a step and
     peak GiB beside mesh-free; (c) B6 and B6-bwd against their plain
     versions at hubert's coordinate (2, 4, 2048, 80, bidirectional) and
     phi-3-vision's (2, 8, 2048, 96, causal), beside their bounds and
     SDPA; `phase_s["27"]` printed;
 28. SPIN-Shampoo on a laid-out state: olmo-1b at full width cut to 4 of
     16 layers (printed; phase 18 runs it mesh-free at full depth) on phase
     19's mesh (data 2, model 4) of cuda:0, `TokenStream` batches of 8 x
     2048 in 2 microbatches, full remat, warmup 1, damping 0.1, the state
     laid out by `state_shardings` (each Gram factor and its inverse by
     `factor_spec`: rows over `data`, columns over `model`), beside the
     same initial state mesh-free, two steps each: step 1 refreshes (the
     refresh timed apart, its B1, B2 and B3 launches the sum over the
     factors' layers of `sharded_spin_launches` at each factor's planned
     grid; the mesh-free refresh's `refresh_launches`), step 2 launches
     none of them; B6 and B6-bwd a layer, coordinate and microbatch as in
     phase 23; step 1's loss within 2e-3 of mesh-free; the second step's
     update of every master leaf within 3 % in norm and at a cosine
     ≥ 0.9 of mesh-free's; layer 0's largest inverse (8192²) after the
     refresh against 4·n·2^-24·κ, beside the mesh-free inverse's
     residual, and that leaf's L⁻¹ and R⁻¹ entry by entry within 1e-2
     of the largest entry of mesh-free's (the factors' gaps beside);
     step 2's bytes and calls by kind equal to
     `partitioned_step_collectives(..., optimizer="spin_shampoo")`,
     nothing made whole ("to_dense" 0), every leaf still laid out by its
     spec and a coordinate holding 1/8 of each factor that both axes
     divide; step and refresh ms beside mesh-free's and peak GiB, with
     the card's name and power limit; `phase_s["28"]` printed;
 29. the partitioned dry run against the card
     (`launch.dryrun.trace_partitioned`): the programs of phases 23 and
     24 run once more on meta tensors, their arguments laid out by their
     specs on a (data 2, model 4) mesh of meta devices, the model inputs
     whole as the card's runs take them: (a) phase 23's olmo-1b step (full
     width and depth, 8 x 2048 in 2 microbatches), (b) phase 24's prefill
     of 8 x 2048 and one decode step at 4096; the bytes and calls of
     each collective kind equal to those the card counted and to
     `partitioned_step_collectives` / `partitioned_serve_collectives`,
     B6's and B6-bwd's booked calls equal to the card's launches; (c)
     phase 20 (d)'s record with its partitioned keys (`coll_scope`,
     `analytic`, `cost_partitioned`), its partitioned counts equal to the
     analytic ones; no kernel built or launched in the phase;
     `phase_s["29"]` and the script's total seconds printed;
 30. one JSON line with every path's times and residual (the examples'
     wall, launches and peak memory under "examples", phase 22's ranks
     under "processes", phase 23's under "partition", phase 24's under
     "serve_partition", phase 25's under "partition_moe", phase 26's under
     "partition_ssm", phase 27's under "partition_frontend", phase 28's
     under "partition_shampoo", phase 29's under "dry_run_partitioned"),
     and one with every kernel's launches,
     error and times (the GEMM's, blocked Gauss-Jordan's and triangular
     solve's launches on every path beside them, the examples' runs and
     phase 22's ranks, each rank's and their sum, included, and B6's and
     B6-bwd's at a coordinate of phases 23 to 27).

The last line is {"ok": true, "device": {...}}. The script imports only
the PyTorch port; it exits non-zero without a result when CUDA is missing
or when it is not run from a checkout of the repository. The planner's
plan file lies in a temporary directory of the run's own
(SPIN_PLAN_CACHE), removed at the end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import math
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
# Phase 19: a mesh of the one card. qwen2-moe-a2.7b under (data 2, model
# 4), every coordinate on cuda:0, so the copies its layout implies are paid
# and counted on one card.
MESH_SHAPE = (2, 4)
MESH_ARCH = "qwen2-moe-a2.7b"
MESH_HINT = 16                    # 60 experts padded to 64: 16 a model shard
MESH_LAYERS = 4                   # phase 18b's depth cut
MESH_STEPS = 3                    # steps under the mesh after one warm-up
MESH_X_SPEC = (("data",), "model", None)   # the EP region's token layout (B 4, S 2048)
# At capacity factor 8 neither level drops: a shard's 1024 tokens make
# 4096 choices against cap = 8·1024·4/4 = 8192 slots a destination, and
# cap2 = 2·4·8192/16 = 4096 rows an expert against a shard's 4096 rows.
MESH_NO_DROP_CF = 8.0
# The EP output against the mesh-free one, bf16, relative to its largest
# entry (tests/test_torch_moe.py's bound); over the tokens whose top-k set
# is the same both ways: a coordinate's f32 router product runs at M =
# 1024 rows where the mesh-free one runs at 8192, and cuBLAS may sum them
# in another order, which can flip a near-tie. At most this share may flip.
MESH_MOE_RTOL = 2e-2
MESH_ROUTE_FLIP_MAX = 0.01
MESH_Z_RTOL = 1e-3
MESH_PSUM_RTOL = 0.05             # compressed_psum (tests/test_distributed.py:154)
# Phase 22: a mesh that spans processes, every rank on cuda:0 under gloo.
PROC_GROUP_TIMEOUT_S = 300.0      # every wait of a rank's process group
PROC_SPAWN_S = 600.0              # a spawn's ranks, start to finish (then all killed)
PROC_TIMED_CALLS = 1              # timed 2x2 inversions a rank, after one warm-up (TIME_CUTS)
# (e): a rank holds qwen2-moe's whole AdamW state (16.0 GiB at one layer
# before gradients and activations, 23.9 at two: `abstract_state`), so
# four ranks fit one 80 GB card at no depth; two ranks at one layer do.
PROC_TRAIN_PROCS, PROC_TRAIN_LAYERS, PROC_TRAIN_STEPS = 2, 1, 2
# and microbatches of 2 x 2048 (the f32 logits of 4 x 2048, 4.6 GiB,
# did not fit beside two ranks' state)
PROC_TRAIN_BATCH, PROC_TRAIN_MICRO = 4, 2        # TIME_CUTS
# Phase 23: the partitioned dense step. olmo-1b at full width and depth on
# a laid-out AdamW state under (data 2, model 4) of cuda:0, each coordinate
# holding and computing its own shards; then two ranks of their own on the
# card, process p holding data row p, olmo cut to 2 layers.
PART_SHAPE = (2, 4)
PART_ARCH = "olmo-1b"
PART_STEPS = 3                    # timed steps after one warm-up
PART_RTOL = 2e-3                  # the first step's loss and grad norm against mesh-free
PART_PROCS, PART_PROC_LAYERS, PART_PROC_STEPS = 2, 2, 2
# Phase 24: partitioned prefill and decode. olmo-1b at full width and depth,
# its parameters laid out by `param_specs` over (data 2, model 4) of cuda:0:
# a prefill of 8 x 2048 (B6 at a coordinate's (4, 4, 2048, 128)), the cache
# padded to 4096 (a coordinate holds 1024 positions of 4 rows), a warm-up
# step and 16 timed decode steps, each fed the mesh-free run's token
# (teacher forcing: a near-tie cannot make the two runs part). Then two
# ranks of their own, process p holding data row p, olmo cut to 2 layers.
SERVE_SHAPE = (2, 4)                 # the model is phase 23's (`_partition_cfg`)
SERVE_BATCH, SERVE_PROMPT, SERVE_CACHE = 8, 2048, 4096
SERVE_STEPS = 8                   # timed decode steps after one warm-up (TIME_CUTS)
# The logits against mesh-free: the bound of two orders of the same
# full-width bf16 logits (phase 17's LM_CONSISTENCY_BOUND): the default
# layout sums the output projections' bf16 partial products over `model`,
# which the mesh-free product rounds once (PERF.md, PR 30). A token must
# agree where the mesh-free top-2 margin exceeds it.
SERVE_BOUND = LM_CONSISTENCY_BOUND
# one layer's decode attention: the laid-out forward's bound in
# tests/test_torch_partition.py (2^-5 of the largest entry)
SERVE_LAYER_RTOL = 2.0 ** -5
SERVE_PROCS, SERVE_PROC_LAYERS, SERVE_PROC_STEPS = 2, 2, 4
# Phase 25: the partitioned MoE. qwen2-moe-a2.7b at full width on phase
# 19's mesh (data 2, model 4) of cuda:0, 16 experts a model shard
# (MESH_HINT): (a) the block alone against the region path `moe_apply` (out,
# aux and z bitwise, gradients within 2^-5 of their largest entry); (b) the
# AdamW step cut to phase 19's depth against the global-view mesh step; (c)
# prefill and decode at full depth against the global view (phase 17's
# rule: SERVE_BOUND on the tokens routed alike at every layer); (d) two
# ranks of their own, qwen2-moe cut to 1 layer.
PMOE_BLOCK_RTOL = 2.0 ** -5
PMOE_LAYERS = MESH_LAYERS         # (b)'s depth: the whole state of 4 layers fits 80 GB
PMOE_STEPS = 2                    # (b)'s timed steps after one warm-up (TIME_CUTS)
PMOE_RTOL = 2e-3                  # (b)'s first loss against the mesh step's
PMOE_SERVE_BATCH = 4              # (c): 4 x 2048, the cache padded to 4096
PMOE_SERVE_PROMPT, PMOE_SERVE_CACHE = 2048, 4096
PMOE_SERVE_STEPS = 8              # (c)'s timed decode steps after one warm-up (TIME_CUTS)
# (c)'s depth, cut from 24 to make room for phase 27 in the script's time
PMOE_SERVE_LAYERS = 8
PMOE_PROCS, PMOE_PROC_LAYERS, PMOE_PROC_STEPS = 2, 1, 2
PMOE_PROC_BATCH = 4               # (d)'s steps: one microbatch of 4 x 2048 (TIME_CUTS)
PMOE_PROC_PROMPT, PMOE_PROC_CACHE, PMOE_PROC_DECODE = 512, 1024, 4
# Phase 26: the partitioned SSM and hybrid bodies on phase 19's mesh (data
# 2, model 4) of cuda:0: hymba-1.5b (50 SSD heads and 25 query heads, whole
# at every coordinate: `model` 4 divides neither, while wq, wz and wo split
# their columns mid-head and are gathered whole) and mamba2-130m (24 SSD
# heads: 6 a coordinate). (a) The SSM block alone at full width against
# `ssm_apply`; (b) AdamW steps against a mesh-free step (cut to
# PSSM_LAYERS); (c) prefill and decode against the mesh-free path (hymba
# cut to PSSM_SERVE_LAYERS), hymba's prompt filling its rolling cache of the
# window's 1024 slots. The gloo ranks of this slice run on the CPU only
# (tests/test_torch_multiprocess_lm.py).
PSSM_ARCHS = ("hymba-1.5b", "mamba2-130m")
PSSM_BLOCK_BATCH, PSSM_BLOCK_SEQ = 4, 2048
PSSM_BLOCK_RTOL = 2.0 ** -5
# (b)'s depths (whole: 32 and 24; phase 18b trains both whole), and why
PSSM_LAYERS = {"hymba-1.5b": 4, "mamba2-130m": 8}
PSSM_CUT_WHY = {
    "hymba-1.5b": "the phase's time: its 8 coordinates each run all 50 SSD heads and 25 "
                  "query heads, which model 4 does not divide",
    "mamba2-130m": "the script's time, to make room for phase 27: about 6 s a step at 24"}
PSSM_STEPS = 3                    # (b)'s timed steps after one warm-up
PSSM_RTOL = 2e-3                  # (b)'s first loss against the mesh-free step's
PSSM_SERVE = {"hymba-1.5b": (4, 1024, 1024),     # (c): batch, prompt, decode length
              "mamba2-130m": (8, 2048, 2048)}
# (c)'s depths (None: whole), hymba's cut from 32 to make room for phase 27
PSSM_SERVE_LAYERS = {"hymba-1.5b": 8, "mamba2-130m": None}
PSSM_SERVE_STEPS = 8              # (c)'s timed decode steps after one warm-up (TIME_CUTS)
# Phase 27: the partitioned audio and VLM bodies on phase 19's mesh (data 2,
# model 4) of cuda:0: hubert-xlarge (16 heads of 80, 4 a coordinate,
# bidirectional; the frames and mask of data/synthetic.py, the loss on the
# masked frames) and phi-3-vision-4.2b (32 heads of 96, 8 a coordinate; 576
# patch stubs before 1472 tokens a sequence). (a) AdamW steps of 8 x 2048
# positions against a mesh-free step, cut to PFRONT_LAYERS; (b) a prefill
# of 4 x 2048 at full depth against the mesh-free path, and for
# phi-3-vision the cache padded to 4096, a warm-up and PFRONT_SERVE_STEPS
# decode steps (hubert, an encoder, decodes nothing: the reference builds
# no decode cell for it); (c) B6 and B6-bwd at each one's coordinate shape.
PFRONT_ARCHS = ("hubert-xlarge", "phi-3-vision-4.2b")
PFRONT_LAYERS = {"hubert-xlarge": 8, "phi-3-vision-4.2b": 4}   # (a)'s depths
PFRONT_CUT_WHY = {
    "hubert-xlarge": "the script's time",
    "phi-3-vision-4.2b": "its laid-out AdamW state, about 9.1 GB at 4 layers, and the "
                         "mesh-free yardstick's must fit 80 GB side by side, in the "
                         "script's time"}
PFRONT_SERVE_BATCH, PFRONT_SERVE_SEQ, PFRONT_SERVE_CACHE = 4, 2048, 4096
PFRONT_SERVE_STEPS = 8            # (b)'s timed decode steps after one warm-up
# Phase 28: SPIN-Shampoo on a laid-out state. olmo-1b at full width on
# phase 19's mesh (data 2, model 4) of cuda:0, its Gram factors and their
# inverses laid out by `optim.spin_shampoo.factor_spec`, the refresh the
# mesh-resident SPIN inversion; the same initial state mesh-free beside it.
PSHAMPOO_LAYERS = 4
PSHAMPOO_CUT_WHY = ("the script's time: a laid-out refresh runs 14 sharded inversions a "
                    "layer (11 of 2048², 3 of 8192²) over 8 coordinates of one card, beside "
                    "a mesh-free run of the same state; phase 18 refreshes all 16 layers "
                    "mesh-free")
# At the default 1e-3 the rank-deficient factors reach a condition where two
# f32 inversions differ by up to 9 % (tests/test_torch_optim.py), so the
# comparisons below would measure noise.
PSHAMPOO_DAMPING = 0.1
PSHAMPOO_RTOL = PART_RTOL         # the first step's loss against mesh-free
PSHAMPOO_UPDATE_COS = 0.9         # the second step's update of each master leaf:
PSHAMPOO_UPDATE_RTOL = 0.03       # its cosine and norm against mesh-free's
# Step 1's L⁻¹ and R⁻¹ of layer 0's largest leaf against mesh-free's, entry
# by entry relative to the largest entry: the residual's bound 4·n·2^-24·κ
# exceeds 1 at κ 4112, so it cannot tell a wrong inverse from a right one
# there. Measured 1.38e-3 and 1.11e-3 (the factors themselves 1.1e-3 and
# 1.09e-2 apart: the step's bf16 gradients summed in another order) on an
# H100 80GB HBM3 at 700 W; the bound is about 7 times the larger.
PSHAMPOO_INV_RTOL = 1e-2
# Sizes cut to make room for phase 28 (20.1 s alone, 7-8 s warm in the
# script, on an H100 80GB HBM3 at 700 W) in the phases that took longest
# before it (22: 168.8-174.4 s, 21: 102.1-126.0, 25: 94.1-101.9): the first
# three, about 21 s, left the command at 1195.7 s on a slow host, so the two
# cross-process training runs take half the tokens too; each keeps every
# check, count, bound, step and path. Phase 29 and the partitioned probes of
# phase 20 (d) add about 30 s of host time (7 s and 25 s on a CPU host), so
# the three 16-step decode runs of phases 24-26 take 8 timed steps: (constant,
# before, after, why), printed at the start.
TIME_CUTS = (
    ("PROC_TIMED_CALLS", 2, 1, "phase 22 (a): one timed 2x2 inversion a rank after the "
     "warm-up, then the traced one (the second timed call took 7.6-8.6 s over four ranks "
     "and 4.6 s over two); the timed call's result, launches and bytes are held as the "
     "last one's were"),
    ("train_100m --steps", 50, 20, "phase 21: train_lm on the 100m scale (9.4 s at 50 "
     "steps, 4.2 at 20); its final loss is still held below the first"),
    ("PMOE_STEPS", 3, 2, "phase 25 (b): two timed laid-out qwen2-moe steps after the "
     "warm-up (2.0-2.4 s a step), so a spread is still recorded"),
    ("PROC_TRAIN_BATCH", 8, 4, "phase 22 (e): both AdamW steps on 4 x 2048 tokens in 2 "
     "microbatches of 2 x 2048 (8 x 2048 took 16.6-20.8 s a step over two ranks); the "
     "losses, digests and launches held as before"),
    ("PMOE_PROC_BATCH", 8, 4, "phase 25 (d): both AdamW steps on 4 x 2048 tokens in one "
     "microbatch (8 x 2048 took 10.3-18.3 s a step over two ranks); the losses, "
     "parameter, logit and cache digests held as before"),
    ("SERVE_STEPS", 16, 8, "phase 24 (a): 8 timed laid-out olmo-1b decode steps after the "
     "warm-up (316-409 ms a step on an H100 80GB HBM3 at 700 W), each still held to the "
     "mesh-free step's logits, counts and launches"),
    ("PMOE_SERVE_STEPS", 16, 8, "phase 25 (c): 8 timed qwen2-moe decode steps after the "
     "warm-up, laid out (777-1349 ms a step) and in the global view (629-884), each still "
     "held on the tokens routed alike"),
    ("PSSM_SERVE_STEPS", 16, 8, "phase 26 (c): 8 timed hymba and mamba2 decode steps after "
     "the warm-up (hymba 570-996 ms a step laid out); hymba's rows still write across its "
     "rolling cache's wrap"),
)
U_F32 = 2.0 ** -24                # f32 unit roundoff
# The refresh residual's bound: c·n·u·κ, the first-order bound on an
# inverse's residual by elimination, with c = 4 over the 1.3 measured at
# n = 256, κ = 8e3 for both packages (tests/test_torch_optim.py).
REFRESH_RESIDUAL_C = 4.0
# Phase 21: the examples' twins (examples_torch/), called in-process at the
# main path's sizes: (label, script, arguments, the multiply engine set
# around the call or None, the kernels that must launch). quickstart takes
# the engine ambient as the reference does; invert_at_scale and
# serve_inverse choose their own. The serve runs decode a reduced model
# (the example always reduces it; full width is phase 17's).
_SCALE = ["--n", str(N), "--block", str(BLOCK_SIZE)]
_RIDGE = ["--samples", "65536", "--features", str(N)]
_SERVE_INV = ["--samples", "32768", "--features", "8192", "--requests", "32"]
EXAMPLE_RUNS = (
    ("quickstart_planned", "quickstart", ["--n", str(N)], "cuda",
     ("matmul", "schur_update")),
    ("quickstart_bs1024", "quickstart", _SCALE, "cuda", ("matmul", "schur_update")),
    ("ridge_multi_target", "ridge_regression", _RIDGE + ["--multi-target", "256"], "cuda",
     ("matmul",)),
    ("ridge_inverse", "ridge_regression", _RIDGE + ["--inverse"], "cuda",
     ("matmul", "schur_update")),
    ("invert_at_scale_cuda", "invert_at_scale", _SCALE + ["--engine", "cuda"], None,
     ("matmul", "schur_update")),
    ("invert_at_scale_ring", "invert_at_scale", _SCALE + ["--engine", "ring"], None, ()),
    ("invert_at_scale_allgather", "invert_at_scale", _SCALE + ["--engine", "allgather"],
     None, ()),
    ("invert_at_scale_sharded_cuda", "invert_at_scale",
     _SCALE + ["--sharded", "--engine", "cuda"], None, ("matmul", "schur_update")),
    ("serve_inverse", "serve_inverse", _SERVE_INV, None, ("matmul", "schur_update")),
    ("serve_inverse_sharded", "serve_inverse", _SERVE_INV + ["--sharded"], None, ()),
    ("serve_olmo", "serve", ["--arch", "olmo-1b"], None, ()),
    ("serve_hymba", "serve", ["--arch", "hymba-1.5b"], None, ()),
    ("train_olmo", "train_lm", ["--arch", "olmo-1b", "--steps", "3"], None,
     ("flash_attention", "flash_attention_bwd")),
    ("train_100m", "train_lm", ["--scale", "100m", "--steps", "20"], None, ()),   # TIME_CUTS
    ("train_10m_shampoo", "train_lm",
     ["--scale", "10m", "--optimizer", "spin_shampoo", "--steps", "20"], None, ()),
)


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


def run_sharded(torch, a, keep: str) -> dict:
    """Phase 14: the sharded placement on the phase-4 matrix. The 1×1 mesh
    bitwise the dense inverse with its launches; a 2×2 mesh of the one card
    under the cuda, allgather and ring engines (residual, deviation from the
    dense inverse, CUDA-event ms, launches, bytes copied between mesh
    coordinates, peak memory, the spec ledger); the sharded solve of the 256
    right-hand sides; the planned sharded inversion recalled from the plan
    file; then at n = SERVICE_SIDE_N, `SpinService` with sharded=True
    against a dense tenant, and the coded inversion with a straggler. The
    matrix, the right-hand sides and the cuda engine's 2×2 inverse and
    solve go to files in `keep`, for phase 22."""
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
        if engine == "cuda":
            torch.save(x, os.path.join(keep, "x14.pt"))
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
    for name, t in (("a.pt", a), ("rhs.pt", rhs), ("xs14.pt", x)):
        torch.save(t, os.path.join(keep, name))
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
    # one more step under FlopCounterMode: the aten FLOPs phase 20 predicts
    from torch.utils.flop_counter import FlopCounterMode

    kernels.reset_launch_counts()
    with FlopCounterMode(display=False) as flop_counter:
        state, _, _ = _timed_step(torch, step, state, stream.next())
    aten_flops = flop_counter.get_total_flops()
    flop_step_launches = kernels.launch_counts()
    print(f"path train_adamw: aten_flops={aten_flops} launches={flop_step_launches}",
          flush=True)
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
            "launches": launches, "aten_flops": aten_flops,
            "flop_step_launches": flop_step_launches,
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
    from repro_torch.data.synthetic import TokenStream
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
    with _timing_refreshes(torch, want) as refreshes:
        kernels.reset_launch_counts()
        state, m1, ms1 = _timed_step(torch, step, state, stream.next())
        launches1 = kernels.launch_counts()
        res = _largest_factor_residual(torch, state.opt, tcfg.shampoo.damping)
        kernels.reset_launch_counts()
        state, m2, ms2 = _timed_step(torch, step, state, stream.next())
        launches2 = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(len(refreshes) == 1, f"train_shampoo: {len(refreshes)} refreshes in two steps")
    print(f"path train_shampoo: {cfg.name} layers={cfg.n_layers} step1_ms={ms1!r} "
          f"step2_ms={ms2!r} refresh_ms={refreshes[0]['ms']!r} "
          f"refresh_launches={refreshes[0]['launches']} loss={m1['loss']!r} {m2['loss']!r} "
          f"grad_norm={m1['grad_norm']!r} {m2['grad_norm']!r} peak_gib={peak!r}", flush=True)
    print(f"path train_shampoo: layer 0 factor n={res['n']} residual={res['residual']!r} "
          f"condition={res['condition']!r} bound={res['bound']!r} (4·n·2^-24·κ) "
          f"pivoted_lu_residual={res['pivoted_lu_residual']!r}", flush=True)
    require(all(np.isfinite([m1["loss"], m2["loss"], m1["grad_norm"], m2["grad_norm"]])),
            "train_shampoo: non-finite metrics")
    require(refreshes[0]["launches"] == want,
            f"train_shampoo: refresh launched {refreshes[0]['launches']}, want {want}")
    _check_step_launches("train_shampoo step 1", launches1, cfg.n_layers, want)
    _check_step_launches("train_shampoo step 2", launches2, cfg.n_layers, {})
    require(res["residual"] <= res["bound"],
            f"train_shampoo: residual {res['residual']} > {res['bound']}")
    del state
    return {"arch": cfg.name, "layers": cfg.n_layers, "step1_ms": ms1, "step2_ms": ms2,
            "refresh_ms": refreshes[0]["ms"], "refresh_launches": refreshes[0]["launches"],
            "inversions": n_inversions, "losses": [m1["loss"], m2["loss"]],
            "grad_norms": [m1["grad_norm"], m2["grad_norm"]], "peak_gib": peak,
            **{f"factor_{k}": v for k, v in res.items()},
            "launches_step1": launches1, "launches_step2": launches2}


@contextlib.contextmanager
def _timing_refreshes(torch, kinds):
    """While open, each SPIN-Shampoo refresh is timed by CUDA events and
    appends {"ms", "launches" of `kinds`} to the list it yields."""
    from repro_torch import kernels
    from repro_torch.optim import spin_shampoo as shampoo

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
                          "launches": {k: after[k] - before[k] for k in kinds}})

    shampoo.refresh_inverses = timed_refresh
    try:
        yield refreshes
    finally:
        shampoo.refresh_inverses = original


def _largest_factor(opt):
    """The stacked factored leaf of `opt` with the largest factor."""
    return max((f for f in opt.factors if f is not None and len(f.l.shape) == 3),
               key=lambda f: max(f.l.shape[-1], f.r.shape[-1]))


def _largest_factor_residual(torch, opt, damping: float, whole=lambda t: t) -> dict:
    """Layer 0 of the largest factor of `opt` after a refresh: the residual
    of its inverse against (F + λI), λ as `invert_spd` damps it, its
    condition, the bound 4·n·2^-24·κ, and the yardstick: cuSOLVER's pivoted
    LU inverse of the same matrix in f32, which the port never calls here;
    `whole` reads a leaf whole on the card."""
    from repro_torch.core import verify

    fac = _largest_factor(opt)
    f, inv = (fac.r, fac.rinv) if fac.r.shape[-1] >= fac.l.shape[-1] else (fac.l, fac.linv)
    f0, x0 = whole(f)[0], whole(inv)[0]
    n = f0.shape[-1]
    damped = f0 + damping * (torch.trace(f0) / n + 1e-12) * torch.eye(n, device=f0.device)
    residual = verify.inverse_residual(damped, x0)
    eig = torch.linalg.eigvalsh(damped)
    kappa = float(eig.max() / eig.min())
    lu_residual = verify.inverse_residual(damped, torch.linalg.inv(damped))
    del damped, eig, f0, x0
    return {"n": n, "residual": residual, "condition": kappa,
            "bound": REFRESH_RESIDUAL_C * n * U_F32 * kappa, "pivoted_lu_residual": lu_residual}


def run_train_shampoo(torch, cfg, dev) -> dict:
    """Phase 18, SPIN-Shampoo at the default config: step 1 refreshes every
    factor's inverse through B1, B2 and B3, step 2 does not; full width,
    and full depth unless the card cannot hold it (then printed)."""
    depths = [cfg.n_layers] + [d for d in TRAIN_DEPTH_CUTS if d < cfg.n_layers]
    return first_depth_that_fits(torch, cfg, depths, _shampoo_run, dev)


def _moe_drops(torch, x, router, cfg, mesh=None) -> dict:
    """Both levels' dropped (token, choice) pairs and rows of `moe_apply`
    on x, mesh-free or expert-parallel on `mesh`, counted by running its
    dispatch phases."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel import collectives as col

    with torch.inference_mode():
        if mesh is None:
            e_loc = router.shape[1]
            r = moe_mod._dispatch(x, router, cfg, 1, e_loc)
            first, received = int(r["dropped"].sum()), [r["send_le"]]
        else:
            m = mesh.shape["model"]
            e_loc = router.shape[1] // m
            xs = col.split(x, MESH_X_SPEC, mesh)
            rs = {c: moe_mod._dispatch(xs[c], router, cfg, m, e_loc) for c in mesh.coords()}
            first = sum(int(r["dropped"].sum()) for r in rs.values())
            received = list(col.all_to_all({c: r["send_le"] for c, r in rs.items()},
                                           "model", 0, 0, mesh).values())
        second = sum(int(moe_mod.second_level(le, e_loc)[1].sum()) for le in received)
    return {"first_level": first, "second_level": second,
            "choices": x.shape[0] * x.shape[1] * cfg.moe.top_k}


def run_mesh_moe(torch, dev, mesh) -> dict:
    """Phase 19.1: qwen2-moe's MoE block at full width, expert-parallel on
    the mesh, against the mesh-free block."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import init_tree
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel import collective_bytes, reset_collective_bytes

    cfg = get_arch(MESH_ARCH)

    def with_cf(cf):
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))

    params = init_tree(moe_mod.moe_params(cfg, MESH_HINT),
                       torch.Generator(device=dev).manual_seed(SEED), dev)
    x = torch.randn((LM_BATCH, LM_SEQ, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED + 1)).to(torch.bfloat16)
    router = params["router"]

    def ep(c):
        with set_mesh(mesh):
            return moe_mod.moe_apply(params, x, c)

    with torch.inference_mode():
        cfg8 = with_cf(MESH_NO_DROP_CF)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        free8, got8 = moe_mod.moe_apply(params, x, cfg8), ep(cfg8)
        peak8 = torch.cuda.max_memory_allocated() / 2 ** 30
        # the tokens whose top-k expert set is the same both ways
        want = moe_mod.route(x, router, cfg8)[3].sort(-1).values.reshape(LM_BATCH, LM_SEQ, -1)
        xs = col.split(x, MESH_X_SPEC, mesh)
        same = torch.ones((LM_BATCH, LM_SEQ), dtype=torch.bool, device=dev)
        for c in mesh.coords():
            (b0, b1), (s0, s1), _ = col.region_of(x.shape, MESH_X_SPEC, mesh, c)
            got = moe_mod.route(xs[c], router, cfg8)[3].sort(-1).values
            same[b0:b1, s0:s1] = (got.reshape(b1 - b0, s1 - s0, -1) ==
                                  want[b0:b1, s0:s1]).all(-1)
        flips = int((~same).sum())
        diff = (got8[0].float() - free8[0].float()).abs().amax(-1)
        err = float(diff[same].max()) / float(free8[0].float().abs().max())
        z_rel = abs(float(got8[2]) - float(free8[2])) / abs(float(free8[2]))
        aux8 = (float(got8[1]), float(free8[1]))
        del free8, got8
        drops8 = {"ep": _moe_drops(torch, x, router, cfg8, mesh),
                  "mesh_free": _moe_drops(torch, x, router, cfg8)}
        print(f"path mesh_moe: {MESH_ARCH} B={LM_BATCH} S={LM_SEQ} mesh={mesh.descriptor()} "
              f"cf={MESH_NO_DROP_CF} route_flips={flips} of {same.numel()} "
              f"max_err_rel={err!r} (bound {MESH_MOE_RTOL}) z_rel={z_rel!r} "
              f"aux_ep={aux8[0]!r} aux_mesh_free={aux8[1]!r} drops={drops8} "
              f"peak_gib={peak8!r}", flush=True)
        require(flips <= MESH_ROUTE_FLIP_MAX * same.numel(),
                f"mesh_moe: {flips} tokens routed apart")
        require(err <= MESH_MOE_RTOL, f"mesh_moe: EP output {err} from mesh-free")
        require(z_rel <= MESH_Z_RTOL, f"mesh_moe: z {z_rel} from mesh-free")
        require(all(d["first_level"] == d["second_level"] == 0 for d in drops8.values()),
                f"mesh_moe: drops at the no-drop factor: {drops8}")

        # the default capacity factor: per-shard drops, bytes, time
        drops = {"ep": _moe_drops(torch, x, router, cfg, mesh),
                 "mesh_free": _moe_drops(torch, x, router, cfg)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_collective_bytes()
        out, aux, z = ep(cfg)
        moved = collective_bytes()
        require(bool(torch.isfinite(out.float()).all()), "mesh_moe: non-finite output")
        del out
        ep_ms = time_ms(lambda: ep(cfg), 3)
        free_ms = time_ms(lambda: moe_mod.moe_apply(params, x, cfg), 3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"path mesh_moe: cf={cfg.moe.capacity_factor} drops={drops} "
          f"bytes={ {k: v for k, v in moved.items() if v} } ep_ms={ep_ms!r} "
          f"mesh_free_ms={free_ms!r} peak_gib={peak!r}", flush=True)
    del params, x
    return {"no_drop": {"capacity_factor": MESH_NO_DROP_CF, "route_flips": flips,
                        "tokens": same.numel(), "max_err_rel": err, "bound": MESH_MOE_RTOL,
                        "z_rel": z_rel, "aux_ep": aux8[0], "aux_mesh_free": aux8[1],
                        "peak_gib": peak8},
            "default": {"capacity_factor": cfg.moe.capacity_factor, "drops": drops,
                        "collective_bytes": moved, "ep_ms": ep_ms, "mesh_free_ms": free_ms,
                        "peak_gib": peak}}


def run_mesh_embed(torch, dev, mesh) -> dict:
    """Phase 19.2: the sharded lookup of qwen2-moe's table, bit for bit
    `F.embedding`."""
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models.embedding import embed_lookup
    from repro_torch.parallel import collective_bytes, reset_collective_bytes

    cfg = get_arch(MESH_ARCH)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    table = (0.02 * torch.randn((cfg.vocab, cfg.d_model), generator=g, device=dev)
             ).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ), generator=g,
                         device=dev)

    def sharded():
        with set_mesh(mesh):
            return embed_lookup(table, toks)

    with torch.inference_mode():
        reset_collective_bytes()
        got = sharded()
        moved = collective_bytes()
        same = torch.equal(got, F.embedding(toks, table))
        del got
        ms, plain_ms = time_ms(sharded, 3), time_ms(lambda: F.embedding(toks, table), 3)
    print(f"path mesh_embed: table={tuple(table.shape)} tokens={tuple(toks.shape)} "
          f"bitwise={same} bytes={ {k: v for k, v in moved.items() if v} } ms={ms!r} "
          f"plain_ms={plain_ms!r}", flush=True)
    require(same, "mesh_embed: the sharded lookup differs from F.embedding")
    return {"bitwise": same, "collective_bytes": moved, "ms": ms, "plain_ms": plain_ms}


def run_mesh_psum(torch, dev) -> dict:
    """Phase 19.3: compressed_psum over a 4-coordinate `pod` mesh of the
    card, at one expert's wi gradient (d x d_ff_expert f32) a coordinate."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel import collective_bytes, reset_collective_bytes
    from repro_torch.parallel.compression import compressed_psum

    cfg = get_arch(MESH_ARCH)
    pod = make_worker_mesh((4,), ("pod",), devices=[dev] * 4)
    n = cfg.d_model * cfg.moe.d_ff_expert
    x = 1e-3 * torch.randn((4, n), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(SEED + 3))
    xs = col.split(x, ("pod", None), pod)
    exact = x.double().sum(0)
    reset_collective_bytes()
    got = compressed_psum(xs, "pod", pod)
    int8_bytes = collective_bytes()
    rel = max(float((got[c].double().reshape(-1) - exact).abs().max()) for c in pod.coords()
              ) / float(exact.abs().max())
    reset_collective_bytes()
    col.psum(xs, "pod", pod)
    f32_bytes = collective_bytes()
    ms = time_ms(lambda: compressed_psum(xs, "pod", pod), 3)
    f32_ms = time_ms(lambda: col.psum(xs, "pod", pod), 3)
    wire = {k: v for k, v in int8_bytes.items() if v}
    print(f"path mesh_compressed_psum: 4 x {n} f32 rel_err={rel!r} (bound {MESH_PSUM_RTOL}) "
          f"bytes={wire} f32_psum_bytes={f32_bytes['psum']} ms={ms!r} f32_psum_ms={f32_ms!r}",
          flush=True)
    require(rel <= MESH_PSUM_RTOL, f"mesh_compressed_psum: {rel} from the exact sum")
    return {"elements": n, "rel_err": rel, "bytes": wire, "f32_psum_bytes": f32_bytes["psum"],
            "ms": ms, "f32_psum_ms": f32_ms}


def run_mesh_train(torch, dev, mesh) -> dict:
    """Phase 19.4-5: AdamW on qwen2-moe cut to MESH_LAYERS at full width,
    one mesh-free step and MESH_STEPS under the mesh through
    `Trainer(rules=DEFAULT_RULES)`, every expert leaf's gradient, the
    layout ledger; then the parameters saved and restored onto the mesh
    and onto an 8-way `data` mesh by `param_specs`."""
    import contextlib

    import numpy as np
    from repro_torch import kernels
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.mesh import make_worker_mesh, set_mesh
    from repro_torch.models import transformer as T
    from repro_torch.parallel import (DEFAULT_RULES, collective_bytes, logical_spec,
                                      record_specs, reset_collective_bytes)
    from repro_torch.parallel.collectives import DistArray, gather
    from repro_torch.runtime.trainer import TrainConfig, Trainer, init_state, make_train_step
    from repro_torch.tree import leaves, leaves_with_path, unflatten

    cfg = dataclasses.replace(get_arch(MESH_ARCH), n_layers=MESH_LAYERS)
    tcfg = TrainConfig(microbatches=TRAIN_MICRO, optimizer="adamw", warmup=1)
    gc.collect()
    torch.cuda.empty_cache()
    state = init_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                       MESH_HINT)
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED, device=str(dev))

    # the same step without a mesh: a warm-up and MESH_STEPS timed steps,
    # the first counted (a step that follows an allocator retry pays for it)
    free_step = make_train_step(cfg, tcfg)
    state, _, _ = _timed_step(torch, free_step, state, stream.next())
    free_ms, free_retries = [], []
    for i in range(MESH_STEPS):
        kernels.reset_launch_counts()
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        state, m, ms = _timed_step(torch, free_step, state, stream.next())
        free_ms.append(ms)
        free_retries.append(torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries)
        if i == 0:
            free_launches = kernels.launch_counts()
        require(np.isfinite(m["loss"]), f"mesh_train: mesh-free loss {m['loss']}")

    trainer = Trainer(cfg, tcfg, stream, rules=DEFAULT_RULES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, recs = [], []
    with set_mesh(mesh):
        state, _ = trainer.run(state, 1, log_every=0)          # warm-up
        for i in range(MESH_STEPS):
            kernels.reset_launch_counts()
            reset_collective_bytes()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
            with record_specs() if i == 0 else contextlib.nullcontext() as ledger:
                start.record()
                state, logs = trainer.run(state, 1, log_every=0)
                end.record()
                end.synchronize()
            if i == 0:
                recs, launches = list(ledger), kernels.launch_counts()
            steps.append({"ms": start.elapsed_time(end), "loss": logs[0]["loss"],
                          "aux": logs[0]["aux"], "grad_norm": logs[0]["grad_norm"],
                          "alloc_retries": torch.cuda.memory_stats().get(
                              "num_alloc_retries", 0) - retries,
                          "collective_bytes": {k: v for k, v in collective_bytes().items()
                                               if v}})
            require(np.isfinite(logs[0]["loss"]), f"mesh_train: step {i} loss {logs[0]}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(launches == free_launches,
            f"mesh_train: launches {launches} under the mesh, {free_launches} without")
    sites = {r.axes for r in recs}
    want_sites = {("batch", "seq", "embed"), ("batch", "seq", "vocab"),
                  ("batch", "seq", "heads", None), ("batch", "seq", "kv_heads", None)}
    require(want_sites <= sites, f"mesh_train: no shard record at {want_sites - sites}")
    for r in recs:
        require(r.spec == logical_spec(r.shape, r.axes, DEFAULT_RULES, mesh),
                f"mesh_train: record {r} is not logical_spec's")

    # every expert leaf's gradient, from one microbatch under the mesh
    batch = {k: v[:TRAIN_BATCH // TRAIN_MICRO] for k, v in stream.next().items()}
    flat = [p.detach().requires_grad_() for p in leaves(state.params)]
    keys = [k for k, _ in leaves_with_path(state.params)]
    experts = [i for i, k in enumerate(keys) if "|moe|" in k]
    with set_mesh(mesh):
        loss, _ = T.loss_fn(unflatten(state.params, flat), batch, cfg, DEFAULT_RULES)
    grads = torch.autograd.grad(loss, [flat[i] for i in experts])
    expert_grads = {keys[i]: float(g.float().abs().max()) for i, g in zip(experts, grads)}
    del loss, grads, flat
    bad = {k: v for k, v in expert_grads.items() if not (np.isfinite(v) and v > 0)}
    ms = [st["ms"] for st in steps]
    print(f"path mesh_train: {cfg.name} layers={cfg.n_layers} mesh={mesh.descriptor()} "
          f"B={TRAIN_BATCH} S={TRAIN_SEQ} microbatches={TRAIN_MICRO} remat=full "
          f"ms={ms!r} mesh_free_ms={free_ms!r} mesh_free_alloc_retries={free_retries} "
          f"steps={steps} peak_gib={peak!r} "
          f"launches={launches} mesh_free_launches={free_launches} shard_records={len(recs)} "
          f"sites={len(sites)} expert_grad_max={expert_grads}", flush=True)
    require(not bad, f"mesh_train: expert gradients zero or non-finite: {bad}")

    # the parameters to disk and back, laid out across two meshes
    params = state.params
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_ckpt_")
    restored = {}
    try:
        t0 = time.perf_counter()
        ckpt.save(ckpt_dir, 1, params)
        save_s = time.perf_counter() - t0
        data8 = make_worker_mesh((8,), ("data",), devices=[dev] * 8)
        for name, target in (("2x4", mesh), ("data8", data8)):
            shardings = _shardings(T.param_specs(cfg, DEFAULT_RULES, target, MESH_HINT), target)
            t0 = time.perf_counter()
            got, _ = ckpt.restore(ckpt_dir, 1, params, shardings=shardings)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            same = all(isinstance(a, DistArray) and a.mesh is target
                       and torch.equal(gather(a), b)
                       for a, b in zip(leaves(got), leaves(params)))
            restored[name] = {"restore_s": restore_s, "bitwise": same,
                              "regions": max(len(a.tiles()) for a in leaves(got))}
            del got
            require(same, f"mesh_ckpt: the restore onto {name} differs")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
    print(f"path mesh_ckpt: bytes={nbytes} save_s={save_s!r} restored={restored}", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.n_layers, "mesh": mesh.descriptor(),
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatches": TRAIN_MICRO,
            "ms": ms, "mesh_free_ms": free_ms, "mesh_free_alloc_retries": free_retries,
            "steps": steps, "peak_gib": peak,
            "launches": launches, "mesh_free_launches": free_launches,
            "shard_records": len(recs), "expert_grad_max": expert_grads,
            "checkpoint": {"bytes": nbytes, "save_s": save_s, "restored": restored}}


def _shardings(specs: dict, mesh) -> dict:
    """`param_specs`' tree as NamedShardings on `mesh`."""
    from repro_torch.parallel import NamedSharding

    return {k: _shardings(v, mesh) if isinstance(v, dict) else NamedSharding(mesh, v)
            for k, v in specs.items()}


def run_mesh(torch, dev) -> dict:
    """Phase 19: a mesh of the one card."""
    from repro_torch.launch.mesh import make_worker_mesh

    mesh = make_worker_mesh(MESH_SHAPE, devices=["cuda:0"] * (MESH_SHAPE[0] * MESH_SHAPE[1]))
    out = {"moe": run_mesh_moe(torch, dev, mesh)}
    gc.collect()
    torch.cuda.empty_cache()
    out["embed"] = run_mesh_embed(torch, dev, mesh)
    out["compressed_psum"] = run_mesh_psum(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = run_mesh_train(torch, dev, mesh)
    return out


def run_dryrun(torch, sharded: dict, mesh: dict, train_adamw: dict) -> dict:
    """Phase 20: the dry run on meta tensors, held against phases 14, 18
    and 19 of this process (see the module docstring)."""
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.kernels.flash_attention.kernel import flash_attention_work
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.parallel import DEFAULT_RULES

    launches0 = kernels.launch_counts()
    out: dict = {"sharded_2x2": {}}

    # (a) the sharded inversion: the program's bytes by kind; phase 14's
    # dense call adds the densify of its result from the 3 other coordinates
    meta22 = make_worker_mesh((2, 2), devices=["meta"] * 4)
    densify = N * N * 4 * 3 // 4
    for engine in ("allgather", "ring"):
        traced = dryrun._trace_solver(N, BLOCK_SIZE, meta22, engine=engine)
        pred, card = traced["moved"], sharded["mesh"][f"2x2_{engine}"]["bytes"]
        del traced
        print(f"dry_run sharded_2x2_{engine}: predicted={pred} card={card} "
              f"densify={densify}", flush=True)
        for kind, n in card.items():
            want = pred[kind] + (densify if kind == "to_dense" else 0)
            require(n == want, f"dry_run sharded_2x2_{engine}: {kind} {n} on the card, "
                               f"{want} predicted")
        out["sharded_2x2"][engine] = {"predicted": pred, "card": card, "densify": densify}

    # (b) the MoE step under (data 2, model 4): phase 19's counted step
    cfg = dataclasses.replace(get_arch(MESH_ARCH), n_layers=MESH_LAYERS)
    meta_mesh = make_worker_mesh(MESH_SHAPE, devices=["meta"] * (MESH_SHAPE[0] * MESH_SHAPE[1]))
    shape = ShapeConfig("phase19_step", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    traced = dryrun._trace_cell(cfg, shape, meta_mesh, DEFAULT_RULES, TRAIN_MICRO,
                                model_size_hint=MESH_HINT)
    pred = {k: v for k, v in traced["moved"].items() if v}
    del traced
    card = mesh["train"]["steps"][0]["collective_bytes"]
    print(f"dry_run mesh_train: predicted={pred} card={card} "
          f"trace_s={time.perf_counter() - t0!r}", flush=True)
    require(pred == card, f"dry_run mesh_train: {pred} predicted, {card} on the card")
    out["mesh_train"] = {"predicted": pred, "card": card}

    # (c) olmo-1b mesh-free: phase 18's step
    cfg = get_arch(TRAIN_ARCH)
    shape = ShapeConfig("phase18_step", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    traced = dryrun._trace_cell(cfg, shape, None, DEFAULT_RULES, TRAIN_MICRO)
    m = dryrun._measure(traced)
    arg_bytes = dryrun._io_bytes(traced, "train", None)[0]
    del traced
    trace_s = time.perf_counter() - t0
    q_shape = (TRAIN_BATCH // TRAIN_MICRO, cfg.n_heads, TRAIN_SEQ, cfg.head_dim)
    k_shape = (TRAIN_BATCH // TRAIN_MICRO, cfg.n_kv_heads, TRAIN_SEQ, cfg.head_dim)
    per_launch = {
        "flash_attention": flash_attention_work(q_shape, k_shape, torch.bfloat16,
                                                causal=cfg.causal),
        "flash_attention_bwd": flash_attention_work(q_shape, k_shape, torch.bfloat16,
                                                    causal=cfg.causal, backward=True)}
    card_launches = train_adamw["flop_step_launches"]
    print(f"dry_run train_adamw: aten_flops predicted={m['flops_aten']} "
          f"card={train_adamw['aten_flops']} booked={m['booked']} "
          f"per_launch={per_launch} card_launches={card_launches} "
          f"trace_s={trace_s!r}", flush=True)
    require(m["flops_aten"] == train_adamw["aten_flops"],
            f"dry_run train_adamw: {m['flops_aten']} aten FLOPs predicted, "
            f"{train_adamw['aten_flops']} counted on the card")
    for name, work in per_launch.items():
        b = m["booked"][name]
        require(b["calls"] == card_launches[name] and b["flops"] == card_launches[name] * work,
                f"dry_run train_adamw: {name} booked {b}, launched {card_launches[name]} "
                f"times at {work} a launch")
    predicted_peak = m["temp_bytes_global"] + arg_bytes
    print(f"dry_run train_adamw: temp_bytes_global={m['temp_bytes_global']} "
          f"argument_bytes={arg_bytes} sum_gib={predicted_peak / 2**30!r} "
          f"card_max_memory_allocated_gib={train_adamw['peak_gib']!r}", flush=True)
    out["train_adamw"] = {"aten_flops": m["flops_aten"], "booked": m["booked"],
                          "per_launch": per_launch,
                          "temp_bytes_global": m["temp_bytes_global"],
                          "argument_bytes": arg_bytes, "predicted_peak_bytes": predicted_peak,
                          "card_peak_gib": train_adamw["peak_gib"]}

    # (d) one production cell
    rec = dryrun.run_cell("olmo-1b", "train_4k", multi_pod=False)
    print(f"dry_run cell: {json.dumps(rec)}", flush=True)
    require(rec["runnable"] and not rec["launches_moved"],
            "dry_run cell: not runnable, or a kernel launched")
    out["cell_olmo_train_4k"] = {k: rec[k] for k in (
        "trace_s", "per_device", "cost", "collectives_once", "coll_scope", "analytic",
        "analytic_match", "cost_partitioned")}
    require(kernels.launch_counts() == launches0, "dry_run: a kernel launched")
    return out


def _example(name: str):
    """The examples_torch/ twin `name`, imported from this checkout."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jsonable(out: dict) -> dict:
    """A twin's returned numbers, without its tensors and step logs."""
    return {k: v for k, v in out.items()
            if k != "logs" and isinstance(v, (int, float, str, dict, list))}


def run_examples(torch) -> dict:
    """Phase 21: each twin's `main(argv)` on the card, one after another,
    the cache freed between runs; its wall time, kernel launches and peak
    memory. A twin's own assert or any fault raises."""
    from contextlib import nullcontext

    from repro_torch import kernels
    from repro_torch.core import multiply_engine

    runs = {}
    for label, script, argv, engine, must_launch in EXAMPLE_RUNS:
        main = _example(script).main
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        print(f"example {label}: {script}.py {' '.join(argv)}"
              f"{f' under multiply_engine({engine!r})' if engine else ''}", flush=True)
        t0 = time.perf_counter()
        with multiply_engine(engine) if engine else nullcontext():
            out = main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"example {label}: wall_s={wall!r} launches={launches} peak_gib={peak!r}",
              flush=True)
        for name in must_launch:
            require(launches[name] > 0, f"example {label}: {name} never launched")
        runs[label] = {"script": script, "argv": argv, "engine": engine, "wall_s": wall,
                       "launches": launches, "peak_gib": peak, "out": _jsonable(out)}
        del out
    # B3 where a plan put the blocked leaf on the path; the sharded service
    # launches B1/B2 when its plan's engine is the kernel engine.
    for label in ("quickstart_planned", "serve_inverse", "serve_inverse_sharded"):
        run = runs[label]
        if run["out"].get("leaf") == "cuda":
            require(run["launches"]["blocked_gauss_jordan"] > 0,
                    f"example {label}: the plan's cuda leaf never launched")
        if run["out"].get("engine") == "cuda":
            require(run["launches"]["matmul"] > 0 and run["launches"]["schur_update"] > 0,
                    f"example {label}: the plan's cuda engine launched no GEMM")
    t100 = runs["train_100m"]["out"]
    require(t100["final_loss"] < t100["start_loss"],
            f"example train_100m: loss {t100['start_loss']} -> {t100['final_loss']}")
    return runs


def _leaves(tree: dict):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# ---------------------------------------------------------------------------
# Phase 22: a mesh that spans processes. Each rank is a child `python3
# chip_smoke.py --rank-case <case> <dir>` on cuda:0 under gloo (NCCL
# refuses two ranks on one card); `launch.procs.run_ranks` starts them with
# SPIN_COORDINATOR=127.0.0.1:<free port>, SPIN_NUM_PROCS and SPIN_PROC_ID,
# and kills them all at the first failure or at its deadline.
# ---------------------------------------------------------------------------


def _digest(torch, t) -> int:
    """A 64-bit hash of a tensor's bytes, computed on its device: equal
    tensors give equal digests (two ranks' parameters are compared so)."""
    w = t.detach().contiguous().reshape(-1).view(torch.uint8)
    w = torch.cat([w, w.new_zeros((-w.numel()) % 4)]).view(torch.int32)
    total = 0
    for lo in range(0, w.numel(), 1 << 26):
        part = w[lo:lo + (1 << 26)].to(torch.int64)
        idx = torch.arange(lo, lo + part.numel(), device=w.device, dtype=torch.int64)
        total = (total + int((part * (idx * 2654435761 + 97)).sum())) % (1 << 64)
    return total


def _moe_block(torch, dev):
    """Phase 19's MoE block at full width (its params, its bf16 input) and
    a seeded f32 output cotangent: (cfg, params, x, ct)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import init_tree

    cfg = get_arch(MESH_ARCH)
    params = init_tree(moe_mod.moe_params(cfg, MESH_HINT),
                       torch.Generator(device=dev).manual_seed(SEED), dev)
    x = torch.randn((LM_BATCH, LM_SEQ, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED + 1)
                    ).to(torch.bfloat16)
    ct = torch.randn((LM_BATCH, LM_SEQ, cfg.d_model), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(SEED + 4))
    return cfg, params, x, ct


def _moe_fwd_bwd(torch, mesh, cfg, params, x, ct) -> dict:
    """Phase 22 (c): the EP MoE block's forward and backward on `mesh`:
    outputs, gradients, and the bytes and calls of each pass."""
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel import collectives as col

    ps = {k: ({kk: vv.detach().requires_grad_() for kk, vv in v.items()}
              if isinstance(v, dict) else v.detach().requires_grad_())
          for k, v in params.items()}
    xg = x.detach().requires_grad_()
    col.reset_collective_bytes()
    with set_mesh(mesh):
        y, aux, z = moe_mod.moe_apply(ps, xg, cfg)
    fwd = (col.collective_bytes(), col.collective_calls())
    col.reset_collective_bytes()
    with col.backward_context(mesh):
        ((y.float() * ct).sum() + aux + z).backward()
    bwd = (col.collective_bytes(), col.collective_calls())
    grads = {"x": xg.grad, **{k: v.grad for k, v in ps.items() if k != "shared"},
             **{f"shared_{k}": v.grad for k, v in ps.get("shared", {}).items()}}
    return {"y": y.detach(), "aux": aux.detach(), "z": z.detach(), "grads": grads,
            "fwd": fwd, "bwd": bwd}


def _psum_input(torch, dev):
    """Phase 19's compressed_psum input: one expert's gradient a coordinate."""
    from repro_torch.configs import get_arch

    cfg = get_arch(MESH_ARCH)
    n = cfg.d_model * cfg.moe.d_ff_expert
    return 1e-3 * torch.randn((4, n), device=dev,
                              generator=torch.Generator(device=dev).manual_seed(SEED + 3))


def _rank_inverse(torch, keep: str, per_rank: int, tag: str) -> dict:
    """Phase 22 (a) in a rank: the 2x2 inversion of phase 4's matrix, a
    warm-up and PROC_TIMED_CALLS timed calls, then one traced."""
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.core import spin_inverse_sharded, verify
    from repro_torch.launch.mesh import make_worker_mesh, set_mesh, worker_info
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel import transport
    from repro_torch.profile_spin import device_breakdown

    rank = worker_info().process_index
    a = torch.load(os.path.join(keep, "a.pt"), map_location="cuda")
    mesh = make_worker_mesh((2, 2), devices=["cuda:0"] * per_rank)

    def call():
        with set_mesh(mesh):
            return spin_inverse_sharded(a, BLOCK_SIZE, leaf_solver="cuda", engine="cuda")

    call()
    torch.cuda.synchronize()
    runs = []
    for i in range(PROC_TIMED_CALLS):
        dist.barrier()
        kernels.reset_launch_counts()
        col.reset_collective_bytes()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        x = call()
        torch.cuda.synchronize()
        runs.append({"wall_ms": (time.perf_counter() - t0) * 1e3,
                     "exchange_ms": transport.exchange_seconds() * 1e3,
                     "launches": kernels.launch_counts(), "bytes": col.collective_bytes(),
                     "calls": col.collective_calls(),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
        if i + 1 < PROC_TIMED_CALLS:
            del x
    ref = torch.load(os.path.join(keep, "x14.pt"), map_location="cuda")
    out = {"rank": rank, "runs": runs, "bitwise": bool(torch.equal(x, ref)),
           "max_abs_dev": float((x - ref).abs().max()),
           "residual": verify.inverse_residual(a, x) if rank == 0 else None,
           "finite": bool(torch.isfinite(x).all())}
    del x, ref
    dist.barrier()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("processes_call"):
            call()
            torch.cuda.synchronize()
    path = os.path.join(keep, f"trace_{tag}_rank{rank}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            report = device_breakdown(json.load(f), "processes_call")
        out["traced"] = {k: report[k] for k in ("span_ms", "busy_ms", "idle_share")}
    except ValueError as err:        # no device events in the trace: not measured
        out["traced"] = {"not_measured": str(err)}
    os.remove(path)
    del a
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rank_solve(torch, keep: str) -> dict:
    """Phase 22 (b) in a rank: the 2x2 solve of 256 right-hand sides."""
    from repro_torch import kernels
    from repro_torch.core import spin_solve_sharded, verify
    from repro_torch.launch.mesh import make_worker_mesh, set_mesh, worker_info
    from repro_torch.parallel import collectives as col

    a = torch.load(os.path.join(keep, "a.pt"), map_location="cuda")
    rhs = torch.load(os.path.join(keep, "rhs.pt"), map_location="cuda")
    mesh = make_worker_mesh((2, 2), devices=["cuda:0"])

    def call():
        with set_mesh(mesh):
            return spin_solve_sharded(a, rhs, BLOCK_SIZE, leaf_solver="cuda", engine="cuda")

    call()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    col.reset_collective_bytes()
    t0 = time.perf_counter()
    x = call()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ref = torch.load(os.path.join(keep, "xs14.pt"), map_location="cuda")
    rank = worker_info().process_index
    out = {"rank": rank, "wall_ms": wall, "launches": kernels.launch_counts(),
           "bytes": col.collective_bytes(), "calls": col.collective_calls(),
           "bitwise": bool(torch.equal(x, ref)), "max_abs_dev": float((x - ref).abs().max()),
           "residual": verify.solve_residual(a, x, rhs) if rank == 0 else None}
    del a, rhs, x, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rank_mesh_lm(torch, keep: str) -> dict:
    """Phase 22 (c) and (d) in a rank: the EP MoE block forward and
    backward on (data 2, model 4), two coordinates a rank; the sharded
    lookup; compressed_psum over a `pod` mesh of one coordinate a rank."""
    import torch.nn.functional as F
    from repro_torch.launch.mesh import make_worker_mesh, set_mesh
    from repro_torch.models.embedding import embed_lookup
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.compression import compressed_psum

    dev = torch.device("cuda")
    mesh = make_worker_mesh(MESH_SHAPE, devices=["cuda:0"] * 2)
    cfg, params, x, ct = _moe_block(torch, dev)
    _moe_fwd_bwd(torch, mesh, cfg, params, x, ct)              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = _moe_fwd_bwd(torch, mesh, cfg, params, x, ct)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    ref = torch.load(os.path.join(keep, "moe_ref.pt"), map_location="cuda")
    same = {k: bool(torch.equal(got[k], ref[k])) for k in ("y", "aux", "z")}
    same.update({f"grad_{k}": bool(torch.equal(g, ref["grads"][k]))
                 for k, g in got["grads"].items()})
    dev_max = max(float((got["y"].float() - ref["y"].float()).abs().max()), *(
        float((g.float() - ref["grads"][k].float()).abs().max())
        for k, g in got["grads"].items()))
    moe = {"ms": ms, "equal": same, "max_abs_dev": dev_max,
           "fwd_bytes": got["fwd"][0], "bwd_bytes": got["bwd"][0],
           "fwd_calls": got["fwd"][1], "bwd_calls": got["bwd"][1],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del got, ref, params, x, ct
    gc.collect()
    torch.cuda.empty_cache()

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    table = (0.02 * torch.randn((cfg.vocab, cfg.d_model), generator=g, device=dev)
             ).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ), generator=g,
                         device=dev)
    with torch.inference_mode():
        col.reset_collective_bytes()
        with set_mesh(mesh):
            e = embed_lookup(table, toks)
        embed = {"bitwise": bool(torch.equal(e, F.embedding(toks, table))),
                 "bytes": col.collective_bytes()}
    del table, toks, e

    pod = make_worker_mesh((4,), ("pod",), devices=["cuda:0"])
    xp = _psum_input(torch, dev)
    col.reset_collective_bytes()
    sums = compressed_psum(col.split(xp, ("pod", None), pod), "pod", pod)
    psum_bytes = col.collective_bytes()
    ref = torch.load(os.path.join(keep, "psum_ref.pt"), map_location="cuda")
    exact = xp.double().sum(0)
    psum = {"bytes": psum_bytes,
            "bitwise": all(bool(torch.equal(sums[c], ref)) for c in pod.local_coords()),
            "rel_err": max(float((sums[c].double() - exact).abs().max())
                           / float(exact.abs().max()) for c in pod.local_coords())}
    return {"moe": moe, "embed": embed, "psum": psum}


def _rank_train(torch) -> dict:
    """Phase 22 (e) in a rank: AdamW steps of qwen2-moe through
    `launch.train`'s multi-process entry (its own `init_distributed`)."""
    from repro_torch import kernels
    from repro_torch.launch import train as train_mod
    from repro_torch.tree import leaves

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = train_mod.main(["--arch", MESH_ARCH, "--layers", str(PROC_TRAIN_LAYERS),
                          "--batch", str(PROC_TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                          "--steps", str(PROC_TRAIN_STEPS), "--microbatches",
                          str(PROC_TRAIN_MICRO), "--mesh", f"{MESH_SHAPE[0]}x{MESH_SHAPE[1]}",
                          "--backend", "gloo"])
    torch.cuda.synchronize()
    out = {"losses": [log["loss"] for log in res["logs"]],
           "step_ms": [log["dt"] * 1e3 for log in res["logs"]],
           "launches": kernels.launch_counts(), "mesh": res["mesh"],
           "processes": res["processes"],
           "digests": [_digest(torch, p) for p in leaves(res["state"].params)],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rank_case(torch, case: str, keep: str) -> dict:
    """What one rank of a phase-22 spawn runs: "four" (4 ranks: (a) with a
    coordinate a rank, (b), (c), (d)) or "two" (2 ranks: (a) with two
    coordinates a rank, then (e)); of phase 23's: "partition" (2 ranks,
    the partitioned steps, (b)); of phase 24's: "serve" (2 ranks,
    partitioned prefill and decode, (b)); or of phase 25's: "moe" (2
    ranks, the partitioned MoE step, prefill and decode, (d))."""
    t0 = time.perf_counter()
    if case == "moe":                         # phase 25 (d)
        from repro_torch.launch.mesh import make_worker_mesh

        n = MESH_SHAPE[0] * MESH_SHAPE[1] // PMOE_PROCS
        out = _pmoe_digests(torch, make_worker_mesh(MESH_SHAPE, devices=["cuda:0"] * n))
    elif case == "serve":                     # phase 24 (b)
        from repro_torch.launch.mesh import make_worker_mesh

        n = SERVE_SHAPE[0] * SERVE_SHAPE[1] // SERVE_PROCS
        out = _serve_digests(torch, _partition_cfg(SERVE_PROC_LAYERS),
                             make_worker_mesh(SERVE_SHAPE, devices=["cuda:0"] * n))
    elif case == "partition":                 # phase 23 (b)
        from repro_torch.launch.mesh import make_worker_mesh

        n = PART_SHAPE[0] * PART_SHAPE[1] // PART_PROCS
        out = _partition_steps(torch, _partition_cfg(PART_PROC_LAYERS),
                               make_worker_mesh(PART_SHAPE, devices=["cuda:0"] * n),
                               PART_PROC_STEPS)
    elif case == "four":
        out = {"inverse": _rank_inverse(torch, keep, 1, "four"),
               "solve": _rank_solve(torch, keep), "lm": _rank_mesh_lm(torch, keep)}
    else:
        out = {"inverse": _rank_inverse(torch, keep, 2, "two"), "train": _rank_train(torch)}
    out["rank_s"] = time.perf_counter() - t0
    return out


def _rank_child(case: str, keep: str) -> int:
    """The `--rank-case` entry: one rank of a phase-22 spawn."""
    import torch

    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.procs import rank_main

    rank_main(lambda: _rank_case(torch, case, keep), backend="gloo",
              timeout_s=PROC_GROUP_TIMEOUT_S)
    return 0


def _processes_summary(out: dict) -> dict:
    """Phase 22's numbers for the paths line: each rank's, without the
    parameter digests."""
    summary = {"state_gib_by_layers": out["state_gib_by_layers"],
               "parent_gib": out["parent_gib"]}
    for case in ("four", "two"):
        ranks = []
        for r in out[case]["ranks"]:
            r = dict(r)
            if "train" in r:
                r["train"] = {k: v for k, v in r["train"].items() if k != "digests"}
            ranks.append(r)
        summary[case] = {"wall_s": out[case]["wall_s"], "ranks": ranks}
    return summary


def _launches_by_rank(out: dict, name: str) -> dict:
    """A kernel's launches on phase 22's paths, each rank's and their sum."""
    paths = {}
    for case in ("four", "two"):
        ranks = out[case]["ranks"]
        got = {f"processes_inverse_{case}": [r["inverse"]["runs"][0]["launches"][name]
                                             for r in ranks]}
        if case == "four":
            got["processes_solve_four"] = [r["solve"]["launches"][name] for r in ranks]
        else:
            got["processes_train_two"] = [r["train"]["launches"][name] for r in ranks]
        for path, per in got.items():
            paths[f"{path}_by_rank"] = per
            paths[f"{path}_sum"] = sum(per)
    return paths


def _sum_ranks(dicts: list) -> dict:
    return {k: sum(d[k] for d in dicts) for k in dicts[0]}


def _without(d: dict, *kinds) -> dict:
    return {k: v for k, v in d.items() if k not in kinds}


def run_processes(torch, keep: str, sharded: dict, mesh19: dict) -> dict:
    """Phase 22: a mesh that spans processes, on the one card, against the
    single process's mesh of phases 14 and 19."""
    import numpy as np
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.launch.procs import free_port, run_ranks
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.compression import compressed_psum
    from repro_torch.runtime.trainer import TrainConfig, abstract_state
    from repro_torch.tree import leaves

    dev = torch.device("cuda")
    grid = N // BLOCK_SIZE
    # the single process's references of (c) and (d), on the phase-19 mesh
    cfg, params, x, ct = _moe_block(torch, dev)
    ref = _moe_fwd_bwd(torch, make_worker_mesh(MESH_SHAPE, devices=["cuda:0"] * 8),
                       cfg, params, x, ct)
    torch.save({k: ref[k] for k in ("y", "aux", "z", "grads")},
               os.path.join(keep, "moe_ref.pt"))
    moe_ref_counts = {"fwd": ref["fwd"], "bwd": ref["bwd"]}
    del ref, params, x, ct
    pod = make_worker_mesh((4,), ("pod",), devices=["cuda:0"] * 4)
    xp = _psum_input(torch, dev)
    torch.save(compressed_psum(col.split(xp, ("pod", None), pod), "pod", pod)[(0,)],
               os.path.join(keep, "psum_ref.pt"))
    del xp
    gc.collect()
    torch.cuda.empty_cache()

    # (e)'s cut: the state each rank holds whole, from its meta twin
    state_gib = {}
    for layers in (1, 2):
        st = abstract_state(dataclasses.replace(cfg, n_layers=layers),
                            TrainConfig(optimizer="adamw"), MESH_HINT)
        state_gib[layers] = sum(t.numel() * t.element_size()
                                for t in leaves((st.params, st.opt))
                                if isinstance(t, torch.Tensor)) / 2 ** 30
    print(f"processes: (e) qwen2-moe depth cut to {PROC_TRAIN_LAYERS} layer over "
          f"{PROC_TRAIN_PROCS} processes: a rank holds the whole AdamW state "
          f"({state_gib[1]!r} GiB at 1 layer, {state_gib[2]!r} at 2, before gradients "
          "and activations), so four ranks do not fit one 80 GB card at any depth "
          "(first_depth_that_fits)", flush=True)

    argv = [sys.executable, str(Path(__file__).resolve()), "--rank-case"]
    out = {"state_gib_by_layers": state_gib,
           "parent_gib": torch.cuda.memory_reserved() / 2 ** 30}
    # two ranks' state and steps nearly fill the card: the allocator grows
    # segments in place rather than leaving GiBs reserved between them
    env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    for case, nprocs in (("four", 4), ("two", 2)):
        t0 = time.perf_counter()
        ranks = run_ranks(argv + [case, keep], nprocs, timeout_s=PROC_SPAWN_S,
                          coordinator=f"127.0.0.1:{free_port()}", env=env)
        out[case] = {"wall_s": time.perf_counter() - t0, "ranks": ranks}
        print(f"processes {case}: {nprocs} ranks in {out[case]['wall_s']!r} s; "
              f"{json.dumps(ranks, default=str)}", flush=True)

    # (a) both ways: bitwise phase 14 on every rank, the residual, launches
    # and bytes summed over the ranks equal to phase 14's (to_dense once a
    # rank; "replicate" is what a rank receives of another's result)
    want_launches = sharded_spin_launches(grid, (2, 2))
    p14 = sharded["mesh"]["2x2_cuda"]
    for case, nprocs in (("four", 4), ("two", 2)):
        runs = [r["inverse"] for r in out[case]["ranks"]]
        tag = f"processes_inverse_{case}"
        require(all(r["bitwise"] and r["finite"] for r in runs),
                f"{tag}: differs from phase 14's 2x2 result: "
                f"{[r['max_abs_dev'] for r in runs]}")
        require(runs[0]["residual"] <= RESIDUAL_BOUND, f"{tag}: residual {runs[0]['residual']}")
        for i in range(PROC_TIMED_CALLS):
            launches = _sum_ranks([r["runs"][i]["launches"] for r in runs])
            for kern, want in want_launches.items():
                require(launches[kern] == want,
                        f"{tag}: {kern} launched {launches[kern]} times in sum, want {want}")
            require(all(r["runs"][i]["launches"]["matmul"] > 0
                        and r["runs"][i]["launches"]["schur_update"] > 0
                        and r["runs"][i]["launches"]["blocked_gauss_jordan"] > 0 for r in runs),
                    f"{tag}: B1, B2 and B3 do not launch on every rank")
            moved = _sum_ranks([r["runs"][i]["bytes"] for r in runs])
            require(moved["to_dense"] == nprocs * p14["bytes"]["to_dense"]
                    and _without(moved, "to_dense", "replicate")
                    == _without(p14["bytes"], "to_dense", "replicate"),
                    f"{tag}: bytes {moved} in sum against phase 14's {p14['bytes']}")
        print(f"path {tag}: wall_ms={[[r['runs'][i]['wall_ms'] for i in range(PROC_TIMED_CALLS)] for r in runs]!r} "
              f"exchange_ms={[[r['runs'][i]['exchange_ms'] for i in range(PROC_TIMED_CALLS)] for r in runs]!r} "
              f"traced={[r['traced'] for r in runs]} "
              f"peak_gib={[r['runs'][0]['peak_gib'] for r in runs]!r} "
              f"residual={runs[0]['residual']!r} launches_by_rank="
              f"{[r['runs'][0]['launches'] for r in runs]} bytes_summed={moved}", flush=True)

    # (b) the solve over 4 ranks
    runs = [r["solve"] for r in out["four"]["ranks"]]
    want = sharded_solve_launches(grid, BLOCK_SIZE, 2)
    launches = _sum_ranks([r["launches"] for r in runs])
    require(all(r["bitwise"] for r in runs),
            f"processes_solve: differs from phase 14's: {[r['max_abs_dev'] for r in runs]}")
    require(runs[0]["residual"] <= RESIDUAL_BOUND, f"processes_solve: residual {runs[0]['residual']}")
    for kern in ("matmul", "triangular_solve"):
        require(launches[kern] == want[kern],
                f"processes_solve: {kern} launched {launches[kern]} in sum, want {want[kern]}")
    require(all(r["launches"]["triangular_solve"] > 0 for r in runs),
            "processes_solve: B5 does not launch on every rank")
    moved = _sum_ranks([r["bytes"] for r in runs])
    p14s = sharded["solve_2x2"]["bytes"]
    require(moved["to_dense"] == 4 * p14s["to_dense"]
            and _without(moved, "to_dense", "replicate") == _without(p14s, "to_dense", "replicate"),
            f"processes_solve: bytes {moved} in sum against phase 14's {p14s}")
    print(f"path processes_solve: wall_ms={[r['wall_ms'] for r in runs]!r} "
          f"residual={runs[0]['residual']!r} launches_by_rank={[r['launches'] for r in runs]} "
          f"bytes_summed={moved}", flush=True)

    # (c) and (d): bitwise the single process's, bytes summed equal
    lm = [r["lm"] for r in out["four"]["ranks"]]
    require(all(all(r["moe"]["equal"].values()) for r in lm),
            f"processes_moe: differs from the single process's: "
            f"{[r['moe']['max_abs_dev'] for r in lm]}")
    for pas in ("fwd", "bwd"):
        moved = _sum_ranks([r["moe"][f"{pas}_bytes"] for r in lm])
        require(_without(moved, "replicate") == _without(moe_ref_counts[pas][0], "replicate"),
                f"processes_moe: {pas} bytes {moved} in sum against {moe_ref_counts[pas][0]}")
    fwd = _sum_ranks([r["moe"]["fwd_bytes"] for r in lm])
    p19 = mesh19["moe"]["default"]["collective_bytes"]
    require(_without(fwd, "replicate") == _without(p19, "replicate"),
            f"processes_moe: forward bytes {fwd} against phase 19's {p19}")
    require(all(r["embed"]["bitwise"] for r in lm), "processes_embed: differs from F.embedding")
    emb = _sum_ranks([r["embed"]["bytes"] for r in lm])
    require(_without(emb, "replicate") == _without(mesh19["embed"]["collective_bytes"],
                                                   "replicate"),
            f"processes_embed: bytes {emb} against phase 19's")
    require(all(r["psum"]["bitwise"] and r["psum"]["rel_err"] <= MESH_PSUM_RTOL for r in lm),
            f"processes_psum: {[r['psum'] for r in lm]}")
    ps = _sum_ranks([r["psum"]["bytes"] for r in lm])
    p19 = mesh19["compressed_psum"]["bytes"]
    require({k: v for k, v in ps.items() if v} == p19,
            f"processes_psum: bytes {ps} against phase 19's {p19}")
    print(f"path processes_moe: ms={[r['moe']['ms'] for r in lm]!r} "
          f"peak_gib={[r['moe']['peak_gib'] for r in lm]!r} fwd_bytes_summed={fwd} "
          f"replicate_fwd={[r['moe']['fwd_bytes']['replicate'] for r in lm]} "
          f"replicate_bwd={[r['moe']['bwd_bytes']['replicate'] for r in lm]}", flush=True)

    # (e): the same losses and parameters on both ranks, B6 and B6-bwd
    tr = [r["train"] for r in out["two"]["ranks"]]
    require(all(np.isfinite(t["losses"]).all() for t in tr), f"processes_train: {tr}")
    require(tr[0]["losses"] == tr[1]["losses"] and tr[0]["digests"] == tr[1]["digests"],
            "processes_train: the ranks' losses or parameters differ")
    # B6 twice a layer and microbatch a step (forward, the remat's
    # recompute), B6-bwd once, no other kernel of the port
    per_step = {"flash_attention": 2 * PROC_TRAIN_LAYERS * PROC_TRAIN_MICRO,
                "flash_attention_bwd": PROC_TRAIN_LAYERS * PROC_TRAIN_MICRO}
    for t in tr:
        for kern, n in t["launches"].items():
            require(n == PROC_TRAIN_STEPS * per_step.get(kern, 0),
                    f"processes_train: {kern} launched {n} times in {PROC_TRAIN_STEPS} steps")
    print(f"path processes_train: {MESH_ARCH} layers={PROC_TRAIN_LAYERS} "
          f"processes={PROC_TRAIN_PROCS} mesh={tr[0]['mesh']} losses={tr[0]['losses']!r} "
          f"step_ms={[t['step_ms'] for t in tr]!r} peak_gib={[t['peak_gib'] for t in tr]!r} "
          f"launches={tr[0]['launches']}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 23: the partitioned dense step (a laid-out state, per coordinate)
# ---------------------------------------------------------------------------


def _partition_cfg(layers: int | None = None):
    from repro_torch.configs import get_arch

    cfg = get_arch(PART_ARCH)
    return dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)


def _held_gib(torch, state) -> float:
    """GiB of the distinct storages behind this process's shards of a
    laid-out state."""
    from repro_torch.tree import leaves

    seen = {}
    for x in leaves(state):
        for t in x.shards.values():
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(seen.values()) / 2 ** 30


def _own_gib(tree) -> float:
    """GiB of this process's coordinates' regions of every laid-out leaf of
    `tree`, each distinct region of a place once."""
    from repro_torch.tree import leaves

    total = 0
    for x in leaves(tree):
        local = x.mesh.local_coords()
        for _, r in {(x.mesh.place(c), x.region(c)) for c in local}:
            n = x.shards[local[0]].element_size()
            for lo, hi in r:
                n *= hi - lo
            total += n
    return total / 2 ** 30


def _partition_steps(torch, cfg, mesh, steps: int, model_size_hint: int = 16,
                     keep_state: bool = False, batch: int = TRAIN_BATCH) -> dict:
    """`steps` AdamW steps of `cfg` on phase 18's seeded state laid out by
    the reference's specs over `mesh` (in one process, or this process's
    part of a mesh that spans processes), `batch` x 2048 tokens in
    microbatches of 4 x 2048: losses, each step's wall and exchange ms,
    the state's GiB, peak GiB, and a digest of every parameter gathered
    whole; the final state too with `keep_state`."""
    from repro_torch import kernels
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.parallel import transport
    from repro_torch.parallel.collectives import gather
    from repro_torch.parallel.sharding import lay_out
    from repro_torch.runtime.trainer import (TrainConfig, init_state, make_train_step,
                                             state_shardings)
    from repro_torch.tree import leaves

    dev = torch.device("cuda")
    tcfg = TrainConfig(microbatches=batch * TRAIN_MICRO // TRAIN_BATCH, optimizer="adamw",
                       warmup=1)
    gc.collect()
    torch.cuda.empty_cache()
    whole = init_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                       model_size_hint)
    state = lay_out(whole, state_shardings(cfg, tcfg, mesh, model_size_hint=model_size_hint))
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = _held_gib(torch, state)
    stream = TokenStream(cfg, batch, TRAIN_SEQ, seed=SEED, device=str(dev))
    step = make_train_step(cfg, tcfg)
    kernels.reset_launch_counts()
    out = {"losses": [], "grad_norms": [], "wall_ms": [], "exchange_ms": []}
    for _ in range(steps):
        transport.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, stream.next())
        loss = float(m["loss"])
        out["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        out["exchange_ms"].append(transport.exchange_seconds() * 1e3)
        out["losses"].append(loss)
        out["grad_norms"].append(float(m["grad_norm"]))
    out["launches"] = kernels.launch_counts()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["state_gib"] = held
    out["digests"] = [_digest(torch, gather(p)) for p in leaves(state.params)]
    if keep_state:
        out["state"] = state
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_flash_partitioned(torch, b: int, h: int, s: int, hd: int,
                            what: str = "the partitioned step",
                            backward: bool = True, kv: int = 0, window: int = 0,
                            causal: bool = True) -> dict:
    """Phases 23 to 27: B6 (and B6-bwd with `backward`) against their
    plain versions at a coordinate's shape of `what` (B_loc, H_loc, S,
    hd; `kv` KV heads, H_loc by default; a sliding `window`), bf16,
    causal or (hubert's) bidirectional, made in the model's (B, S, H, hd)
    layout; each timed beside its bound, its plain version and SDPA
    (forward, backward; given the window's boolean mask)."""
    from repro_torch.kernels.flash_attention import kernel as fa, ref as fa_ref
    import numpy as np
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rng = np.random.default_rng([SEED, 23])

    kv = kv or h

    def one(heads):
        x = rng.standard_normal((b, s, heads, hd), dtype=np.float32)
        return torch.from_numpy(x).to(dev, torch.bfloat16).transpose(1, 2)

    q, k, v, do = one(h), one(kv), one(kv), one(h)
    w = {"causal": causal, "window": window}
    got = fa.flash_attention_cuda(q, k, v, **w)
    err = max_abs(got, fa_ref.attention_ref(q, k, v, **w))
    require(bool(torch.isfinite(got.float()).all()) and err <= FLASH_TOL["bfloat16"],
            f"partition flash_attention: max_abs_err {err}")
    bound, by = flash_bound_ms(b, h, kv, s, s, hd, causal, 2, PEAK_BF16_FLOPS, window=window)
    # SDPA takes a boolean mask only for the window (check_flash_families)
    mask = fa_ref.attention_mask(s, s, True, window, dev) if window else None
    sdpa_causal = causal and not window
    fwd = {"ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v, **w), 10),
           "plain_ms": time_ms(lambda: fa_ref.attention_ref(q, k, v, **w), 2),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=mask, is_causal=sdpa_causal, enable_gqa=kv != h), 10),
           "bound_ms": bound, "bound_by": by, "max_abs_err": err}
    shape = (f"B={b} H={h} KV={kv} S={s} hd={hd} " + ("causal" if causal else "bidirectional")
             + (f" window={window}" if window else "") + f" bf16 (a coordinate of {what})")
    print(f"time flash_attention {what}: {fwd} {shape}", flush=True)
    if not backward:
        del q, k, v, do, mask
        torch.cuda.empty_cache()
        return {"flash_attention": {**fwd, "shape": shape}}
    out, lse = fa._forward(q, k, v, causal, want_lse=True, window=window)
    grads = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse, **w)
    want = fa_ref.attention_bwd_ref(q, k, v, do, **w)
    errs = [max_abs(g, w) for g, w in zip(grads, want)]
    rel = max(e / float(w.float().abs().max()) for e, w in zip(errs, want))
    require(all(bool(torch.isfinite(g.float()).all()) for g in grads)
            and rel <= FLASH_BWD_TOL["bfloat16"],
            f"partition flash_attention_bwd: rel err {rel}")
    del grads, want
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, is_causal=sdpa_causal,
                                             enable_gqa=kv != h)
    bound, by = flash_bwd_bound_ms(b, h, kv, s, hd, causal, 2, PEAK_BF16_FLOPS, window=window)
    bwd = {"ms": time_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, out, do, lse, **w), 20),
           "plain_ms": time_ms(lambda: fa_ref.attention_bwd_ref(q, k, v, do, **w), 1),
           "library_ms": time_ms(lambda: torch.autograd.grad(lib_out, leaves, do,
                                                             retain_graph=True), 20),
           "bound_ms": bound, "bound_by": by, "max_abs_err": max(errs), "rel_err": rel}
    print(f"time flash_attention_bwd {what}: {bwd} {shape}", flush=True)
    del q, k, v, do, out, lse, lib_out, leaves, mask
    torch.cuda.empty_cache()
    return {"flash_attention": {**fwd, "shape": shape},
            "flash_attention_bwd": {**bwd, "shape": shape}}


def run_partition(torch, keep: str) -> dict:
    """Phase 23: (a) olmo-1b's partitioned AdamW step on (data 2, model 4)
    of cuda:0 against a mesh-free step on the same weights and batch, its
    launches, bytes and calls by collective kind, times and memory; (b)
    two ranks on the card against the single process (module docstring)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.dryrun import partitioned_step_collectives
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.launch.procs import free_port, run_ranks
    from repro_torch.parallel import collective_bytes, collective_calls, reset_collective_bytes
    from repro_torch.parallel.collectives import DistArray
    from repro_torch.parallel.sharding import lay_out
    from repro_torch.runtime.trainer import (TrainConfig, init_state, make_train_step,
                                             state_shardings)
    from repro_torch.tree import leaves

    dev = torch.device("cuda")
    cfg = _partition_cfg()
    n_coords = PART_SHAPE[0] * PART_SHAPE[1]
    mesh = make_worker_mesh(PART_SHAPE, devices=["cuda:0"] * n_coords)
    tcfg = TrainConfig(microbatches=TRAIN_MICRO, optimizer="adamw", warmup=1)
    gc.collect()
    torch.cuda.empty_cache()
    whole = init_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    shardings = state_shardings(cfg, tcfg, mesh)
    state = lay_out(whole, shardings)
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED, device=str(dev))
    first = stream.next()
    # the mesh-free step on the same weights and batch (it consumes `whole`)
    whole, free, free_ms = _timed_step(torch, make_train_step(cfg, tcfg), whole, first)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    step = make_train_step(cfg, tcfg)
    kernels.reset_launch_counts()
    reset_collective_bytes()
    state, m1, ms1 = _timed_step(torch, step, state, first)
    launches = kernels.launch_counts()
    moved, calls = collective_bytes(), collective_calls()
    print(f"path partition_first_step: loss={m1['loss']!r} mesh_free_loss={free['loss']!r} "
          f"grad_norm={m1['grad_norm']!r} mesh_free_grad_norm={free['grad_norm']!r} "
          f"ms={ms1!r} mesh_free_ms={free_ms!r} launches={launches} bytes={moved} "
          f"calls={calls}", flush=True)
    for key in ("loss", "grad_norm"):
        require(np.isfinite(m1[key]) and abs(m1[key] - free[key]) <= PART_RTOL * abs(free[key]),
                f"partition: {key} {m1[key]} against mesh-free {free[key]}")
    per_step = {"flash_attention": 2 * cfg.n_layers * TRAIN_MICRO * n_coords,
                "flash_attention_bwd": cfg.n_layers * TRAIN_MICRO * n_coords}
    for kern, n in launches.items():
        require(n == per_step.get(kern, 0),
                f"partition: {kern} launched {n} times, want {per_step.get(kern, 0)}")
    want_moved, want_calls = partitioned_step_collectives(cfg, PART_SHAPE, "default",
                                                          TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO)
    require({k: moved[k] for k in want_moved} == want_moved
            and all(v == 0 for k, v in moved.items() if k not in want_moved),
            f"partition: bytes {moved}, want {want_moved}")
    require({k: calls[k] for k in want_calls} == want_calls,
            f"partition: calls {calls}, want {want_calls}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, _, warm_ms = _timed_step(torch, step, state, stream.next())
    steps = []
    for _ in range(PART_STEPS):
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        state, m, ms = _timed_step(torch, step, state, stream.next())
        steps.append({"ms": ms, "loss": m["loss"], "grad_norm": m["grad_norm"],
                      "alloc_retries": torch.cuda.memory_stats().get("num_alloc_retries", 0)
                      - retries})
        require(np.isfinite(m["loss"]), f"partition: loss {m['loss']}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for x, sh in zip(leaves(state), leaves(shardings)):
        require(isinstance(x, DistArray) and x.spec == tuple(sh.spec) and x.mesh is mesh,
                "partition: a state leaf is no longer laid out by its spec")
    held = _held_gib(torch, state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    ms = [st["ms"] for st in steps]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    a = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": mesh.descriptor(),
         "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatches": TRAIN_MICRO,
         "first_step": {"loss": m1["loss"], "grad_norm": m1["grad_norm"], "ms": ms1,
                        "mesh_free_loss": free["loss"],
                        "mesh_free_grad_norm": free["grad_norm"],
                        "mesh_free_ms": free_ms},
         "warmup_ms": warm_ms, "ms": ms, "tokens_per_s": tokens / (min(ms) / 1e3),
         "steps": steps, "peak_gib": peak, "state_gib": held, "launches": launches,
         "collective_bytes": moved, "collective_calls": calls}
    print(f"path partition_train: {json.dumps(a)}", flush=True)
    a["kernels"] = check_flash_partitioned(
        torch, TRAIN_BATCH // TRAIN_MICRO // PART_SHAPE[0], cfg.n_heads // PART_SHAPE[1],
        TRAIN_SEQ, cfg.head_dim)

    # (b) two ranks on the card against the single process at 2 layers
    small = _partition_cfg(PART_PROC_LAYERS)
    single = _partition_steps(torch, small, mesh, PART_PROC_STEPS)
    t0 = time.perf_counter()
    env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    ranks = run_ranks([sys.executable, str(Path(__file__).resolve()), "--rank-case",
                       "partition", keep], PART_PROCS, timeout_s=PROC_SPAWN_S,
                      coordinator=f"127.0.0.1:{free_port()}", env=env)
    wall_s = time.perf_counter() - t0
    for r in ranks:
        require(r["losses"] == single["losses"] and r["digests"] == single["digests"],
                f"partition ranks: losses {r['losses']} against the single process's "
                f"{single['losses']}, or the parameters differ")
        require(r["launches"]["flash_attention"] * PART_PROCS
                == single["launches"]["flash_attention"],
                f"partition ranks: B6 {r['launches']} against {single['launches']}")
    b = {"processes": PART_PROCS, "layers": small.n_layers, "spawn_s": wall_s,
         "single": {k: v for k, v in single.items() if k != "digests"},
         "ranks": [{k: v for k, v in r.items() if k != "digests"} for r in ranks]}
    print(f"path partition_ranks: {json.dumps(b)}", flush=True)
    return {"train": a, "ranks": b}


# ---------------------------------------------------------------------------
# Phase 24: partitioned prefill and decode (laid-out parameters, per coordinate)
# ---------------------------------------------------------------------------


def _laid_out_params(torch, cfg, mesh):
    """Phase 18's seeded weights of `cfg`, whole on the card, and laid out
    by `param_specs` over `mesh` (a copy of each of this process's
    regions)."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import lay_out

    dev = torch.device("cuda")
    whole = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    return whole, lay_out(whole, _shardings(T.param_specs(cfg, mesh=mesh), mesh))


def _serve_laid_out(torch, cfg, params, prompts, fed=None, steps: int = 0,
                    cache_len: int | None = SERVE_CACHE, probe=None) -> dict:
    """On laid-out `params`: a prefill of `prompts` (tokens, or a batch of
    model inputs; its logits, launches, bytes and calls by kind, wall ms),
    the cache padded to `cache_len`, then one decode step a token of `fed`
    (or `steps` steps fed their own argmax), each step's logits, bytes,
    calls and wall ms; the cache's GiB held after each phase, its leaves'
    specs and shard shapes, and the final cache's digests. `probe(cache)`
    is called on the padded cache before the first step and on the last
    step's: its two results under "probe". With `cache_len` None (an
    encoder) nothing decodes: the prefill's cache is the final one."""
    from repro_torch import kernels
    from repro_torch.models import transformer as T
    from repro_torch.parallel import collective_bytes, collective_calls, reset_collective_bytes
    from repro_torch.parallel import transport
    from repro_torch.parallel.collectives import gather

    def counted(fn):
        kernels.reset_launch_counts()
        reset_collective_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, {"ms": (time.perf_counter() - t0) * 1e3,
                     "exchange_ms": transport.exchange_seconds() * 1e3,
                     "launches": kernels.launch_counts(), "bytes": collective_bytes(),
                     "calls": collective_calls()}

    batch = prompts if isinstance(prompts, dict) else {"tokens": prompts}
    (logits, _, _, cache), prefill = counted(lambda: T.prefill(params, batch, cfg))
    out = {"prefill": prefill, "prefill_logits": logits, "held_gib": [_held_gib(torch, cache)]}
    out["steps"], out["step_logits"], out["probe"] = [], [], []
    if cache_len is None:
        fed = []
    else:
        cache = T.pad_cache(cache, cfg, cache_len)
        out["held_gib"].append(_held_gib(torch, cache))
        out["probe"] = [probe(cache)] if probe is not None else []
    tok = torch.argmax(logits[:, -1], -1)
    del logits
    for i in range(len(fed) if fed is not None else steps):
        tok = fed[i] if fed is not None else tok
        (lg, cache), step = counted(lambda: T.decode_step(params, cache, tok, cfg))
        out["steps"].append(step)
        out["step_logits"].append(lg)
        tok = torch.argmax(lg, -1)
    if cache_len is not None:
        out["held_gib"].append(_held_gib(torch, cache))
        if probe is not None:
            out["probe"].append(probe(cache))
    out["cache"] = {k: (x.spec, {c: tuple(t.shape) for c, t in x.shards.items()})
                    for k, x in cache.items()}
    out["cache_digests"] = {k: _digest(torch, gather(x)) for k, x in cache.items()}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del cache
    return out


def _serve_digests(torch, cfg, mesh) -> dict:
    """Phase 24 (b)'s run: the prefill and SERVE_PROC_STEPS steps fed their
    argmax, its logits as digests."""
    import numpy as np

    whole, params = _laid_out_params(torch, cfg, mesh)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prompts = torch.from_numpy(np.random.default_rng([SEED, 24]).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT))).cuda()
    out = _serve_laid_out(torch, cfg, params, prompts, steps=SERVE_PROC_STEPS)
    out["logit_digests"] = [_digest(torch, t) for t in
                            [out.pop("prefill_logits")] + out.pop("step_logits")]
    out.pop("cache")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _logit_errs(got, want) -> tuple[float, float]:
    """(max abs, rms) of got - want."""
    d = got.float() - want.float()
    return float(d.abs().max()), float(d.square().mean().sqrt())


def _clear_agree(got, want) -> tuple[int, int]:
    """(argmax agreements, positions) over the positions where `want`'s
    top-2 margin exceeds SERVE_BOUND (phase 17's rule)."""
    top2 = want.float().topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > SERVE_BOUND
    same = got.argmax(-1) == want.argmax(-1)
    return int(same[clear].sum()), int(clear.sum())


def _nudged(torch, tree, gen=None):
    """`tree`'s weights each times 1 ± 2^-7 (random signs, seeded): about
    one bf16 ulp."""
    gen = gen or torch.Generator(device="cuda").manual_seed(SEED + 1)
    if isinstance(tree, dict):
        return {k: _nudged(torch, v, gen) for k, v in tree.items()}
    sign = torch.randint(0, 2, tree.shape, device=tree.device, generator=gen) * 2 - 1
    return (tree.float() * (1 + sign * 2.0 ** -7)).to(tree.dtype)


def check_decode_attention_laid_out(torch, cfg, mesh) -> dict:
    """Phase 24: one layer's `attn_decode_laid_out` at `cfg`'s width on
    `mesh` against `attn_decode` on the same inputs: SERVE_BATCH rows at
    position SERVE_PROMPT of a SERVE_CACHE-slot cache (the slices past it
    wholly masked), the output within SERVE_LAYER_RTOL of its largest entry
    and finite, the written cache within the same of the mesh-free one."""
    import numpy as np
    from repro_torch.models import attention, transformer as T
    from repro_torch.parallel import NamedSharding
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.sharding import DEFAULT_RULES, Program, lay_out

    rng = np.random.default_rng([SEED, 241])

    def draw(shape, scale=1.0):
        x = scale * rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(x).cuda().to(torch.bfloat16)

    b, n = SERVE_BATCH, SERVE_CACHE
    stacked = T.param_specs(cfg, mesh=mesh)["layers"]["attn"]
    params = {k: draw(d.shape, 0.02) for k, d in attention.attn_params(cfg).items()}
    laid = lay_out(params, {k: NamedSharding(mesh, tuple(stacked[k])[1:]) for k in params})
    x = draw((b, 1, cfg.d_model))
    ck, cv = (draw((b, n, cfg.n_kv_heads, cfg.head_dim)) for _ in range(2))
    pos = torch.full((b,), SERVE_PROMPT, dtype=torch.int32, device="cuda")
    spec = T.cache_specs(cfg, b, n, mesh=mesh)["k"][1:]
    with torch.inference_mode():
        k_laid, v_laid = col.distribute(ck.clone(), spec, mesh), col.distribute(cv.clone(),
                                                                                spec, mesh)
        got = col.join(attention.attn_decode_laid_out(
            laid, col.split(x, ("data", None, None), mesh), k_laid, v_laid,
            col.split(pos, ("data",), mesh), cfg, Program(mesh, DEFAULT_RULES, b, 1)),
            ("data", None, None), mesh)
        want, wk, wv = attention.attn_decode(params, x, ck, cv, pos, cfg)
    scale = float(want.float().abs().max())
    out = {"rel_err": max_abs(got, want) / scale,
           "cache_rel_err": max(max_abs(col.gather(k_laid), wk) / float(wk.float().abs().max()),
                                max_abs(col.gather(v_laid), wv) / float(wv.float().abs().max())),
           "masked_slices": sum(1 for lo in range(0, n, n // SERVE_SHAPE[1]) if lo > SERVE_PROMPT)}
    print(f"path serve_partition_layer: {json.dumps(out)}", flush=True)
    require(bool(torch.isfinite(got.float()).all()) and out["rel_err"] <= SERVE_LAYER_RTOL
            and out["cache_rel_err"] <= SERVE_LAYER_RTOL,
            f"serve partition: decode attention at full width {out}")
    return out


def run_serve_partition(torch, keep: str) -> dict:
    """Phase 24: (a) olmo-1b's partitioned prefill and decode on (data 2,
    model 4) of cuda:0 against the mesh-free path on the same weights and
    tokens: logits, launches, bytes and calls by collective kind, the
    cache's layout, times and memory; B6 at a coordinate's shape; (b) two
    ranks on the card against the single process (module docstring)."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.launch.dryrun import RULES_VARIANTS, partitioned_serve_collectives
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.launch.procs import free_port, run_ranks
    from repro_torch.models import transformer as T
    from repro_torch.parallel.collectives import gather
    from repro_torch.parallel.sharding import lay_out

    cfg = _partition_cfg()
    n_coords = SERVE_SHAPE[0] * SERVE_SHAPE[1]
    mesh = make_worker_mesh(SERVE_SHAPE, devices=["cuda:0"] * n_coords)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    whole, params = _laid_out_params(torch, cfg, mesh)
    prompts = torch.from_numpy(np.random.default_rng([SEED, 24]).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT))).cuda()
    batch = {"tokens": prompts}

    # the mesh-free path: prefill (a warm-up, then timed), the cache padded,
    # a warm-up step and SERVE_STEPS steps fed their argmax; its peak beside
    # the laid-out run's (both with the other's weights alive)
    T.prefill(whole, batch, cfg)
    (free_logits, _, _, cache), free_prefill_ms = timed(torch, lambda: T.prefill(whole, batch,
                                                                                cfg))
    pad = (0, 0, 0, 0, 0, SERVE_CACHE - SERVE_PROMPT)
    cache = {"k": F.pad(cache["k"], pad), "v": F.pad(cache["v"], pad), "pos": cache["pos"]}
    tok = torch.argmax(free_logits[:, -1], -1)
    fed, free_steps, free_ms = [], [], []
    for _ in range(1 + SERVE_STEPS):
        fed.append(tok)
        (lg, cache), ms = timed(torch, lambda: T.decode_step(whole, cache, tok, cfg))
        free_steps.append(lg)
        free_ms.append(ms)
        tok = torch.argmax(lg, -1)
    free_peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # the laid-out prompt caches layer by layer against the mesh-free one
    # (the padded cache's first SERVE_PROMPT slots, which decode leaves),
    # under the default rules (the warm-up of the counted run below) and
    # under dp_only (no partial sums: FSDP over both axes), with dp_only's
    # prefill logits
    layer_errs = {}
    for rname, laid in (("default", params), ("dp_only", None)):
        rules = RULES_VARIANTS[rname]
        if laid is None:
            laid = lay_out(whole, _shardings(T.param_specs(cfg, rules, mesh), mesh))
        logits, _, _, prompt = T.prefill(laid, batch, cfg, rules)
        if rname == "dp_only":
            dp_only_err = _logit_errs(logits, free_logits)
        del logits, laid
        layer_errs[rname] = {k: [max_abs(t, w[:, :SERVE_PROMPT]) for t, w in
                                 zip(gather(prompt[k]), cache[k])] for k in ("k", "v")}
        del prompt
        gc.collect()
        torch.cuda.empty_cache()
    # the floor: the mesh-free path on the weights moved by about one bf16
    # ulp (each entry times 1 ± 2^-7), fed the same tokens
    del cache
    nudged = _nudged(torch, whole)
    lg, _, _, cache = T.prefill(nudged, batch, cfg)
    floor = [_logit_errs(lg, free_logits)]
    cache = {"k": F.pad(cache["k"], pad), "v": F.pad(cache["v"], pad), "pos": cache["pos"]}
    for tok, want in zip(fed, free_steps):
        lg, cache = T.decode_step(nudged, cache, tok, cfg)
        floor.append(_logit_errs(lg, want))
    del cache, whole, nudged, lg
    gc.collect()
    torch.cuda.empty_cache()

    # the partitioned path: the counted and timed run
    torch.cuda.reset_peak_memory_stats()
    run = _serve_laid_out(torch, cfg, params, prompts, fed)
    pairs = [(run.pop("prefill_logits"), free_logits)] + list(zip(run.pop("step_logits"),
                                                                   free_steps))
    errs = [_logit_errs(got, want) for got, want in pairs]
    agree = [_clear_agree(got, want) for got, want in pairs]
    del pairs, free_logits, free_steps
    pre = run["prefill"]
    ms = [st["ms"] for st in run["steps"][1:]]
    tokens_per_s = SERVE_BATCH / (sum(ms) / len(ms) / 1e3)
    print(f"path serve_partition_prefill: err={errs[0]!r} floor={floor[0]!r} "
          f"dp_only_err={dp_only_err!r} ms={pre['ms']!r} mesh_free_ms={free_prefill_ms!r} "
          f"launches={pre['launches']} bytes={pre['bytes']} calls={pre['calls']}", flush=True)
    print(f"path serve_partition_cache_layers: {json.dumps(layer_errs)}", flush=True)
    print(f"path serve_partition_decode: errs={errs[1:]!r} floor={floor[1:]!r} "
          f"clear_agree={agree!r} ms={ms!r} mesh_free_ms={free_ms[1:]!r} "
          f"tokens_per_s={tokens_per_s!r} "
          f"mesh_free_tokens_per_s={SERVE_BATCH / (sum(free_ms[1:]) / SERVE_STEPS / 1e3)!r} "
          f"peak_gib={run['peak_gib']!r} mesh_free_peak_gib={free_peak!r}", flush=True)
    require(all(e[0] <= SERVE_BOUND for e in errs) and dp_only_err[0] <= SERVE_BOUND,
            f"serve partition: logits {errs}, dp_only {dp_only_err} against mesh-free "
            f"(bound {SERVE_BOUND})")
    require(all(a == n for a, n in agree),
            f"serve partition: a token differs where the top-2 margin exceeds "
            f"{SERVE_BOUND}: {agree}")
    layer = check_decode_attention_laid_out(torch, cfg, mesh)
    want = partitioned_serve_collectives(cfg, SERVE_SHAPE, "default", SERVE_BATCH,
                                         SERVE_PROMPT, SERVE_CACHE)
    for phase, got in [("prefill", pre)] + [("decode", st) for st in run["steps"]]:
        want_moved, want_calls = want[phase]
        require({k: got["bytes"][k] for k in want_moved} == want_moved
                and all(v == 0 for k, v in got["bytes"].items() if k not in want_moved),
                f"serve partition {phase}: bytes {got['bytes']}, want {want_moved}")
        require({k: got["calls"][k] for k in want_calls} == want_calls,
                f"serve partition {phase}: calls {got['calls']}, want {want_calls}")
        n_b6 = cfg.n_layers * n_coords if phase == "prefill" else 0
        for kern, n in got["launches"].items():
            require(n == (n_b6 if kern == "flash_attention" else 0),
                    f"serve partition {phase}: {kern} launched {n} times")
    specs = T.cache_specs(cfg, SERVE_BATCH, SERVE_CACHE, mesh=mesh)
    full = T.abstract_cache(cfg, SERVE_BATCH, SERVE_CACHE)
    for key, (spec, shapes) in run["cache"].items():
        require(spec == tuple(specs[key]), f"serve partition: cache {key} laid out {spec}")
        require(key == "pos" or all(int(np.prod(sh)) * n_coords == full[key].numel()
                                    for sh in shapes.values()),
                f"serve partition: cache {key} regions {shapes}, not 1/{n_coords} each")
    # one process holds every coordinate: its regions add up to the cache,
    # with no whole leaf alive behind them
    gib = {"cache_gib": run["held_gib"], "whole_cache_gib": sum(
        t.numel() * t.element_size() for t in full.values()) / 2 ** 30}
    require(all(abs(g - gib["whole_cache_gib"]) <= 1e-9 for g in run["held_gib"][1:]),
            f"serve partition: the cache holds {run['held_gib']} GiB")
    a = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": mesh.descriptor(),
         "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "cache_len": SERVE_CACHE,
         "prefill": {**pre, "err": errs[0], "floor": floor[0], "dp_only_err": dp_only_err,
                     "mesh_free_ms": free_prefill_ms,
                     "tokens_per_s": SERVE_BATCH * SERVE_PROMPT / (pre["ms"] / 1e3),
                     "mesh_free_tokens_per_s": SERVE_BATCH * SERVE_PROMPT
                     / (free_prefill_ms / 1e3)},
         "decode": {"ms": ms, "warmup_ms": run["steps"][0]["ms"],
                    "exchange_ms": [st["exchange_ms"] for st in run["steps"][1:]],
                    "errs": errs[1:], "floor": floor[1:], "tokens_per_s": tokens_per_s,
                    "mesh_free_ms": free_ms[1:], "mesh_free_warmup_ms": free_ms[0],
                    "bytes": run["steps"][1]["bytes"], "calls": run["steps"][1]["calls"]},
         "clear_agree": agree, "cache_layer_errs": layer_errs, "layer": layer,
         "peak_gib": run["peak_gib"], "mesh_free_peak_gib": free_peak, **gib}
    print(f"path serve_partition: {json.dumps(a)}", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    a["kernels"] = check_flash_partitioned(
        torch, SERVE_BATCH // SERVE_SHAPE[0], cfg.n_heads // SERVE_SHAPE[1], SERVE_PROMPT,
        cfg.head_dim, what="the partitioned prefill", backward=False)
    a["launches"] = run["prefill"]["launches"]

    # (b) two ranks on the card against the single process at 2 layers
    small = _partition_cfg(SERVE_PROC_LAYERS)
    single = _serve_digests(torch, small, mesh)
    t0 = time.perf_counter()
    env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    ranks = run_ranks([sys.executable, str(Path(__file__).resolve()), "--rank-case",
                       "serve", keep], SERVE_PROCS, timeout_s=PROC_SPAWN_S,
                      coordinator=f"127.0.0.1:{free_port()}", env=env)
    wall_s = time.perf_counter() - t0
    for r in ranks:
        require(r["logit_digests"] == single["logit_digests"]
                and r["cache_digests"] == single["cache_digests"],
                "serve partition ranks: the logits or the cache differ from the single "
                "process's")
        require(all(abs(g * SERVE_PROCS - w) <= 1e-6
                    for g, w in zip(r["held_gib"], single["held_gib"])),
                f"serve partition ranks: a rank holds {r['held_gib']} GiB of cache, the "
                f"single process {single['held_gib']}")
    def summary(r):
        return {"prefill_ms": r["prefill"]["ms"], "prefill_exchange_ms": r["prefill"]["exchange_ms"],
                "decode_ms": [st["ms"] for st in r["steps"]],
                "decode_exchange_ms": [st["exchange_ms"] for st in r["steps"]],
                "cache_gib": r["held_gib"], "peak_gib": r["peak_gib"]}

    b = {"processes": SERVE_PROCS, "layers": small.n_layers, "spawn_s": wall_s,
         "single": summary(single), "ranks": [summary(r) for r in ranks]}
    print(f"path serve_partition_ranks: {json.dumps(b)}", flush=True)
    return {"serve": a, "ranks": b}


# ---------------------------------------------------------------------------
# Phase 25: the partitioned MoE (laid-out experts, per coordinate)
# ---------------------------------------------------------------------------


def _pmoe_cfg(layers: int | None = None):
    from repro_torch.configs import get_arch

    cfg = get_arch(MESH_ARCH)
    return dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)


def _whole_grad(torch, laid, parts: dict):
    """A laid-out leaf's whole gradient from its coordinates' parts: each
    region the sum of its holders' parts, in coordinate order (plain
    PyTorch on the card, not a collective)."""
    whole = torch.zeros(laid.shape, dtype=torch.float32, device="cuda")
    for c, g in parts.items():
        if g is not None:
            whole[tuple(slice(lo, hi) for lo, hi in laid.region(c))] += g.float()
    return whole


def check_moe_block_laid_out(torch, mesh) -> dict:
    """Phase 25 (a): `moe_apply_laid_out` at full width (phase 19's block,
    B 4 x S 2048) against the region path `moe_apply` under the same mesh
    (phase 22's `_moe_fwd_bwd`) on the same bits: out, aux and z bitwise,
    the gradients of x and of every weight within PMOE_BLOCK_RTOL of their
    largest entry, the bytes and calls of the forward and backward equal
    to `moe_block_collectives`; both timed."""
    from repro_torch.launch.dryrun import moe_block_collectives
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import spec_tree
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.sharding import DEFAULT_RULES, Program, lay_out
    from repro_torch.tree import leaves_with_path

    dev = torch.device("cuda")
    cfg, params, x, ct = _moe_block(torch, dev)
    _moe_fwd_bwd(torch, mesh, cfg, params, x, ct)                  # warm-up
    t0 = time.perf_counter()
    ref = _moe_fwd_bwd(torch, mesh, cfg, params, x, ct)
    torch.cuda.synchronize()
    region_ms = (time.perf_counter() - t0) * 1e3
    laid = lay_out(params, _shardings(spec_tree(moe_mod.moe_params(cfg, MESH_HINT),
                                                DEFAULT_RULES, mesh), mesh))
    xs = col.distribute(x, ("data", None, None), mesh)
    prog = Program(mesh, DEFAULT_RULES, x.shape[0], x.shape[1])

    def run():
        (out, aux, z), entered = col.laid_out_region(
            lambda p, xx: moe_mod.moe_apply_laid_out(p, col.per_coord(xx), cfg, prog))(
                laid, xs)
        y = col.join(out, ("data", None, None), mesh)
        aux, z = col.join(aux, (), mesh), col.join(z, (), mesh)
        flat = leaves_with_path({"p": entered[0], "x": entered[1]})
        inputs = [t for _, leaf in flat for t in col.per_coord(leaf).values()]
        with col.backward_context(mesh):
            gs = iter(torch.autograd.grad((y.float() * ct).sum() + aux + z, inputs,
                                          allow_unused=True))
        grads = {k: _whole_grad(torch, leaf, {c: next(gs) for c in mesh.coords()})
                 for k, leaf in flat}
        return y.detach(), aux.detach(), z.detach(), grads

    col.reset_collective_bytes()
    y, aux, z, grads = run()
    moved, calls = col.collective_bytes(), col.collective_calls()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    laid_ms = (time.perf_counter() - t0) * 1e3
    names = {"x": "x", "p|router": "router", "p|wi": "wi", "p|wg": "wg", "p|wo": "wo",
             "p|shared|wi": "shared_wi", "p|shared|wg": "shared_wg",
             "p|shared|wo": "shared_wo"}
    errs = {}
    for key, g in grads.items():
        w = ref["grads"][names[key]].float()
        errs[names[key]] = float((g - w).abs().max()) / float(w.abs().max())
    want_moved, want_calls = moe_block_collectives(cfg, MESH_SHAPE, "default", x.shape[0],
                                                   x.shape[1], MESH_HINT, backward=True)
    out = {"bitwise": {"out": bool(torch.equal(y, ref["y"])),
                       "aux": bool(torch.equal(aux, ref["aux"])),
                       "z": bool(torch.equal(z, ref["z"]))},
           "grad_rel_err": errs, "bound": PMOE_BLOCK_RTOL, "ms": laid_ms,
           "region_ms": region_ms, "bytes": {k: v for k, v in moved.items() if v},
           "calls": {k: v for k, v in calls.items() if v}}
    print(f"path partition_moe_block: {json.dumps(out)}", flush=True)
    require(all(out["bitwise"].values()),
            f"partition moe block: not the region path's bits {out['bitwise']}")
    require(len(errs) == len(ref["grads"]) and all(e <= PMOE_BLOCK_RTOL for e in errs.values()),
            f"partition moe block: gradients {errs}")
    require({k: moved[k] for k in want_moved} == want_moved
            and all(v == 0 for k, v in moved.items() if k not in want_moved)
            and {k: calls[k] for k in want_calls} == want_calls,
            f"partition moe block: bytes {moved} calls {calls}, want {want_moved} "
            f"{want_calls}")
    del ref, laid, xs, params, x, ct, y, grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_partition_moe_train(torch, mesh) -> dict:
    """Phase 25 (b): qwen2-moe's partitioned AdamW step at full width (cut
    to PMOE_LAYERS) on (data 2, model 4) of cuda:0, against phase 19's
    global-view mesh step on the same weights and first batch (that step
    runs first, on the whole state, and is freed before the laid-out one
    is built)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.dryrun import partitioned_step_collectives
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import (DEFAULT_RULES, collective_bytes, collective_calls,
                                      reset_collective_bytes)
    from repro_torch.parallel.collectives import DistArray
    from repro_torch.parallel.sharding import lay_out
    from repro_torch.runtime.trainer import (TrainConfig, TrainState, init_state,
                                             make_train_step, state_shardings)
    from repro_torch.tree import leaves, tree_map

    dev = torch.device("cuda")
    cfg = _pmoe_cfg(PMOE_LAYERS)
    print(f"partition_moe: {cfg.name} cut to {cfg.n_layers} of 24 layers for the step "
          f"(phases 18b and 19: the whole state, AdamW's included, of 4 layers fits 80 GB "
          f"beside a step's activations)", flush=True)
    tcfg = TrainConfig(microbatches=TRAIN_MICRO, optimizer="adamw", warmup=1)
    n_coords = MESH_SHAPE[0] * MESH_SHAPE[1]
    gc.collect()
    torch.cuda.empty_cache()
    whole = init_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                       MESH_HINT)
    host = tree_map(lambda t: t.to("cpu"), whole.params)
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED, device=str(dev))
    first = stream.next()

    # the yardstick: the global-view step under the ambient mesh (the same
    # EP capacities, so the same drops), its first step's routes recorded,
    # then a step to time it beside
    routes, uninstall = _route_recorder(moe_mod)
    torch.cuda.reset_peak_memory_stats()
    mesh_step = make_train_step(cfg, tcfg, DEFAULT_RULES)
    try:
        with set_mesh(mesh):
            whole, ref, ref_first_ms = _timed_step(torch, mesh_step, whole, first)
            ref_routes = routes[:cfg.n_layers * n_coords]
            routes.clear()
            whole, _, ref_ms = _timed_step(torch, mesh_step, whole, stream.next())
    finally:
        uninstall()
    ref_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del whole, mesh_step
    gc.collect()
    torch.cuda.empty_cache()

    # the laid-out state: the same parameters, laid out region by region
    # from the host, AdamW's state made shard by shard
    shardings = state_shardings(cfg, tcfg, mesh, DEFAULT_RULES, MESH_HINT)
    params = lay_out(host, shardings.params)
    del host
    opt = adamw_init(params)
    opt = opt._replace(step=lay_out(opt.step, shardings.opt.step))
    state = TrainState(params, opt, lay_out(torch.zeros((), dtype=torch.int32),
                                            shardings.step))
    del params, opt
    step = make_train_step(cfg, tcfg)
    routes, uninstall = _route_recorder(moe_mod)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    reset_collective_bytes()
    try:
        state, m1, ms1 = _timed_step(torch, step, state, first)
    finally:
        uninstall()
    launches = kernels.launch_counts()
    moved, calls = collective_bytes(), collective_calls()
    agree, _ = _token_agreement(torch, routes[:cfg.n_layers * n_coords], ref_routes,
                                cfg.n_layers, mesh, TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ)
    del routes, ref_routes
    print(f"path partition_moe_first_step: loss={m1['loss']!r} mesh_loss={ref['loss']!r} "
          f"grad_norm={m1['grad_norm']!r} mesh_grad_norm={ref['grad_norm']!r} "
          f"grad_norm_gap={abs(m1['grad_norm'] - ref['grad_norm'])!r} aux={m1['aux']!r} "
          f"mesh_aux={ref['aux']!r} z={m1['z']!r} mesh_z={ref['z']!r} "
          f"route_agree_by_layer={agree!r} ms={ms1!r} mesh_ms={ref_first_ms!r} "
          f"launches={launches} bytes={moved} calls={calls}", flush=True)
    require(np.isfinite(m1["loss"]) and abs(m1["loss"] - ref["loss"])
            <= PMOE_RTOL * abs(ref["loss"]),
            f"partition moe: loss {m1['loss']} against the mesh step's {ref['loss']}")
    per_step = {"flash_attention": 2 * cfg.n_layers * TRAIN_MICRO * n_coords,
                "flash_attention_bwd": cfg.n_layers * TRAIN_MICRO * n_coords}
    for kern, n in launches.items():
        require(n == per_step.get(kern, 0),
                f"partition moe: {kern} launched {n} times, want {per_step.get(kern, 0)}")
    want_moved, want_calls = partitioned_step_collectives(
        cfg, MESH_SHAPE, "default", TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, MESH_HINT)
    require({k: moved[k] for k in want_moved} == want_moved
            and all(v == 0 for k, v in moved.items() if k not in want_moved),
            f"partition moe: bytes {moved}, want {want_moved}")
    require({k: calls[k] for k in want_calls} == want_calls,
            f"partition moe: calls {calls}, want {want_calls}")

    state, _, warm_ms = _timed_step(torch, step, state, stream.next())
    steps = []
    for _ in range(PMOE_STEPS):
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        state, m, ms = _timed_step(torch, step, state, stream.next())
        steps.append({"ms": ms, "loss": m["loss"], "aux": m["aux"],
                      "grad_norm": m["grad_norm"],
                      "alloc_retries": torch.cuda.memory_stats().get("num_alloc_retries", 0)
                      - retries})
        require(np.isfinite(m["loss"]), f"partition moe: loss {m['loss']}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for x, sh in zip(leaves(state), leaves(shardings)):
        require(isinstance(x, DistArray) and x.spec == tuple(sh.spec) and x.mesh is mesh,
                "partition moe: a state leaf is no longer laid out by its spec")
    held = _held_gib(torch, state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    ms = [st["ms"] for st in steps]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    return {"arch": cfg.name, "layers": cfg.n_layers, "mesh": mesh.descriptor(),
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatches": TRAIN_MICRO,
            "first_step": {"loss": m1["loss"], "grad_norm": m1["grad_norm"], "aux": m1["aux"],
                           "z": m1["z"], "ms": ms1, "mesh_loss": ref["loss"],
                           "mesh_grad_norm": ref["grad_norm"], "mesh_aux": ref["aux"],
                           "mesh_z": ref["z"], "mesh_ms": ref_first_ms,
                           "route_agree_by_layer": agree},
           "warmup_ms": warm_ms, "ms": ms, "tokens_per_s": tokens / (min(ms) / 1e3),
           "mesh_ms": ref_ms, "mesh_tokens_per_s": tokens / (ref_ms / 1e3),
           "steps": steps, "peak_gib": peak, "mesh_peak_gib": ref_peak, "state_gib": held,
           "launches": launches, "collective_bytes": moved, "collective_calls": calls}


def _token_agreement(torch, got: list, want: list, n_layers: int, mesh, batch: int,
                     seq: int):
    """(each layer's share, (batch, seq) bool at every layer) of the
    tokens whose top-k set is the same in both runs' routes (call by
    call, layer-major and coordinate-minor, each coordinate routing its
    region of the (batch, seq) tokens: its rows, and its slice of the
    sequence where `model` divides seq, else the whole sequence)."""
    from repro_torch.parallel.collectives import region_of

    spec = ("data", "model" if seq % mesh.shape["model"] == 0 else None)
    coords = mesh.coords()
    every = torch.ones((batch, seq), dtype=torch.bool, device=got[0].device)
    shares = []
    for layer in range(n_layers):
        same = torch.ones((batch, seq), dtype=torch.bool, device=got[0].device)
        for j, c in enumerate(coords):
            i = layer * len(coords) + j
            (b0, b1), (s0, s1) = region_of((batch, seq), spec, mesh, c)
            eq = (got[i].sort(-1).values == want[i].sort(-1).values).all(-1)
            same[b0:b1, s0:s1] &= eq.reshape(b1 - b0, s1 - s0)
        shares.append(float(same.float().mean()))
        every &= same
    return shares, every


def run_partition_moe_serve(torch, mesh) -> dict:
    """Phase 25 (c): qwen2-moe's partitioned prefill and decode at full
    width, cut to PMOE_SERVE_LAYERS, its parameters laid out by
    `param_specs` on (data 2, model 4) of cuda:0, against the global-view
    path under the same mesh
    on the same weights (run first, its logits and routes kept on the
    host, then freed): the prefill of PMOE_SERVE_BATCH x
    PMOE_SERVE_PROMPT, `pad_cache` to PMOE_SERVE_CACHE, a warm-up and
    PMOE_SERVE_STEPS decode steps fed the reference run's tokens; the
    logits within SERVE_BOUND on the tokens routed alike at every layer
    (phase 17's rule: the first layer's share at least
    MOE_ROUTE_AGREE_MIN, decode's pooled over its steps, and a token kept
    in the prefill and in decode), the argmax equal there where the top-2
    margin exceeds it; B6 8 x L times a prefill and never in decode; bytes and
    calls equal to `partitioned_serve_collectives`."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.launch.dryrun import partitioned_serve_collectives
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import moe as moe_mod, transformer as T
    from repro_torch.parallel.sharding import lay_out

    dev = torch.device("cuda")
    cfg = _pmoe_cfg(PMOE_SERVE_LAYERS)
    print(f"partition_moe_serve: {cfg.name} cut to {cfg.n_layers} of "
          f"{_pmoe_cfg().n_layers} layers for prefill and decode (the script's time, to "
          f"make room for phase 27)", flush=True)
    n_coords = MESH_SHAPE[0] * MESH_SHAPE[1]
    b, s, n = PMOE_SERVE_BATCH, PMOE_SERVE_PROMPT, PMOE_SERVE_CACHE
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    whole = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev, MESH_HINT)
    prompts = torch.from_numpy(np.random.default_rng([SEED, 25]).integers(
        0, cfg.vocab, (b, s))).cuda()

    # the global-view reference under the mesh: routes and logits to the host
    routes, uninstall = _route_recorder(moe_mod)
    try:
        with set_mesh(mesh):
            (logits, _, _, cache), ref_prefill_ms = timed(
                torch, lambda: T.prefill(whole, {"tokens": prompts}, cfg))
            ref_prefill_routes = [r.cpu() for r in routes]
            routes.clear()
            ref_logits = logits.cpu()
            tok = torch.argmax(logits[:, -1], -1)
            del logits
            pad = (0, 0, 0, 0, 0, n - s)
            cache = {"k": F.pad(cache["k"], pad), "v": F.pad(cache["v"], pad),
                     "pos": cache["pos"]}
            fed, ref_steps, ref_step_routes, ref_ms = [], [], [], []
            for _ in range(1 + PMOE_SERVE_STEPS):
                fed.append(tok)
                (lg, cache), ms = timed(torch, lambda: T.decode_step(whole, cache, tok, cfg))
                ref_steps.append(lg.cpu())
                ref_step_routes.append([r.cpu() for r in routes])
                routes.clear()
                ref_ms.append(ms)
                tok = torch.argmax(lg, -1)
    finally:
        uninstall()
    ref_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del cache, lg
    gc.collect()
    torch.cuda.empty_cache()
    params = lay_out(whole, _shardings(T.param_specs(cfg, mesh=mesh, model_size_hint=MESH_HINT),
                                       mesh))
    del whole
    gc.collect()
    torch.cuda.empty_cache()

    # the partitioned run, counted and timed, its routes recorded
    torch.cuda.reset_peak_memory_stats()
    routes, uninstall = _route_recorder(moe_mod)
    try:
        run = _serve_laid_out(torch, cfg, params, prompts, fed, cache_len=n)
    finally:
        uninstall()
    calls_a_prefill = cfg.n_layers * n_coords
    got_prefill, got_steps = routes[:calls_a_prefill], routes[calls_a_prefill:]
    shares, keep = _token_agreement(torch, got_prefill,
                                    [r.cuda() for r in ref_prefill_routes], cfg.n_layers,
                                    mesh, b, s)
    first = shares[0]
    errs, agree, kept = [], [], []
    logits = run.pop("prefill_logits")
    for row in range(b):
        got, want = logits[row], ref_logits[row].cuda()
        d = (got.float() - want.float()).abs().amax(-1)
        errs.append(float(d[keep[row]].max()) if bool(keep[row].any()) else 0.0)
        a, c = _clear_agree(got[keep[row]], want[keep[row]])
        agree.append((a, c))
    kept.append(int(keep.sum()))
    prefill_err = max(errs)
    prefill_agree = (sum(a for a, _ in agree), sum(c for _, c in agree))
    del logits, ref_logits
    step_errs, step_agree, step_first = [], [], []
    per_step = cfg.n_layers * n_coords
    for i, (lg, want) in enumerate(zip(run.pop("step_logits"), ref_steps)):
        want = want.cuda()
        f, k = _token_agreement(torch, got_steps[i * per_step:(i + 1) * per_step],
                                [r.cuda() for r in ref_step_routes[i]], cfg.n_layers, mesh, b, 1)
        k = k[:, 0]
        step_first.append(f[0])
        kept.append(int(k.sum()))
        d = (lg.float() - want.float()).abs().amax(-1)
        step_errs.append(float(d[k].max()) if bool(k.any()) else 0.0)
        step_agree.append(_clear_agree(lg[k], want[k]))
    pre = run["prefill"]
    ms = [st["ms"] for st in run["steps"][1:]]
    out = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": mesh.descriptor(), "batch": b,
           "prompt": s, "cache_len": n,
           "prefill": {"ms": pre["ms"], "mesh_ms": ref_prefill_ms, "err": prefill_err,
                       "agree_by_layer": shares, "tokens_kept": kept[0],
                       "clear_agree": prefill_agree, "launches": pre["launches"],
                       "bytes": pre["bytes"], "calls": pre["calls"]},
           "decode": {"ms": ms, "warmup_ms": run["steps"][0]["ms"], "mesh_ms": ref_ms[1:],
                      "mesh_warmup_ms": ref_ms[0], "errs": step_errs,
                      "first_layer_agree": step_first, "tokens_kept": kept[1:],
                      "clear_agree": step_agree, "bytes": run["steps"][1]["bytes"],
                      "calls": run["steps"][1]["calls"]},
           "bound": SERVE_BOUND, "peak_gib": run["peak_gib"], "mesh_peak_gib": ref_peak,
           "cache_gib": run["held_gib"]}
    print(f"path partition_moe_serve: {json.dumps(out)}", flush=True)
    # decode checks B tokens a step: pooled over the steps, as phase 17 pools
    step_share = sum(step_first) / len(step_first)
    out["decode"]["first_layer_agree_pooled"] = step_share
    require(first >= MOE_ROUTE_AGREE_MIN and step_share >= MOE_ROUTE_AGREE_MIN
            and kept[0] > 0 and sum(kept[1:]) > 0,
            f"partition moe serve: first layer's route agreement {first} {step_share} "
            f"(< {MOE_ROUTE_AGREE_MIN}) or no token routed alike at every layer {kept}")
    require(prefill_err <= SERVE_BOUND and all(e <= SERVE_BOUND for e in step_errs),
            f"partition moe serve: logits {prefill_err} {step_errs} on the tokens routed "
            f"alike (bound {SERVE_BOUND})")
    require(prefill_agree[0] == prefill_agree[1] and all(a == c for a, c in step_agree),
            f"partition moe serve: a token differs where the top-2 margin exceeds "
            f"{SERVE_BOUND}: {prefill_agree} {step_agree}")
    want = partitioned_serve_collectives(cfg, MESH_SHAPE, "default", b, s, n, MESH_HINT)
    for phase, got in [("prefill", pre)] + [("decode", st) for st in run["steps"]]:
        want_moved, want_calls = want[phase]
        require({k: got["bytes"][k] for k in want_moved} == want_moved
                and all(v == 0 for k, v in got["bytes"].items() if k not in want_moved),
                f"partition moe serve {phase}: bytes {got['bytes']}, want {want_moved}")
        require({k: got["calls"][k] for k in want_calls} == want_calls,
                f"partition moe serve {phase}: calls {got['calls']}, want {want_calls}")
        n_b6 = calls_a_prefill if phase == "prefill" else 0
        for kern, cnt in got["launches"].items():
            require(cnt == (n_b6 if kern == "flash_attention" else 0),
                    f"partition moe serve {phase}: {kern} launched {cnt} times")
    out["launches"] = pre["launches"]
    del params, run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _pmoe_digests(torch, mesh) -> dict:
    """Phase 25 (d)'s run of qwen2-moe cut to PMOE_PROC_LAYERS on `mesh`
    (one process's, or this rank's part of one that spans processes):
    PMOE_PROC_STEPS AdamW steps of PMOE_PROC_BATCH x 2048 tokens on a laid-out state,
    then on its parameters a prefill of PMOE_SERVE_BATCH x
    PMOE_PROC_PROMPT and PMOE_PROC_DECODE decode steps fed their argmax
    over a PMOE_PROC_CACHE-slot cache: losses, digests, state and cache
    GiB held."""
    import numpy as np

    cfg = _pmoe_cfg(PMOE_PROC_LAYERS)
    out = _partition_steps(torch, cfg, mesh, PMOE_PROC_STEPS, MESH_HINT, keep_state=True,
                           batch=PMOE_PROC_BATCH)
    state = out.pop("state")
    # after a step the f32 router's parameter is its AdamW master (the
    # update's cast to its own dtype returns the master itself): held once
    out["held_gib"], out["own_gib"] = _held_gib(torch, state), _own_gib(state)
    router = state.params["layers"]["moe"]["router"]
    out["aliased_gib"] = sum(t.numel() * t.element_size() for t in
                             {id(t): t for t in router.shards.values()}.values()) / 2 ** 30
    params = state.params
    del state
    prompts = torch.from_numpy(np.random.default_rng([SEED, 25]).integers(
        0, cfg.vocab, (PMOE_SERVE_BATCH, PMOE_PROC_PROMPT))).cuda()
    torch.cuda.reset_peak_memory_stats()
    serve = _serve_laid_out(torch, cfg, params, prompts, steps=PMOE_PROC_DECODE,
                            cache_len=PMOE_PROC_CACHE)
    out["logit_digests"] = [_digest(torch, t) for t in
                            [serve.pop("prefill_logits")] + serve.pop("step_logits")]
    out["cache_digests"] = serve["cache_digests"]
    out["cache_gib"] = serve["held_gib"]
    out["serve_peak_gib"] = serve["peak_gib"]
    out["prefill_ms"] = serve["prefill"]["ms"]
    out["decode_ms"] = [st["ms"] for st in serve["steps"]]
    del params, serve
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_partition_moe(torch, keep: str) -> dict:
    """Phase 25: the partitioned MoE on (data 2, model 4) of cuda:0: (a)
    the block alone against the region path, (b) the AdamW step against
    the global-view mesh step, (c) prefill and decode against the global
    view; (d) two ranks on the card against the single process (module
    docstring)."""
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.launch.procs import free_port, run_ranks

    mesh = make_worker_mesh(MESH_SHAPE, devices=["cuda:0"] * (MESH_SHAPE[0] * MESH_SHAPE[1]))
    out = {"block": check_moe_block_laid_out(torch, mesh)}
    out["train"] = run_partition_moe_train(torch, mesh)
    print(f"path partition_moe_train: {json.dumps(out['train'])}", flush=True)
    out["serve"] = run_partition_moe_serve(torch, mesh)

    # (d) two ranks on the card against the single process at 1 layer
    single = _pmoe_digests(torch, mesh)
    t0 = time.perf_counter()
    env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    ranks = run_ranks([sys.executable, str(Path(__file__).resolve()), "--rank-case", "moe",
                       keep], PMOE_PROCS, timeout_s=PROC_SPAWN_S,
                      coordinator=f"127.0.0.1:{free_port()}", env=env)
    wall_s = time.perf_counter() - t0
    for r in ranks:
        require(r["losses"] == single["losses"] and r["digests"] == single["digests"]
                and r["logit_digests"] == single["logit_digests"]
                and r["cache_digests"] == single["cache_digests"],
                f"partition moe ranks: losses {r['losses']} against the single process's "
                f"{single['losses']}, or the parameters, logits or cache differ")
        # a rank's state is its coordinates' regions: its half of the experts
        # and the rest split over `data`, the leaves whole along `data`
        # (shared experts, router, norms, counters) once a process
        require(abs(r["held_gib"] - (r["own_gib"] - r["aliased_gib"])) <= 1e-9
                and r["state_gib"] < single["state_gib"]
                and all(abs(g * PMOE_PROCS - w) <= 1e-6
                        for g, w in zip(r["cache_gib"], single["cache_gib"])),
                f"partition moe ranks: a rank holds {r['held_gib']} GiB of state (its "
                f"regions {r['own_gib']}) and {r['cache_gib']} of cache, the single process "
                f"{single['state_gib']} and {single['cache_gib']}")

    def summary(r):
        return {k: r[k] for k in ("losses", "wall_ms", "exchange_ms", "state_gib", "own_gib",
                                  "peak_gib", "cache_gib", "serve_peak_gib", "prefill_ms",
                                  "decode_ms", "rank_s") if k in r}

    out["ranks"] = {"processes": PMOE_PROCS, "layers": PMOE_PROC_LAYERS, "spawn_s": wall_s,
                    "single": summary(single), "ranks": [summary(r) for r in ranks]}
    print(f"path partition_moe_ranks: {json.dumps(out['ranks'])}", flush=True)
    cfg = _pmoe_cfg()
    out["kernels"] = check_flash_partitioned(
        torch, TRAIN_BATCH // TRAIN_MICRO // MESH_SHAPE[0], cfg.n_heads // MESH_SHAPE[1],
        TRAIN_SEQ, cfg.head_dim, what="the partitioned MoE step")
    return out


# ---------------------------------------------------------------------------
# Phase 26: the partitioned SSM and hybrid bodies (SSD heads per coordinate)
# ---------------------------------------------------------------------------


def _pssm_cfg(name: str, layers: int | None = None):
    from repro_torch.configs import get_arch

    cfg = get_arch(name)
    return dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)


def check_ssm_block_laid_out(torch, mesh, cfg) -> dict:
    """Phase 26 (a): `ssm_apply_laid_out` at full width (B 4 x S 2048)
    against `ssm_apply` on the same bits (seeded weights, input and output
    cotangent): the output, the state (h on each coordinate's SSD heads,
    the conv state) and the gradients of x and of every weight within
    PSSM_BLOCK_RTOL of their largest entry, the forward's and backward's
    bytes and calls equal to `ssm_block_collectives`; both timed (a
    forward and backward, after one warm-up)."""
    from repro_torch.launch.dryrun import ssm_block_collectives
    from repro_torch.models import ssm as ssm_mod, transformer as T
    from repro_torch.models.layers import init_tree, spec_tree
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.sharding import DEFAULT_RULES, Program, lay_out
    from repro_torch.tree import leaves, leaves_with_path, unflatten

    dev = torch.device("cuda")
    b, s = PSSM_BLOCK_BATCH, PSSM_BLOCK_SEQ
    gen = torch.Generator(device=dev).manual_seed(SEED)
    defs = ssm_mod.ssm_params(cfg)
    params = init_tree(defs, gen, dev)
    x = torch.randn(b, s, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
    ct = torch.randn(b, s, cfg.d_model, generator=gen, device=dev)

    def free():
        flat = [t.detach().requires_grad_() for t in leaves(params)] + [
            x.detach().requires_grad_()]
        y, st = ssm_mod.ssm_apply(unflatten(params, flat[:-1]), flat[-1], cfg)
        grads = torch.autograd.grad((y.float() * ct).sum(), flat)
        return y.detach(), st.h.detach(), st.conv.detach(), grads

    free()                                                       # warm-up
    (y_ref, h_ref, conv_ref, g_ref), free_ms = timed(torch, free)
    names = [k for k, _ in leaves_with_path(params)] + ["x"]
    g_ref = dict(zip(names, g_ref))
    laid = lay_out(params, _shardings(spec_tree(defs, DEFAULT_RULES, mesh), mesh))
    xs = col.distribute(x, ("data", None, None), mesh)
    prog = Program(mesh, DEFAULT_RULES, b, s)
    h_spec = T.cache_specs(cfg, b, s, DEFAULT_RULES, mesh)["ssm_h"][1:]

    def run():
        (out, st), entered = col.laid_out_region(
            lambda p, xx: ssm_mod.ssm_apply_laid_out(p, col.per_coord(xx), cfg, prog))(
                laid, xs)
        y = col.join(out, ("data", None, None), mesh)
        h, conv = col.join(st.h, h_spec, mesh), col.join(st.conv, ("data", None, None), mesh)
        flat = leaves_with_path({"p": entered[0], "x": entered[1]})
        inputs = [t for _, leaf in flat for t in col.per_coord(leaf).values()]
        with col.backward_context(mesh):
            gs = iter(torch.autograd.grad((y.float() * ct).sum(), inputs, allow_unused=True))
        grads = {k.removeprefix("p|"): _whole_grad(torch, leaf, {c: next(gs)
                                                                  for c in mesh.coords()})
                 for k, leaf in flat}
        return y.detach(), h.detach(), conv.detach(), grads

    col.reset_collective_bytes()
    y, h, conv, grads = run()
    moved, calls = col.collective_bytes(), col.collective_calls()
    _, laid_ms = timed(torch, run)

    def rel(got, want):
        return float((got.float() - want.float()).abs().max()) / float(
            want.float().abs().max())

    errs = {"out": rel(y, y_ref), "ssm_h": rel(h, h_ref), "ssm_conv": rel(conv, conv_ref),
            **{f"grad_{k}": rel(g, g_ref[k]) for k, g in grads.items()}}
    _, n_h, _, _, _ = ssm_mod._dims(cfg)
    h_loc = n_h // MESH_SHAPE[1] if h_spec[1] else n_h
    want_moved, want_calls = ssm_block_collectives(cfg, MESH_SHAPE, "default", b, s,
                                                   backward=True)
    out = {"arch": cfg.name, "batch": b, "seq": s, "ssd_heads": n_h,
           "heads_a_coordinate": h_loc,
           "rel_err": errs, "bound": PSSM_BLOCK_RTOL, "ms": laid_ms, "mesh_free_ms": free_ms,
           "bytes": {k: v for k, v in moved.items() if v},
           "calls": {k: v for k, v in calls.items() if v}}
    print(f"path partition_ssm_block {cfg.name}: {json.dumps(out)}", flush=True)
    require(len(grads) == len(g_ref) and all(e <= PSSM_BLOCK_RTOL for e in errs.values()),
            f"partition ssm block {cfg.name}: {errs}")
    require({k: moved[k] for k in want_moved} == want_moved
            and all(v == 0 for k, v in moved.items() if k not in want_moved)
            and {k: calls[k] for k in want_calls} == want_calls,
            f"partition ssm block {cfg.name}: bytes {moved} calls {calls}, want "
            f"{want_moved} {want_calls}")
    del laid, xs, params, x, ct, y, h, conv, grads, g_ref, y_ref, h_ref, conv_ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_partitioned_step(torch, mesh, cfg, cut_from: int, tag: str, why: str) -> dict:
    """Phases 26 (b) and 27 (a): the partitioned AdamW step of `cfg` (cut
    from `cut_from` layers, for the reason `why`, printed) on (data 2,
    model 4) of cuda:0 against a mesh-free step on the same weights and
    first batch (`TokenStream`'s: tokens, audio's frames and mask, the
    VLM's patch stubs and text): the loss within PSSM_RTOL, the grad
    norm's gap printed, B6 32 x L and B6-bwd 16 x L launches a step with
    attention (none without), bytes and calls equal to
    `partitioned_step_collectives`, PSSM_STEPS timed steps after that
    first one (their warm-up), every state leaf still a DistArray of its
    spec; the mesh-free yardstick's second step is its warm time. Audio's
    token table, which no loss reads, gets a zero gradient at every
    coordinate, and its masters after the second step are the mesh-free
    step's bits: the weight decay alone moves them. `tag` names the
    printed lines and failures."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.dryrun import partitioned_step_collectives
    from repro_torch.parallel import collective_bytes, collective_calls, reset_collective_bytes
    from repro_torch.parallel.collectives import DistArray, gather
    from repro_torch.parallel.sharding import lay_out
    from repro_torch.runtime.trainer import (TrainConfig, init_state, make_train_step,
                                             state_shardings)
    from repro_torch.tree import leaves

    dev = torch.device("cuda")
    n_coords = MESH_SHAPE[0] * MESH_SHAPE[1]
    if cfg.n_layers < cut_from:
        print(f"{tag}: {cfg.name} cut to {cfg.n_layers} of {cut_from} layers for the step "
              f"({why})", flush=True)
    tcfg = TrainConfig(microbatches=TRAIN_MICRO, optimizer="adamw", warmup=1)
    gc.collect()
    torch.cuda.empty_cache()
    whole = init_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    shardings = state_shardings(cfg, tcfg, mesh)
    state = lay_out(whole, shardings)
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED, device=str(dev))
    first = stream.next()
    torch.cuda.reset_peak_memory_stats()
    # the mesh-free step on the same weights and batch (it consumes `whole`),
    # then one more on the next batch, timed warm
    free_step = make_train_step(cfg, tcfg)
    whole, free, free_first_ms = _timed_step(torch, free_step, whole, first)
    whole, _, free_ms = _timed_step(torch, free_step, whole, stream.next())
    free_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    audio = cfg.family == "audio"
    if audio:       # the token table no loss reads: its masters after two steps
        free_embed = whole.opt.master["embed"].clone()
        init_embed = gather(state.opt.master["embed"])
    del whole, free_step
    gc.collect()
    torch.cuda.empty_cache()
    step = make_train_step(cfg, tcfg)
    kernels.reset_launch_counts()
    reset_collective_bytes()
    torch.cuda.reset_peak_memory_stats()
    state, m1, ms1 = _timed_step(torch, step, state, first)
    launches = kernels.launch_counts()
    moved, calls = collective_bytes(), collective_calls()
    gap = abs(m1["grad_norm"] - free["grad_norm"])
    if audio:
        require(all(not bool(t.any()) for t in state.opt.m["embed"].shards.values()),
                f"{tag} {cfg.name}: the token table, which no loss reads, has a gradient")
    print(f"path {tag}_first_step {cfg.name}: loss={m1['loss']!r} "
          f"mesh_free_loss={free['loss']!r} grad_norm={m1['grad_norm']!r} "
          f"mesh_free_grad_norm={free['grad_norm']!r} grad_norm_gap={gap!r} ms={ms1!r} "
          f"mesh_free_first_ms={free_first_ms!r} mesh_free_ms={free_ms!r} "
          f"launches={launches} bytes={moved} calls={calls}",
          flush=True)
    require(np.isfinite(m1["loss"]) and abs(m1["loss"] - free["loss"])
            <= PSSM_RTOL * abs(free["loss"]),
            f"{tag} {cfg.name}: loss {m1['loss']} against mesh-free {free['loss']}")
    per_step = ({} if cfg.attn_free else
                {"flash_attention": 2 * cfg.n_layers * TRAIN_MICRO * n_coords,
                 "flash_attention_bwd": cfg.n_layers * TRAIN_MICRO * n_coords})
    for kern, n in launches.items():
        require(n == per_step.get(kern, 0),
                f"{tag} {cfg.name}: {kern} launched {n} times, want {per_step.get(kern, 0)}")
    want_moved, want_calls = partitioned_step_collectives(cfg, MESH_SHAPE, "default",
                                                          TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO)
    require({k: moved[k] for k in want_moved} == want_moved
            and all(v == 0 for k, v in moved.items() if k not in want_moved)
            and {k: calls[k] for k in want_calls} == want_calls,
            f"{tag} {cfg.name}: bytes {moved} calls {calls}, want {want_moved} {want_calls}")
    # the first step is the warm-up of the timed ones (the mesh-free yardstick
    # read the first batch; these read the batches after the second)
    steps = []
    for i in range(PSSM_STEPS):
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        state, m, ms = _timed_step(torch, step, state, stream.next())
        steps.append({"ms": ms, "loss": m["loss"], "grad_norm": m["grad_norm"],
                      "alloc_retries": torch.cuda.memory_stats().get("num_alloc_retries", 0)
                      - retries})
        require(np.isfinite(m["loss"]), f"{tag} {cfg.name}: loss {m['loss']}")
        if audio and i == 0:      # the second step: the weight decay's first move
            laid_embed = gather(state.opt.master["embed"])
            require(torch.equal(laid_embed, free_embed)
                    and not torch.equal(laid_embed, init_embed),
                    f"{tag} {cfg.name}: the token table's masters after two steps are not "
                    f"the mesh-free step's (the weight decay alone)")
            del laid_embed, free_embed, init_embed
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for x, sh in zip(leaves(state), leaves(shardings)):
        require(isinstance(x, DistArray) and x.spec == tuple(sh.spec) and x.mesh is mesh,
                f"{tag} {cfg.name}: a state leaf is no longer laid out by its spec")
    held = _held_gib(torch, state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    ms = [st["ms"] for st in steps]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    return {"arch": cfg.name, "layers": cfg.n_layers, "mesh": mesh.descriptor(),
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatches": TRAIN_MICRO,
            "first_step": {"loss": m1["loss"], "grad_norm": m1["grad_norm"], "ms": ms1,
                           "mesh_free_loss": free["loss"],
                           "mesh_free_grad_norm": free["grad_norm"], "grad_norm_gap": gap,
                           "mesh_free_ms": free_first_ms},
            "ms": ms, "tokens_per_s": tokens / (min(ms) / 1e3), "mesh_free_ms": free_ms,
            "mesh_free_tokens_per_s": tokens / (free_ms / 1e3), "steps": steps,
            "peak_gib": peak, "mesh_free_peak_gib": free_peak, "state_gib": held,
            "launches": launches, "collective_bytes": moved, "collective_calls": calls}


def _layer0_k(cache: dict) -> dict:
    """Phase 26 (c)'s probe of the rolling cache: layer 0's k at each of
    this process's coordinates, cloned (none without attention)."""
    return {c: t[0].clone() for c, t in cache["k"].shards.items()} if "k" in cache else {}


def run_partition_ssm_serve(torch, mesh, cfg) -> dict:
    """Phase 26 (c): the partitioned prefill and decode of `cfg` at full
    width and depth, its parameters laid out by `param_specs` on (data 2,
    model 4) of cuda:0, against the mesh-free path on the same weights
    (run first): a prefill of PSSM_SERVE's batch x prompt, `pad_cache` to
    its cache length, a warm-up and PSSM_SERVE_STEPS decode steps fed the
    mesh-free run's tokens; the logits within SERVE_BOUND and the argmax
    equal where the mesh-free top-2 margin exceeds it; the prefill's
    logits under dp_only beside, and the prompt's state (k, v, ssm_h,
    ssm_conv) layer by layer under both rules; B6 8 x L launches a
    prefill with attention and none in decode; bytes and calls equal to
    `partitioned_serve_collectives`. hymba's cache is the window's 1024
    slots, filled by the prompt: every step writes slot pos % 1024, in the
    first `model` coordinate's slice, which no other step touches."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.launch.dryrun import RULES_VARIANTS, partitioned_serve_collectives
    from repro_torch.models import transformer as T
    from repro_torch.parallel.collectives import gather
    from repro_torch.parallel.sharding import lay_out

    b, s, n = PSSM_SERVE[cfg.name]
    n_coords = MESH_SHAPE[0] * MESH_SHAPE[1]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    whole, params = _laid_out_params(torch, cfg, mesh)
    prompts = torch.from_numpy(np.random.default_rng([SEED, 26]).integers(
        0, cfg.vocab, (b, s))).cuda()
    batch = {"tokens": prompts}
    state_keys = [k for k in ("k", "v", "ssm_h", "ssm_conv") if k in T.cache_specs(cfg, b, n)]

    # the mesh-free path: prefill (a warm-up, then timed), its prompt state
    # kept, the cache padded, a warm-up step and PSSM_SERVE_STEPS steps
    T.prefill(whole, batch, cfg)
    (free_logits, _, _, cache), free_prefill_ms = timed(torch, lambda: T.prefill(whole, batch,
                                                                                cfg))
    prompt_state = {k: cache[k].clone() for k in state_keys}
    if "k" in cache:
        slots = T.abstract_cache(cfg, b, n)["k"].shape[2]
        pad = (0, 0, 0, 0, 0, slots - s)
        cache = {**cache, "k": F.pad(cache["k"], pad), "v": F.pad(cache["v"], pad)}
    tok = torch.argmax(free_logits[:, -1], -1)
    fed, free_steps, free_ms = [], [], []
    for _ in range(1 + PSSM_SERVE_STEPS):
        fed.append(tok)
        (lg, cache), ms = timed(torch, lambda: T.decode_step(whole, cache, tok, cfg))
        free_steps.append(lg)
        free_ms.append(ms)
        tok = torch.argmax(lg, -1)
    free_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del cache

    # the prompt's state layer by layer under the default rules (the
    # warm-up of the counted run) and under dp_only, with dp_only's logits
    layer_errs = {}
    for rname, laid in (("default", params), ("dp_only", None)):
        rules = RULES_VARIANTS[rname]
        if laid is None:
            laid = lay_out(whole, _shardings(T.param_specs(cfg, rules, mesh), mesh))
        logits, _, _, got = T.prefill(laid, batch, cfg, rules)
        if rname == "dp_only":
            dp_only_err = _logit_errs(logits, free_logits)
        del logits, laid
        layer_errs[rname] = {
            k: [max_abs(t, w) / float(w.float().abs().max())
                for t, w in zip(gather(got[k]), prompt_state[k])] for k in state_keys}
        del got
        gc.collect()
        torch.cuda.empty_cache()
    del whole, prompt_state
    gc.collect()
    torch.cuda.empty_cache()

    # the partitioned path: the counted and timed run
    torch.cuda.reset_peak_memory_stats()
    run = _serve_laid_out(torch, cfg, params, prompts, fed, cache_len=n,
                          probe=_layer0_k)
    pairs = [(run.pop("prefill_logits"), free_logits)] + list(zip(run.pop("step_logits"),
                                                                   free_steps))
    errs = [_logit_errs(got, want) for got, want in pairs]
    agree = [_clear_agree(got, want) for got, want in pairs]
    del pairs, free_logits, free_steps
    pre = run["prefill"]
    ms = [st["ms"] for st in run["steps"][1:]]
    out = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": mesh.descriptor(), "batch": b,
           "prompt": s, "cache_len": n,
           "prefill": {"ms": pre["ms"], "mesh_free_ms": free_prefill_ms, "err": errs[0],
                       "dp_only_err": dp_only_err, "clear_agree": agree[0],
                       "launches": pre["launches"], "bytes": pre["bytes"],
                       "calls": pre["calls"]},
           "decode": {"ms": ms, "warmup_ms": run["steps"][0]["ms"],
                      "mesh_free_ms": free_ms[1:], "mesh_free_warmup_ms": free_ms[0],
                      "errs": errs[1:], "clear_agree": agree[1:],
                      "tokens_per_s": b / (sum(ms) / len(ms) / 1e3),
                      "mesh_free_tokens_per_s": b / (sum(free_ms[1:]) / len(ms) / 1e3),
                      "bytes": run["steps"][1]["bytes"], "calls": run["steps"][1]["calls"]},
           "state_layer_rel_err": layer_errs, "bound": SERVE_BOUND,
           "peak_gib": run["peak_gib"], "mesh_free_peak_gib": free_peak,
           "cache_gib": run["held_gib"]}
    before, after = run.pop("probe")
    if before:
        # the rolling cache: slot (s + i) % n of step i, in the first slice
        written = [(s + i) % n for i in range(1 + PSSM_SERVE_STEPS)]
        s_loc = n // MESH_SHAPE[1]
        first_slice = [c for c in before if c[1] == 0]
        out["rolling"] = {"slots_written": written, "slice_slots": s_loc}
        require(max(written) < s_loc and all(
            not torch.equal(after[c][:, j], before[c][:, j]) for c in first_slice
            for j in written) and all(
            torch.equal(after[c][:, j], before[c][:, j]) for c in first_slice
            for j in range(s_loc) if j not in written) and all(
            torch.equal(after[c], before[c]) for c in before if c[1] != 0),
            f"partition ssm serve {cfg.name}: the rolling cache's rows did not land in "
            f"slots {written} of the first slice alone")
    del before, after
    print(f"path partition_ssm_serve {cfg.name}: {json.dumps(out)}", flush=True)
    require(all(e[0] <= SERVE_BOUND for e in errs) and dp_only_err[0] <= SERVE_BOUND,
            f"partition ssm serve {cfg.name}: logits {errs}, dp_only {dp_only_err} "
            f"against mesh-free (bound {SERVE_BOUND})")
    require(all(a == c for a, c in agree),
            f"partition ssm serve {cfg.name}: a token differs where the top-2 margin "
            f"exceeds {SERVE_BOUND}: {agree}")
    want = partitioned_serve_collectives(cfg, MESH_SHAPE, "default", b, s, n)
    n_b6 = 0 if cfg.attn_free else cfg.n_layers * n_coords
    for phase, got in [("prefill", pre)] + [("decode", st) for st in run["steps"]]:
        want_moved, want_calls = want[phase]
        require({k: got["bytes"][k] for k in want_moved} == want_moved
                and all(v == 0 for k, v in got["bytes"].items() if k not in want_moved)
                and {k: got["calls"][k] for k in want_calls} == want_calls,
                f"partition ssm serve {cfg.name} {phase}: bytes {got['bytes']} calls "
                f"{got['calls']}, want {want_moved} {want_calls}")
        for kern, cnt in got["launches"].items():
            want_n = n_b6 if phase == "prefill" and kern == "flash_attention" else 0
            require(cnt == want_n, f"partition ssm serve {cfg.name} {phase}: {kern} "
                                   f"launched {cnt} times, want {want_n}")
    out["launches"] = pre["launches"]
    del params, run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_partition_ssm(torch) -> dict:
    """Phase 26: the partitioned SSM and hybrid bodies on (data 2, model 4)
    of cuda:0 (module docstring): (a) the block alone, (b) the AdamW
    steps, (c) prefill and decode, of hymba-1.5b and mamba2-130m; B6 and
    B6-bwd at hymba's coordinate shape."""
    from repro_torch.launch.mesh import make_worker_mesh

    mesh = make_worker_mesh(MESH_SHAPE, devices=["cuda:0"] * (MESH_SHAPE[0] * MESH_SHAPE[1]))
    out = {"block": {}, "train": {}, "serve": {}}
    for name in PSSM_ARCHS:
        out["block"][name] = check_ssm_block_laid_out(torch, mesh, _pssm_cfg(name))
    for name in PSSM_ARCHS:
        full = _pssm_cfg(name)
        cfg = _pssm_cfg(name, PSSM_LAYERS[name])
        out["train"][name] = run_partitioned_step(torch, mesh, cfg, full.n_layers,
                                                  "partition_ssm", PSSM_CUT_WHY[name])
        print(f"path partition_ssm_train {name}: {json.dumps(out['train'][name])}", flush=True)
    for name in PSSM_ARCHS:
        cfg = _pssm_cfg(name, PSSM_SERVE_LAYERS[name])
        full = _pssm_cfg(name)
        if cfg.n_layers < full.n_layers:
            print(f"partition_ssm_serve: {name} cut to {cfg.n_layers} of {full.n_layers} "
                  f"layers for prefill and decode (the script's time, to make room for "
                  f"phase 27)", flush=True)
        out["serve"][name] = run_partition_ssm_serve(torch, mesh, cfg)
    cfg = _pssm_cfg("hymba-1.5b")
    out["kernels"] = check_flash_partitioned(
        torch, TRAIN_BATCH // TRAIN_MICRO // MESH_SHAPE[0], cfg.n_heads, TRAIN_SEQ,
        cfg.head_dim, what="the partitioned hybrid step", kv=cfg.n_kv_heads,
        window=cfg.sliding_window)
    return out


# ---------------------------------------------------------------------------
# Phase 27: the partitioned audio and VLM bodies (hubert's frames, phi-3-vision's patches)
# ---------------------------------------------------------------------------


def _pfront_cfg(name: str, layers: int | None = None):
    from repro_torch.configs import get_arch

    cfg = get_arch(name)
    return dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)


def run_partition_frontend_serve(torch, mesh, cfg) -> dict:
    """Phase 27 (b): the partitioned prefill of `cfg` at full width and
    depth, its parameters laid out by `param_specs` on (data 2, model 4)
    of cuda:0, against the mesh-free path on the same weights and batch
    (run first; hubert's the `forward` of phase 17b's lm_forward_audio): a
    `make_batch` prompt of PFRONT_SERVE_BATCH x PFRONT_SERVE_SEQ model
    positions; for phi-3-vision then `pad_cache` to PFRONT_SERVE_CACHE, a
    warm-up and PFRONT_SERVE_STEPS decode steps fed the mesh-free run's
    tokens, the positions going on after the patches. The logits within
    SERVE_BOUND and the argmax equal where the mesh-free top-2 margin
    exceeds it; phi-3-vision's dp_only prefill error beside; the cache laid
    out by `cache_specs` (its GiB a coordinate); B6 8 x L launches a
    prefill and none in decode; bytes and calls equal to
    `partitioned_serve_collectives`; prefill ms, decode ms a step and peak
    GiB beside mesh-free."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.dryrun import RULES_VARIANTS, partitioned_serve_collectives
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import lay_out

    b, s, n = PFRONT_SERVE_BATCH, PFRONT_SERVE_SEQ, PFRONT_SERVE_CACHE
    decodes = cfg.decode_capable
    n_coords = MESH_SHAPE[0] * MESH_SHAPE[1]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    whole, params = _laid_out_params(torch, cfg, mesh)
    batch = make_batch(cfg, b, s, np.random.default_rng([SEED, 27]), "prefill", "cuda")

    # the mesh-free path: the prefill (the forward for an encoder; a
    # warm-up, then timed), then the padded cache, a warm-up step and
    # PFRONT_SERVE_STEPS steps
    def free_prefill():
        return (T.prefill if decodes else T.forward)(whole, batch, cfg)

    free_prefill()
    (free_logits, _, _, cache), free_prefill_ms = timed(torch, free_prefill)
    fed, free_steps, free_ms = [], [], []
    if decodes:
        pad = (0, 0, 0, 0, 0, n - s)
        cache = {**cache, "k": F.pad(cache["k"], pad), "v": F.pad(cache["v"], pad)}
        tok = torch.argmax(free_logits[:, -1], -1)
        for _ in range(1 + PFRONT_SERVE_STEPS):
            fed.append(tok)
            (lg, cache), ms = timed(torch, lambda: T.decode_step(whole, cache, tok, cfg))
            free_steps.append(lg)
            free_ms.append(ms)
            tok = torch.argmax(lg, -1)
    free_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del cache

    # the warm-up of the counted run: phi-3-vision's under dp_only, whose
    # logits' error is printed beside the default's; hubert's under default
    rname = "dp_only" if decodes else "default"
    rules = RULES_VARIANTS[rname]
    laid = lay_out(whole, _shardings(T.param_specs(cfg, rules, mesh), mesh)) if decodes \
        else params
    warm_logits = T.prefill(laid, batch, cfg, rules)[0]
    dp_only_err = _logit_errs(warm_logits, free_logits) if decodes else None
    del warm_logits, laid, whole
    gc.collect()
    torch.cuda.empty_cache()

    # the partitioned path: the counted and timed run
    torch.cuda.reset_peak_memory_stats()
    run = _serve_laid_out(torch, cfg, params, batch, fed, cache_len=n if decodes else None)
    pairs = [(run.pop("prefill_logits"), free_logits)] + list(zip(run.pop("step_logits"),
                                                                   free_steps))
    errs = [_logit_errs(got, want) for got, want in pairs]
    agree = [_clear_agree(got, want) for got, want in pairs]
    del pairs, free_logits, free_steps
    pre = run["prefill"]
    specs = T.cache_specs(cfg, b, n if decodes else s, RULES_VARIANTS["default"], mesh)
    first = mesh.coords()[0]
    coord_gib = sum(math.prod(shards[first]) * 2 for k, (_, shards) in run["cache"].items()
                    if k in ("k", "v")) / 2 ** 30
    out = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": mesh.descriptor(), "batch": b,
           "seq": s, "cache_len": n if decodes else s,
           "prefill": {"ms": pre["ms"], "mesh_free_ms": free_prefill_ms, "err": errs[0],
                       "dp_only_err": dp_only_err, "clear_agree": agree[0],
                       "launches": pre["launches"], "bytes": pre["bytes"],
                       "calls": pre["calls"]},
           "bound": SERVE_BOUND, "peak_gib": run["peak_gib"], "mesh_free_peak_gib": free_peak,
           "cache_gib": run["held_gib"], "cache_gib_a_coordinate": coord_gib,
           "cache_specs": {k: list(spec) for k, (spec, _) in run["cache"].items()}}
    if decodes:
        ms = [st["ms"] for st in run["steps"][1:]]
        out["decode"] = {"ms": ms, "warmup_ms": run["steps"][0]["ms"],
                         "mesh_free_ms": free_ms[1:], "mesh_free_warmup_ms": free_ms[0],
                         "errs": errs[1:], "clear_agree": agree[1:],
                         "tokens_per_s": b / (sum(ms) / len(ms) / 1e3),
                         "mesh_free_tokens_per_s": b / (sum(free_ms[1:]) / len(ms) / 1e3),
                         "bytes": run["steps"][1]["bytes"], "calls": run["steps"][1]["calls"]}
    print(f"path partition_frontend_serve {cfg.name}: {json.dumps(out)}", flush=True)
    require(all(np.isfinite(e[0]) and e[0] <= SERVE_BOUND for e in errs)
            and (dp_only_err is None or dp_only_err[0] <= SERVE_BOUND),
            f"partition frontend serve {cfg.name}: logits {errs}, dp_only {dp_only_err} "
            f"against mesh-free (bound {SERVE_BOUND})")
    require(all(a == c for a, c in agree),
            f"partition frontend serve {cfg.name}: a token differs where the top-2 margin "
            f"exceeds {SERVE_BOUND}: {agree}")
    require(all(tuple(spec) == tuple(specs[k]) for k, (spec, _) in run["cache"].items())
            and len(run["steps"]) == (1 + PFRONT_SERVE_STEPS if decodes else 0),
            f"partition frontend serve {cfg.name}: the cache is not laid out by cache_specs "
            f"{specs}: {run['cache']}")
    want = partitioned_serve_collectives(cfg, MESH_SHAPE, "default", b, s, n)
    for phase, got in [("prefill", pre)] + [("decode", st) for st in run["steps"]]:
        want_moved, want_calls = want[phase]
        require({k: got["bytes"][k] for k in want_moved} == want_moved
                and all(v == 0 for k, v in got["bytes"].items() if k not in want_moved)
                and {k: got["calls"][k] for k in want_calls} == want_calls,
                f"partition frontend serve {cfg.name} {phase}: bytes {got['bytes']} calls "
                f"{got['calls']}, want {want_moved} {want_calls}")
        for kern, cnt in got["launches"].items():
            want_n = cfg.n_layers * n_coords if (phase == "prefill"
                                                 and kern == "flash_attention") else 0
            require(cnt == want_n, f"partition frontend serve {cfg.name} {phase}: {kern} "
                                   f"launched {cnt} times, want {want_n}")
    out["launches"] = pre["launches"]
    del params, run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_partition_frontend(torch) -> dict:
    """Phase 27: the partitioned audio and VLM bodies on (data 2, model 4)
    of cuda:0 (module docstring): (a) the AdamW steps, (b) prefill and
    decode, of hubert-xlarge and phi-3-vision-4.2b; (c) B6 and B6-bwd at
    each one's coordinate shape (hubert's bidirectional)."""
    from repro_torch.launch.mesh import make_worker_mesh

    mesh = make_worker_mesh(MESH_SHAPE, devices=["cuda:0"] * (MESH_SHAPE[0] * MESH_SHAPE[1]))
    out = {"train": {}, "serve": {}, "kernels": {}}
    for name in PFRONT_ARCHS:
        out["train"][name] = run_partitioned_step(
            torch, mesh, _pfront_cfg(name, PFRONT_LAYERS[name]), _pfront_cfg(name).n_layers,
            "partition_frontend", PFRONT_CUT_WHY[name])
        print(f"path partition_frontend_train {name}: {json.dumps(out['train'][name])}",
              flush=True)
    for name in PFRONT_ARCHS:
        out["serve"][name] = run_partition_frontend_serve(torch, mesh, _pfront_cfg(name))
    for name in PFRONT_ARCHS:
        cfg = _pfront_cfg(name)
        out["kernels"][name] = check_flash_partitioned(
            torch, TRAIN_BATCH // TRAIN_MICRO // MESH_SHAPE[0], cfg.n_heads // MESH_SHAPE[1],
            TRAIN_SEQ, cfg.head_dim, what=f"the partitioned {cfg.family} step",
            causal=cfg.causal)
    return out


def run_partition_shampoo(torch) -> dict:
    """Phase 28: SPIN-Shampoo on a laid-out state (module docstring): two
    steps of olmo-1b cut to PSHAMPOO_LAYERS on (data 2, model 4) of cuda:0
    beside two mesh-free steps of the same initial state; the refresh of
    step 1 timed apart, its B1, B2 and B3 launches the sharded inversions'
    of the factors' planned grids; step 2's bytes the analytic count."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.dryrun import partitioned_step_collectives
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.optim import SpinShampooConfig
    from repro_torch.parallel import collective_bytes, collective_calls, reset_collective_bytes
    from repro_torch.parallel.collectives import DistArray, gather
    from repro_torch.parallel.sharding import lay_out
    from repro_torch.planner import get_plan
    from repro_torch.runtime.trainer import (TrainConfig, init_state, make_train_step,
                                             state_shardings)
    from repro_torch.tree import leaves

    dev = torch.device("cuda")
    card = card_line()
    cfg = _partition_cfg(PSHAMPOO_LAYERS)
    print(f"partition_shampoo: {cfg.name} cut to {cfg.n_layers} of "
          f"{_partition_cfg().n_layers} layers ({PSHAMPOO_CUT_WHY})", flush=True)
    n_coords = MESH_SHAPE[0] * MESH_SHAPE[1]
    mesh = make_worker_mesh(MESH_SHAPE, devices=["cuda:0"] * n_coords)
    tcfg = TrainConfig(microbatches=TRAIN_MICRO, optimizer="spin_shampoo", warmup=1,
                       shampoo=SpinShampooConfig(damping=PSHAMPOO_DAMPING))
    gc.collect()
    torch.cuda.empty_cache()
    whole = init_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    shardings = state_shardings(cfg, tcfg, mesh)
    state = lay_out(whole, shardings)
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED, device=str(dev))
    batches = [stream.next(), stream.next()]

    # a refresh on the mesh: each factor layer's sharded inversion on its plan's grid
    want_refresh = {"matmul": 0, "schur_update": 0, "blocked_gauss_jordan": 0}
    grids = {}
    for fac in state.opt.factors:
        if fac is None:
            continue
        for f in (fac.l, fac.r):
            n, count = f.shape[-1], (f.shape[0] if len(f.shape) == 3 else 1)
            plan = get_plan("inverse", n, torch.float32, measure=False, placement="sharded",
                            backend="cuda")
            require(plan.leaf_solver == "cuda" and plan.multiply_engine == "cuda",
                    f"partition_shampoo: the sharded plan for n={n} is {plan.to_dict()}")
            grids[n] = n // plan.block_size
            for k, v in sharded_spin_launches(grids[n], MESH_SHAPE).items():
                if k in want_refresh:
                    want_refresh[k] += count * v
    want_free = refresh_launches(whole.opt)
    step = make_train_step(cfg, tcfg)
    with _timing_refreshes(torch, want_refresh) as refreshes:
        # mesh-free: two steps of the same state and batches (consumes `whole`)
        init = [m.clone() for m in whole.opt.master]
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        whole, f1, free_ms1 = _timed_step(torch, step, whole, batches[0])
        free_launches1 = kernels.launch_counts()
        # step 1's inverse against step 1's factor (step 2 moves the factor only)
        free_res = _largest_factor_residual(torch, whole.opt, PSHAMPOO_DAMPING)
        free_fac = [t[0].clone() for t in _largest_factor(whole.opt)]    # L, R, L⁻¹, R⁻¹
        kernels.reset_launch_counts()
        whole, f2, free_ms2 = _timed_step(torch, step, whole, batches[1])
        free_launches2 = kernels.launch_counts()
        free_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        free_update = [m - i for m, i in zip(whole.opt.master, init)]
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        # laid out
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        reset_collective_bytes()
        state, m1, ms1 = _timed_step(torch, step, state, batches[0])
        launches1 = kernels.launch_counts()
        moved1, calls1 = collective_bytes(), collective_calls()
        res = _largest_factor_residual(torch, state.opt, PSHAMPOO_DAMPING, gather)
        # layer 0 of the same leaf's factors and inverses, entry by entry
        gaps = {}
        for name, t, free in zip(("l", "r", "linv", "rinv"), _largest_factor(state.opt),
                                 free_fac):
            gaps[name] = float((gather(t)[0] - free).abs().max() / free.abs().max())
        del free_fac
        kernels.reset_launch_counts()
        reset_collective_bytes()
        state, m2, ms2 = _timed_step(torch, step, state, batches[1])
        launches2 = kernels.launch_counts()
        moved2, calls2 = collective_bytes(), collective_calls()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(len(refreshes) == 2, f"partition_shampoo: {len(refreshes)} refreshes in 4 steps")
    free_refresh, refresh = refreshes
    print(f"path partition_shampoo_steps: loss={m1['loss']!r} {m2['loss']!r} "
          f"mesh_free_loss={f1['loss']!r} {f2['loss']!r} grad_norm={m1['grad_norm']!r} "
          f"mesh_free_grad_norm={f1['grad_norm']!r} step_ms={ms1!r} {ms2!r} "
          f"refresh_ms={refresh['ms']!r} mesh_free_step_ms={free_ms1!r} {free_ms2!r} "
          f"mesh_free_refresh_ms={free_refresh['ms']!r} peak_gib={peak!r} "
          f"mesh_free_peak_gib={free_peak!r} launches={launches1} {launches2} "
          f"refresh_launches={refresh['launches']} want={want_refresh} grids={grids} "
          f"bytes={moved1} {moved2} calls={calls2} ({card})", flush=True)

    require(np.isfinite([m1["loss"], m2["loss"], m1["grad_norm"], m2["grad_norm"]]).all(),
            "partition_shampoo: non-finite metrics")
    require(abs(m1["loss"] - f1["loss"]) <= PSHAMPOO_RTOL * abs(f1["loss"]),
            f"partition_shampoo: loss {m1['loss']} against mesh-free {f1['loss']}")
    require(refresh["launches"] == want_refresh,
            f"partition_shampoo: refresh launched {refresh['launches']}, want {want_refresh}")
    require(free_refresh["launches"] == want_free,
            f"partition_shampoo: the mesh-free refresh launched {free_refresh['launches']}, "
            f"want {want_free}")
    # B6 and B6-bwd a layer, microbatch and coordinate
    _check_step_launches("partition_shampoo step 1", launches1, cfg.n_layers * n_coords,
                         want_refresh)
    _check_step_launches("partition_shampoo step 2", launches2, cfg.n_layers * n_coords, {})
    _check_step_launches("partition_shampoo mesh-free step 1", free_launches1, cfg.n_layers,
                         want_free)
    _check_step_launches("partition_shampoo mesh-free step 2", free_launches2, cfg.n_layers,
                         {})
    require(moved1["to_dense"] == moved2["to_dense"] == 0,
            f"partition_shampoo: a factor was made whole: {moved1} {moved2}")
    want_moved, want_calls = partitioned_step_collectives(
        cfg, MESH_SHAPE, "default", TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO,
        optimizer="spin_shampoo")
    require({k: moved2[k] for k in want_moved} == want_moved
            and all(v == 0 for k, v in moved2.items() if k not in want_moved),
            f"partition_shampoo: step 2 bytes {moved2}, want {want_moved}")
    require({k: calls2[k] for k in want_calls} == want_calls,
            f"partition_shampoo: step 2 calls {calls2}, want {want_calls}")

    # every leaf still laid out by its spec, a factor both axes divide 1/8 a coordinate
    for x, sh in zip(leaves(state), leaves(shardings)):
        require(isinstance(x, DistArray) and x.spec == tuple(sh.spec) and x.mesh is mesh,
                "partition_shampoo: a state leaf is no longer laid out by its spec")
    shares = set()
    for fac in state.opt.factors:
        for t in fac or ():
            if t.spec[-2:] == ("data", "model"):
                shares |= {t.shards[c].numel() * n_coords / math.prod(t.shape)
                           for c in mesh.coords()}
    require(shares == {1.0}, f"partition_shampoo: a coordinate holds {shares} of a factor")

    # the second step's update of every master leaf against mesh-free's
    updates = []
    for i, (ma, ini, fu) in enumerate(zip(state.opt.master, init, free_update)):
        du = (gather(ma) - ini).double()
        fu = fu.double()
        nu, nf = float(du.norm()), float(fu.norm())
        cos = float((du * fu).sum()) / max(nu * nf, 1e-300)
        updates.append({"norm": nu, "mesh_free_norm": nf, "cosine": cos})
        require(nf > 0 and abs(nu - nf) <= PSHAMPOO_UPDATE_RTOL * nf
                and cos >= PSHAMPOO_UPDATE_COS,
                f"partition_shampoo: master leaf {i}'s update norm {nu} (mesh-free {nf}), "
                f"cosine {cos}")
    del init, free_update
    print(f"path partition_shampoo: layer 0 factor n={res['n']} residual={res['residual']!r} "
          f"condition={res['condition']!r} bound={res['bound']!r} (4·n·2^-24·κ) "
          f"mesh_free_residual={free_res['residual']!r} "
          f"mesh_free_condition={free_res['condition']!r} ({card})", flush=True)
    require(res["residual"] <= res["bound"],
            f"partition_shampoo: residual {res['residual']} > {res['bound']}")
    print(f"path partition_shampoo: layer 0 of that leaf, max |laid out - mesh-free| / "
          f"max |mesh-free|: L {gaps['l']!r} R {gaps['r']!r} L^-1 {gaps['linv']!r} "
          f"R^-1 {gaps['rinv']!r} (bound {PSHAMPOO_INV_RTOL!r} on the inverses; {card})",
          flush=True)
    require(max(gaps["linv"], gaps["rinv"]) <= PSHAMPOO_INV_RTOL,
            f"partition_shampoo: the inverses lie {gaps} from mesh-free's")
    held = _held_gib(torch, state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    out = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": mesh.descriptor(),
           "damping": PSHAMPOO_DAMPING, "grids": grids,
           "losses": [m1["loss"], m2["loss"]], "mesh_free_losses": [f1["loss"], f2["loss"]],
           "grad_norms": [m1["grad_norm"], m2["grad_norm"]],
           "mesh_free_grad_norms": [f1["grad_norm"], f2["grad_norm"]],
           "step_ms": [ms1, ms2], "mesh_free_step_ms": [free_ms1, free_ms2],
           "refresh_ms": refresh["ms"], "mesh_free_refresh_ms": free_refresh["ms"],
           "refresh_launches": refresh["launches"], "launches": launches1,
           "launches_step2": launches2, "peak_gib": peak, "mesh_free_peak_gib": free_peak,
           "state_gib": held, "collective_bytes": [moved1, moved2],
           "collective_calls": [calls1, calls2], "updates": updates,
           "factor": res, "mesh_free_factor": free_res, "factor_gaps": gaps, "card": card}
    print(f"path partition_shampoo_train: {json.dumps(out)}", flush=True)
    return out



# ---------------------------------------------------------------------------
# Phase 29: the partitioned dry run against the card
# ---------------------------------------------------------------------------


def _counted(d: dict) -> dict:
    return {k: v for k, v in d.items() if v}


def run_dryrun_partitioned(torch, partition: dict, serve_partition: dict,
                           dry_run: dict) -> dict:
    """Phase 29: the partitioned program traced on meta tensors
    (`dryrun.trace_partitioned`: the arguments laid out by their specs on
    a (data 2, model 4) mesh of meta devices) held against what phases 23
    and 24 counted on the card in this process, and phase 20 (d)'s
    production record against the analytic count. Builds and launches
    nothing."""
    from repro_torch import kernels
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.parallel import DEFAULT_RULES

    launches0 = kernels.launch_counts()
    cfg = _partition_cfg()
    meta = make_worker_mesh(PART_SHAPE, devices=["meta"] * (PART_SHAPE[0] * PART_SHAPE[1]))
    train, serve = partition["train"], serve_partition["serve"]
    # (a) phase 23's step, (b) phase 24's prefill and one decode step: the
    # model inputs whole, as the stream and the last step hand them
    runs = (("step", ShapeConfig("phase23_step", TRAIN_SEQ, TRAIN_BATCH, "train"), TRAIN_MICRO,
             train["collective_bytes"], train["collective_calls"], train["launches"],
             dryrun.partitioned_step_collectives(cfg, PART_SHAPE, "default", TRAIN_BATCH,
                                                 TRAIN_SEQ, TRAIN_MICRO)),
            ("prefill", ShapeConfig("phase24_prefill", SERVE_PROMPT, SERVE_BATCH, "prefill"), 1,
             serve["prefill"]["bytes"], serve["prefill"]["calls"],
             serve["prefill"]["launches"], None),
            ("decode", ShapeConfig("phase24_decode", SERVE_CACHE, SERVE_BATCH, "decode"), 1,
             serve["decode"]["bytes"], serve["decode"]["calls"], {}, None))
    want_serve = dryrun.partitioned_serve_collectives(cfg, SERVE_SHAPE, "default", SERVE_BATCH,
                                                      SERVE_PROMPT, SERVE_CACHE)
    out = {}
    for what, shape, micro, card_bytes, card_calls, card_launches, analytic in runs:
        analytic = analytic or want_serve[what]
        t0 = time.perf_counter()
        traced = dryrun.trace_partitioned(cfg, shape, meta, DEFAULT_RULES, micro,
                                          model_size_hint=16, lay_batch=False)
        trace_s = time.perf_counter() - t0
        got = (_counted(traced["moved"]), _counted(traced["calls"]))
        booked = {name: b["calls"] for name, b in traced["booked"].items()}
        del traced
        card = (_counted(card_bytes), _counted(card_calls))
        print(f"dry_run_partitioned {what}: meta bytes={got[0]} calls={got[1]} "
              f"card bytes={card[0]} calls={card[1]} booked={booked} "
              f"card_launches={card_launches} trace_s={trace_s!r}", flush=True)
        require(got == card, f"dry_run_partitioned {what}: meta {got}, card {card}")
        require(got == (_counted(analytic[0]), _counted(analytic[1])),
                f"dry_run_partitioned {what}: meta {got}, analytic {analytic}")
        for name, n in booked.items():
            require(n == card_launches.get(name, 0),
                    f"dry_run_partitioned {what}: {name} booked {n} times, launched "
                    f"{card_launches.get(name, 0)} on the card")
        out[what] = {"bytes": got[0], "calls": got[1], "booked": booked,
                     "card_launches": card_launches, "trace_s": trace_s}

    # (c) phase 20 (d)'s production record, with its partitioned keys
    rec = dry_run["cell_olmo_train_4k"]
    keys = {k: rec[k] for k in ("coll_scope", "analytic", "analytic_match", "cost",
                                "collectives_once")}
    keys["cost_partitioned"] = {k: v for k, v in rec["cost_partitioned"].items()
                                if k != "probes"}
    print(f"dry_run_partitioned cell olmo-1b x train_4k x 16x16: {json.dumps(keys)}",
          flush=True)
    require(rec["coll_scope"] == "partitioned" and rec["analytic_match"] is True,
            f"dry_run_partitioned cell: scope {rec['coll_scope']}, analytic match "
            f"{rec['analytic_match']}")
    out["cell_olmo_train_4k"] = keys
    require(kernels.launch_counts() == launches0, "dry_run_partitioned: a kernel launched")
    return out


def main(proc_dir: str) -> int:
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

    start_s = time.perf_counter()
    # 1. card
    card = card_line()
    print(card, flush=True)
    for name, before, after, why in TIME_CUTS:
        print(f"cut: {name} {before} -> {after} ({why})", flush=True)
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
    sharded = run_sharded(torch, a, proc_dir)
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
    gc.collect()
    torch.cuda.empty_cache()

    # 19. a mesh of the one card: expert-parallel MoE, the sharded
    # embedding, compressed_psum, training and the elastic restore
    phase_s = {}
    t0 = time.perf_counter()
    mesh = run_mesh(torch, torch.device("cuda"))
    phase_s["19"] = time.perf_counter() - t0
    print(f"phase_s {json.dumps(phase_s)}", flush=True)

    # 20. the dry run's meta predictions against what the card counted
    t0 = time.perf_counter()
    dry_run = run_dryrun(torch, sharded, mesh, train_adamw)
    phase_s["20"] = time.perf_counter() - t0
    print(f"phase_s {json.dumps(phase_s)}", flush=True)

    # 21. the examples' twins at the main path's sizes, with a plan file of
    # their own
    t0 = time.perf_counter()
    outer_plans = os.environ["SPIN_PLAN_CACHE"]
    example_plans = tempfile.mkdtemp(prefix="chip_smoke_example_plans_")
    os.environ["SPIN_PLAN_CACHE"] = os.path.join(example_plans, "plans.json")
    try:
        examples = run_examples(torch)
    finally:
        os.environ["SPIN_PLAN_CACHE"] = outer_plans
        shutil.rmtree(example_plans, ignore_errors=True)
    phase_s["21"] = time.perf_counter() - t0
    print(f"phase_s {json.dumps(phase_s)}", flush=True)

    # 22. a mesh that spans processes: ranks of their own on the card
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    processes = run_processes(torch, proc_dir, sharded, mesh)
    phase_s["22"] = time.perf_counter() - t0
    print(f"phase_s {json.dumps(phase_s)}", flush=True)

    # 23. the partitioned dense step: a laid-out state, per coordinate; and
    # two ranks of their own
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    partition = run_partition(torch, proc_dir)
    phase_s["23"] = time.perf_counter() - t0
    print(f"phase_s {json.dumps(phase_s)}", flush=True)

    # 24. partitioned prefill and decode: laid-out parameters, the cache laid
    # out by cache_specs; and two ranks of their own
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    serve_partition = run_serve_partition(torch, proc_dir)
    phase_s["24"] = time.perf_counter() - t0
    print(f"phase_s {json.dumps(phase_s)}", flush=True)

    # 25. the partitioned MoE: laid-out experts in the step, prefill and
    # decode; and two ranks of their own
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    partition_moe = run_partition_moe(torch, proc_dir)
    phase_s["25"] = time.perf_counter() - t0
    print(f"phase_s {json.dumps(phase_s)}", flush=True)

    # 26. the partitioned SSM and hybrid bodies: the SSD heads per
    # coordinate in the step, prefill and decode, hymba's rolling cache
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    partition_ssm = run_partition_ssm(torch)
    phase_s["26"] = time.perf_counter() - t0
    print(f"phase_s {json.dumps(phase_s)}", flush=True)

    # 27. the partitioned audio and VLM bodies: hubert's bidirectional
    # frames and masked-frame loss, phi-3-vision's patch prefix
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    partition_frontend = run_partition_frontend(torch)
    phase_s["27"] = time.perf_counter() - t0
    print(f"phase_s {json.dumps(phase_s)}", flush=True)

    # 28. SPIN-Shampoo on a laid-out state: the Gram factors over data x
    # model, the refresh through the mesh-resident SPIN inversion
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    partition_shampoo = run_partition_shampoo(torch)
    phase_s["28"] = time.perf_counter() - t0
    print(f"phase_s {json.dumps(phase_s)}", flush=True)

    # 29. the partitioned dry run: phases 23's and 24's programs on meta
    # tensors against what the card counted; phase 20 (d)'s analytic match
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dry_run_partitioned = run_dryrun_partitioned(torch, partition, serve_partition, dry_run)
    phase_s["29"] = time.perf_counter() - t0
    print(f"phase_s {json.dumps(phase_s)} ({card})", flush=True)
    print(f"chip_smoke total_s {time.perf_counter() - start_s!r} ({card})", flush=True)

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
        "train_families": train_families, "mesh": mesh, "dry_run": dry_run,
        "examples": examples, "processes": _processes_summary(processes),
        "partition": partition, "serve_partition": serve_partition,
        "partition_moe": partition_moe, "partition_ssm": partition_ssm,
        "partition_frontend": partition_frontend, "partition_shampoo": partition_shampoo,
        "dry_run_partitioned": dry_run_partitioned, "phase_s": phase_s},
        "card": card}), flush=True)

    # 30. the kernels line
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
                   for arch, run in train_families.items()},
                "train_mesh_step": mesh["train"]["launches"][name],
                "train_partitioned_step": partition["train"]["launches"][name],
                "partitioned_prefill": serve_partition["serve"]["launches"][name],
                "train_partitioned_moe_step": partition_moe["train"]["launches"][name],
                "partitioned_moe_prefill": partition_moe["serve"]["launches"][name],
                **{f"train_partitioned_{arch}_step": run["launches"].get(name, 0)
                   for arch, run in partition_ssm["train"].items()},
                **{f"partitioned_{arch}_prefill": run["launches"].get(name, 0)
                   for arch, run in partition_ssm["serve"].items()},
                **{f"train_partitioned_{arch}_step": run["launches"][name]
                   for arch, run in partition_frontend["train"].items()},
                **{f"partitioned_{arch}_prefill": run["launches"][name]
                   for arch, run in partition_frontend["serve"].items()},
                "train_partitioned_shampoo_step": partition_shampoo["launches"][name]}
            r["partitioned_coordinate"] = partition["train"]["kernels"][name]
            r["partitioned_prefill_coordinate"] = serve_partition["serve"]["kernels"][name]
            r["partitioned_moe_coordinate"] = partition_moe["kernels"][name]
            r["partitioned_hybrid_coordinate"] = partition_ssm["kernels"][name]
            r["partitioned_audio_coordinate"] = \
                partition_frontend["kernels"]["hubert-xlarge"][name]
            r["partitioned_vlm_coordinate"] = \
                partition_frontend["kernels"]["phi-3-vision-4.2b"][name]
        if name in ("matmul", "schur_update", "blocked_gauss_jordan"):
            r["launches_by_path"]["train_shampoo_refresh"] = \
                train_shampoo["refresh_launches"][name]
            r["launches_by_path"]["partitioned_shampoo_refresh"] = \
                partition_shampoo["refresh_launches"][name]
        if name == "flash_attention_bwd":
            r["launches_by_path"] = {
                "train_adamw_step": train_adamw["launches"][name],
                **{f"train_{arch}_step": run["launches"][name]
                   for arch, run in train_families.items()},
                "train_mesh_step": mesh["train"]["launches"][name],
                "train_partitioned_step": partition["train"]["launches"][name],
                "train_partitioned_moe_step": partition_moe["train"]["launches"][name],
                **{f"train_partitioned_{arch}_step": run["launches"].get(name, 0)
                   for arch, run in partition_ssm["train"].items()},
                **{f"train_partitioned_{arch}_step": run["launches"][name]
                   for arch, run in partition_frontend["train"].items()},
                "train_partitioned_shampoo_step": partition_shampoo["launches"][name]}
            r["partitioned_coordinate"] = partition["train"]["kernels"][name]
            r["partitioned_moe_coordinate"] = partition_moe["kernels"][name]
            r["partitioned_hybrid_coordinate"] = partition_ssm["kernels"][name]
            r["partitioned_audio_coordinate"] = \
                partition_frontend["kernels"]["hubert-xlarge"][name]
            r["partitioned_vlm_coordinate"] = \
                partition_frontend["kernels"]["phi-3-vision-4.2b"][name]
            r["kernels_by_dtype"] = {
                "bf16, f16": ["flash_bwd_delta",
                              *fa.flash_attention_bwd_kernels(torch.bfloat16).values()],
                "f32": ["flash_bwd_delta",
                        *fa.flash_attention_bwd_kernels(torch.float32).values()]}
        r.setdefault("launches_by_path", {}).update(
            {f"example_{label}": run["launches"][name] for label, run in examples.items()})
        r["launches_by_path"].update(_launches_by_rank(processes, name))
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": path["launches"][name], **r})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-case"]:      # one rank of phase 22, 23, 24 or 25
        sys.exit(_rank_child(sys.argv[2], sys.argv[3]))
    # The planner's plan file lies in a directory of this run's own, so that
    # no plan of an earlier run is recalled; phase 22's files (phase 4's
    # matrix, phase 14's results, the ranks' references) in another; both
    # are removed at the end.
    plan_dir = tempfile.mkdtemp(prefix="chip_smoke_plans_")
    proc_dir = tempfile.mkdtemp(prefix="chip_smoke_processes_")
    os.environ["SPIN_PLAN_CACHE"] = os.path.join(plan_dir, "plans.json")
    try:
        code = main(proc_dir)
    finally:
        shutil.rmtree(plan_dir, ignore_errors=True)
        shutil.rmtree(proc_dir, ignore_errors=True)
    sys.exit(code)
