// C entry points of the port's GEMM, bound from Python with ctypes. It
// serves two kernels of the port:
//   * matmul, which replaces `matmul_pallas`
//     (src/repro/kernels/matmul/kernel.py): c == nullptr, out = A @ B;
//   * schur_update, which replaces `schur_update_pallas` (same file):
//     out = beta * C + alpha * (A @ B), the product never going to device
//     memory.
//
// Two bodies compute them. The Python wrapper picks one by a rule on the
// shape (kernels/matmul/kernel.py, `gemm_route`):
//
// gemm_tc, on Hopper's tensor cores: every product with k >= 1.
//  * Bound on an H100: the SPIN products are square and large (k >= 1024
//    on the main path), far above the card's ridge, so the bound is the
//    tensor cores' rate. f32 is multiplied as a 3xTF32 split: each operand
//    x becomes hi = rna_tf32(x) and lo = rna_tf32(x - hi), and the product
//    is lo·hi + hi·lo + hi·hi, three TF32 products at 495 TFLOP/s, so an
//    effective 165 TFLOP/s: 6.66 ms at 8192³ against 16.4 ms for f32 FFMA
//    at 67 TFLOP/s. The dropped lo·lo term and the rounding of lo leave
//    about 3·2^-22 of |a||b| a product, below the f32 summation error the
//    FFMA body already carried. bf16 and f16 take one product a k step at
//    989 TFLOP/s.
//  * TF32 wgmma has no transpose bit, so both shared-memory operands must
//    be K-major; B (k x n, row-major) is not. A pack pre-pass (gemm_pack)
//    writes A as (planes, m, ldp) and B transposed as (planes, n, ldp), K
//    contiguous, rows padded to 16 bytes, planes hi and lo for f32 (one
//    plane, a copy, for bf16 and f16), into scratch that the wrapper
//    allocates. The main loop then only loads aligned K-major tiles, and
//    any row stride or ragged shape is legal. The pre-pass moves 3·4 bytes
//    an f32 element (read x, write hi and lo): about 0.5 ms at 8192² beside
//    a product of several ms.
//  * The main loop (gemm_tc): one block owns a BM x 128 output tile (BM
//    128: two consumer warpgroups of 64 rows; BM 64 for outputs with
//    fewer 128 x 128 tiles than the card has SMs, so that the 1024² and
//    smaller products of SPIN's deepest levels fill it), plus one producer
//    warpgroup, one thread of which issues the loads. Tiles are rastered
//    in groups of 8 tile rows so that the blocks in flight share their A
//    and B panels in L2.
//  * The producer TMA-loads k slices of 128 bytes a row (32 f32, 64 bf16)
//    of A and B, both planes in one box each, into a ring of 3 to 6 stages
//    (192 KB) with a full and an empty mbarrier a stage. The tiles are the
//    128-byte swizzle atoms TMA writes and wgmma reads, on 1024-byte
//    boundaries; TMA fills the parts of a box outside the operand with
//    zeros, so ragged m, n and k need no masking in the main loop.
//  * Each consumer warpgroup runs wgmma m64n128k8 (tf32) or m64n128k16
//    (bf16, f16) from shared memory, four k steps a stage, lo·hi and hi·lo
//    before hi·hi in each k step. The tensor cores sum one stage into a
//    part (64 f32 a thread) from zero, and the part is added to the
//    accumulator in f32 registers with round-to-nearest (see below). Two
//    parts alternate, so one stage's products run while the stage before
//    is added and its slot freed.
//  * The epilogue computes out = alpha·acc + beta·C in f32 with masked
//    stores; alpha is applied there, as schur_update_ref applies it.
//  * Left for later work: a persistent schedule, ping-pong between the
//    consumer warpgroups, a TMA store of the output, and fusing the pack.
//
// gemm_kernel (gemm_tile.cuh), f32 FFMA: products with k == 0, whose
// output is beta·C or zeros.
//
// Every launch returns cudaGetLastError(), which the Python wrapper checks.
#include <algorithm>

#include "gemm_tile.cuh"
#include "hopper.cuh"

namespace {

using repro::from_f32;
using repro::rna_tf32;
using repro::to_f32;

// ---------------------------------------------------------------------------
// Pack pre-pass
// ---------------------------------------------------------------------------

constexpr int kPackTile = 32;  // 32 x 32 elements a block, 256 threads as 32 x 8

// One operand of the pre-pass: src (rows x cols, row stride ld) into dst,
// (planes, rows', ldp) at plane stride `plane`, where rows' = rows and
// dst[r][c] = src[r][c], or with `transpose` rows' = cols and
// dst[c][r] = src[r][c].
struct PackOp {
  const void* src;
  void* dst;
  long long ld, ldp, plane;
  int rows, cols, transpose;
};

struct PackArgs {
  PackOp op[2];  // A, B: blockIdx.z
};

template <typename T>
__global__ void __launch_bounds__(256) gemm_pack(const PackArgs args) {
  __shared__ float tile[kPackTile][kPackTile + 1];
  // A select, not an index: indexing the parameter by blockIdx.z would
  // copy it to local memory.
  const PackOp p = blockIdx.z ? args.op[1] : args.op[0];
  const int r0 = blockIdx.y * kPackTile, c0 = blockIdx.x * kPackTile;
  if (r0 >= p.rows || c0 >= p.cols) return;
  const int tx = threadIdx.x % kPackTile, ty = threadIdx.x / kPackTile;
  const T* src = static_cast<const T*>(p.src);
#pragma unroll
  for (int j = 0; j < kPackTile / 8; ++j) {
    const int i = ty + 8 * j, r = r0 + i, c = c0 + tx;
    tile[i][tx] = (r < p.rows && c < p.cols) ? to_f32(src[r * p.ld + c]) : 0.f;
  }
  __syncthreads();
  T* dst = static_cast<T*>(p.dst);
#pragma unroll
  for (int j = 0; j < kPackTile / 8; ++j) {
    // Neighbouring threads write neighbouring k of one destination row.
    const int i = ty + 8 * j;
    const bool t = p.transpose;
    const int dr = t ? c0 + i : r0 + i, dc = t ? r0 + tx : c0 + tx;
    if (dr >= (t ? p.cols : p.rows) || dc >= (t ? p.rows : p.cols)) continue;
    const float v = t ? tile[tx][i] : tile[i][tx];
    const long long at = dr * p.ldp + dc;
    if constexpr (std::is_same_v<T, float>) {
      const float hi = rna_tf32(v);
      dst[at] = hi;
      dst[p.plane + at] = rna_tf32(v - hi);
    } else {
      dst[at] = from_f32<T>(v);  // exact: v came from a T
    }
  }
}

template <typename T>
cudaError_t launch_pack(const PackArgs& args, cudaStream_t s) {
  int rows = 0, cols = 0;
  for (const PackOp& op : args.op) {
    rows = std::max(rows, op.rows);
    cols = std::max(cols, op.cols);
  }
  const dim3 grid((cols + kPackTile - 1) / kPackTile, (rows + kPackTile - 1) / kPackTile, 2);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  gemm_pack<T><<<grid, 256, 0, s>>>(args);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core main loop
// ---------------------------------------------------------------------------

constexpr int kTcBN = 128;             // output columns a block
constexpr int kRowBytes = 128;         // bytes of k a tile row: one swizzle atom
constexpr int kStepBytes = 32;         // bytes of k a wgmma: 8 tf32 or 16 bf16
constexpr int kRingBytes = 196608;     // shared memory of the stage ring
constexpr int kGroupM = 8;             // tile rows a raster group
constexpr int kLayout = repro::wgmma_layout(kRowBytes);
// With two consumer warpgroups (384 threads, 168 registers a thread at
// entry) setmaxnreg gives the producer 24 and each consumer 240:
// 128·24 + 256·240 = 384·168. One consumer (256 threads) has 255 anyway.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <typename T, int BM>
struct TcShape {
  static constexpr int kPlanes = std::is_same_v<T, float> ? 2 : 1;  // hi, lo
  static constexpr int kBK = kRowBytes / static_cast<int>(sizeof(T));  // k a stage
  static constexpr int kConsumers = BM / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kABytes = kPlanes * BM * kRowBytes;
  static constexpr int kBBytes = kPlanes * kTcBN * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = kRingBytes / kStageBytes < 6 ? kRingBytes / kStageBytes : 6;
  // 1024 bytes of slack to align the ring to the swizzle pattern, and the
  // full and empty barriers.
  static constexpr size_t kSmem = 1024 + kStages * kStageBytes + 16 * kStages;
  static_assert(BM == 64 || BM == 128, "one or two consumer warpgroups");
  static_assert(kStages >= 2 && kSmem <= 232448, "the ring must fit in 227 KB");
};

struct TcArgs {
  const void* c;  // nullptr: plain product
  void* out;
  int m, n, k;
  long long ldc, ldo;
  float alpha, beta;
  int tiles_m, tiles_n;
};

template <typename T, typename TOut, int BM>
__global__ void __launch_bounds__(TcShape<T, BM>::kThreads, 1)
    gemm_tc(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
            const TcArgs p) {
  using Sh = TcShape<T, BM>;
  constexpr int kStages = Sh::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ring = smem_raw + ((1024 - (repro::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + kStages * Sh::kStageBytes);
  uint64_t* const empty = full + kStages;

  // The block's output tile, rastered in groups of kGroupM tile rows.
  const int per_group = kGroupM * p.tiles_n;
  const int first = static_cast<int>(blockIdx.x) / per_group * kGroupM;
  const int group_rows = min(p.tiles_m - first, kGroupM);
  const int local = static_cast<int>(blockIdx.x) % per_group;
  const int row0 = (first + local % group_rows) * BM;
  const int col0 = local / group_rows * kTcBN;
  const int n_k = (p.k + Sh::kBK - 1) / Sh::kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], 128 * Sh::kConsumers);  // every consumer thread
    }
    repro::mbar_init_fence();
  }
  __syncthreads();

  // The warpgroup index, read from lane 0 so that ptxas sees it is the
  // same across each warp: it sizes each branch by its setmaxnreg then.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == Sh::kConsumers) {
    // Producer: one thread issues every load; a stage is one box of A and
    // one of B, both planes each. The other warps only hand their
    // registers over.
    if constexpr (Sh::kConsumers == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * Sh::kConsumers) {
      for (int t = 0; t < n_k; ++t) {
        const int s = t % kStages;
        repro::mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        uint8_t* const st = ring + s * Sh::kStageBytes;
        repro::mbar_expect_tx(&full[s], Sh::kStageBytes);
        repro::tma_load_3d(st, &ta, &full[s], t * Sh::kBK, row0, 0);
        repro::tma_load_3d(st + Sh::kABytes, &tb, &full[s], t * Sh::kBK, col0, 0);
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows row0 + 64 wg .. + 63 of the tile. The
  // tensor cores sum a stage's products into `part` from zero; the
  // finished part is then added to `acc` in f32 with round-to-nearest.
  // Summed by the tensor cores across all of k, the error grew as k and
  // not as √k (on an H100: 5.7e-5 of the largest entry at 8192³, against
  // 7.8e-6 at 1024³): their f32 accumulation does not round to nearest.
  // So a part sums at most 32 k (f32) or 64 (bf16, f16). Two parts
  // alternate, so that one stage's products run while the stage before is
  // added and freed.
  if constexpr (Sh::kConsumers == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  float acc[64], part[2][64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  auto issue = [&](int t, float(&d)[64]) {
    const int s = t % kStages;
    repro::mbar_wait(&full[s], (t / kStages) & 1);
    const uint8_t* const a = ring + s * Sh::kStageBytes + wg * 64 * kRowBytes;
    const uint8_t* const b = ring + s * Sh::kStageBytes + Sh::kABytes;
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRowBytes / kStepBytes; ++kk) {
      const int off = kk * kStepBytes;  // bytes into the swizzle atom
      const uint64_t da = repro::wgmma_desc(a + off, 16, 8 * kRowBytes, kLayout);
      const uint64_t db = repro::wgmma_desc(b + off, 16, 8 * kRowBytes, kLayout);
      if constexpr (Sh::kPlanes == 2) {
        const uint64_t da_lo = repro::wgmma_desc(a + BM * kRowBytes + off, 16, 8 * kRowBytes,
                                                 kLayout);
        const uint64_t db_lo = repro::wgmma_desc(b + kTcBN * kRowBytes + off, 16,
                                                 8 * kRowBytes, kLayout);
        repro::wgmma_tf32_n128(d, da_lo, db, kk > 0);
        repro::wgmma_tf32_n128(d, da, db_lo, 1);
        repro::wgmma_tf32_n128(d, da, db, 1);
      } else {
        repro::wgmma_ss_n128<T>(d, da, db, kk > 0);
      }
    }
    repro::wgmma_commit();
  };
  auto retire = [&](int t, float(&d)[64]) {
    repro::fence_regs(d);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d[i];
    repro::mbar_arrive(&empty[t % kStages]);
  };
  for (int t = 0; t < n_k; t += 2) {
    issue(t, part[0]);
    repro::wgmma_wait_one();  // stage t - 1 is done
    if (t > 0) retire(t - 1, part[1]);
    if (t + 1 < n_k) {
      issue(t + 1, part[1]);
      repro::wgmma_wait_one();  // stage t is done
      retire(t, part[0]);
    }
  }
  repro::wgmma_wait_all();
  if (n_k % 2) retire(n_k - 1, part[0]);
  else retire(n_k - 1, part[1]);

  // Register i of (warp, lane) holds row 16 warp + lane / 4 + 8 ((i / 2) % 2)
  // and column 8 (i / 4) + 2 (lane % 4) + i % 2 of the warpgroup's 64 x 128.
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int rbase = row0 + 64 * wg + 16 * warp + lane / 4;
  const int cbase = col0 + 2 * (lane & 3);
  const T* const C = static_cast<const T*>(p.c);
  TOut* const O = static_cast<TOut*>(p.out);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = rbase + 8 * ((i >> 1) & 1), c = cbase + 8 * (i >> 2) + (i & 1);
    if (r < p.m && c < p.n) {
      float v = p.alpha * acc[i];
      if (C != nullptr) v += p.beta * to_f32(C[r * p.ldc + c]);
      O[r * p.ldo + c] = from_f32<TOut>(v);
    }
  }
}

// The tensor map of a packed operand, (planes, rows, ldp) with k valid
// columns a row, cut into boxes of 128 bytes of k by box_rows rows by
// every plane.
template <typename T>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int rows, int k, long long ldp,
                     int planes, int box_rows) {
  const repro::EncodeTiled encode = repro::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ldp) * sizeof(T),
                                 static_cast<cuuint64_t>(ldp) * rows * sizeof(T)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kRowBytes / sizeof(T)),
                             static_cast<cuuint32_t>(box_rows),
                             static_cast<cuuint32_t>(planes)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType type = std::is_same_v<T, float> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : std::is_same_v<T, __nv_bfloat16>
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUresult r = encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct TcLaunch {
  const void* a_packed;
  const void* b_packed;
  long long ldp;
  TcArgs args;
};

template <typename T, typename TOut, int BM>
cudaError_t launch_tc(TcLaunch L, cudaStream_t s) {
  using Sh = TcShape<T, BM>;
  CUtensorMap ta, tb;
  cudaError_t err;
  TcArgs& p = L.args;
  if ((err = make_map<T>(&ta, L.a_packed, p.m, p.k, L.ldp, Sh::kPlanes, BM)) ||
      (err = make_map<T>(&tb, L.b_packed, p.n, p.k, L.ldp, Sh::kPlanes, kTcBN)))
    return err;
  // Once an instantiation: the attribute outlives the launch, and the
  // products of SPIN's deep levels are short enough that the host's time
  // a launch counts.
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_tc<T, TOut, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Sh::kSmem));
  if (attr != cudaSuccess) return attr;
  p.tiles_m = (p.m + BM - 1) / BM;
  p.tiles_n = (p.n + kTcBN - 1) / kTcBN;
  const long long blocks = static_cast<long long>(p.tiles_m) * p.tiles_n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gemm_tc<T, TOut, BM><<<static_cast<unsigned>(blocks), Sh::kThreads, Sh::kSmem, s>>>(ta, tb, p);
  return cudaGetLastError();
}

template <typename T, typename TOut>
cudaError_t launch_tc_bm(const TcLaunch& L, int block_m, cudaStream_t s) {
  switch (block_m) {
    case 64: return launch_tc<T, TOut, 64>(L, s);
    case 128: return launch_tc<T, TOut, 128>(L, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_tc_out(const TcLaunch& L, int block_m, int out_dtype, cudaStream_t s) {
  if (out_dtype == repro::kF32) return launch_tc_bm<T, float>(L, block_m, s);
  if constexpr (!std::is_same_v<T, float>) {
    if (out_dtype == (std::is_same_v<T, __nv_bfloat16> ? repro::kBF16 : repro::kF16))
      return launch_tc_bm<T, T>(L, block_m, s);
  }
  return cudaErrorInvalidValue;
}

PackArgs pack_args(const void* a, const void* b, void* a_packed, void* b_packed, int m, int n,
                   int k, long long lda, long long ldb, long long ldp) {
  PackArgs args;
  args.op[0] = PackOp{a, a_packed, lda, ldp, ldp * m, m, k, 0};
  args.op[1] = PackOp{b, b_packed, ldb, ldp, ldp * n, k, n, 1};
  return args;
}

template <typename T, int BM>
cudaError_t attributes_t(int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, gemm_tc<T, float, BM>);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = static_cast<int>(TcShape<T, BM>::kSmem);
  out[3] = static_cast<int>(fa.localSizeBytes);
  out[4] = TcShape<T, BM>::kStages;
  return cudaSuccess;
}

template <typename T>
cudaError_t attributes_bm(int block_m, int* out) {
  switch (block_m) {
    case 64: return attributes_t<T, 64>(out);
    case 128: return attributes_t<T, 128>(out);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The FFMA body: out = beta * C + alpha * (A @ B).
extern "C" int repro_gemm(const void* a, const void* b, const void* c, void* out, int m, int n,
                          int k, long long lda, long long ldb, long long ldc, long long ldo,
                          float alpha, float beta, int in_dtype, int out_dtype, void* stream) {
  repro::GemmArgs p{a, b, c, out, m, n, k, lda, ldb, ldc, ldo, alpha, beta};
  return static_cast<int>(
      repro::launch_gemm(p, in_dtype, out_dtype, static_cast<cudaStream_t>(stream)));
}

// The pack pre-pass alone: A (m x k, row stride lda) into a_packed
// (planes, m, ldp) and B (k x n, row stride ldb) transposed into b_packed
// (planes, n, ldp); f32 as TF32 hi and lo planes, bf16 and f16 copied.
extern "C" int repro_gemm_pack(const void* a, const void* b, void* a_packed, void* b_packed,
                               int m, int n, int k, long long lda, long long ldb, long long ldp,
                               int in_dtype, void* stream) {
  if (m == 0 || n == 0 || k == 0) return 0;
  const PackArgs args = pack_args(a, b, a_packed, b_packed, m, n, k, lda, ldb, ldp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case repro::kF32: return launch_pack<float>(args, s);
    case repro::kBF16: return launch_pack<__nv_bfloat16>(args, s);
    case repro::kF16: return launch_pack<__half>(args, s);
  }
  return cudaErrorInvalidValue;
}

// The tensor-core body: the pack pre-pass, then the main loop with BM =
// block_m (64 or 128) rows a block. ldp is a multiple of 16 bytes and at
// least k; a_packed and b_packed are 16-byte aligned scratch of
// planes x m x ldp and planes x n x ldp elements.
extern "C" int repro_gemm_tc(const void* a, const void* b, const void* c, void* out,
                             void* a_packed, void* b_packed, int m, int n, int k, long long lda,
                             long long ldb, long long ldc, long long ldo, long long ldp,
                             float alpha, float beta, int block_m, int in_dtype, int out_dtype,
                             void* stream) {
  if (m == 0 || n == 0) return 0;
  if (k < 1 || ldp < k) return cudaErrorInvalidValue;
  int err = repro_gemm_pack(a, b, a_packed, b_packed, m, n, k, lda, ldb, ldp, in_dtype, stream);
  if (err) return err;
  const TcLaunch L{a_packed, b_packed, ldp, TcArgs{c, out, m, n, k, ldc, ldo, alpha, beta, 0, 0}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case repro::kF32: return launch_tc_out<float>(L, block_m, out_dtype, s);
    case repro::kBF16: return launch_tc_out<__nv_bfloat16>(L, block_m, out_dtype, s);
    case repro::kF16: return launch_tc_out<__half>(L, block_m, out_dtype, s);
  }
  return cudaErrorInvalidValue;
}

// out[0..4]: registers a thread, static and dynamic shared memory, local
// (spill) bytes, and ring stages of the main loop for in_dtype and block_m.
extern "C" int repro_gemm_tc_attributes(int in_dtype, int block_m, int* out) {
  switch (in_dtype) {
    case repro::kF32: return attributes_bm<float>(block_m, out);
    case repro::kBF16: return attributes_bm<__nv_bfloat16>(block_m, out);
    case repro::kF16: return attributes_bm<__half>(block_m, out);
  }
  return cudaErrorInvalidValue;
}
