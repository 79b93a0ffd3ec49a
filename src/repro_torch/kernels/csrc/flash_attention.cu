// Flash attention forward: softmax(q kᵀ · hd^-0.5, causal mask) v with an
// online softmax, grouped-query heads (kv head = query head / group), f32
// accumulation, output in the operands' dtype.
//
// Replaces the Pallas kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py), and with it the JAX
// model's chunked attention scan (src/repro/models/attention.py,
// `_attend_chunked`), whose TPU twin that kernel is. It computes what the
// Pallas kernel computes: s = (q · k) · scale in f32, the causal mask
// q_pos >= kv_pos as -1e30, a running max and sum with the f32
// accumulator rescaled at each tile, l floored at 1e-30 at the end.
//
// Bound on an H100: every live (q, k) pair costs 4·hd operations (hd
// multiply-adds for the score, hd for the weighted sum of v), against
// 2·hd bytes a row of q, k, v and o in bf16. At the granite-8b layer
// (hd = 128, S = 2048) that is about 800 operations a byte: far above the
// card's ridge, so the bound is the tensor cores' operation rate
// (989 TFLOP/s in bf16 and f16).
//
// Two kernels, split by dtype:
//
// bf16 and f16: flash_fwd_tc, on Hopper's tensor cores.
//  * One block owns 128 query rows of one (batch, head): two consumer
//    warpgroups of 64 rows each and one producer warpgroup, one thread of
//    which issues the loads (384 threads); the grid is query tiles
//    (longest first) x heads x batch. setmaxnreg gives the producer 24
//    registers and the consumers 240.
//  * The producer issues TMA loads (cp.async.bulk.tensor) of the q tile
//    once, then of 128-row K and V tiles into a ring of two stages, with
//    full and empty mbarriers a slot. The tensor maps are 4-D views
//    (hd, S, H, B) at the operands' own strides, made on the host; TMA
//    fills rows past S with zeros, kv past Skv is masked and q rows past
//    Sq are not written.
//  * Tiles are stored as the swizzle atoms TMA writes and wgmma reads: 128
//    bytes of hd a row where 2·hd is a multiple of 128 (hd 64, 128), else
//    64 (hd 32, 96, 160) or 32 (hd 16). Shared memory: q 32 KB plus two
//    stages of K and V, 160 KB at hd = 128 and 200 KB at hd = 160.
//  * S = Q Kᵀ is wgmma m64n128k16 with both operands in shared memory, both
//    K-major (hd is the reduction axis). O += P V is wgmma with P from
//    registers as the A operand: the S accumulator's fragment layout,
//    converted to bf16 / f16 pairs, is the A fragment layout (as in
//    FlashAttention-3); V is an MN-major B operand through the transpose
//    bit, one swizzle atom of hd columns a product.
//  * Sums are f32. P is rounded to the operands' dtype before P V, while
//    l sums the f32 P: one rounding of each weight, at most 2^-9 relative
//    in bf16, which the reference's bf16 tolerance covers.
//  * The causal mask is applied on the accumulator registers of the tiles
//    that cross the diagonal or the end of the keys only; tiles above the
//    diagonal are never loaded.
//  * Left for later work: overlapping one warpgroup's softmax with the
//    other's products (ping-pong), a persistent schedule, and a TMA store
//    of the output.
//
// f32: flash_fwd, f32 FFMA (67 TFLOP/s on an H100). TF32 products would
// not hold the f32 tolerance, and this kernel already runs 1.5x faster
// than PyTorch's f32 attention, so f32 keeps it:
//  * One block owns one 64-row query tile of one head of one batch
//    element (grid: query tiles x heads x batch) and walks the kv tiles
//    itself, with the accumulator and the row statistics in registers.
//  * The q tile and one 64-row K (then V) tile are staged in shared
//    memory in f32, rows padded by 4 floats so that the float4 reads of
//    the score product meet no bank conflict; the P tile goes through
//    shared memory to the weighted sum. That is 88 KB at hd = 128 and
//    104 KB at hd = 160: dynamic shared memory, two blocks an SM.
//  * 256 threads as 16 x 16: a thread holds rows ty + 16 i (i < 4) of the
//    tile and, in the score product, columns tx + 16 j (j < 4), in the
//    weighted sum columns tx + 16 c (c < hd / 16). The 16 threads of a row
//    sit in one half-warp, so a row max or sum is four shuffles.
//  * Causal tiles above the diagonal are never visited (the Pallas
//    kernel's `pl.when(live)`), and query tiles are issued longest first.
//
// Both take a ragged sequence and any strides on the B, H and S axes with
// unit stride on hd, so the model's (B, S, H, hd) activations pass as
// transposed views.
#include <cuda.h>
#include <math_constants.h>

#include "gemm_tile.cuh"
#include "hopper.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kBQ = 64;         // query rows a block
constexpr int kBK = 64;         // key and value rows a tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLDP = kBK + 16;  // row stride of the P tile: its stores hit 32 banks
constexpr float kNegInf = -1e30f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int h, group, sq, skv;
  long long q_sb, q_sh, q_ss;  // strides of the B, H and S axes, in elements
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal;
  float scale;
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBQ * (HD + 4) + kBQ * kLDP);
}

// Stage 64 rows of a (rows, HD) slice, row stride ld, into shared memory
// as f32 at row stride HD + 4; rows at or past `rows` become zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, long long ld, int rows) {
  constexpr int kLD = HD + 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    dst[r * kLD + c] = r < rows ? to_f32(src[r * ld + c]) : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd(FlashArgs p) {
  constexpr int kLD = HD + 4;
  constexpr int kCols = HD / 16;  // output columns a thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // kBQ x kLD
  float* KVs = Qs + kBQ * kLD;    // kBK x kLD: K, then V, of one tile
  float* Ps = KVs + kBK * kLD;    // kBQ x kLDP

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nq = (p.sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / p.group;
  const T* Q = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh + q0 * p.q_ss;
  const T* K = static_cast<const T*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + bb * p.v_sb + kvh * p.v_sh;
  T* O = static_cast<T*>(p.o) + bb * p.o_sb + hh * p.o_sh;

  stage_tile<T, HD>(Qs, Q, p.q_ss, p.sq - q0);

  float acc[4][kCols], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (p.skv + kBK - 1) / kBK;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + kBQ, p.sq) - 1) / kBK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's V is read
    stage_tile<T, HD>(KVs, K + k0 * p.k_ss, p.k_ss, p.skv - k0);
    __syncthreads();

    // Scores of rows ty + 16 i against columns tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * kLD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * j) * kLD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          s[i][j] = fmaf(qv[i].w, kv[j].w, a);
        }
    }

    // Scale and mask; kv rows past Skv take no weight at all.
    const bool edge = k0 + kBK > p.skv || (p.causal && k0 + kBK - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (edge) {
          if (kpos >= p.skv) x = -CUDART_INF_F;
          else if (p.causal && qpos < kpos) x = kNegInf;
        }
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mt));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * kLDP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();  // K is read, P is written
    stage_tile<T, HD>(KVs, V + k0 * p.v_ss, p.v_ss, p.skv - k0);
    __syncthreads();

    // acc += P V over the tile's kBK rows.
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * kLDP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) vv[c] = KVs[(kk + u) * kLD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = reinterpret_cast<const float*>(&pv[i])[u];
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(w, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos < p.sq) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        O[qpos * p.o_ss + tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_t(const FlashArgs& p, int batch, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.h, batch);
  flash_fwd<T, HD><<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

// The head dims of the configs: 16 (reduced), 64, 96, 128, 160 (and 32).
template <typename T>
cudaError_t launch_hd(const FlashArgs& p, int batch, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_t<T, 16>(p, batch, s);
    case 32: return launch_t<T, 32>(p, batch, s);
    case 64: return launch_t<T, 64>(p, batch, s);
    case 96: return launch_t<T, 96>(p, batch, s);
    case 128: return launch_t<T, 128>(p, batch, s);
    case 160: return launch_t<T, 160>(p, batch, s);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16, f16): wgmma products, TMA loads
// ---------------------------------------------------------------------------

constexpr int kTcBQ = 128;         // query rows a block: two consumer warpgroups of 64
constexpr int kTcBK = 128;         // key and value rows a tile
constexpr int kTcStages = 2;       // K and V tiles in flight
// Warpgroups 0 and 1 consume; warpgroup 2 produces, and one of its threads
// issues every load. ptxas sizes the register pool by whole warpgroups
// (168 a thread at entry for 384 threads, and the same for 288), so the
// producer is a full warpgroup that gives back what the consumers take:
// 128·24 + 256·240 = 384·168.
constexpr int kTcThreads = 384;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared-memory layout for a head dim: each tile is stored as hd / kCE
// chunks of rows x kSw bytes, the swizzle atom TMA writes and wgmma reads.
template <int HD>
struct TcShape {
  static constexpr int kSw = (2 * HD) % 128 == 0 ? 128 : (2 * HD) % 64 == 0 ? 64 : 32;
  static constexpr int kCE = kSw / 2;  // elements of a chunk row
  static constexpr int kChunks = HD / kCE;
  static constexpr int kLayout = repro::wgmma_layout(kSw);
  static constexpr int kQBytes = kTcBQ * HD * 2;
  static constexpr int kKVBytes = kTcBK * HD * 2;  // one K or one V tile
  static constexpr int kBarBytes = 8 * (1 + 3 * kTcStages);
  // 1024 bytes of slack to align the tiles to the swizzle pattern.
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kTcStages * kKVBytes + kBarBytes;
  static_assert(HD % kCE == 0 && kSmem <= 232448, "tiles must fit in 227 KB");
};

struct TcArgs {
  void* o;
  int group, sq, skv;
  long long o_sb, o_sh, o_ss;
  int causal;
  float scale_log2;  // hd^-0.5 · log2(e): the softmax runs on exp2
};

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// The m64nNk16 accumulator layout: register i of thread (warp w, lane) of
// a warpgroup holds row 16 w + lane / 4 + 8 ((i / 2) % 2) and column
// 8 (i / 4) + 2 (lane % 4) + i % 2 of the 64 x N tile.
__device__ __forceinline__ int acc_row(int i) { return 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// O-type product with N = one swizzle atom of hd columns, accumulating.
template <int N, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) repro::wgmma_rs_n16<T>(d, a, db, 1);
  else if constexpr (N == 32) repro::wgmma_rs_n32<T>(d, a, db, 1);
  else repro::wgmma_rs_n64<T>(d, a, db, 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const TcArgs p) {
  using Sh = TcShape<HD>;
  constexpr int kSw = Sh::kSw, kCE = Sh::kCE, kChunks = Sh::kChunks;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const Qs = smem_raw + ((1024 - (repro::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const Ks = Qs + Sh::kQBytes;                  // stage s at + s · kKVBytes
  uint8_t* const Vs = Ks + kTcStages * Sh::kKVBytes;
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(Vs + kTcStages * Sh::kKVBytes);
  uint64_t* const k_full = q_full + 1;
  uint64_t* const v_full = k_full + kTcStages;
  uint64_t* const kv_empty = v_full + kTcStages;

  const int nq = (p.sq + kTcBQ - 1) / kTcBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTcBQ;
  const int hh = blockIdx.y, bb = blockIdx.z, kvh = hh / p.group;
  int n_tiles = (p.skv + kTcBK - 1) / kTcBK;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + kTcBQ, p.sq) - 1) / kTcBK + 1);

  if (threadIdx.x == 0) {
    repro::mbar_init(q_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      repro::mbar_init(&k_full[s], 1);
      repro::mbar_init(&v_full[s], 1);
      repro::mbar_init(&kv_empty[s], 256);  // every consumer thread
    }
    repro::mbar_init_fence();
  }
  __syncthreads();

  // The warpgroup index, read from lane 0 so that ptxas can see it is the
  // same across each warp: it sizes each branch by its setmaxnreg then.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    // Producer: one thread issues every load, the q tile once, then K and
    // V tiles into the ring as the consumers free its slots; the other
    // warps of the warpgroup only hand their registers over.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      repro::mbar_expect_tx(q_full, Sh::kQBytes);
      for (int c = 0; c < kChunks; ++c)
        repro::tma_load_4d(Qs + c * kTcBQ * kSw, &tq, q_full, c * kCE, q0, hh, bb);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kTcStages, use = t / kTcStages;
        repro::mbar_wait(&kv_empty[s], (use & 1) ^ 1);
        uint8_t* const kt = Ks + s * Sh::kKVBytes;
        uint8_t* const vt = Vs + s * Sh::kKVBytes;
        repro::mbar_expect_tx(&k_full[s], Sh::kKVBytes);
        for (int c = 0; c < kChunks; ++c)
          repro::tma_load_4d(kt + c * kTcBK * kSw, &tk, &k_full[s], c * kCE, t * kTcBK, kvh, bb);
        repro::mbar_expect_tx(&v_full[s], Sh::kKVBytes);
        for (int c = 0; c < kChunks; ++c)
          repro::tma_load_4d(vt + c * kTcBK * kSw, &tv, &v_full[s], c * kCE, t * kTcBK, kvh, bb);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int qw = q0 + 64 * wg;                 // first row of this warpgroup
    const int row0 = qw + 16 * (tid / 32) + lane / 4;  // the thread's rows: row0, row0 + 8
    const uint8_t* const Qw = Qs + 64 * wg * kSw;

    float o[kChunks][kCE / 2];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < kCE / 2; ++i) o[c][i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    repro::mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kTcStages, parity = (t / kTcStages) & 1;
      const uint8_t* const kt = Ks + st * Sh::kKVBytes;
      const uint8_t* const vt = Vs + st * Sh::kKVBytes;

      // S = Q Kᵀ over hd, 16 at a time; both tiles K-major (hd contiguous).
      float s[kTcBK / 2];
      repro::mbar_wait(&k_full[st], parity);
      repro::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int off = ((ks * 16) % kCE) * 2;  // bytes into the swizzle atom
        const uint64_t da = repro::wgmma_desc(Qw + (ks * 16 / kCE) * kTcBQ * kSw + off, 16,
                                              8 * kSw, Sh::kLayout);
        const uint64_t db = repro::wgmma_desc(kt + (ks * 16 / kCE) * kTcBK * kSw + off, 16,
                                              8 * kSw, Sh::kLayout);
        repro::wgmma_ss_n128<T>(s, da, db, ks > 0);
      }
      repro::wgmma_commit();
      repro::wgmma_wait_all();
      repro::fence_regs(s);

      // Scale, mask on the registers (only tiles that cross the diagonal or
      // the end of the keys), and the online softmax in f32.
      const int k0 = t * kTcBK;
      const bool edge = k0 + kTcBK > p.skv || (p.causal && k0 + kTcBK - 1 > qw);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kTcBK / 2; ++i) {
        float x = s[i] * p.scale_log2;
        if (edge) {
          const int col = k0 + acc_col(i, lane), row = row0 + acc_row(i);
          if (col >= p.skv || (p.causal && row < col)) x = -CUDART_INF_F;
        }
        s[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
      uint32_t pa[kTcBK / 16][4];
#pragma unroll
      for (int i = 0; i < kTcBK / 2; ++i) {
        s[i] = exp2f(s[i] - mx[(i >> 1) & 1]);
        rs[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) pa[kk][q] = pack2<T>(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int i = 0; i < kCE / 2; ++i) o[c][i] *= corr[(i >> 1) & 1];

      // O += P V: P from registers (the S accumulator's layout is the A
      // fragment's), V MN-major (hd contiguous) with the transpose bit,
      // one swizzle atom of hd columns a product.
      repro::mbar_wait(&v_full[st], parity);
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk)
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const uint64_t db = repro::wgmma_desc(vt + c * kTcBK * kSw + kk * 16 * kSw,
                                                kTcBK * kSw, 8 * kSw, Sh::kLayout);
          wgmma_rs<kCE, T>(o[c], pa[kk], db);
        }
      repro::wgmma_commit();
      repro::wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < kChunks; ++c) repro::fence_regs(o[c]);
      repro::mbar_arrive(&kv_empty[st]);
    }

    // l sums this thread's columns; the row's four threads add theirs.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    T* const O = static_cast<T*>(p.o) + bb * p.o_sb + hh * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.sq) continue;
      T* const orow = O + row * p.o_ss;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int j = 0; j < kCE / 8; ++j) {
          const int col = c * kCE + acc_col(4 * j, lane);
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack2<T>(o[c][4 * j + 2 * r] * inv[r], o[c][4 * j + 2 * r + 1] * inv[r]);
        }
    }
  }
}

// The tensor map of a (batch, heads, s, hd) operand at strides (sb, sh, ss)
// in elements, unit stride on hd, as a 4-D tensor (hd, s, heads, batch)
// cut into boxes of kSw bytes of hd by `rows` rows. An axis of extent 1
// takes the stride its neighbour implies: its stride is never followed.
template <typename T, int HD>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int s, int heads, int batch,
                     long long sb, long long sh, long long ss, int rows) {
  using Sh = TcShape<HD>;
  const repro::EncodeTiled encode = repro::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (s == 1) ss = HD;
  if (heads == 1) sh = ss * s;
  if (batch == 1) sb = sh * heads;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {Sh::kCE, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = Sh::kSw == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : Sh::kSw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                     : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapDataType type = std::is_same_v<T, __nv_bfloat16>
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUresult r = encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int HD>
cudaError_t launch_tc(const FlashArgs& p, int batch, int kv_heads, cudaStream_t s) {
  using Sh = TcShape<HD>;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map<T, HD>(&tq, p.q, p.sq, p.h, batch, p.q_sb, p.q_sh, p.q_ss, kTcBQ)) ||
      (err = make_map<T, HD>(&tk, p.k, p.skv, kv_heads, batch, p.k_sb, p.k_sh, p.k_ss, kTcBK)) ||
      (err = make_map<T, HD>(&tv, p.v, p.skv, kv_heads, batch, p.v_sb, p.v_sh, p.v_ss, kTcBK)))
    return err;
  err = cudaFuncSetAttribute(flash_fwd_tc<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Sh::kSmem));
  if (err != cudaSuccess) return err;
  const TcArgs args{p.o, p.group, p.sq, p.skv, p.o_sb, p.o_sh, p.o_ss, p.causal,
                    p.scale * 1.4426950408889634f};
  const dim3 grid((p.sq + kTcBQ - 1) / kTcBQ, p.h, batch);
  flash_fwd_tc<T, HD><<<grid, kTcThreads, Sh::kSmem, s>>>(tq, tk, tv, args);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc_hd(const FlashArgs& p, int batch, int kv_heads, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_tc<T, 16>(p, batch, kv_heads, s);
    case 32: return launch_tc<T, 32>(p, batch, kv_heads, s);
    case 64: return launch_tc<T, 64>(p, batch, kv_heads, s);
    case 96: return launch_tc<T, 96>(p, batch, kv_heads, s);
    case 128: return launch_tc<T, 128>(p, batch, kv_heads, s);
    case 160: return launch_tc<T, 160>(p, batch, kv_heads, s);
  }
  return cudaErrorInvalidValue;
}

// Registers, static and dynamic shared memory and local (spill) bytes of
// the kernel that `dtype` and `hd` launch.
template <typename T, int HD>
cudaError_t attributes_t(int* out) {
  cudaFuncAttributes fa;
  size_t dynamic;
  cudaError_t err;
  if constexpr (std::is_same_v<T, float>) {
    err = cudaFuncGetAttributes(&fa, flash_fwd<T, HD>);
    dynamic = smem_bytes<HD>();
  } else {
    err = cudaFuncGetAttributes(&fa, flash_fwd_tc<T, HD>);
    dynamic = TcShape<HD>::kSmem;
  }
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = static_cast<int>(dynamic);
  out[3] = static_cast<int>(fa.localSizeBytes);
  return cudaSuccess;
}

template <typename T>
cudaError_t attributes_hd(int hd, int* out) {
  switch (hd) {
    case 16: return attributes_t<T, 16>(out);
    case 32: return attributes_t<T, 32>(out);
    case 64: return attributes_t<T, 64>(out);
    case 96: return attributes_t<T, 96>(out);
    case 128: return attributes_t<T, 128>(out);
    case 160: return attributes_t<T, 160>(out);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o: (batch, h, sq, hd); k, v: (batch, kv_heads, skv, hd); each at its
// own strides for the first three axes and unit stride on hd; one dtype.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int batch, int h, int kv_heads, int sq, int skv, int hd,
                                     long long q_sb, long long q_sh, long long q_ss,
                                     long long k_sb, long long k_sh, long long k_ss,
                                     long long v_sb, long long v_sh, long long v_ss,
                                     long long o_sb, long long o_sh, long long o_ss,
                                     int causal, float scale, int dtype, void* stream) {
  if (batch == 0 || h == 0 || sq == 0) return 0;
  if (kv_heads < 1 || h % kv_heads || skv < 1 || h > 65535 || batch > 65535)
    return cudaErrorInvalidValue;
  const FlashArgs p{q, k, v, o, h, h / kv_heads, sq, skv,
                    q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                    causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32: return launch_hd<float>(p, batch, hd, s);
    case repro::kBF16: return launch_tc_hd<__nv_bfloat16>(p, batch, kv_heads, hd, s);
    case repro::kF16: return launch_tc_hd<__half>(p, batch, kv_heads, hd, s);
  }
  return cudaErrorInvalidValue;
}

// out[0..3]: registers a thread, static and dynamic shared memory, and
// local (spill) bytes of the kernel that dtype and hd launch.
extern "C" int repro_flash_attention_attributes(int dtype, int hd, int* out) {
  switch (dtype) {
    case repro::kF32: return attributes_hd<float>(hd, out);
    case repro::kBF16: return attributes_hd<__nv_bfloat16>(hd, out);
    case repro::kF16: return attributes_hd<__half>(hd, out);
  }
  return cudaErrorInvalidValue;
}
