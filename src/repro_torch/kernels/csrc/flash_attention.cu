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
// Sliding window (causal only, the hybrid family's attention): query i sees
// key j iff 0 <= i - j < window, the reference's `_chunk_mask`
// (src/repro/models/attention.py:47-56). Both kernels start their kv walk
// at the band's first tile for the block's first row, as the reference's
// `_kv_band` does, so tiles wholly below the band are never loaded, and
// mask the band's lower edge on the tiles that cross it. Live pairs a
// (batch, head) at S >= w: S·w - w(w - 1)/2.
//
// Head dims 16, 32, 64, 80, 96, 128, 160. hd 80 (hubert-xlarge) takes the
// 32-byte swizzle of hd 16 with 5 chunks a row, and its P V products are
// five n16 wgmma a k-step. The backward is built for the others only.
//
// Both take a ragged sequence and any strides on the B, H and S axes with
// unit stride on hd, so the model's (B, S, H, hd) activations pass as
// transposed views. Given a non-null `lse`, both also write each query
// row's log-sum-exp, m + log(l) in natural-log units, as f32 (B, H, Sq):
// what the backward needs to recompute P. The serving path passes null and
// runs the same code, with one predicated store skipped at the end.
//
// Backward (flash_bwd_*): dQ, dK, dV of the same function. The JAX package
// has no backward kernel: its models differentiate the chunked scan
// `_attend_chunked` (src/repro/models/attention.py:77-143), whose gradient
// XLA derives. Three launches, f32 sums, split by dtype like the forward:
//  * flash_bwd_delta (every dtype): D = rowsum(dO o O), one warp a query
//    row; for the tensor-core kernels it also writes lse·log2(e), both
//    padded with zeros to a multiple of 128 rows so that a tile's rows are
//    one bulk copy.
//  * bf16 and f16, on Hopper's tensor cores (the FlashAttention-3 shape),
//    384 threads as the forward: one producer warpgroup (24 registers; one
//    thread issues every TMA load) and two consumer warpgroups (240):
//    - flash_bwd_dkdv_tc: one block a (batch, kv head, 128-row kv tile),
//      64 kv rows a consumer. K and V come in once; the 64-row Q and dO
//      tiles (32 rows at hd 160) of every query head of the group, each with
//      its rows' lse and D, stream through a two-stage ring, head after head
//      in a fixed order (the GQA sum stays in the block, no drain between
//      heads), from the diagonal on when causal. Sᵀ = K Qᵀ and dPᵀ = V dOᵀ
//      are SS wgmma (both operands K-major, hd the reduction axis);
//      Pᵀ = exp2(Sᵀ·scale·log2e − lse·log2e) and dSᵀ = Pᵀ o (dPᵀ − D) are
//      computed on the accumulator registers (lse and D index columns), the
//      masks only on tiles that cross the diagonal or an end; then
//      dV += Pᵀ dO and dK += dSᵀ Q are RS wgmma: Pᵀ and dSᵀ rounded to the
//      operand dtype are A fragments in place (the forward's P trick), and
//      the same swizzled Q and dO tiles are read MN-major through the
//      transpose bit. P and dS never touch shared memory.
//    - flash_bwd_dq_tc: one block a (batch, head, 128-row query tile),
//      longest first, 64 query rows a consumer; 64-row K and V tiles stream
//      through the ring. S = Q Kᵀ and dP = dO Vᵀ are SS wgmma, dS is made
//      in registers, dQ += dS K is RS wgmma with K read MN-major.
//    Both grids put the tile index on their slowest axis, so that every
//    head's longest tiles (when causal) are issued first and the short
//    ones fill the tail.
//    hd 160 takes 32-row query tiles in the dK/dV kernel: with Sᵀ and dPᵀ
//    at n32, its 80 + 80 dK and dV accumulators stay in registers. Shared
//    memory at hd 128: 130 KB (dK/dV: K, V and two stages of Q and dO) and
//    129 KB (dQ: Q, dO and two stages of K and V).
//  * f32: FFMA (flash_bwd_dkdv, flash_bwd_dq: 64 x 64 tiles, 256 threads as
//    16 x 16, operands staged in f32). TF32 products would not hold the f32
//    tolerance, and no f32 path trains; the same walks as the tensor-core
//    kernels with 64-row kv tiles.
//  dQ gets its own pass instead of f32 atomics from the dK/dV blocks: it
//  recomputes S and dP once more (14·hd operations a live pair instead of
//  10·hd), and in return every gradient is summed in one fixed order, so a
//  training step gives the same bits each time it runs.
//  Bound on an H100: 10·hd operations a live (q, k) pair at the tensor
//  cores' rate (989 TFLOP/s) in bf16 and f16, at the f32 rate (67) in f32.
//  Rounding Pᵀ and dSᵀ to the operand dtype before their products is the
//  forward's choice and FlashAttention-3's (`attention_bwd_rounded_ref` is
//  that arithmetic in plain torch).
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
static_assert(kBQ == kBK, "the backward's causal tile walk assumes square tiles");
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
  float* lse;  // (B, H, Sq) f32 log-sum-exp of each query row, or nullptr
  int window;  // > 0: query i sees key j iff 0 <= i - j < window (causal only)
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
  // A window starts the walk at the band's first tile (the reference's
  // `_kv_band`): tiles wholly below the band are never loaded.
  const int t_lo = p.window > 0 ? max(0, q0 - p.window + 1) / kBK : 0;

  for (int t = t_lo; t < n_tiles; ++t) {
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

    // Scale and mask; kv rows past Skv, and below the band, take no weight at all.
    const bool edge = k0 + kBK > p.skv || (p.causal && k0 + kBK - 1 > q0) ||
                      (p.window > 0 && q0 + kBQ - 1 - k0 >= p.window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (edge) {
          if (kpos >= p.skv || (p.window > 0 && qpos - kpos >= p.window)) x = -CUDART_INF_F;
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
      if (p.lse != nullptr && tx == 0)
        p.lse[(static_cast<long long>(bb) * p.h + hh) * p.sq + qpos] = m[i] + logf(denom);
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

// The head dims of the configs: 16 (reduced), 64, 80, 96, 128, 160 (and 32).
template <typename T>
cudaError_t launch_hd(const FlashArgs& p, int batch, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_t<T, 16>(p, batch, s);
    case 32: return launch_t<T, 32>(p, batch, s);
    case 64: return launch_t<T, 64>(p, batch, s);
    case 80: return launch_t<T, 80>(p, batch, s);
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
  float* lse;        // (B, H, Sq) f32, natural-log units, or nullptr
  int h;
  int window;        // > 0: the band 0 <= i - j < window (causal only)
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

// kWindow: the sliding-window build; without it the band code folds away,
// so the full and causal paths compile as they did before the window.
template <typename T, int HD, bool kWindow>
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
  // The band's first tile for the block's first row: the walk starts there.
  const int t_lo = kWindow ? max(0, q0 - p.window + 1) / kTcBK : 0;

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
      for (int t = t_lo; t < n_tiles; ++t) {
        const int s = (t - t_lo) % kTcStages, use = (t - t_lo) / kTcStages;
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
    for (int t = t_lo; t < n_tiles; ++t) {
      const int st = (t - t_lo) % kTcStages, parity = ((t - t_lo) / kTcStages) & 1;
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

      // Scale, mask on the registers (only tiles that cross the diagonal,
      // the band's lower edge or the end of the keys), and the online
      // softmax in f32. A row may find a whole tile below its band: its
      // scores are -inf against m = -1e30, so the tile adds nothing.
      const int k0 = t * kTcBK;
      const bool edge = k0 + kTcBK > p.skv || (p.causal && k0 + kTcBK - 1 > qw) ||
                        (kWindow && qw + 63 - k0 >= p.window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kTcBK / 2; ++i) {
        float x = s[i] * p.scale_log2;
        if (edge) {
          const int col = k0 + acc_col(i, lane), row = row0 + acc_row(i);
          if (col >= p.skv || (p.causal && row < col) || (kWindow && row - col >= p.window))
            x = -CUDART_INF_F;
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
      // m and l run in log2 units of the scaled scores
      if (p.lse != nullptr && (lane & 3) == 0)
        p.lse[(static_cast<long long>(bb) * p.h + hh) * p.sq + row] =
            (m[r] + log2f(fmaxf(l[r], 1e-30f))) * 0.69314718055994531f;
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
  const auto kernel = p.window > 0 ? flash_fwd_tc<T, HD, true> : flash_fwd_tc<T, HD, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Sh::kSmem));
  if (err != cudaSuccess) return err;
  const TcArgs args{p.o, p.group, p.sq, p.skv, p.o_sb, p.o_sh, p.o_ss, p.causal,
                    p.scale * 1.4426950408889634f, p.lse, p.h, p.window};
  const dim3 grid((p.sq + kTcBQ - 1) / kTcBQ, p.h, batch);
  kernel<<<grid, kTcThreads, Sh::kSmem, s>>>(tq, tk, tv, args);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc_hd(const FlashArgs& p, int batch, int kv_heads, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_tc<T, 16>(p, batch, kv_heads, s);
    case 32: return launch_tc<T, 32>(p, batch, kv_heads, s);
    case 64: return launch_tc<T, 64>(p, batch, kv_heads, s);
    case 80: return launch_tc<T, 80>(p, batch, kv_heads, s);
    case 96: return launch_tc<T, 96>(p, batch, kv_heads, s);
    case 128: return launch_tc<T, 128>(p, batch, kv_heads, s);
    case 160: return launch_tc<T, 160>(p, batch, kv_heads, s);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Backward: D in every dtype; f32 on FFMA, f32 sums, 64 x 64 tiles, 256
// threads as 16 x 16
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq) f32, from the forward
  void* dq;
  void* dk;
  void* dv;
  float* delta;      // f32 scratch, 2·B·H·bwd_ld(Sq): D = rowsum(dO o O), then lse·log2(e)
  int h, group, sq, skv;
  long long q_sb, q_sh, q_ss;  // strides of the B, H and S axes, in elements
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int causal;
  float scale;
};

// K, V, Q and dO tiles, P and dS tiles, the q rows' lse and D.
template <int HD>
constexpr size_t bwd_dkdv_smem() {
  return sizeof(float) * (4 * kBQ * (HD + 4) + 2 * kBK * kLDP + 2 * kBQ);
}

// Q, dO, K and V tiles, the dS tile, the q rows' lse and D.
template <int HD>
constexpr size_t bwd_dq_smem() {
  return sizeof(float) * (4 * kBQ * (HD + 4) + kBQ * kLDP + 2 * kBQ);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return reinterpret_cast<const float*>(&v)[u];
}

// D = rowsum(dO o O) in f32, one warp a query row, at
// delta[(b·h + head)·ld + row] for rows below ld, zero from sq on. With a
// non-null `lse2`, also the forward's lse in log2 units at the same place
// (zero from sq on): the tensor-core kernels copy a tile's rows of both.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta(BwdArgs p, int ld, float* lse2) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int hh = blockIdx.y, bb = blockIdx.z;
  if (row >= ld) return;
  float acc = 0.f;
  if (row < p.sq) {  // the same for the whole warp
    const T* O = static_cast<const T*>(p.o) + bb * p.o_sb + hh * p.o_sh + row * p.o_ss;
    const T* dO = static_cast<const T*>(p.dout) + bb * p.do_sb + hh * p.do_sh + row * p.do_ss;
#pragma unroll
    for (int d = lane; d < HD; d += 32) acc = fmaf(to_f32(O[d]), to_f32(dO[d]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    const long long head = static_cast<long long>(bb) * p.h + hh;
    p.delta[head * ld + row] = acc;
    if (lse2 != nullptr)
      lse2[head * ld + row] = row < p.sq ? p.lse[head * p.sq + row] * 1.4426950408889634f : 0.f;
  }
}

// Stage the q tile's lse and D (rows past Sq read as 0; their P is masked).
__device__ __forceinline__ void stage_rows(float* Ls, float* Ds, const BwdArgs& p, int bb,
                                           int hh, int q0) {
  if (threadIdx.x < kBQ) {
    const int r = q0 + threadIdx.x;
    const long long at = (static_cast<long long>(bb) * p.h + hh) * p.sq + r;
    Ls[threadIdx.x] = r < p.sq ? p.lse[at] : 0.f;
    Ds[threadIdx.x] = r < p.sq ? p.delta[at] : 0.f;
  }
}

// dK and dV of one 64-row kv tile, summed over the group's query heads.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv(BwdArgs p) {
  constexpr int kLD = HD + 4;
  constexpr int kCols = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;               // kBK x kLD
  float* Vs = Ks + kBK * kLD;
  float* Qs = Vs + kBK * kLD;     // kBQ x kLD
  float* dOs = Qs + kBQ * kLD;
  float* Ps = dOs + kBQ * kLD;    // kBK x kLDP: row = kv row, column = q row
  float* dSs = Ps + kBK * kLDP;
  float* Ls = dSs + kBK * kLDP;   // kBQ
  float* Ds = Ls + kBQ;           // kBQ

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y, bb = blockIdx.z;
  stage_tile<T, HD>(Ks, static_cast<const T*>(p.k) + bb * p.k_sb + kvh * p.k_sh + k0 * p.k_ss,
                    p.k_ss, p.skv - k0);
  stage_tile<T, HD>(Vs, static_cast<const T*>(p.v) + bb * p.v_sb + kvh * p.v_sh + k0 * p.v_ss,
                    p.v_ss, p.skv - k0);

  float dk[4][kCols], dv[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[a][c] = dv[a][c] = 0.f;

  // Causal: query rows before k0 see none of this tile (kBQ == kBK).
  const int q_begin = p.causal ? k0 : 0;
  for (int hh = kvh * p.group; hh < (kvh + 1) * p.group; ++hh) {
    const T* Qh = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
    const T* dOh = static_cast<const T*>(p.dout) + bb * p.do_sb + hh * p.do_sh;
    for (int q0 = q_begin; q0 < p.sq; q0 += kBQ) {
      __syncthreads();  // the previous tile's Q, dO, P and dS are read
      stage_tile<T, HD>(Qs, Qh + q0 * p.q_ss, p.q_ss, p.sq - q0);
      stage_tile<T, HD>(dOs, dOh + q0 * p.do_ss, p.do_ss, p.sq - q0);
      stage_rows(Ls, Ds, p, bb, hh, q0);
      __syncthreads();

      // S and dP of kv rows ty + 16 a against q rows tx + 16 b.
      float s[4][4], dp[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HD; d += 4) {
        float4 kr[4], vr[4], qr[4], orow[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          kr[a] = *reinterpret_cast<const float4*>(&Ks[(ty + 16 * a) * kLD + d]);
          vr[a] = *reinterpret_cast<const float4*>(&Vs[(ty + 16 * a) * kLD + d]);
        }
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          qr[b] = *reinterpret_cast<const float4*>(&Qs[(tx + 16 * b) * kLD + d]);
          orow[b] = *reinterpret_cast<const float4*>(&dOs[(tx + 16 * b) * kLD + d]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            s[a][b] = dot4(kr[a], qr[b], s[a][b]);
            dp[a][b] = dot4(vr[a], orow[b], dp[a][b]);
          }
      }

      // P from the forward's lse; masked pairs (past Sq or Skv, or above
      // the diagonal) take no weight. dS = P o (dP - D).
      const bool edge = q0 + kBQ > p.sq || k0 + kBK > p.skv || (p.causal && q0 < k0 + kBK - 1);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = q0 + tx + 16 * b, j = k0 + ty + 16 * a;
          float pr = expf(s[a][b] * p.scale - Ls[tx + 16 * b]);
          if (edge && (i >= p.sq || j >= p.skv || (p.causal && i < j))) pr = 0.f;
          Ps[(ty + 16 * a) * kLDP + tx + 16 * b] = pr;
          dSs[(ty + 16 * a) * kLDP + tx + 16 * b] = pr * (dp[a][b] - Ds[tx + 16 * b]);
        }
      __syncthreads();

      // dV += Pᵀ dO and dK += dSᵀ Q over the tile's q rows.
#pragma unroll 2
      for (int i = 0; i < kBQ; i += 4) {
        float4 pv[4], sv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pv[a] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * a) * kLDP + i]);
          sv[a] = *reinterpret_cast<const float4*>(&dSs[(ty + 16 * a) * kLDP + i]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float ov[kCols], qv[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            ov[c] = dOs[(i + u) * kLD + tx + 16 * c];
            qv[c] = Qs[(i + u) * kLD + tx + 16 * c];
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float w = lane_of(pv[a], u), ws = lane_of(sv[a], u);
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              dv[a][c] = fmaf(w, ov[c], dv[a][c]);
              dk[a][c] = fmaf(ws, qv[c], dk[a][c]);
            }
          }
        }
      }
    }
  }

  T* dK = static_cast<T*>(p.dk) + bb * p.dk_sb + kvh * p.dk_sh;
  T* dV = static_cast<T*>(p.dv) + bb * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= p.skv) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dK[j * p.dk_ss + tx + 16 * c] = from_f32<T>(dk[a][c] * p.scale);
      dV[j * p.dv_ss + tx + 16 * c] = from_f32<T>(dv[a][c]);
    }
  }
}

// dQ of one 64-row query tile of one head.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq(BwdArgs p) {
  constexpr int kLD = HD + 4;
  constexpr int kCols = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // kBQ x kLD
  float* dOs = Qs + kBQ * kLD;
  float* Ks = dOs + kBQ * kLD;    // kBK x kLD
  float* Vs = Ks + kBK * kLD;
  float* dSs = Vs + kBK * kLD;    // kBQ x kLDP: row = q row, column = kv row
  float* Ls = dSs + kBQ * kLDP;   // kBQ
  float* Ds = Ls + kBQ;           // kBQ

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nq = (p.sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBQ;  // longest first
  const int hh = blockIdx.y, bb = blockIdx.z, kvh = hh / p.group;
  const T* K = static_cast<const T*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + bb * p.v_sb + kvh * p.v_sh;
  stage_tile<T, HD>(Qs, static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh + q0 * p.q_ss,
                    p.q_ss, p.sq - q0);
  stage_tile<T, HD>(dOs,
                    static_cast<const T*>(p.dout) + bb * p.do_sb + hh * p.do_sh + q0 * p.do_ss,
                    p.do_ss, p.sq - q0);
  stage_rows(Ls, Ds, p, bb, hh, q0);

  float dq[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[a][c] = 0.f;

  int n_tiles = (p.skv + kBK - 1) / kBK;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + kBQ, p.sq) - 1) / kBK + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K and dS are read
    stage_tile<T, HD>(Ks, K + k0 * p.k_ss, p.k_ss, p.skv - k0);
    stage_tile<T, HD>(Vs, V + k0 * p.v_ss, p.v_ss, p.skv - k0);
    __syncthreads();

    // S and dP of q rows ty + 16 a against kv rows tx + 16 b.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 qr[4], orow[4], kr[4], vr[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qr[a] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * a) * kLD + d]);
        orow[a] = *reinterpret_cast<const float4*>(&dOs[(ty + 16 * a) * kLD + d]);
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        kr[b] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * b) * kLD + d]);
        vr[b] = *reinterpret_cast<const float4*>(&Vs[(tx + 16 * b) * kLD + d]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          s[a][b] = dot4(qr[a], kr[b], s[a][b]);
          dp[a][b] = dot4(orow[a], vr[b], dp[a][b]);
        }
    }

    const bool edge = q0 + kBQ > p.sq || k0 + kBK > p.skv || (p.causal && q0 < k0 + kBK - 1);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = q0 + ty + 16 * a, j = k0 + tx + 16 * b;
        float pr = expf(s[a][b] * p.scale - Ls[ty + 16 * a]);
        if (edge && (i >= p.sq || j >= p.skv || (p.causal && i < j))) pr = 0.f;
        dSs[(ty + 16 * a) * kLDP + tx + 16 * b] = pr * (dp[a][b] - Ds[ty + 16 * a]);
      }
    __syncthreads();

    // dQ += dS K over the tile's kv rows.
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 sv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        sv[a] = *reinterpret_cast<const float4*>(&dSs[(ty + 16 * a) * kLDP + j]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float kv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) kv[c] = Ks[(j + u) * kLD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float w = lane_of(sv[a], u);
#pragma unroll
          for (int c = 0; c < kCols; ++c) dq[a][c] = fmaf(w, kv[c], dq[a][c]);
        }
      }
    }
  }

  T* dQ = static_cast<T*>(p.dq) + bb * p.dq_sb + hh * p.dq_sh;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= p.sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dQ[i * p.dq_ss + tx + 16 * c] = from_f32<T>(dq[a][c] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// Backward on the tensor cores (bf16, f16): wgmma products, TMA loads
// ---------------------------------------------------------------------------

// Rows of the delta and lse·log2(e) scratch a (batch, head): Sq padded to a
// whole 128-row tile, so that every staged tile's rows lie inside it.
__host__ __device__ constexpr int bwd_ld(int sq) { return (sq + 127) / 128 * 128; }

// dK/dV kernel: 128 kv rows a block, 64 a consumer warpgroup; query tiles
// of kBQ rows, each with its rows' lse and D, through a ring of kStages.
template <int HD>
struct DkdvShape {
  static constexpr int kBK = 128;
  // hd 160: Sᵀ and dPᵀ at n32 leave room for the 80 + 80 dK, dV registers
  static constexpr int kBQ = HD <= 128 ? 64 : 32;
  static constexpr int kStages = 2;
  static constexpr int kKVBytes = kBK * HD * 2;  // one K or one V tile
  static constexpr int kQBytes = kBQ * HD * 2;   // one Q or one dO tile
  static constexpr int kRowBytes = kBQ * 4;      // one tile's lse or D
  static constexpr int kStageTx = 2 * kQBytes + 2 * kRowBytes;
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr size_t kSmem = 1024 + 2 * kKVBytes + kStages * kStageTx + kBarBytes;
  static_assert(kSmem <= 232448, "tiles must fit in 227 KB");
};

// dQ kernel: 128 query rows a block, 64 a consumer warpgroup; kv tiles of
// kBK rows through a ring of kStages.
template <int HD>
struct DqShape {
  static constexpr int kBQ = 128;
  static constexpr int kBK = 64;
  static constexpr int kStages = 2;
  static constexpr int kQBytes = kBQ * HD * 2;   // one Q or one dO tile
  static constexpr int kKVBytes = kBK * HD * 2;  // one K or one V tile
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr size_t kSmem = 1024 + 2 * kQBytes + 2 * kStages * kKVBytes + kBarBytes;
  static_assert(kSmem <= 232448, "tiles must fit in 227 KB");
};

struct BwdTcArgs {
  void* dq;
  void* dk;
  void* dv;
  const float* delta;  // (B, H, ld) f32: D, zero from Sq on
  const float* lse2;   // (B, H, ld) f32: lse·log2(e), zero from Sq on
  int h, group, sq, skv, ld;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int causal;
  float scale;       // hd^-0.5
  float scale_log2;  // hd^-0.5 · log2(e)
};

template <int N, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 32) repro::wgmma_ss_n32<T>(d, da, db, scale_d);
  else repro::wgmma_ss_n64<T>(d, da, db, scale_d);
}

// d = A Bᵀ over hd, both read K-major: A the 64 rows at `a` of a tile of
// AR rows, B the N rows of the tile at `b`. Tiles are hd / kCE chunks of
// rows x kSw bytes, as TMA writes them.
template <typename T, int HD, int AR, int N>
__device__ __forceinline__ void product_over_hd(float (&d)[N / 2], const uint8_t* a,
                                                const uint8_t* b) {
  using Sh = TcShape<HD>;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int chunk = ks * 16 / Sh::kCE, off = ((ks * 16) % Sh::kCE) * 2;
    const uint64_t da =
        repro::wgmma_desc(a + chunk * AR * Sh::kSw + off, 16, 8 * Sh::kSw, Sh::kLayout);
    const uint64_t db =
        repro::wgmma_desc(b + chunk * N * Sh::kSw + off, 16, 8 * Sh::kSw, Sh::kLayout);
    wgmma_ss<N, T>(d, da, db, ks > 0);
  }
}

// d += A B: A (64 x K) from registers as K / 16 fragments, B the K x hd
// tile at `b` read MN-major through the transpose bit, one swizzle atom of
// hd columns a product (the forward's P V).
template <typename T, int HD, int K>
__device__ __forceinline__ void product_into_hd(
    float (&d)[TcShape<HD>::kChunks][TcShape<HD>::kCE / 2], const uint32_t (&a)[K / 16][4],
    const uint8_t* b) {
  using Sh = TcShape<HD>;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int c = 0; c < Sh::kChunks; ++c) {
      const uint64_t db = repro::wgmma_desc(b + c * K * Sh::kSw + kk * 16 * Sh::kSw,
                                            K * Sh::kSw, 8 * Sh::kSw, Sh::kLayout);
      wgmma_rs<Sh::kCE, T>(d[c], a[kk], db);
    }
}

// An m64nNk16 accumulator rounded to A fragments of K = N: the accumulator
// layout of 16 columns is the A fragment layout (the forward's P).
template <typename T, int N>
__device__ __forceinline__ void to_frags(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) a[kk][q] = pack2<T>(x[8 * kk + 2 * q], x[8 * kk + 2 * q + 1]);
}

template <int HD>
__device__ __forceinline__ void zero_acc(float (&d)[TcShape<HD>::kChunks][TcShape<HD>::kCE / 2]) {
#pragma unroll
  for (int c = 0; c < TcShape<HD>::kChunks; ++c)
#pragma unroll
    for (int i = 0; i < TcShape<HD>::kCE / 2; ++i) d[c][i] = 0.f;
}

template <int HD>
__device__ __forceinline__ void fence_acc(float (&d)[TcShape<HD>::kChunks][TcShape<HD>::kCE / 2]) {
#pragma unroll
  for (int c = 0; c < TcShape<HD>::kChunks; ++c) repro::fence_regs(d[c]);
}

// Store a 64 x hd accumulator times `scale`: this thread's rows `row` and
// row + 8 (absolute positions, at stride ss from `base`), those below `rows`.
template <typename T, int HD>
__device__ __forceinline__ void store_acc(T* base, long long ss, int row, int rows,
                                          const float (&d)[TcShape<HD>::kChunks][TcShape<HD>::kCE / 2],
                                          float scale, int lane) {
  using Sh = TcShape<HD>;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= rows) continue;
    T* const out = base + (row + 8 * r) * ss;
#pragma unroll
    for (int c = 0; c < Sh::kChunks; ++c)
#pragma unroll
      for (int j = 0; j < Sh::kCE / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + c * Sh::kCE + acc_col(4 * j, lane)) =
            pack2<T>(d[c][4 * j + 2 * r] * scale, d[c][4 * j + 2 * r + 1] * scale);
  }
}

// dK and dV of one 128-row kv tile, summed over the group's query heads.
template <typename T, int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const BwdTcArgs p) {
  using Sh = TcShape<HD>;
  using Kv = DkdvShape<HD>;
  constexpr int kSw = Sh::kSw, kCE = Sh::kCE, kChunks = Sh::kChunks;
  constexpr int kBQ = Kv::kBQ, kBK = Kv::kBK, kStages = Kv::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const Ks = smem_raw + ((1024 - (repro::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const Vs = Ks + Kv::kKVBytes;
  uint8_t* const Qs = Vs + Kv::kKVBytes;                  // stage s at + s · kQBytes
  uint8_t* const dOs = Qs + kStages * Kv::kQBytes;
  float* const Ls = reinterpret_cast<float*>(dOs + kStages * Kv::kQBytes);  // + s · kBQ
  float* const Ds = Ls + kStages * kBQ;
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(Ds + kStages * kBQ);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + kStages;

  const int k0 = blockIdx.z * kBK;
  const int kvh = blockIdx.x, bb = blockIdx.y;
  const int h_begin = kvh * p.group, h_end = h_begin + p.group;
  // Causal: query rows before k0 see none of this tile (k0 is a multiple of kBQ).
  const int q_begin = p.causal ? k0 : 0;

  if (threadIdx.x == 0) {
    repro::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], 256);  // every consumer thread
    }
    repro::mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      repro::mbar_expect_tx(kv_full, 2 * Kv::kKVBytes);
      for (int c = 0; c < kChunks; ++c) {
        repro::tma_load_4d(Ks + c * kBK * kSw, &tk, kv_full, c * kCE, k0, kvh, bb);
        repro::tma_load_4d(Vs + c * kBK * kSw, &tv, kv_full, c * kCE, k0, kvh, bb);
      }
      int s = 0, phase = 0;
      for (int hh = h_begin; hh < h_end; ++hh)
        for (int q0 = q_begin; q0 < p.sq; q0 += kBQ) {
          repro::mbar_wait(&empty[s], phase ^ 1);
          repro::mbar_expect_tx(&full[s], Kv::kStageTx);
          uint8_t* const qt = Qs + s * Kv::kQBytes;
          uint8_t* const dot = dOs + s * Kv::kQBytes;
          for (int c = 0; c < kChunks; ++c) {
            repro::tma_load_4d(qt + c * kBQ * kSw, &tq, &full[s], c * kCE, q0, hh, bb);
            repro::tma_load_4d(dot + c * kBQ * kSw, &tdo, &full[s], c * kCE, q0, hh, bb);
          }
          const long long at = (static_cast<long long>(bb) * p.h + hh) * p.ld + q0;
          repro::bulk_load(Ls + s * kBQ, p.lse2 + at, Kv::kRowBytes, &full[s]);
          repro::bulk_load(Ds + s * kBQ, p.delta + at, Kv::kRowBytes, &full[s]);
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int kw = k0 + 64 * wg;                        // first kv row of this warpgroup
    const int row = kw + 16 * (tid / 32) + lane / 4;    // the thread's kv rows: row, row + 8
    const uint8_t* const Kw = Ks + 64 * wg * kSw;
    const uint8_t* const Vw = Vs + 64 * wg * kSw;

    float dk[kChunks][kCE / 2], dv[kChunks][kCE / 2];
    zero_acc<HD>(dk);
    zero_acc<HD>(dv);

    repro::mbar_wait(kv_full, 0);
    int s = 0, phase = 0;
    for (int hh = h_begin; hh < h_end; ++hh)
      for (int q0 = q_begin; q0 < p.sq; q0 += kBQ) {
        repro::mbar_wait(&full[s], phase);
        // A tile wholly above this warpgroup's diagonal, or past Skv, adds nothing.
        if (kw < p.skv && !(p.causal && q0 + kBQ - 1 < kw)) {
          const uint8_t* const qt = Qs + s * Kv::kQBytes;
          const uint8_t* const dot = dOs + s * Kv::kQBytes;
          // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: rows are kv rows, columns query rows.
          float st[kBQ / 2], dpt[kBQ / 2];
          repro::wgmma_fence();
          product_over_hd<T, HD, kBK, kBQ>(st, Kw, qt);
          product_over_hd<T, HD, kBK, kBQ>(dpt, Vw, dot);
          repro::wgmma_commit();
          repro::wgmma_wait_all();
          repro::fence_regs(st);
          repro::fence_regs(dpt);

          // Pᵀ and dSᵀ; lse and D belong to the columns. Masked pairs (past
          // Sq or Skv, or above the diagonal) take no weight.
          const float* const L = Ls + s * kBQ;
          const float* const D = Ds + s * kBQ;
          const bool edge = q0 + kBQ > p.sq || kw + 64 > p.skv || (p.causal && q0 < kw + 63);
#pragma unroll
          for (int i = 0; i < kBQ / 2; ++i) {
            const int col = acc_col(i, lane);
            float pr = exp2f(st[i] * p.scale_log2 - L[col]);
            if (edge) {
              const int qi = q0 + col, kj = row + acc_row(i);
              if (qi >= p.sq || kj >= p.skv || (p.causal && qi < kj)) pr = 0.f;
            }
            st[i] = pr;
            dpt[i] = pr * (dpt[i] - D[col]);
          }
          uint32_t pa[kBQ / 16][4], sa[kBQ / 16][4];
          to_frags<T, kBQ>(pa, st);
          to_frags<T, kBQ>(sa, dpt);

          // dV += Pᵀ dO and dK += dSᵀ Q, dO and Q read MN-major.
          repro::wgmma_fence();
          product_into_hd<T, HD, kBQ>(dv, pa, dot);
          product_into_hd<T, HD, kBQ>(dk, sa, qt);
          repro::wgmma_commit();
          repro::wgmma_wait_all();
          fence_acc<HD>(dv);
          fence_acc<HD>(dk);
        }
        repro::mbar_arrive(&empty[s]);
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }

    T* const dK = static_cast<T*>(p.dk) + bb * p.dk_sb + kvh * p.dk_sh;
    T* const dV = static_cast<T*>(p.dv) + bb * p.dv_sb + kvh * p.dv_sh;
    store_acc<T, HD>(dK, p.dk_ss, row, p.skv, dk, p.scale, lane);
    store_acc<T, HD>(dV, p.dv_ss, row, p.skv, dv, 1.f, lane);
  }
}

// dQ of one 128-row query tile of one head.
template <typename T, int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const BwdTcArgs p) {
  using Sh = TcShape<HD>;
  using Dq = DqShape<HD>;
  constexpr int kSw = Sh::kSw, kCE = Sh::kCE, kChunks = Sh::kChunks;
  constexpr int kBQ = Dq::kBQ, kBK = Dq::kBK, kStages = Dq::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const Qs = smem_raw + ((1024 - (repro::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const dOs = Qs + Dq::kQBytes;
  uint8_t* const Ks = dOs + Dq::kQBytes;                   // stage s at + s · kKVBytes
  uint8_t* const Vs = Ks + kStages * Dq::kKVBytes;
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(Vs + kStages * Dq::kKVBytes);
  uint64_t* const full = q_full + 1;
  uint64_t* const empty = full + kStages;

  const int nq = (p.sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.z)) * kBQ;  // longest first
  const int hh = blockIdx.x, bb = blockIdx.y, kvh = hh / p.group;
  int n_tiles = (p.skv + kBK - 1) / kBK;
  if (p.causal) n_tiles = min(n_tiles, (min(q0 + kBQ, p.sq) - 1) / kBK + 1);

  if (threadIdx.x == 0) {
    repro::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], 256);
    }
    repro::mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      repro::mbar_expect_tx(q_full, 2 * Dq::kQBytes);
      for (int c = 0; c < kChunks; ++c) {
        repro::tma_load_4d(Qs + c * kBQ * kSw, &tq, q_full, c * kCE, q0, hh, bb);
        repro::tma_load_4d(dOs + c * kBQ * kSw, &tdo, q_full, c * kCE, q0, hh, bb);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages, use = t / kStages;
        repro::mbar_wait(&empty[s], (use & 1) ^ 1);
        repro::mbar_expect_tx(&full[s], 2 * Dq::kKVBytes);
        uint8_t* const kt = Ks + s * Dq::kKVBytes;
        uint8_t* const vt = Vs + s * Dq::kKVBytes;
        for (int c = 0; c < kChunks; ++c) {
          repro::tma_load_4d(kt + c * kBK * kSw, &tk, &full[s], c * kCE, t * kBK, kvh, bb);
          repro::tma_load_4d(vt + c * kBK * kSw, &tv, &full[s], c * kCE, t * kBK, kvh, bb);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int qw = q0 + 64 * wg;                        // first query row of this warpgroup
    const int row = qw + 16 * (tid / 32) + lane / 4;    // the thread's rows: row, row + 8
    const uint8_t* const Qw = Qs + 64 * wg * kSw;
    const uint8_t* const dOw = dOs + 64 * wg * kSw;
    // The rows' lse and D, read once (row + 8 < q0 + 128 <= ld).
    const long long at = (static_cast<long long>(bb) * p.h + hh) * p.ld + row;
    const float L[2] = {p.lse2[at], p.lse2[at + 8]};
    const float D[2] = {p.delta[at], p.delta[at + 8]};

    float dq[kChunks][kCE / 2];
    zero_acc<HD>(dq);

    repro::mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages, parity = (t / kStages) & 1;
      const int k0 = t * kBK;
      repro::mbar_wait(&full[st], parity);
      // A tile wholly above this warpgroup's diagonal, or rows past Sq, add nothing.
      if (qw < p.sq && !(p.causal && k0 > qw + 63)) {
        const uint8_t* const kt = Ks + st * Dq::kKVBytes;
        const uint8_t* const vt = Vs + st * Dq::kKVBytes;
        float sc[kBK / 2], dp[kBK / 2];
        repro::wgmma_fence();
        product_over_hd<T, HD, kBQ, kBK>(sc, Qw, kt);
        product_over_hd<T, HD, kBQ, kBK>(dp, dOw, vt);
        repro::wgmma_commit();
        repro::wgmma_wait_all();
        repro::fence_regs(sc);
        repro::fence_regs(dp);

        const bool edge = qw + 64 > p.sq || k0 + kBK > p.skv || (p.causal && k0 + kBK - 1 > qw);
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int r = (i >> 1) & 1;
          float pr = exp2f(sc[i] * p.scale_log2 - L[r]);
          if (edge) {
            const int col = k0 + acc_col(i, lane), qi = row + 8 * r;
            if (col >= p.skv || qi >= p.sq || (p.causal && qi < col)) pr = 0.f;
          }
          dp[i] = pr * (dp[i] - D[r]);
        }
        uint32_t sa[kBK / 16][4];
        to_frags<T, kBK>(sa, dp);

        // dQ += dS K, K read MN-major.
        repro::wgmma_fence();
        product_into_hd<T, HD, kBK>(dq, sa, kt);
        repro::wgmma_commit();
        repro::wgmma_wait_all();
        fence_acc<HD>(dq);
      }
      repro::mbar_arrive(&empty[st]);
    }

    T* const dQ = static_cast<T*>(p.dq) + bb * p.dq_sb + hh * p.dq_sh;
    store_acc<T, HD>(dQ, p.dq_ss, row, p.sq, dq, p.scale, lane);
  }
}

template <typename T, int HD>
cudaError_t launch_bwd_tc(const BwdArgs& p, int batch, int kv_heads, cudaStream_t s) {
  using Kv = DkdvShape<HD>;
  using Dq = DqShape<HD>;
  const int ld = bwd_ld(p.sq);
  if ((p.skv + Kv::kBK - 1) / Kv::kBK > 65535 || (p.sq + Dq::kBQ - 1) / Dq::kBQ > 65535)
    return cudaErrorInvalidValue;  // the tile index is the grid's z axis
  float* const lse2 = p.delta + static_cast<long long>(batch) * p.h * ld;
  CUtensorMap q_kv, do_kv, k_kv, v_kv, q_q, do_q, k_q, v_q;
  cudaError_t err;
  if ((err = make_map<T, HD>(&q_kv, p.q, p.sq, p.h, batch, p.q_sb, p.q_sh, p.q_ss, Kv::kBQ)) ||
      (err = make_map<T, HD>(&do_kv, p.dout, p.sq, p.h, batch, p.do_sb, p.do_sh, p.do_ss,
                             Kv::kBQ)) ||
      (err = make_map<T, HD>(&k_kv, p.k, p.skv, kv_heads, batch, p.k_sb, p.k_sh, p.k_ss,
                             Kv::kBK)) ||
      (err = make_map<T, HD>(&v_kv, p.v, p.skv, kv_heads, batch, p.v_sb, p.v_sh, p.v_ss,
                             Kv::kBK)) ||
      (err = make_map<T, HD>(&q_q, p.q, p.sq, p.h, batch, p.q_sb, p.q_sh, p.q_ss, Dq::kBQ)) ||
      (err = make_map<T, HD>(&do_q, p.dout, p.sq, p.h, batch, p.do_sb, p.do_sh, p.do_ss,
                             Dq::kBQ)) ||
      (err = make_map<T, HD>(&k_q, p.k, p.skv, kv_heads, batch, p.k_sb, p.k_sh, p.k_ss,
                             Dq::kBK)) ||
      (err = make_map<T, HD>(&v_q, p.v, p.skv, kv_heads, batch, p.v_sb, p.v_sh, p.v_ss,
                             Dq::kBK)))
    return err;
  if ((err = cudaFuncSetAttribute(flash_bwd_dkdv_tc<T, HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(Kv::kSmem))) ||
      (err = cudaFuncSetAttribute(flash_bwd_dq_tc<T, HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(Dq::kSmem))))
    return err;
  flash_bwd_delta<T, HD><<<dim3(ld / (kThreads / 32), p.h, batch), kThreads, 0, s>>>(p, ld, lse2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const BwdTcArgs args{p.dq, p.dk, p.dv, p.delta, lse2, p.h, p.group, p.sq, p.skv, ld,
                       p.dq_sb, p.dq_sh, p.dq_ss, p.dk_sb, p.dk_sh, p.dk_ss,
                       p.dv_sb, p.dv_sh, p.dv_ss, p.causal, p.scale,
                       p.scale * 1.4426950408889634f};
  // The tile index is the slowest grid axis: every head's longest tiles
  // (kv tile 0, the last query tile, when causal) are issued first.
  flash_bwd_dkdv_tc<T, HD><<<dim3(kv_heads, batch, (p.skv + Kv::kBK - 1) / Kv::kBK), kTcThreads,
                             Kv::kSmem, s>>>(q_kv, k_kv, v_kv, do_kv, args);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq_tc<T, HD><<<dim3(p.h, batch, (p.sq + Dq::kBQ - 1) / Dq::kBQ), kTcThreads,
                           Dq::kSmem, s>>>(q_q, k_q, v_q, do_q, args);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_bwd_t(const BwdArgs& p, int batch, int kv_heads, cudaStream_t s) {
  if constexpr (!std::is_same_v<T, float>) {
    return launch_bwd_tc<T, HD>(p, batch, kv_heads, s);
  } else {
    constexpr size_t smem_kv = bwd_dkdv_smem<HD>(), smem_q = bwd_dq_smem<HD>();
    static_assert(smem_kv <= 232448 && smem_q <= 232448, "tiles must fit in 227 KB");
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem_kv));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_dq<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_q));
    if (err != cudaSuccess) return err;
    if (p.sq > 0) {
      flash_bwd_delta<T, HD><<<dim3((p.sq + kThreads / 32 - 1) / (kThreads / 32), p.h, batch),
                               kThreads, 0, s>>>(p, p.sq, nullptr);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    flash_bwd_dkdv<T, HD><<<dim3((p.skv + kBK - 1) / kBK, kv_heads, batch), kThreads, smem_kv,
                            s>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (p.sq > 0)
      flash_bwd_dq<T, HD><<<dim3((p.sq + kBQ - 1) / kBQ, p.h, batch), kThreads, smem_q, s>>>(p);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_bwd_hd(const BwdArgs& p, int batch, int kv_heads, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_bwd_t<T, 16>(p, batch, kv_heads, s);
    case 32: return launch_bwd_t<T, 32>(p, batch, kv_heads, s);
    case 64: return launch_bwd_t<T, 64>(p, batch, kv_heads, s);
    case 96: return launch_bwd_t<T, 96>(p, batch, kv_heads, s);
    case 128: return launch_bwd_t<T, 128>(p, batch, kv_heads, s);
    case 160: return launch_bwd_t<T, 160>(p, batch, kv_heads, s);
  }
  return cudaErrorInvalidValue;
}

// Registers, shared memory and spills of the backward's dK/dV (which 0)
// or dQ (which 1) kernel that dtype T launches: flash_bwd_{dkdv,dq}_tc in
// bf16 and f16, flash_bwd_{dkdv,dq} in f32.
template <typename T, int HD>
cudaError_t bwd_attributes_t(int which, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err;
  size_t dynamic;
  if constexpr (std::is_same_v<T, float>) {
    err = which == 0 ? cudaFuncGetAttributes(&fa, flash_bwd_dkdv<T, HD>)
                     : cudaFuncGetAttributes(&fa, flash_bwd_dq<T, HD>);
    dynamic = which == 0 ? bwd_dkdv_smem<HD>() : bwd_dq_smem<HD>();
  } else {
    err = which == 0 ? cudaFuncGetAttributes(&fa, flash_bwd_dkdv_tc<T, HD>)
                     : cudaFuncGetAttributes(&fa, flash_bwd_dq_tc<T, HD>);
    dynamic = which == 0 ? DkdvShape<HD>::kSmem : DqShape<HD>::kSmem;
  }
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = static_cast<int>(dynamic);
  out[3] = static_cast<int>(fa.localSizeBytes);
  return cudaSuccess;
}

template <typename T>
cudaError_t bwd_attributes_hd(int hd, int which, int* out) {
  switch (hd) {
    case 16: return bwd_attributes_t<T, 16>(which, out);
    case 32: return bwd_attributes_t<T, 32>(which, out);
    case 64: return bwd_attributes_t<T, 64>(which, out);
    case 96: return bwd_attributes_t<T, 96>(which, out);
    case 128: return bwd_attributes_t<T, 128>(which, out);
    case 160: return bwd_attributes_t<T, 160>(which, out);
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
    err = cudaFuncGetAttributes(&fa, flash_fwd_tc<T, HD, false>);
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
    case 80: return attributes_t<T, 80>(out);
    case 96: return attributes_t<T, 96>(out);
    case 128: return attributes_t<T, 128>(out);
    case 160: return attributes_t<T, 160>(out);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o: (batch, h, sq, hd); k, v: (batch, kv_heads, skv, hd); each at its
// own strides for the first three axes and unit stride on hd; one dtype.
// lse: nullptr, or (batch, h, sq) f32 contiguous, written with each query
// row's log-sum-exp. window: 0, or > 0 with causal (query i sees key j iff
// 0 <= i - j < window).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     float* lse,
                                     int batch, int h, int kv_heads, int sq, int skv, int hd,
                                     long long q_sb, long long q_sh, long long q_ss,
                                     long long k_sb, long long k_sh, long long k_ss,
                                     long long v_sb, long long v_sh, long long v_ss,
                                     long long o_sb, long long o_sh, long long o_ss,
                                     int causal, int window, float scale, int dtype,
                                     void* stream) {
  if (batch == 0 || h == 0 || sq == 0) return 0;
  if (kv_heads < 1 || h % kv_heads || skv < 1 || h > 65535 || batch > 65535 || window < 0 ||
      (window > 0 && !causal))
    return cudaErrorInvalidValue;
  const FlashArgs p{q, k, v, o, h, h / kv_heads, sq, skv,
                    q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                    causal, scale, lse, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32: return launch_hd<float>(p, batch, hd, s);
    case repro::kBF16: return launch_tc_hd<__nv_bfloat16>(p, batch, kv_heads, hd, s);
    case repro::kF16: return launch_tc_hd<__half>(p, batch, kv_heads, hd, s);
  }
  return cudaErrorInvalidValue;
}

// dq, dk, dv of the forward whose output is o and log-sum-exp lse, given
// dout; every tensor at its own strides on the first three axes, unit
// stride on hd, one dtype; lse (batch, h, sq) f32; delta f32 scratch of
// 2·batch·h·bwd_ld(sq) floats. bf16 and f16 load by TMA: q, k, v, dout
// 16-byte aligned with 16-byte strides, and sq >= 1.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, void* dq, void* dk, void* dv, float* delta,
    int batch, int h, int kv_heads, int sq, int skv, int hd,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, long long do_sb, long long do_sh, long long do_ss,
    long long dq_sb, long long dq_sh, long long dq_ss, long long dk_sb, long long dk_sh,
    long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss,
    int causal, float scale, int dtype, void* stream) {
  if (batch == 0 || h == 0 || skv == 0) return 0;
  if (kv_heads < 1 || h % kv_heads || h > 65535 || batch > 65535 || kv_heads > 65535)
    return cudaErrorInvalidValue;
  const BwdArgs p{q, k, v, o, dout, lse, dq, dk, dv, delta, h, h / kv_heads, sq, skv,
                  q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                  do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss,
                  dv_sb, dv_sh, dv_ss, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32: return launch_bwd_hd<float>(p, batch, kv_heads, hd, s);
    case repro::kBF16: return launch_bwd_hd<__nv_bfloat16>(p, batch, kv_heads, hd, s);
    case repro::kF16: return launch_bwd_hd<__half>(p, batch, kv_heads, hd, s);
  }
  return cudaErrorInvalidValue;
}

// out[0..3]: registers a thread, static and dynamic shared memory, and
// local (spill) bytes of the backward's dK/dV kernel (which 0) or dQ
// kernel (which 1) for dtype and hd.
extern "C" int repro_flash_attention_bwd_attributes(int dtype, int hd, int which, int* out) {
  switch (dtype) {
    case repro::kF32: return bwd_attributes_hd<float>(hd, which, out);
    case repro::kBF16: return bwd_attributes_hd<__nv_bfloat16>(hd, which, out);
    case repro::kF16: return bwd_attributes_hd<__half>(hd, which, out);
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
