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
// card's ridge even for its bf16 tensor cores, so the bound is the
// operation rate, and this kernel, which runs in f32 FFMA (67 TFLOP/s),
// can reach at most 1/15 of the tensor-core bound.
//
// What the design does about it, simply first:
//  * On the TPU the kv axis is a sequential grid dimension and VMEM
//    scratch carries the accumulator and the row statistics from one kv
//    step to the next. Here blocks run in parallel and carry nothing, so
//    one block owns one 64-row query tile of one head of one batch
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
//  * The sequence may be ragged: rows of q past Sq and of k, v past Skv
//    are staged as zeros and masked (kv) or not written (q). Each of the
//    B, H and S axes has its own stride and hd has unit stride, so the
//    model's (B, S, H, hd) activations pass as transposed views.
//  * Tensor cores (wgmma), TMA loads and a pipelined kv loop are later
//    work.
#include <math_constants.h>

#include "gemm_tile.cuh"

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
    case repro::kBF16: return launch_hd<__nv_bfloat16>(p, batch, hd, s);
    case repro::kF16: return launch_hd<__half>(p, batch, hd, s);
  }
  return cudaErrorInvalidValue;
}
