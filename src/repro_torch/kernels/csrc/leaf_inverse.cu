// Pivot-free Gauss-Jordan inversion of a batch of (bs, bs) blocks on the
// augmented system [A | I], swept in f32. Pivot-free is the function the
// JAX package computes (src/repro/kernels/leaf_inverse/kernel.py): safe
// for SPD and diagonally dominant blocks, the class SPIN targets.
//
// repro_gauss_jordan replaces `leaf_inverse_pallas` (scalar sweep, one
// column a step). repro_blocked_gauss_jordan replaces
// `blocked_leaf_inverse_pallas` (a t-row panel mini-sweep, then a rank-t
// update of every other row).
//
// What bounds them on an H100: the scratch [A | I] is bs x 2bs f32, 8 MB
// at bs = 1024, far more than one block's 227 KB of shared memory, and a
// scalar sweep is bs dependent steps. On the TPU the whole scratch sits in
// VMEM and one program walks it.
//
// What the design does about it:
//  * The scratch lives in device memory (it fits in the 50 MB L2). The
//    scalar kernel copies it into shared memory when it fits (bs <= 128)
//    and runs one block a matrix, with the bs steps inside the block.
//  * The blocked sweep is a host loop over panels, three launches each:
//    a panel kernel that runs the t-step mini-sweep on column slices of
//    the panel in parallel (each block carries its own copy of the t x t
//    pivot block, so the slices need no exchange), a gather of the
//    factor columns, and the rank-t update as the shared tiled GEMM with
//    alpha = -1, beta = 1, in place. So the O(bs^3) part runs on the
//    whole card even at batch 1, which is SPIN's leaf.
//  * The TPU's iota row masks and one-hot selector GEMMs are addressing
//    tricks for its vector unit; here threads index rows and columns.
//  * Products and differences in the sweeps are rounded separately
//    (__fmul_rn, __fsub_rn), as the plain PyTorch versions round them, so
//    the sweeps are step-exact against them.
#include "gemm_tile.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kPanelMax = 64;  // largest panel width t
constexpr int kSlice = 64;     // columns of the panel a block sweeps
constexpr int kPanelThreads = 512;

__host__ __device__ inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

inline int stride_blocks(long long total) {
  const long long want = cdiv(total, 256);
  return static_cast<int>(want < 132 * 32 ? want : 132 * 32);
}

// m[b] = [A_b | I] in f32.
template <typename TIn>
__global__ void gj_init(const TIn* a, float* m, int batch, int bs) {
  const long long w = 2LL * bs, total = batch * bs * w;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long j = e % w, bi = e / w;  // bi = b * bs + i
    const long long i = bi % bs;
    m[e] = j < bs ? to_f32(a[bi * bs + j]) : (j - bs == i ? 1.f : 0.f);
  }
}

// out[b] = right half of m[b], cast to the output type.
template <typename TOut>
__global__ void gj_extract(const float* m, TOut* out, int batch, int bs) {
  const long long total = (long long)batch * bs * bs;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long j = e % bs, bi = e / bs;
    out[e] = from_f32<TOut>(m[bi * 2 * bs + bs + j]);
  }
}

// Scalar sweep: one block a matrix, bs steps. Shared memory holds the
// normalized pivot row and the factor column, and the whole [A | I] when
// use_smem is set.
__global__ void __launch_bounds__(1024) gj_scalar(float* mg, int bs, int use_smem) {
  extern __shared__ float smem[];
  const int w = 2 * bs, tid = threadIdx.x, nt = blockDim.x;
  float* rown = smem;
  float* fac = smem + w;
  float* src = mg + blockIdx.x * (long long)bs * w;
  float* m = use_smem ? smem + w + bs : src;
  if (use_smem) {
    for (int e = tid; e < bs * w; e += nt) m[e] = src[e];
    __syncthreads();
  }
  for (int k = 0; k < bs; ++k) {
    const float piv = m[k * w + k];
    for (int j = tid; j < w; j += nt) rown[j] = m[k * w + j] / piv;
    for (int i = tid; i < bs; i += nt) fac[i] = (i == k) ? 0.f : m[i * w + k];
    __syncthreads();
    for (int e = tid; e < bs * w; e += nt) {
      const int i = e / w, j = e - i * w;
      m[e] = (i == k) ? rown[j] : __fsub_rn(m[e], __fmul_rn(fac[i], rown[j]));
    }
    __syncthreads();
  }
  if (use_smem)
    for (int e = tid; e < bs * w; e += nt) src[e] = m[e];
}

// Panel mini-sweep: rows [base, base + t) of m[b], columns
// [blockIdx.x * kSlice, +kSlice), result into p[b] (t x 2bs). The t x t
// pivot block rides along in every block, so each block has the pivots
// and factors of every step without exchanging them. Element e of a
// t x 64 tile is row e / 64, column e % 64.
__global__ void __launch_bounds__(kPanelThreads) gj_panel(const float* mg, float* pg, int bs,
                                                         int t, int base) {
  static_assert(kPanelMax == 64 && kSlice == 64, "tiles index rows by e >> 6");
  __shared__ float D[kPanelMax][kPanelMax + 1];
  __shared__ float S[kPanelMax][kSlice + 1];
  __shared__ float rd[kPanelMax], rs[kSlice], fac[kPanelMax];
  const int w = 2 * bs, tid = threadIdx.x;
  const int c0 = blockIdx.x * kSlice;
  const int cw = min(kSlice, w - c0);
  const float* M = mg + blockIdx.y * (long long)bs * w;
  float* P = pg + blockIdx.y * (long long)t * w;
  const int tile = t * 64;

  for (int e = tid; e < tile; e += kPanelThreads) {
    const int i = e >> 6, c = e & 63;
    if (c < t) D[i][c] = M[(long long)(base + i) * w + base + c];
    if (c < cw) S[i][c] = M[(long long)(base + i) * w + c0 + c];
  }
  __syncthreads();
  for (int j = 0; j < t; ++j) {
    const float piv = D[j][j];
    if (tid < t) {
      rd[tid] = D[j][tid] / piv;
      fac[tid] = (tid == j) ? 0.f : D[tid][j];
    }
    if (tid < cw) rs[tid] = S[j][tid] / piv;
    __syncthreads();
    for (int e = tid; e < tile; e += kPanelThreads) {
      const int i = e >> 6, c = e & 63;
      if (c < t) D[i][c] = (i == j) ? rd[c] : __fsub_rn(D[i][c], __fmul_rn(fac[i], rd[c]));
      if (c < cw) S[i][c] = (i == j) ? rs[c] : __fsub_rn(S[i][c], __fmul_rn(fac[i], rs[c]));
    }
    __syncthreads();
  }
  for (int e = tid; e < tile; e += kPanelThreads) {
    const int i = e >> 6, c = e & 63;
    if (c < cw) P[(long long)i * w + c0 + c] = S[i][c];
  }
}

// f[b] = the panel's columns of every row of m[b], zero on the panel's own
// rows; then the swept panel p[b] replaces those rows of m[b]. The reads
// touch only rows outside the panel and the writes only rows inside it.
__global__ void gj_gather(float* mg, const float* pg, float* fg, int batch, int bs, int t,
                          int base) {
  const long long w = 2LL * bs;
  const long long nf = (long long)batch * bs * t, np = (long long)batch * t * w;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < nf + np;
       e += (long long)gridDim.x * blockDim.x) {
    if (e < nf) {
      const long long q = e % t, bi = e / t;
      const long long i = bi % bs, b = bi / bs;
      fg[e] = (i >= base && i < base + t) ? 0.f : mg[b * bs * w + i * w + base + q];
    } else {
      const long long ep = e - nf;
      const long long c = ep % w, bi = ep / w;
      const long long i = bi % t, b = bi / t;
      mg[b * bs * w + (base + i) * w + c] = pg[ep];
    }
  }
}

template <typename TIn>
cudaError_t init_t(const void* a, float* m, int batch, int bs, cudaStream_t s) {
  gj_init<TIn><<<stride_blocks(2LL * batch * bs * bs), 256, 0, s>>>(
      static_cast<const TIn*>(a), m, batch, bs);
  return cudaGetLastError();
}

cudaError_t init(const void* a, float* m, int batch, int bs, int in_dtype, cudaStream_t s) {
  switch (in_dtype) {
    case repro::kF32: return init_t<float>(a, m, batch, bs, s);
    case repro::kBF16: return init_t<__nv_bfloat16>(a, m, batch, bs, s);
    case repro::kF16: return init_t<__half>(a, m, batch, bs, s);
  }
  return cudaErrorInvalidValue;
}

template <typename TOut>
cudaError_t extract_t(const float* m, void* out, int batch, int bs, cudaStream_t s) {
  gj_extract<TOut><<<stride_blocks((long long)batch * bs * bs), 256, 0, s>>>(
      m, static_cast<TOut*>(out), batch, bs);
  return cudaGetLastError();
}

cudaError_t extract(const float* m, void* out, int batch, int bs, int out_dtype,
                    cudaStream_t s) {
  switch (out_dtype) {
    case repro::kF32: return extract_t<float>(m, out, batch, bs, s);
    case repro::kBF16: return extract_t<__nv_bfloat16>(m, out, batch, bs, s);
    case repro::kF16: return extract_t<__half>(m, out, batch, bs, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Scalar Gauss-Jordan. m: (batch, bs, 2bs) f32 scratch.
extern "C" int repro_gauss_jordan(const void* a, void* out, float* m, int batch, int bs,
                                  int in_dtype, int out_dtype, void* stream) {
  if (batch == 0 || bs == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = init(a, m, batch, bs, in_dtype, s);
  if (err != cudaSuccess) return err;
  const size_t rows = (size_t)3 * bs * sizeof(float);  // pivot row + factor column
  const size_t whole = rows + (size_t)2 * bs * bs * sizeof(float);
  const int use_smem = whole <= 200 * 1024;
  const size_t smem = use_smem ? whole : rows;
  err = cudaFuncSetAttribute(gj_scalar, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gj_scalar<<<batch, 1024, smem, s>>>(m, bs, use_smem);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return extract(m, out, batch, bs, out_dtype, s);
}

// Blocked Gauss-Jordan with panel width t (t <= 64, t divides bs).
// m: (batch, bs, 2bs), p: (batch, t, 2bs), f: (batch, bs, t) f32 scratch.
extern "C" int repro_blocked_gauss_jordan(const void* a, void* out, float* m, float* p,
                                          float* f, int batch, int bs, int t, int in_dtype,
                                          int out_dtype, void* stream) {
  if (batch == 0 || bs == 0) return 0;
  if (t < 1 || t > kPanelMax || bs % t) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = init(a, m, batch, bs, in_dtype, s);
  if (err != cudaSuccess) return err;
  const long long w = 2LL * bs;
  const dim3 panel_grid(static_cast<unsigned>(cdiv(w, kSlice)), batch);
  const int gather_blocks = stride_blocks((long long)batch * (bs * t + t * w));
  for (int base = 0; base < bs; base += t) {
    gj_panel<<<panel_grid, kPanelThreads, 0, s>>>(m, p, bs, t, base);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    gj_gather<<<gather_blocks, 256, 0, s>>>(m, p, f, batch, bs, t, base);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // m <- m - f @ p: the rank-t update, in place on m.
    repro::GemmArgs g{f, p, m, m, bs, static_cast<int>(w), t,
                      t, w, w, w,
                      (long long)bs * t, (long long)t * w, (long long)bs * w, (long long)bs * w,
                      -1.f, 1.f};
    err = repro::launch_gemm(g, batch, repro::kF32, repro::kF32, s);
    if (err != cudaSuccess) return err;
  }
  return extract(m, out, batch, bs, out_dtype, s);
}
