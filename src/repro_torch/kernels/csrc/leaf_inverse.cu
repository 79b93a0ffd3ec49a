// Pivot-free Gauss-Jordan inverses and the blocked triangular solve, for a
// batch of (bs, bs) blocks, in f32. Pivot-free is the function the JAX
// package computes (src/repro/kernels/leaf_inverse/kernel.py): safe for
// SPD and diagonally dominant blocks, the class SPIN targets.
//
// repro_gauss_jordan replaces `leaf_inverse_pallas` (scalar sweep, one
// column a step).
//  * The scalar sweep is a chain of bs dependent steps, each cheap, so its
//    time is bs x (one barrier + one shared-memory round trip), not its
//    2 bs^3 operations. For bs <= kGjRegMaxBs (the main path's leaf is
//    bs = 128) one launch runs one block a matrix: it reads A in its
//    dtype, sweeps in place on bs x bs (column k of the inverse takes
//    the place of pivot column k, the classic in-place Gauss-Jordan, so a
//    step touches bs live columns, not the 2 bs of [A | I]), and writes
//    out_dtype. Each thread keeps fixed (row, column) cells in registers
//    (no index is divided a step); the raw pivot row and factor column of
//    the next step go through shared memory, double-buffered, so a step
//    needs one __syncthreads. The new column k is 0 - fac_i * (1 / piv),
//    exactly what the full sweep writes into column bs + k, and the full
//    sweep's dead columns are exact 0 / 1, so the two are bitwise equal.
//  * Larger scalar leaves keep [A | I] in device memory (it fits in the
//    50 MB L2): gj_init, gj_scalar with the bs steps inside one block a
//    matrix, gj_extract.
//  * Products and differences in the sweeps are rounded separately
//    (__fmul_rn, __fsub_rn), as the plain PyTorch versions round them, so
//    the sweeps are step-exact against them.
//
// repro_blocked_gauss_jordan replaces `blocked_leaf_inverse_pallas` (a
// t-row panel mini-sweep, then a rank-t update of every other row).
//  * Bound on an H100: 2 bs^3 operations; at bs = 1024 that is 0.032 ms
//    on the f32 FFMA units and 0.013 ms as 3xTF32 on the tensor cores.
//    What holds it back is the chain: bs / t panels, each a t-step
//    elimination, at batch 1 (SPIN's leaf).
//  * In place on bs x bs, the blocked form: for panel P with pivot block
//    D = M_PP, M_PP <- D^-1, M_PQ <- D^-1 M_PQ, M_QP <- -M_QP D^-1 and
//    M_QQ <- M_QQ - M_QP D^-1 M_PQ. With W = [D^-1 ; -M_QP D^-1] (bs x t)
//    and R = the panel rows with their P columns replaced by I (t x bs),
//    that is M <- (M with rows P and columns P zeroed) + W R: one product
//    a panel, two launches, and no [A | I] scratch.
//  * bgj_panel: every block of the launch inverts D (2 x 2 blocks of 32,
//    each 32-step sweep in one warp's registers, no barrier on the chain),
//    then forms its 32 rows of W and of R^T, packed K-major as TF32 hi and
//    lo planes for the tensor cores; R^T, which needs no inverse, is
//    written by the other warps while warp 0 sweeps.
//  * bgj_update: M += W R on wgmma, 3xTF32 (lo·hi + hi·lo + hi·hi, the
//    split of matmul.cu), t <= 64 deep, W and R^T TMA-loaded whole; the
//    epilogue zeroes the panel's rows and columns of M as it adds, in
//    place. The 2 bs / t launches are chained by programmatic dependent
//    launch, so each one's start-up overlaps the end of the one before.
//
// repro_triangular_solve replaces `triangular_solve_pallas`: T X = B for a
// batch of triangular (or packed-LU) T, bs x bs, and B, bs x k, in f32,
// reading only the targeted triangle of T.
//  * Bound on an H100: bs^2 k operations, 0.244 ms at bs = 1024,
//    k = 15616 on the FFMA units, 0.099 ms as 3xTF32. The TPU kernel keeps
//    the whole right-hand side in VMEM and sweeps its panels in one grid
//    step; here columns of B are independent, so a block owns a strip of
//    N of them and walks the bs / t panels in order. What held the FFMA
//    design back was that walk: a t-step scalar chain a panel, in every
//    block, and too few blocks for narrow k.
//  * The reference's mini sweep on [D_p | rhs_p] applies D_p^-1. Here
//    tri_dinv inverts every diagonal block up front (one small block
//    each, a column a thread in registers), and tri_pack writes
//    P = [-D_p^-1 T[p, <p] | D_p^-1 | 0], panel row by panel row, as TF32
//    hi/lo planes, K contiguous. tri_pack_b writes B transposed as the
//    same planes, Z (k x bs). Then for each panel
//    X_p = D_p^-1 (B_p - T[p, <p] X[<p]) = P[p, :base+t] Z[:base+t],
//    where Z's first base columns hold X already and the next t still
//    hold B_p: one product a panel, and the scalar chains run once, in
//    parallel, before the sweep.
//  * tri_tc: a producer warpgroup, one thread of which TMA-loads 32-deep
//    chunks of P's panel rows and of the block's Z strip into a ring; a
//    consumer warpgroup runs wgmma m64nNk8 (3xTF32), adds each chunk's part
//    to an f32 register accumulator (the tensor cores do not round their
//    sums to nearest; see matmul.cu), writes X_p to the output and its
//    hi/lo split into Z, fences the proxies, and signals the producer,
//    which loads a chunk only once the panels it reads are solved.
//  * N (8 .. 64) is chosen by the wrapper from k, so that narrow right-
//    hand sides still give enough blocks, and wide ones read P few times.
//  * The upper sweep is the lower sweep on T flipped about both axes (row
//    and column i read as bs - 1 - i), and B and X flipped by rows.
//  * T is read through its strides: the LU that torch.linalg.lu_factor
//    returns is column-major, and the loads of T follow whichever of its
//    strides is unit, so they stay coalesced.
#include "gemm_tile.cuh"
#include "hopper.cuh"

namespace {

using repro::from_f32;
using repro::rna_tf32;
using repro::to_f32;

constexpr int kPanelMax = 64;  // largest panel width t, both blocked kernels

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

// Scalar sweep on [A | I] in device memory, for bs > kGjRegMaxBs: one
// block a matrix, bs steps. Shared memory holds the normalized pivot row
// and the factor column, and the whole [A | I] when use_smem is set.
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

// In-place scalar sweep, one launch: one block of TR x 32 threads a
// matrix. Thread (tr, lane) owns rows tr + TR a (a < R) and columns
// lane + 32 b (b < N) of the bs x bs matrix, in registers; cells past bs
// hold 0 and are never stored. Step k reads the normalized pivot row and
// the factor column k, as they were after step k - 1, from one half of
// rowbuf / facbuf, and the owners of row and column k + 1 write theirs
// into the other half after their update, so one barrier a step is
// enough: a half is rewritten only two steps after it was read, with a
// barrier between.
constexpr int kGjRegMaxBs = 208;  // 13 x 16 rows, 7 x 32 columns

__device__ __forceinline__ float load_f32(const void* p, long long i, int dtype) {
  switch (dtype) {
    case repro::kBF16: return to_f32(static_cast<const __nv_bfloat16*>(p)[i]);
    case repro::kF16: return to_f32(static_cast<const __half*>(p)[i]);
  }
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_f32(void* p, long long i, float x, int dtype) {
  switch (dtype) {
    case repro::kBF16: static_cast<__nv_bfloat16*>(p)[i] = from_f32<__nv_bfloat16>(x); return;
    case repro::kF16: static_cast<__half*>(p)[i] = from_f32<__half>(x); return;
  }
  static_cast<float*>(p)[i] = x;
}

template <int R, int N, int TR>
__global__ void __launch_bounds__(TR * 32, 1)
    gj_inplace(const void* a, void* out, int bs, int in_dtype, int out_dtype) {
  __shared__ float rowbuf[2][32 * N];
  __shared__ float facbuf[2][TR * R];
  const int lane = threadIdx.x & 31, tr = threadIdx.x >> 5;
  const long long base = blockIdx.x * (long long)bs * bs;
  float c[R][N];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int i = tr + TR * r, j = lane + 32 * q;
      c[r][q] = (i < bs && j < bs) ? load_f32(a, base + (long long)i * bs + j, in_dtype) : 0.f;
    }
  // Row k of the current matrix, divided by its pivot, and column k into
  // half h of the buffers. The owners of row k are one warp, and the
  // pivot sits in its lane k % 32, so the warp divides the row once for
  // every thread.
  auto publish = [&](int k, int h) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (tr + TR * r == k) {
        float own = 0.f;
#pragma unroll
        for (int q = 0; q < N; ++q)
          if (q == k / 32) own = c[r][q];
        const float piv = __shfl_sync(0xffffffffu, own, k % 32);
#pragma unroll
        for (int q = 0; q < N; ++q) {
          const int j = lane + 32 * q;
          rowbuf[h][j] = __fdiv_rn(j == k ? 1.f : c[r][q], piv);
        }
      }
#pragma unroll
    for (int q = 0; q < N; ++q)
      if (lane + 32 * q == k)
#pragma unroll
        for (int r = 0; r < R; ++r) facbuf[h][tr + TR * r] = c[r][q];
  };
  publish(0, 0);
  __syncthreads();
  for (int k = 0; k < bs; ++k) {
    const int h = k & 1;
    float row[N], fac[R];
#pragma unroll
    for (int q = 0; q < N; ++q) row[q] = rowbuf[h][lane + 32 * q];
#pragma unroll
    for (int r = 0; r < R; ++r) fac[r] = tr + TR * r == k ? 0.f : facbuf[h][tr + TR * r];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool pivot_row = tr + TR * r == k;
#pragma unroll
      for (int q = 0; q < N; ++q) {
        const float m = lane + 32 * q == k ? 0.f : c[r][q];
        c[r][q] = pivot_row ? row[q] : __fsub_rn(m, __fmul_rn(fac[r], row[q]));
      }
    }
    if (k + 1 < bs) publish(k + 1, h ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int i = tr + TR * r, j = lane + 32 * q;
      if (i < bs && j < bs) store_f32(out, base + (long long)i * bs + j, c[r][q], out_dtype);
    }
}

// The in-place kernel for bs, its block size: up to bs = 128 a 32 x 32
// block (at most 16 cells a thread under the 64-register cap of 1024
// threads), above it 16 x 32 threads (at most 91 cells under 128).
template <typename F>
cudaError_t with_gj_inplace(int bs, F&& f) {
  switch ((bs + 31) / 32) {
    case 1: return f(gj_inplace<1, 1, 32>, 1024);
    case 2: return f(gj_inplace<2, 2, 32>, 1024);
    case 3: return f(gj_inplace<3, 3, 32>, 1024);
    case 4: return f(gj_inplace<4, 4, 32>, 1024);
    case 5: return f(gj_inplace<10, 5, 16>, 512);
    case 6: return f(gj_inplace<12, 6, 16>, 512);
    case 7: return f(gj_inplace<13, 7, 16>, 512);
  }
  return cudaErrorInvalidValue;
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

// Elementwise cast of n values, for the blocked sweep's f32 working copy.
template <typename TIn, typename TOut>
__global__ void convert(const TIn* src, TOut* dst, long long n) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x)
    dst[e] = from_f32<TOut>(to_f32(src[e]));
}

template <typename TIn>
cudaError_t convert_to(const TIn* src, void* dst, long long n, int dtype, cudaStream_t s) {
  const int blocks = stride_blocks(n);
  switch (dtype) {
    case repro::kF32: convert<<<blocks, 256, 0, s>>>(src, static_cast<float*>(dst), n); break;
    case repro::kBF16: convert<<<blocks, 256, 0, s>>>(src, static_cast<__nv_bfloat16*>(dst), n); break;
    case repro::kF16: convert<<<blocks, 256, 0, s>>>(src, static_cast<__half*>(dst), n); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t convert_any(const void* src, int src_dtype, void* dst, int dst_dtype, long long n,
                        cudaStream_t s) {
  switch (src_dtype) {
    case repro::kF32: return convert_to(static_cast<const float*>(src), dst, n, dst_dtype, s);
    case repro::kBF16:
      return convert_to(static_cast<const __nv_bfloat16*>(src), dst, n, dst_dtype, s);
    case repro::kF16: return convert_to(static_cast<const __half*>(src), dst, n, dst_dtype, s);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// 3xTF32 wgmma on operands packed K-major as hi/lo planes
// ---------------------------------------------------------------------------

constexpr int kRowBytes = 128;                 // bytes of k a tile row: one swizzle atom
constexpr int kChunk = kRowBytes / 4;          // k of one chunk: 32 f32
constexpr int kStepBytes = 32;                 // k of one wgmma: 8 tf32
constexpr int kLayout = repro::wgmma_layout(kRowBytes);
constexpr int kTileM = 64;                     // rows of a wgmma tile
constexpr int kATileBytes = 2 * kTileM * kRowBytes;  // a chunk of A, hi and lo planes

// The tensor map of f32 planes (batch, 2, rows, ld), `depth` values of each
// row valid, in boxes of one chunk by box_rows rows by both planes: the hi
// tile lands first, the lo tile right after it. TMA fills the parts of a
// box past depth or rows with zeros.
cudaError_t plane_map(CUtensorMap* map, const float* ptr, int depth, int rows, long long ld,
                      int batch, int box_rows) {
  const repro::EncodeTiled encode = repro::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(depth), static_cast<cuuint64_t>(rows), 2,
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ld) * 4,
                                 static_cast<cuuint64_t>(ld) * rows * 4,
                                 static_cast<cuuint64_t>(ld) * rows * 8};
  const cuuint32_t box[4] = {kChunk, static_cast<cuuint32_t>(box_rows), 2, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// d = A B over one chunk, from zero: A a 64-row tile and B an N-row tile,
// each as plane_map lands them. lo·hi and hi·lo before hi·hi.
template <int N>
__device__ __forceinline__ void chunk_product(float (&d)[N / 2], const uint8_t* a,
                                              const uint8_t* b) {
  repro::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kRowBytes / kStepBytes; ++kk) {
    const int off = kk * kStepBytes;
    const uint64_t da = repro::wgmma_desc(a + off, 16, 8 * kRowBytes, kLayout);
    const uint64_t db = repro::wgmma_desc(b + off, 16, 8 * kRowBytes, kLayout);
    const uint64_t da_lo = repro::wgmma_desc(a + kTileM * kRowBytes + off, 16, 8 * kRowBytes,
                                             kLayout);
    const uint64_t db_lo = repro::wgmma_desc(b + N * kRowBytes + off, 16, 8 * kRowBytes, kLayout);
    repro::wgmma_tf32<N>(d, da_lo, db, kk > 0);
    repro::wgmma_tf32<N>(d, da, db_lo, 1);
    repro::wgmma_tf32<N>(d, da, db, 1);
  }
  repro::wgmma_commit();
}

// Row and column in the 64 x N tile of accumulator register i of this
// thread of the warpgroup.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * ((threadIdx.x % 128) / 32) + (threadIdx.x % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1);
}

__device__ __forceinline__ void store_split(float* hi, float* lo, long long at, float v) {
  const float h = rna_tf32(v);
  hi[at] = h;
  lo[at] = rna_tf32(v - h);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (repro::smem_u32(p) & 1023)) & 1023);
}

// Programmatic dependent launch, for the blocked Gauss-Jordan's chain of
// 2 bs / t short dependent launches: each may start while the one before
// ends; a kernel waits for its predecessor (which has then finished and
// flushed its writes) before it reads anything, and lets its own successor
// be scheduled early. (The triangular solve's four launches gained nothing
// from it on an H100.)
__device__ __forceinline__ void wait_for_previous_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void let_next_grid_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename... KArgs, typename... Args>
cudaError_t launch_after(void (*kernel)(KArgs...), dim3 grid, int threads, size_t smem,
                         cudaStream_t s, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

// ---------------------------------------------------------------------------
// Blocked Gauss-Jordan, in place
// ---------------------------------------------------------------------------

constexpr int kBgjN = 64;  // output columns of an update block

struct BgjArgs {
  float* m;   // (batch, bs, bs): the working copy, swept in place
  float* w;   // (batch, 2, bs, ld): W, hi and lo planes
  float* rt;  // (batch, 2, bs, ld): R^T, hi and lo planes
  int bs, t, base;
  long long ld;
};

// 1 / p from the hardware's approximation and one Newton step: within an
// ulp or so, and no branch to a slow path on the sweep's chain.
__device__ __forceinline__ float reciprocal(float p) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(p));
  return fmaf(r, fmaf(-p, r, 1.f), r);
}

// Pivot-free in-place Gauss-Jordan of the 32 x 32 block at d (row stride
// ld, shared memory) by one warp, in registers. Lane (g, h) = (lane / 8,
// lane % 8) holds rows 8 g .. 8 g + 7 and columns 4 h .. 4 h + 3, so a
// step fetches by shuffle only the 4 pivot-row values and the 8 factors
// its cells need, and no barrier. A step is gauss_jordan_ref's, except
// that the pivot row is multiplied by 1 / pivot, one reciprocal a step,
// not divided cell by cell (four IEEE divisions a lane a step were most of
// its time): within about an ulp of the plain version's row.
//  * Steps run in 4 rolled groups of 8 unrolled ones: k % 8 (and so k % 4)
//    is a constant in the body, which keeps every register index constant,
//    and the code small enough to stay in the instruction cache (fully
//    unrolled, the sweeps ran slower on an H100). Not inlined, for the
//    same reason: both calls share one copy.
__device__ __noinline__ void warp_gauss_jordan32(float* d, int ld) {
  const int lane = threadIdx.x % 32, g = lane / 8, h = lane % 8;
  float c[8][4];
#pragma unroll
  for (int v = 0; v < 8; ++v)
#pragma unroll
    for (int u = 0; u < 4; ++u) c[v][u] = d[(8 * g + v) * ld + 4 * h + u];
#pragma unroll 1
  for (int kg = 0; kg < 4; ++kg) {
#pragma unroll
    for (int kv = 0; kv < 8; ++kv) {
      // Step k = 8 kg + kv. Cell (k, k) lies in lane (kg, k / 4) at
      // (kv, k % 4); row k of this lane's columns in lane (kg, h), column
      // k of its rows in lane (g, k / 4).
      const int k = 8 * kg + kv, ku = kv % 4;
      const float rp = reciprocal(__shfl_sync(0xffffffffu, c[kv][ku], 8 * kg + k / 4));
      float row[4], fac[8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float x = __shfl_sync(0xffffffffu, c[kv][u], 8 * kg + h);
        row[u] = 4 * h + u == k ? rp : __fmul_rn(x, rp);
      }
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const float f = __shfl_sync(0xffffffffu, c[v][ku], 8 * g + k / 4);
        fac[v] = 8 * g + v == k ? 0.f : f;
      }
#pragma unroll
      for (int v = 0; v < 8; ++v)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          c[v][u] = 8 * g + v == k
                        ? row[u]
                        : __fsub_rn(4 * h + u == k ? 0.f : c[v][u], __fmul_rn(fac[v], row[u]));
    }
  }
#pragma unroll
  for (int v = 0; v < 8; ++v)
#pragma unroll
    for (int u = 0; u < 4; ++u) d[(8 * g + v) * ld + 4 * h + u] = c[v][u];
}

// out (+)= sign a b for 32 x 32 blocks in shared memory, a's rows on
// 16-byte boundaries (lda a multiple of 4): a thread of 256 computes
// column threadIdx.x % 32 of every 8th row, reading a four values at a
// time. With kAdd the product is added to out, else it replaces it.
template <bool kAdd, bool kNegate>
__device__ __forceinline__ void product32(float* out, int ldo, const float* a, int lda,
                                          const float* b, int ldb) {
  const int j = threadIdx.x % 32, i0 = threadIdx.x / 32;
  float acc[4] = {};
#pragma unroll
  for (int l = 0; l < 32; l += 4) {
    float bv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = b[(l + q) * ldb + j];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float4 av = *reinterpret_cast<const float4*>(&a[(i0 + 8 * n) * lda + l]);
      acc[n] = fmaf(av.x, bv[0], acc[n]);
      acc[n] = fmaf(av.y, bv[1], acc[n]);
      acc[n] = fmaf(av.z, bv[2], acc[n]);
      acc[n] = fmaf(av.w, bv[3], acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float* const o = &out[(i0 + 8 * n) * ldo + j];
    const float v = kNegate ? -acc[n] : acc[n];
    *o = kAdd ? *o + v : v;
  }
}

// Panel [base, base + t): D^-1 into shared memory (every block of the launch
// computes the same), then rows [32 x, +32) of W and of R^T.
//  * D, padded to 64 x 64 with the identity (a padded row or column is
//    never touched by the steps of the t x t block, so its inverse is the
//    top-left of the padded one), is inverted as 2 x 2 blocks of 32:
//    A^-1 by one warp, X = -A^-1 B, Y = -C A^-1, S = E + C X, S^-1 by one
//    warp, then [A^-1 + X S^-1 Y, X S^-1 ; S^-1 Y, S^-1]. The chain is two
//    32-step sweeps in registers and five small products (float4 reads).
//  * Warp 0 starts the inverse as soon as D is loaded; the other warps
//    load W's left factor and R^T's source meanwhile, and write R^T.
//  * W's rows are register-tiled products: 2 rows x 4 columns a thread.
// Rows of W and of R^T a block of bgj_panel forms: few, so that the part
// of the launch after the inverse is short, and many blocks share it.
constexpr int kPanelRows = 32;
// Row strides of bgj_panel's tiles: rows on 16-byte boundaries, for float4
// reads.
constexpr int kPanelLd = kPanelMax + 4;
constexpr int kXyLd = 32 + 4;
// D (64 rows), S^T (64 x 32), the R^T source (64 x 32), X and Y (32 x 32).
constexpr size_t kPanelSmem =
    (kPanelMax * kPanelLd + 2 * kPanelMax * kPanelLd + 2 * 32 * kXyLd) * sizeof(float);

__global__ void __launch_bounds__(256) bgj_panel(const BgjArgs a) {
  constexpr int kLd = kPanelLd;
  extern __shared__ __align__(16) float panel_smem[];
  float (*const D)[kLd] = reinterpret_cast<float (*)[kLd]>(panel_smem);
  float (*const ST)[kLd] = D + kPanelMax;   // ST[l][r], r < kPanelRows
  float (*const RT)[kLd] = ST + kPanelMax;  // RT[q][c], c < kPanelRows
  float* const XY = &RT[kPanelMax][0];
  const int t = a.t, base = a.base, bs = a.bs, tid = threadIdx.x;
  const int r0 = blockIdx.x * kPanelRows;
  const long long sys = blockIdx.y;
  const float* M = a.m + sys * bs * bs;
  wait_for_previous_grid();
  // D first (a loop of constant trip count, unrolled, so that every
  // thread's loads are in flight together): the sweep waits for it alone.
#pragma unroll
  for (int n = 0; n < kPanelMax * kPanelMax / 256; ++n) {
    const int e = tid + 256 * n, i = e / kPanelMax, j = e % kPanelMax;
    D[i][j] = (i < t && j < t) ? M[(long long)(base + i) * bs + base + j] : (i == j ? 1.f : 0.f);
  }
  __syncthreads();
  let_next_grid_start();
  const int warp = tid / 32;
  float* const rhi = a.rt + sys * 2 * bs * a.ld;
  float* const rlo = rhi + bs * a.ld;
  if (warp == 0) {
    warp_gauss_jordan32(&D[0][0], kLd);
  } else {
    // While warp 0 sweeps, the other warps load W's left factor, the
    // block's rows of the panel's columns (zero past t), transposed, and
    // R^T's source, the panel rows' columns r0 .. r0 + 63; then write R^T,
    // which needs no inverse: the panel rows' column c, or e_(c - base)
    // inside the panel.
    constexpr int kOthers = 256 - 32;
#pragma unroll 4
    for (int e = tid - 32; e < kPanelRows * kPanelMax; e += kOthers) {
      const int r = e / kPanelMax, l = e % kPanelMax;
      ST[l][r] = (r0 + r < bs && l < t) ? M[(long long)(r0 + r) * bs + base + l] : 0.f;
      const int q = e / kPanelRows, c = e % kPanelRows;
      RT[q][c] = (q < t && r0 + c < bs) ? M[(long long)(base + q) * bs + r0 + c] : 0.f;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kOthers) : "memory");
    for (int e = tid - 32; e < kPanelRows * kPanelMax; e += kOthers) {
      const int cc = e / kPanelMax, q = e % kPanelMax, c = r0 + cc;
      if (c >= bs || q >= t) continue;
      const float v = (c >= base && c < base + t) ? (c - base == q ? 1.f : 0.f) : RT[q][cc];
      store_split(rhi, rlo, (long long)c * a.ld + q, v);
    }
  }
  __syncthreads();
  if (t > 32) {
    float* const X = XY;
    float* const Y = XY + 32 * kXyLd;
    product32<false, true>(X, kXyLd, &D[0][0], kLd, &D[0][32], kLd);    // X = -A^-1 B
    product32<false, true>(Y, kXyLd, &D[32][0], kLd, &D[0][0], kLd);    // Y = -C A^-1
    __syncthreads();
    product32<true, false>(&D[32][32], kLd, &D[32][0], kLd, X, kXyLd);  // S = E + C X
    __syncthreads();
    if (warp == 0) warp_gauss_jordan32(&D[32][32], kLd);
    __syncthreads();
    // Top right: -A^-1 B S^-1 = X S^-1; bottom left: -S^-1 C A^-1 = S^-1 Y.
    product32<false, false>(&D[0][32], kLd, X, kXyLd, &D[32][32], kLd);
    product32<false, false>(&D[32][0], kLd, &D[32][32], kLd, Y, kXyLd);
    __syncthreads();
    // Top left: A^-1 + A^-1 B S^-1 C A^-1 = A^-1 + X (S^-1 Y), the bottom
    // left just written.
    product32<true, false>(&D[0][0], kLd, X, kXyLd, &D[32][0], kLd);
    __syncthreads();
  }
  float* const whi = a.w + sys * 2 * bs * a.ld;
  float* const wlo = whi + bs * a.ld;
  // W rows: D^-1 on the panel's rows, -M[i, P] D^-1 elsewhere. Thread
  // (rq, cq) owns rows 2 rq, 2 rq + 1 and columns 4 cq .. 4 cq + 3, and
  // reads them a step as a float2 and a float4.
  {
    static_assert(kPanelRows == 32, "16 x 16 threads of 2 x 4 outputs");
    const int rq = tid / 16, cq = tid % 16;
    float w[2][4] = {};
    // ST is zero past row t, so the sum runs over all 64, unrolled.
#pragma unroll
    for (int l = 0; l < kPanelMax; ++l) {
      const float2 s2 = *reinterpret_cast<const float2*>(&ST[l][2 * rq]);
      const float4 d4 = *reinterpret_cast<const float4*>(&D[l][4 * cq]);
      const float sv[2] = {s2.x, s2.y}, dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int u = 0; u < 4; ++u) w[v][u] = fmaf(sv[v], dv[u], w[v][u]);
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int i = r0 + 2 * rq + v;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = 4 * cq + u;
        if (i >= bs || q >= t) continue;
        const float val = (i >= base && i < base + t) ? D[i - base][q] : -w[v][u];
        store_split(whi, wlo, (long long)i * a.ld + q, val);
      }
    }
  }
}

template <int N>
struct BgjShape {
  static constexpr int kBBytes = 2 * N * kRowBytes;
  static constexpr int kChunkBytes = kATileBytes + kBBytes;
  static constexpr int kChunks = kPanelMax / kChunk;
  static constexpr size_t kSmem = 1024 + kChunks * kChunkBytes + 8;
};

// M (+)= W R on one 64 x N tile, with the panel's rows and columns of M
// zeroed as the sum is added. W and R^T are at most 64 deep: both chunks
// are loaded at once.
template <int N>
__global__ void __launch_bounds__(128) bgj_update(const __grid_constant__ CUtensorMap tw,
                                                  const __grid_constant__ CUtensorMap tr,
                                                  const BgjArgs a) {
  using Sh = BgjShape<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const tiles = align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(tiles + Sh::kChunks * Sh::kChunkBytes);
  const int tiles_n = static_cast<int>(cdiv(a.bs, N));
  const int row0 = blockIdx.x / tiles_n * kTileM, col0 = blockIdx.x % tiles_n * N;
  const int sys = blockIdx.y, n_k = static_cast<int>(cdiv(a.t, kChunk));
  if (threadIdx.x == 0) {
    repro::prefetch_tensormap(&tw);
    repro::prefetch_tensormap(&tr);
    repro::mbar_init(full, 1);
    repro::mbar_init_fence();
  }
  // W, R^T and M are the panel launch's, and the update's before it.
  wait_for_previous_grid();
  if (threadIdx.x == 0) {
    repro::mbar_expect_tx(full, n_k * Sh::kChunkBytes);
    for (int kc = 0; kc < n_k; ++kc) {
      uint8_t* const st = tiles + kc * Sh::kChunkBytes;
      repro::tma_load_4d(st, &tw, full, kc * kChunk, row0, 0, sys);
      repro::tma_load_4d(st + kATileBytes, &tr, full, kc * kChunk, col0, 0, sys);
    }
  }
  __syncthreads();
  // The tile of M, read while the loads are in flight; zero on the panel's
  // rows and columns.
  float* const M = a.m + static_cast<long long>(sys) * a.bs * a.bs;
  float acc[N / 2], part[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = row0 + acc_row(i), c = col0 + acc_col(i);
    const bool panel = (r >= a.base && r < a.base + a.t) || (c >= a.base && c < a.base + a.t);
    acc[i] = (r < a.bs && c < a.bs && !panel) ? M[static_cast<long long>(r) * a.bs + c] : 0.f;
  }
  repro::mbar_wait(full, 0);
  let_next_grid_start();
  for (int kc = 0; kc < n_k; ++kc) {
    const uint8_t* const st = tiles + kc * Sh::kChunkBytes;
    chunk_product<N>(part, st, st + kATileBytes);
    repro::wgmma_wait_all();
    repro::fence_regs(part);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] += part[i];
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = row0 + acc_row(i), c = col0 + acc_col(i);
    if (r < a.bs && c < a.bs) M[static_cast<long long>(r) * a.bs + c] = acc[i];
  }
}

// ---------------------------------------------------------------------------
// Blocked triangular solve
// ---------------------------------------------------------------------------

struct TriArgs {
  const void* t;
  const void* b;
  void* out;    // (batch, bs, k) in b's type
  float* pk;    // (batch, 2, bs, ld): P, panel rows [-D_p^-1 T[p, <p] | D_p^-1 | 0]
  float* zt;    // (batch, 2, k, ld): B, then X, transposed and flipped
  float* dinv;  // (batch, bs / t, t, t)
  int bs, k, panel;
  long long ld;
  long long st_batch, st_row, st_col;  // strides of T, in elements
  int lower, unit;
};

// Row or column of T (or row of B and X) that logical index i names: the
// upper sweep reads everything flipped, which makes it a lower sweep.
__host__ __device__ __forceinline__ int flip(int i, int bs, int lower) {
  return lower ? i : bs - 1 - i;
}

template <typename TT>
__device__ __forceinline__ float t_at(const TriArgs& a, long long sys, int i, int j) {
  const TT* T = static_cast<const TT*>(a.t) + sys * a.st_batch;
  return to_f32(T[flip(i, a.bs, a.lower) * a.st_row + flip(j, a.bs, a.lower) * a.st_col]);
}

// D_p^-1 for panel blockIdx.x of system blockIdx.y: thread j substitutes
// column j of the identity, rows in order, its column in registers (the
// loops unrolled, so every index is a constant). D is padded to 64 x 64
// with the identity, which leaves the t x t inverse as its top-left.
template <typename TT>
__global__ void __launch_bounds__(256) tri_dinv(const TriArgs a) {
  __shared__ float D[kPanelMax][kPanelMax + 1];
  const int t = a.panel, base = blockIdx.x * t, j = threadIdx.x;
  const long long sys = blockIdx.y;
  const bool col_major = a.st_row == 1 && a.st_col != 1;
  // The diagonal block from the targeted triangle only, by all 256 threads,
  // their loads in flight together.
#pragma unroll
  for (int n = 0; n < kPanelMax * kPanelMax / 256; ++n) {
    const int e = j + 256 * n;
    const int r = col_major ? e % kPanelMax : e / kPanelMax;
    const int c = col_major ? e / kPanelMax : e % kPanelMax;
    float v = r == c ? 1.f : 0.f;
    if (r < t && c < r) v = t_at<TT>(a, sys, base + r, base + c);
    if (r < t && c == r && !a.unit) v = t_at<TT>(a, sys, base + r, base + r);
    D[r][c] = v;
  }
  __syncthreads();
  if (j >= kPanelMax) return;
  float x[kPanelMax];
#pragma unroll
  for (int r = 0; r < kPanelMax; ++r) {
    float s = r == j ? 1.f : 0.f;
#pragma unroll
    for (int l = 0; l < r; ++l) s = fmaf(-D[r][l], x[l], s);
    x[r] = a.unit ? s : __fdiv_rn(s, D[r][r]);
  }
  float* const out = a.dinv + (sys * gridDim.x + blockIdx.x) * t * t;
  if (j < t)
#pragma unroll
    for (int r = 0; r < kPanelMax; ++r)
      if (r < t) out[r * t + j] = x[r];
}

// P's rows of panel blockIdx.y, columns [64 blockIdx.x, +64), system
// blockIdx.z, as TF32 hi and lo planes. Thread (rq, cq) computes rows
// 4 rq .. 4 rq + 3 and columns cq + 16 u of the 64 x 64 tile.
constexpr int kPackCols = 64;

template <typename TT>
__global__ void __launch_bounds__(256) tri_pack(const TriArgs a) {
  __shared__ float Di[kPanelMax][kPanelMax + 1];
  __shared__ float Tc[kPanelMax][kPackCols + 1];
  const int t = a.panel, base = blockIdx.y * t, c0 = blockIdx.x * kPackCols, tid = threadIdx.x;
  const long long sys = blockIdx.z;
  const float* const di = a.dinv + (sys * gridDim.y + blockIdx.y) * t * t;
#pragma unroll
  for (int n = 0; n < kPanelMax * kPanelMax / 256; ++n) {
    const int e = tid + 256 * n, r = e / kPanelMax, m = e % kPanelMax;
    Di[r][m] = (r < t && m < t) ? di[r * t + m] : 0.f;
  }
  // T[p, c] for the tile's columns left of the diagonal block: inside the
  // targeted triangle.
  const bool col_major = a.st_row == 1 && a.st_col != 1;
#pragma unroll
  for (int n = 0; n < kPanelMax * kPackCols / 256; ++n) {
    const int e = tid + 256 * n;
    const int m = col_major ? e % kPanelMax : e / kPackCols;
    const int c = col_major ? e / kPanelMax : e % kPackCols;
    Tc[m][c] = (m < t && c0 + c < base) ? t_at<TT>(a, sys, base + m, c0 + c) : 0.f;
  }
  __syncthreads();
  const int rq = tid / 16, cq = tid % 16;
  float acc[4][4] = {};
  if (c0 < base) {
    for (int m = 0; m < t; ++m) {
      float dv[4], tv[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) dv[v] = Di[4 * rq + v][m];
#pragma unroll
      for (int u = 0; u < 4; ++u) tv[u] = Tc[m][cq + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[v][u] = fmaf(dv[v], tv[u], acc[v][u]);
    }
  }
  float* const hi = a.pk + sys * 2 * a.bs * a.ld;
  float* const lo = hi + a.bs * a.ld;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int r = 4 * rq + v;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = c0 + cq + 16 * u;
      if (r >= t || col >= a.bs) continue;
      const float val = col < base ? -acc[v][u] : col < base + t ? Di[r][col - base] : 0.f;
      store_split(hi, lo, static_cast<long long>(base + r) * a.ld + col, val);
    }
  }
}

// Z[c][i] = B[flip(i)][c], as TF32 hi and lo planes: a 32 x 32 tile a block.
template <typename TB>
__global__ void __launch_bounds__(256) tri_pack_b(const TriArgs a) {
  __shared__ float tile[kChunk][kChunk + 1];
  const int i0 = blockIdx.x * kChunk, c0 = blockIdx.y * kChunk;
  const int tx = threadIdx.x % kChunk, ty = threadIdx.x / kChunk;
  const long long sys = blockIdx.z;
  const TB* const B = static_cast<const TB*>(a.b) + sys * a.bs * static_cast<long long>(a.k);
  for (int q = ty; q < kChunk; q += 256 / kChunk) {
    const int i = i0 + q, c = c0 + tx;
    tile[q][tx] = (i < a.bs && c < a.k)
                      ? to_f32(B[static_cast<long long>(flip(i, a.bs, a.lower)) * a.k + c])
                      : 0.f;
  }
  __syncthreads();
  float* const hi = a.zt + sys * 2 * a.k * a.ld;
  float* const lo = hi + static_cast<long long>(a.k) * a.ld;
  for (int q = ty; q < kChunk; q += 256 / kChunk) {
    const int c = c0 + q, i = i0 + tx;
    if (c < a.k && i < a.bs) store_split(hi, lo, static_cast<long long>(c) * a.ld + i, tile[tx][q]);
  }
}

template <int N>
struct TriShape {
  static constexpr int kBBytes = 2 * N * kRowBytes;
  static constexpr int kStageBytes = kATileBytes + kBBytes;
  // As deep as 192 KB allows, up to 12 (narrow strips have small stages).
  static constexpr int kStages = 196608 / kStageBytes < 12 ? 196608 / kStageBytes : 12;
  // 1024 bytes of slack to align the ring; the full and empty barriers of
  // each stage and the solved barrier.
  static constexpr size_t kSmem = 1024 + kStages * kStageBytes + 8 * (2 * kStages + 1);
  static_assert(kStages >= 2 && kSmem <= 232448, "the ring must fit in 227 KB");
};

// The sweep over columns [N blockIdx.x, +N) of system blockIdx.y.
template <int N, typename TB>
__global__ void __launch_bounds__(256, 1)
    tri_tc(const __grid_constant__ CUtensorMap tp, const __grid_constant__ CUtensorMap tz,
           const TriArgs a) {
  using Sh = TriShape<N>;
  constexpr int kStages = Sh::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ring = align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + kStages * Sh::kStageBytes);
  uint64_t* const empty = full + kStages;
  uint64_t* const solved = empty + kStages;  // one phase a solved panel
  const int t = a.panel, npan = a.bs / t, c0 = blockIdx.x * N, sys = blockIdx.y;

  if (threadIdx.x == 0) {
    repro::prefetch_tensormap(&tp);
    repro::prefetch_tensormap(&tz);
    for (int s = 0; s < kStages; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], 128);
    }
    repro::mbar_init(solved, 128);
    repro::mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 1) {
    // Producer: a chunk of panel p reads Z's columns [32 kc, +32); those
    // below base are rows of X, which it loads only once the panels that
    // solve them are done (the consumer's phases of `solved`, in order).
    if (threadIdx.x == 128) {
      int it = 0, done = 0;
      for (int p = 0; p < npan; ++p) {
        const int base = p * t, n_k = static_cast<int>(cdiv(base + t, kChunk));
        for (int kc = 0; kc < n_k; ++kc, ++it) {
          const int last = min(kc * kChunk + kChunk, base) - 1;
          const int need = last < 0 ? 0 : last / t + 1;
          for (; done < need; ++done) repro::mbar_wait(solved, done & 1);
          const int s = it % kStages;
          repro::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          uint8_t* const st = ring + s * Sh::kStageBytes;
          repro::mbar_expect_tx(&full[s], Sh::kStageBytes);
          repro::tma_load_4d(st, &tp, &full[s], kc * kChunk, base, 0, sys);
          repro::tma_load_4d(st + kATileBytes, &tz, &full[s], kc * kChunk, c0, 0, sys);
        }
      }
    }
    return;
  }

  // Consumer warpgroup: the tensor cores sum a chunk into a part from zero;
  // the part is added to acc in f32 with round-to-nearest once the chunk's
  // products are done. (Adding one part while the next chunk's products
  // run made ptxas serialize every wgmma: it cannot tell the parts'
  // registers apart.)
  TB* const O = static_cast<TB*>(a.out) + static_cast<long long>(sys) * a.bs * a.k;
  float* const zhi = a.zt + static_cast<long long>(sys) * 2 * a.k * a.ld;
  float* const zlo = zhi + static_cast<long long>(a.k) * a.ld;
  float acc[N / 2], part[N / 2];
  int it = 0;
  for (int p = 0; p < npan; ++p) {
    const int base = p * t, n_k = static_cast<int>(cdiv(base + t, kChunk));
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    for (int j = 0; j < n_k; ++j) {
      const int s = (it + j) % kStages;
      repro::mbar_wait(&full[s], ((it + j) / kStages) & 1);
      const uint8_t* const st = ring + s * Sh::kStageBytes;
      chunk_product<N>(part, st, st + kATileBytes);
      repro::wgmma_wait_all();
      repro::fence_regs(part);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] += part[i];
      repro::mbar_arrive(&empty[s]);
    }
    it += n_k;
    // X_p: rows past the panel (t < 64) and columns past k are not stored.
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int r = acc_row(i), c = c0 + acc_col(i);
      if (r < t && c < a.k) {
        const int row = base + r;
        O[static_cast<long long>(flip(row, a.bs, a.lower)) * a.k + c] = from_f32<TB>(acc[i]);
        store_split(zhi, zlo, static_cast<long long>(c) * a.ld + row, acc[i]);
      }
    }
    repro::fence_proxy_async();
    repro::mbar_arrive(solved);
  }
}

template <typename F>
cudaError_t with_strip(int strip, F&& f) {
  switch (strip) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
  }
  return cudaErrorInvalidValue;
}

template <int N, typename TB>
cudaError_t launch_tri_tc(const TriArgs& a, int batch, cudaStream_t s) {
  using Sh = TriShape<N>;
  CUtensorMap tp, tz;
  cudaError_t err;
  if ((err = plane_map(&tp, a.pk, a.bs, a.bs, a.ld, batch, kTileM)) ||
      (err = plane_map(&tz, a.zt, a.bs, a.k, a.ld, batch, N)))
    return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      tri_tc<N, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Sh::kSmem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(static_cast<unsigned>(cdiv(a.k, N)), batch);
  tri_tc<N, TB><<<grid, 256, Sh::kSmem, s>>>(tp, tz, a);
  return cudaGetLastError();
}

template <typename TT, typename TB>
cudaError_t tri_solve_t(const TriArgs& a, int batch, int strip, cudaStream_t s) {
  const int npan = a.bs / a.panel;
  tri_dinv<TT><<<dim3(npan, batch), 256, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tri_pack<TT><<<dim3(static_cast<unsigned>(cdiv(a.bs, kPackCols)), npan, batch), 256, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tri_pack_b<TB><<<dim3(static_cast<unsigned>(cdiv(a.bs, kChunk)),
                        static_cast<unsigned>(cdiv(a.k, kChunk)), batch),
                   256, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return with_strip(strip, [&](auto n) { return launch_tri_tc<decltype(n)::value, TB>(a, batch, s); });
}

template <typename TT>
cudaError_t tri_solve_b(const TriArgs& a, int batch, int b_dtype, int strip, cudaStream_t s) {
  switch (b_dtype) {
    case repro::kF32: return tri_solve_t<TT, float>(a, batch, strip, s);
    case repro::kBF16: return tri_solve_t<TT, __nv_bfloat16>(a, batch, strip, s);
    case repro::kF16: return tri_solve_t<TT, __half>(a, batch, strip, s);
  }
  return cudaErrorInvalidValue;
}

// Row stride, in f32, of the packed planes of a bs-wide operand: 16 bytes
// a granule, as TMA asks.
inline long long plane_ld(int cols) { return (cols + 3) / 4 * 4LL; }

cudaError_t attributes_of(const void* kernel, size_t dynamic, int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = static_cast<int>(dynamic);
  out[3] = static_cast<int>(fa.localSizeBytes);
  return cudaSuccess;
}

}  // namespace

// Scalar Gauss-Jordan. For bs <= kGjRegMaxBs one in-place launch and no
// scratch (m may be null); above it m: (batch, bs, 2bs) f32 scratch.
extern "C" int repro_gauss_jordan(const void* a, void* out, float* m, int batch, int bs,
                                  int in_dtype, int out_dtype, void* stream) {
  if (batch == 0 || bs == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bs <= kGjRegMaxBs)
    return with_gj_inplace(bs, [&](auto kernel, int threads) {
      kernel<<<batch, threads, 0, s>>>(a, out, bs, in_dtype, out_dtype);
      return cudaGetLastError();
    });
  if (m == nullptr) return cudaErrorInvalidValue;
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

// Registers a thread, static shared memory and local (spill) bytes of the
// kernel the scalar route launches for bs: out[0..2].
extern "C" int repro_gauss_jordan_attributes(int bs, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err;
  if (bs <= kGjRegMaxBs)
    err = with_gj_inplace(bs, [&](auto kernel, int) {
      return cudaFuncGetAttributes(&fa, kernel);
    });
  else
    err = cudaFuncGetAttributes(&fa, gj_scalar);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = static_cast<int>(fa.localSizeBytes);
  return 0;
}

// Blocked Gauss-Jordan with panel width t (t <= 64, t divides bs), in
// place. m: (batch, bs, bs) f32, the working copy, which may be out itself
// when out_dtype is f32; w: (2, batch, 2, bs, ld) f32 scratch for W and
// R^T, ld = plane_ld(t).
extern "C" int repro_blocked_gauss_jordan(const void* a, void* out, float* m, float* w,
                                          int batch, int bs, int t, int in_dtype,
                                          int out_dtype, void* stream) {
  if (batch == 0 || bs == 0) return 0;
  if (t < 1 || t > kPanelMax || bs % t) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(batch) * bs * bs, ld = plane_ld(t);
  cudaError_t err = convert_any(a, in_dtype, m, repro::kF32, n, s);
  if (err != cudaSuccess) return err;
  BgjArgs args{m, w, w + 2LL * batch * bs * ld, bs, t, 0, ld};
  using Sh = BgjShape<kBgjN>;
  CUtensorMap tw, tr;
  if ((err = plane_map(&tw, args.w, t, bs, ld, batch, kTileM)) ||
      (err = plane_map(&tr, args.rt, t, bs, ld, batch, kBgjN)))
    return err;
  static const cudaError_t attr =
      cudaFuncSetAttribute(bgj_update<kBgjN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(Sh::kSmem));
  if (attr != cudaSuccess) return attr;
  static const cudaError_t panel_attr = cudaFuncSetAttribute(
      bgj_panel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kPanelSmem));
  if (panel_attr != cudaSuccess) return panel_attr;
  const dim3 panel_grid(static_cast<unsigned>(cdiv(bs, kPanelRows)), batch);
  const dim3 update_grid(static_cast<unsigned>(cdiv(bs, kTileM) * cdiv(bs, kBgjN)), batch);
  for (int base = 0; base < bs; base += t) {
    args.base = base;
    if ((err = launch_after(bgj_panel, panel_grid, 256, kPanelSmem, s, args)) ||
        (err = launch_after(bgj_update<kBgjN>, update_grid, 128, Sh::kSmem, s, tw, tr, args)))
      return err;
  }
  return m == out ? cudaSuccess : convert_any(m, repro::kF32, out, out_dtype, n, s);
}

// Blocked triangular solve T X = B, panel width t (t <= 64, t divides bs),
// strip columns of B a block (8, 16, 32 or 64). t: (batch, bs, bs) at
// strides (st_batch, st_row, st_col); b, out: (batch, bs, k) contiguous;
// scratch: f32, batch * (2 (bs + k) ld + bs t) of it, ld = plane_ld(bs).
extern "C" int repro_triangular_solve(const void* t, const void* b, void* out, float* scratch,
                                      int batch, int bs, int k, int panel, long long st_batch,
                                      long long st_row, long long st_col, int lower, int unit,
                                      int t_dtype, int b_dtype, int strip, void* stream) {
  if (batch == 0 || bs == 0 || k == 0) return 0;
  if (panel < 1 || panel > kPanelMax || bs % panel) return cudaErrorInvalidValue;
  const long long ld = plane_ld(bs);
  float* const zt = scratch + 2LL * batch * bs * ld;
  float* const dinv = zt + 2LL * batch * k * ld;
  const TriArgs args{t, b, out, scratch, zt, dinv, bs, k, panel, ld,
                     st_batch, st_row, st_col, lower, unit};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (t_dtype) {
    case repro::kF32: return tri_solve_b<float>(args, batch, b_dtype, strip, s);
    case repro::kBF16: return tri_solve_b<__nv_bfloat16>(args, batch, b_dtype, strip, s);
    case repro::kF16: return tri_solve_b<__half>(args, batch, b_dtype, strip, s);
  }
  return cudaErrorInvalidValue;
}

// Registers a thread, static and dynamic shared memory and local (spill)
// bytes, out[0..3], of a kernel of the blocked routes: 0 tri_tc (f32 B,
// strip columns), 1 tri_dinv, 2 tri_pack, 3 bgj_panel, 4 bgj_update.
extern "C" int repro_blocked_attributes(int kernel, int strip, int* out) {
  switch (kernel) {
    case 0:
      return with_strip(strip, [&](auto n) {
        constexpr int kN = decltype(n)::value;
        return attributes_of(reinterpret_cast<const void*>(tri_tc<kN, float>),
                             TriShape<kN>::kSmem, out);
      });
    case 1: return attributes_of(reinterpret_cast<const void*>(tri_dinv<float>), 0, out);
    case 2: return attributes_of(reinterpret_cast<const void*>(tri_pack<float>), 0, out);
    case 3: return attributes_of(reinterpret_cast<const void*>(bgj_panel), kPanelSmem, out);
    case 4:
      return attributes_of(reinterpret_cast<const void*>(bgj_update<kBgjN>),
                           BgjShape<kBgjN>::kSmem, out);
  }
  return cudaErrorInvalidValue;
}
