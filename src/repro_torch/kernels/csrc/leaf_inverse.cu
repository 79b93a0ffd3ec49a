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
//
// repro_triangular_solve replaces `triangular_solve_pallas`: T X = B for a
// batch of triangular (or packed-LU) T, bs x bs, and B, bs x k, swept in
// f32, reading only the targeted triangle of T.
//
// What bounds it on an H100: bs^2 k operations against 4 (bs^2 + 2 bs k)
// bytes, so at SPIN's leaves (bs = 1024, k up to 15616) it is bound by the
// f32 FMA rate. The TPU kernel keeps the whole (bs, k) right-hand side in
// VMEM and one grid step sweeps every panel; at bs = 1024, k = 15616 that
// is 64 MB, against 227 KB of shared memory a block.
//
// What the design does about it:
//  * Columns of the right-hand side are independent, so each block owns a
//    strip of kTriStrip columns (grid: strips x batch) and walks the
//    panels of t rows in order, with no exchange between blocks.
//  * Left-looking: for panel p the block first subtracts the already
//    solved rows, acc = B_p - T[p, :base] X[:base], as a tiled product
//    (4 x 4 register tile a thread, T and X staged through shared memory
//    kTriDepth deep, the next chunk loaded while the current one is
//    multiplied), then substitutes against the t x t diagonal block in
//    shared memory, and writes X_p once. T (4 MB at bs = 1024) and the
//    f32 solution stay in the 50 MB L2 for all the strips.
//  * A block's walk is a chain of dependent steps, and SPIN's narrow
//    leaves give few blocks, so the walk's latency, not the card's FMA
//    rate, sets the time: the substitution's t steps a panel run in
//    registers inside one warp each (each warp owns 8 columns), with no
//    barrier and no shared-memory round trip on the chain. That takes
//    about 200 registers a thread, so one block an SM: capping them at
//    128 for two blocks spilled and slowed the narrow leaves more than it
//    sped the wide ones, on an H100.
//  * The upper sweep is the lower sweep on T flipped about both axes (row
//    and column i read as bs - 1 - i), so one kernel does both.
//  * T is read through its strides: the LU that torch.linalg.lu_factor
//    returns is column-major, and the loads of T follow whichever of its
//    strides is unit, so they stay coalesced.
//  * The substitution inside a panel is direct (x_j = rhs_j / d_jj, then
//    the rows below), not the TPU kernel's Gauss-Jordan sweep on
//    [D | rhs_p], and the panel updates sum in another order than the
//    plain version's rank-t updates; the two agree to rounding.
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


// ---------------------------------------------------------------------------
// Blocked triangular solve
// ---------------------------------------------------------------------------

constexpr int kTriPanelMax = 64;  // largest panel t (rows solved together)
constexpr int kTriStrip = 64;     // right-hand-side columns of one block
constexpr int kTriDepth = 32;     // depth of one staged chunk of T's panel row
constexpr int kTriThreads = 256;
constexpr int kTriLoads = kTriPanelMax * kTriDepth / kTriThreads;  // per thread
constexpr int kTriSPitch = kTriStrip + 8;  // row pitch of S: see the mapping

struct TriArgs {
  const void* t;
  const void* b;
  float* work;  // (batch, bs, k) f32: the solution as it is solved
  void* out;    // (batch, bs, k) in b's type, or nullptr when work is the output
  int bs, k, panel;
  long long st_batch, st_row, st_col;  // strides of T, in elements
  int lower, unit;
};

// Row or column of T (or row of B and X) that logical index i names: the
// upper sweep reads everything flipped, which makes it a lower sweep.
__device__ __forceinline__ int flip(int i, int bs, int lower) { return lower ? i : bs - 1 - i; }

// One block: columns [blockIdx.x * kTriStrip, +kTriStrip) of system
// blockIdx.y.
//  * Panel product: thread (ty, tx) owns rows ty + 16 r and columns
//    tx + 16 q of the t x 64 accumulator. The next chunk of T and X is
//    loaded into registers while the current one is multiplied.
//  * Substitution: warp w owns columns 8 w .. 8 w + 7, lane l column
//    8 w + (l & 7) and rows (l >> 3) + 4 r, in registers, so the t
//    dependent steps of a panel stay inside one warp and pass x_j by
//    shuffle. S's pitch of 72 puts the 32 lanes' rows and columns on 32
//    different banks as they load their rows.
template <typename TT, typename TB>
__global__ void __launch_bounds__(kTriThreads) tri_solve(TriArgs a) {
  static_assert(kTriThreads == 256 && kTriStrip == 64 && kTriPanelMax == 64,
                "the thread mappings assume a 64 x 64 panel tile on 256 threads");
  // The staged chunks and the panel's right-hand sides are never live at
  // once, so they share their shared memory.
  __shared__ union {
    struct {
      float Ts[kTriPanelMax][kTriDepth + 1];
      float Xs[kTriDepth][kTriStrip];
    } chunk;
    float S[kTriPanelMax][kTriSPitch];
  } sm;
  __shared__ float D[kTriPanelMax][kTriPanelMax + 1];
  const int tid = threadIdx.x, bs = a.bs, k = a.k, t = a.panel, lower = a.lower;
  const int c0 = blockIdx.x * kTriStrip;
  const long long sys = blockIdx.y, rk = (long long)bs * k;
  const TT* T = static_cast<const TT*>(a.t) + sys * a.st_batch;
  const TB* B = static_cast<const TB*>(a.b) + sys * rk;
  float* X = a.work + sys * rk;
  TB* O = a.out ? static_cast<TB*>(a.out) + sys * rk : nullptr;
  // Consecutive threads walk T's unit-stride axis.
  const bool col_major = a.st_row == 1 && a.st_col != 1;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, sc = (tid >> 5) * 8 + (lane & 7), g = lane >> 3;
  auto tval = [&](int i, int j) {  // logical T[i][j], in f32
    return to_f32(T[flip(i, bs, lower) * a.st_row + flip(j, bs, lower) * a.st_col]);
  };
  // Element n of this thread's share of a chunk: (i, j) of T's t x 32 part,
  // (jx, c) of X's 32 x 64 part.
  auto t_at = [&](int n, int& i, int& j) {
    const int e = tid + n * kTriThreads;
    i = col_major ? e % kTriPanelMax : e / kTriDepth;
    j = col_major ? e / kTriPanelMax : e % kTriDepth;
  };
  float tr[kTriLoads], xr[kTriLoads];
  auto fetch = [&](int base, int kk) {
#pragma unroll
    for (int n = 0; n < kTriLoads; ++n) {
      int i, j;
      t_at(n, i, j);
      tr[n] = (i < t && kk + j < base) ? tval(base + i, kk + j) : 0.f;
      const int e = tid + n * kTriThreads, jx = e / kTriStrip, c = e % kTriStrip;
      xr[n] = (kk + jx < base && c0 + c < k)
                  ? X[(long long)flip(kk + jx, bs, lower) * k + c0 + c] : 0.f;
    }
  };

  for (int base = 0; base < bs; base += t) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = ty + 16 * r, c = c0 + tx + 16 * q;
        acc[r][q] = (i < t && c < k) ? to_f32(B[(long long)flip(base + i, bs, lower) * k + c]) : 0.f;
      }
    // acc -= T[base:base+t, :base] @ X[:base], over the solved rows only.
    if (base > 0) fetch(base, 0);
    for (int kk = 0; kk < base; kk += kTriDepth) {
#pragma unroll
      for (int n = 0; n < kTriLoads; ++n) {
        int i, j;
        t_at(n, i, j);
        sm.chunk.Ts[i][j] = tr[n];
        const int e = tid + n * kTriThreads;
        sm.chunk.Xs[e / kTriStrip][e % kTriStrip] = xr[n];
      }
      __syncthreads();
      if (kk + kTriDepth < base) fetch(base, kk + kTriDepth);
#pragma unroll
      for (int j = 0; j < kTriDepth; ++j) {
        float tv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) tv[r] = sm.chunk.Ts[ty + 16 * r][j];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = sm.chunk.Xs[j][tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(-tv[r], xv[q], acc[r][q]);
      }
      __syncthreads();
    }
    // The diagonal block, from the targeted triangle only, and the panel's
    // right-hand sides.
    for (int e = tid; e < kTriPanelMax * kTriPanelMax; e += kTriThreads) {
      const int i = col_major ? e % kTriPanelMax : e / kTriPanelMax;
      const int j = col_major ? e / kTriPanelMax : e % kTriPanelMax;
      if (i < t && j < i) D[i][j] = tval(base + i, base + j);
      if (i < t && j == i) D[i][i] = a.unit ? 1.f : tval(base + i, base + i);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) sm.S[ty + 16 * r][tx + 16 * q] = acc[r][q];
    __syncthreads();
    // Forward substitution in registers: a lane holds rows g + 4 r of its
    // column, and step j takes x_j from the lane that holds row j (final
    // after steps 0 .. j-1) by a shuffle, then updates the rows below it.
    // The steps are unrolled so that every register index is a constant.
    float sr[kTriPanelMax / 4];
#pragma unroll
    for (int r = 0; r < kTriPanelMax / 4; ++r) sr[r] = sm.S[g + 4 * r][sc];
    const bool live = c0 + sc < k;
#pragma unroll
    for (int j = 0; j < kTriPanelMax; ++j) {
      if (j == t) break;
      float x = __shfl_sync(0xffffffffu, sr[j >> 2], (lane & 7) + 8 * (j & 3));
      if (!a.unit) x = __fdiv_rn(x, D[j][j]);
#pragma unroll
      for (int r = 0; r < kTriPanelMax / 4; ++r) {
        const int i = g + 4 * r;
        if (i > j && i < t) sr[r] = __fsub_rn(sr[r], __fmul_rn(D[i][j], x));
      }
      if (live && g == (j & 3)) {
        const long long off = (long long)flip(base + j, bs, lower) * k + c0 + sc;
        X[off] = x;
        if (O) O[off] = from_f32<TB>(x);
      }
    }
    // Every warp is done with S and D (and its stores of X are visible)
    // before the next panel stages its chunks over S.
    __syncthreads();
  }
}

template <typename TT, typename TB>
cudaError_t tri_solve_t(const TriArgs& args, int batch, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(cdiv(args.k, kTriStrip)), batch);
  tri_solve<TT, TB><<<grid, kTriThreads, 0, s>>>(args);
  return cudaGetLastError();
}

template <typename TT>
cudaError_t tri_solve_b(const TriArgs& args, int batch, int b_dtype, cudaStream_t s) {
  switch (b_dtype) {
    case repro::kF32: return tri_solve_t<TT, float>(args, batch, s);
    case repro::kBF16: return tri_solve_t<TT, __nv_bfloat16>(args, batch, s);
    case repro::kF16: return tri_solve_t<TT, __half>(args, batch, s);
  }
  return cudaErrorInvalidValue;
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

// Blocked triangular solve T X = B, panel width t (t <= 64, t divides bs).
// t: (batch, bs, bs) at strides (st_batch, st_row, st_col); b, out:
// (batch, bs, k) contiguous; work: (batch, bs, k) f32 scratch, which is
// the output itself when out is nullptr (b in f32).
extern "C" int repro_triangular_solve(const void* t, const void* b, float* work, void* out,
                                      int batch, int bs, int k, int panel, long long st_batch,
                                      long long st_row, long long st_col, int lower, int unit,
                                      int t_dtype, int b_dtype, void* stream) {
  if (batch == 0 || bs == 0 || k == 0) return 0;
  if (panel < 1 || panel > kTriPanelMax || bs % panel) return cudaErrorInvalidValue;
  const TriArgs args{t, b, work, out, bs, k, panel, st_batch, st_row, st_col, lower, unit};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (t_dtype) {
    case repro::kF32: return tri_solve_b<float>(args, batch, b_dtype, s);
    case repro::kBF16: return tri_solve_b<__nv_bfloat16>(args, batch, b_dtype, s);
    case repro::kF16: return tri_solve_b<__half>(args, batch, b_dtype, s);
  }
  return cudaErrorInvalidValue;
}
