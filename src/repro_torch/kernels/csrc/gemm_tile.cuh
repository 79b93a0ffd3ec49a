// Tiled f32-accumulating FFMA GEMM body: out = beta * C + alpha * (A @ B),
// one product a launch. It carries the matmul and schur_update products
// with k == 0; every other product of those two takes the tensor-core body
// of matmul.cu. The element-type helpers here serve every kernel file.
//
// Written for the Pallas kernels `matmul_pallas` and `schur_update_pallas`
// (src/repro/kernels/matmul/kernel.py). On the TPU the k axis is a
// sequential grid dimension that carries an f32 VMEM accumulator from step
// to step; here blocks run in parallel and carry nothing, so each block
// owns one BM x BN output tile and walks the whole k range itself, with
// the accumulator in registers (TM x TN = 64 floats a thread).
//
// Bound on an H100: for a large product, the f32 FMA rate outside the
// tensor cores. f32 operands are multiplied in IEEE f32 with FFMA, never as
// one TF32 product, which would not hold the inversion's 1e-3 residual at
// large n. bf16 and f16 operands are widened to f32 as they are staged
// into shared memory.
//
// Design for that bound: 128 x 128 output tiles, 16-deep k slices staged
// through two shared-memory buffers (A stored transposed so that a thread
// reads its 8 A values and 8 B values as float4s), the next slice's loads
// from device memory in flight while the current slice is multiplied, and
// an 8 x 8 register tile a thread, which gives 64 FMAs for every 16
// shared-memory floats read.
// alpha is folded into the A tile as it is staged, and beta * C seeds the
// accumulator before the k loop, so the update costs no extra pass over
// the output. Every load and store is masked, so any (m, n, k) works and
// no tile rule of the TPU carries over.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace repro {

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

constexpr int kBM = 128, kBN = 128, kBK = 16, kThreads = 256;

struct GemmArgs {
  const void* a;
  const void* b;
  const void* c;  // nullptr: plain product
  void* out;      // may alias c: each element is read and written by one thread
  int m, n, k;
  long long lda, ldb, ldc, ldo;  // row strides, in elements
  float alpha, beta;
};

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads) gemm_kernel(GemmArgs p) {
  // Two shared-memory stages: while the block multiplies one k slice, each
  // thread holds its share of the next slice in registers, loaded from
  // device memory before the multiply, and stores it after.
  __shared__ __align__(16) float As[2][kBK][kBM + 4];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  constexpr int kLoads = kBM * kBK / kThreads;  // = kBK * kBN / kThreads
  static_assert(kLoads * kThreads == kBK * kBN, "tile shapes");

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const TIn* A = static_cast<const TIn*>(p.a);
  const TIn* B = static_cast<const TIn*>(p.b);

  // A thread's rows: row0 + ty*4 + {0..3} and row0 + 64 + ty*4 + {0..3};
  // its columns likewise from tx.
  int rows[8], cols[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rows[i] = row0 + ty * 4 + i;
    rows[i + 4] = row0 + 64 + ty * 4 + i;
    cols[i] = col0 + tx * 4 + i;
    cols[i + 4] = col0 + 64 + tx * 4 + i;
  }

  float acc[8][8];
  if (p.c != nullptr) {
    const TIn* C = static_cast<const TIn*>(p.c);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = (rows[i] < p.m && cols[j] < p.n)
                        ? p.beta * to_f32(C[rows[i] * p.ldc + cols[j]])
                        : 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  float ra[kLoads], rb[kLoads];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int e = tid + l * kThreads;
      const int ar = row0 + e / kBK, ak = k0 + e % kBK;
      ra[l] = (ar < p.m && ak < p.k) ? to_f32(A[ar * p.lda + ak]) : 0.f;
      const int bk = k0 + e / kBN, bc = col0 + e % kBN;
      rb[l] = (bk < p.k && bc < p.n) ? to_f32(B[bk * p.ldb + bc]) : 0.f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int e = tid + l * kThreads;
      As[buf][e % kBK][e / kBK] = p.alpha * ra[l];
      Bs[buf][e / kBN][e % kBN] = rb[l];
    }
  };

  fetch(0);
  stage(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < p.k; k0 += kBK) {
    const bool more = k0 + kBK < p.k;
    if (more) fetch(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // The other stage was last read before the previous barrier, so it
    // can be overwritten now; one barrier a slice covers both hazards.
    if (more) stage(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  TOut* O = static_cast<TOut*>(p.out);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (rows[i] < p.m && cols[j] < p.n)
        O[rows[i] * p.ldo + cols[j]] = from_f32<TOut>(acc[i][j]);
}

template <typename TIn, typename TOut>
inline cudaError_t launch_gemm_t(const GemmArgs& p, cudaStream_t s) {
  const dim3 grid((p.n + kBN - 1) / kBN, (p.m + kBM - 1) / kBM);
  gemm_kernel<TIn, TOut><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

// Operands A, B (and C) share in_dtype; the output is in_dtype or f32.
inline cudaError_t launch_gemm(const GemmArgs& p, int in_dtype, int out_dtype, cudaStream_t s) {
  if (p.m == 0 || p.n == 0) return cudaSuccess;
  if (out_dtype == kF32) {
    switch (in_dtype) {
      case kF32: return launch_gemm_t<float, float>(p, s);
      case kBF16: return launch_gemm_t<__nv_bfloat16, float>(p, s);
      case kF16: return launch_gemm_t<__half, float>(p, s);
    }
  } else if (out_dtype == in_dtype) {
    switch (in_dtype) {
      case kBF16: return launch_gemm_t<__nv_bfloat16, __nv_bfloat16>(p, s);
      case kF16: return launch_gemm_t<__half, __half>(p, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace repro
