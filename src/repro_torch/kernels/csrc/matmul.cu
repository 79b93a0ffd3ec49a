// C entry point of the tiled GEMM (gemm_tile.cuh), bound from Python with
// ctypes. It serves two kernels of the port:
//   * matmul, which replaces `matmul_pallas`
//     (src/repro/kernels/matmul/kernel.py): c == nullptr, out = A @ B;
//   * schur_update, which replaces `schur_update_pallas` (same file):
//     out = beta * C + alpha * (A @ B), with the C tile seeding the f32
//     accumulator, so the product never goes to device memory.
// What bounds them on the card and how the design meets it is noted in
// gemm_tile.cuh. The launch returns cudaGetLastError(), which the Python
// wrapper checks.
#include "gemm_tile.cuh"

extern "C" int repro_gemm(const void* a, const void* b, const void* c,
                          void* out, int m, int n, int k, long long lda,
                          long long ldb, long long ldc, long long ldo,
                          long long sa, long long sb, long long sc,
                          long long so, int batch, float alpha, float beta,
                          int in_dtype, int out_dtype, void* stream) {
  repro::GemmArgs p{a, b, c, out, m, n, k, lda, ldb, ldc, ldo,
                    sa, sb, sc, so, alpha, beta};
  return static_cast<int>(repro::launch_gemm(
      p, batch, in_dtype, out_dtype, static_cast<cudaStream_t>(stream)));
}
