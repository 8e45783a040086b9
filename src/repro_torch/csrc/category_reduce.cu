// Per-category energy accumulation of the per-plan evaluator (Hopper,
// sm_90a): [B, U] @ [U, C] -> [B, C] in f32.
//
// Replaces the TPU kernel repro/kernels/category_reduce.py::_reduce_kernel
// (the pl.pallas_call of category_reduce, :46), which runs the unit ->
// category segment sum as a small matmul on the MXU.
//
// One thread per design point (row): the [U, C] weights sit in shared
// memory and each thread accumulates out[c] += e[u] * w[u][c] over
// u = 0 .. U-1 in order, the same order as the plain-torch twin
// (repro_torch/kernels/category_reduce.py::category_reduce_torch); built
// with --fmad=false, kernel and twin agree bit for bit.  U and C are
// small on the main paths (U = 6-11 units, C = 10 columns: 8 categories,
// the total and the on-sensor total), far from a tensor-core shape, so a
// matrix unit buys nothing here.
//
// What bounds it on the card: the bytes moved, 4 * (U + C) per row
// (84 B at U = 11, C = 10); the arithmetic is 2 * U * C operations per
// row.
//
// Plain C interface (repro_category_reduce) for ctypes; the Python
// wrapper is repro_torch/kernels/category_reduce.py::category_reduce.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 32;

__global__ void __launch_bounds__(kThreads)
category_reduce_kernel(const float* __restrict__ e,
                       const float* __restrict__ w, long long b, int u_n,
                       int c_n, float* __restrict__ out) {
  extern __shared__ float s_w[];
  for (int i = threadIdx.x; i < u_n * c_n; i += kThreads) s_w[i] = w[i];
  __syncthreads();
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= b) return;
  float acc[kMaxCols];
  for (int c = 0; c < c_n; ++c) acc[c] = 0.f;
  const float* er = e + row * u_n;
  for (int u = 0; u < u_n; ++u) {
    const float x = er[u];
    const float* wu = s_w + u * c_n;
    for (int c = 0; c < c_n; ++c) acc[c] = acc[c] + x * wu[c];
  }
  float* o = out + row * c_n;
  for (int c = 0; c < c_n; ++c) o[c] = acc[c];
}

}  // namespace

extern "C" {

// kMaxCols, checked by the wrapper before the first launch.
int repro_category_reduce_max_cols() { return kMaxCols; }

// out[b, c_n] = e[b, u_n] @ w[u_n, c_n], all row-major device pointers;
// returns the cudaError_t of the launch (0 on success).
int repro_category_reduce(const float* e, const float* w, long long b,
                          int u_n, int c_n, float* out, void* stream) {
  if (b <= 0 || u_n <= 0 || c_n <= 0 || c_n > kMaxCols) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)u_n * c_n * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        category_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned nb = (unsigned)((b + kThreads - 1) / kThreads);
  category_reduce_kernel<<<nb, kThreads, smem, (cudaStream_t)stream>>>(
      e, w, b, u_n, c_n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
