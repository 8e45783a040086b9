// Per-category energy accumulation of the per-plan evaluator (Hopper,
// sm_90a): [B, U] @ [U, C] -> [B, C] in f32.
//
// Replaces the TPU kernel repro/kernels/category_reduce.py::_reduce_kernel
// (the pl.pallas_call of category_reduce, :46), which runs the unit ->
// category segment sum as a small matmul on the MXU.
//
// Each output row is out[c] = sum over u = 0 .. U-1, in order, of
// e[u] * w[u][c], the order of the plain-torch twin
// (repro_torch/kernels/category_reduce.py::category_reduce_torch); built
// with --fmad=false (a multiply, then an add), kernel and twin agree bit
// for bit.  U and C are small on the main paths (U = 6-11 units, C = 10
// columns: 8 categories, the total and the on-sensor total), far from a
// tensor-core shape, so a matrix unit buys nothing here.
//
// What bounds it on the card: the bytes moved, 4 * (U + C) per row
// (84 B at U = 11, C = 10: 22 MB, 6.6 us for a 2^18-row chunk at
// 3.35 TB/s); the arithmetic is 2 * U * C operations per row.  So the
// design is about the memory accesses:
//   * a block of 256 threads owns 256 rows.  Its [256, U] slice of e is
//     one contiguous span, which the block copies into shared memory with
//     coalesced 16-byte loads (scalar loads for the unaligned head and
//     tail of the span); with U odd (11 on the main paths) each thread
//     then reads its row at a stride of U words, which falls in 32
//     different banks.  Even U, or U past 32 (staged 32 units at a time),
//     pads the staged rows to an odd stride instead;
//   * the weights sit in shared memory and are read as broadcasts;
//   * each thread keeps its C sums in registers: the kernel is
//     instantiated for a few column capacities (8, 10, 16, 32) and
//     unrolled over them with a c < C predicate, so no sum lives in local
//     memory;
//   * the [256, C] results are staged in shared memory and stored as one
//     contiguous, coalesced span.
//
// Plain C interface (repro_category_reduce) for ctypes; the Python
// wrapper is repro_torch/kernels/category_reduce.py::category_reduce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // rows a block, one thread each
constexpr int kMaxCols = 32;
constexpr int kUnitChunk = 32;     // units staged at a time

// floats of dynamic shared memory: the weights, then one tile that holds
// the staged e rows and later the staged results
size_t smem_floats(int u_n, int c_n) {
  const int uc = u_n < kUnitChunk ? u_n : kUnitChunk;
  const int ld_e = uc | 1;
  const int tile = ld_e > c_n ? ld_e : c_n;
  return (size_t)u_n * c_n + (size_t)kThreads * tile;
}

// The block's rows [row0, row0 + rows), units [u0, u0 + uc), into s_e at
// row stride ld.  One chunk of an odd U is the contiguous span of e copied
// as it lies (ld = U); otherwise each element is placed by row and unit.
__device__ __forceinline__ void stage_rows(const float* __restrict__ e,
                                           float* s_e, long long row0,
                                           int rows, int u_n, int u0, int uc,
                                           int ld) {
  const int t = threadIdx.x;
  if (uc == u_n && ld == u_n) {
    const float* src = e + row0 * u_n;
    const int n = rows * u_n;
    // floats before the first 16-byte boundary of the span
    int head = (int)(((16u - ((uintptr_t)src & 15u)) & 15u) >> 2);
    if (head > n) head = n;
    for (int i = t; i < head; i += kThreads) s_e[i] = src[i];
    const int n4 = (n - head) >> 2;
    const float4* src4 = reinterpret_cast<const float4*>(src + head);
    if (head == 0) {
      float4* dst4 = reinterpret_cast<float4*>(s_e);
      for (int i = t; i < n4; i += kThreads) dst4[i] = __ldg(src4 + i);
    } else {
      for (int i = t; i < n4; i += kThreads) {
        const float4 x = __ldg(src4 + i);
        float* d = s_e + head + 4 * i;
        d[0] = x.x;
        d[1] = x.y;
        d[2] = x.z;
        d[3] = x.w;
      }
    }
    for (int i = head + 4 * n4 + t; i < n; i += kThreads) s_e[i] = src[i];
    return;
  }
  for (int i = t; i < rows * uc; i += kThreads) {
    const int r = i / uc;
    const int j = i - r * uc;
    s_e[r * ld + j] = e[(row0 + r) * u_n + u0 + j];
  }
}

template <int CMAX>
__global__ void __launch_bounds__(kThreads)
category_reduce_kernel(const float* __restrict__ e,
                       const float* __restrict__ w, long long b, int u_n,
                       int c_n, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;
  float* s_t = smem + ((u_n * c_n + 3) & ~3);   // 16-byte aligned tile
  for (int i = threadIdx.x; i < u_n * c_n; i += kThreads) s_w[i] = w[i];
  const long long row0 = (long long)blockIdx.x * kThreads;
  const int rows = (int)min((long long)kThreads, b - row0);
  const int t = threadIdx.x;

  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.f;
  for (int u0 = 0; u0 < u_n; u0 += kUnitChunk) {
    const int uc = min(kUnitChunk, u_n - u0);
    const int ld = (uc == u_n && (u_n & 1)) ? u_n : (uc | 1);
    __syncthreads();                 // the weights, or the last chunk used
    stage_rows(e, s_t, row0, rows, u_n, u0, uc, ld);
    __syncthreads();
    if (t < rows) {
      const float* er = s_t + t * ld;
      for (int j = 0; j < uc; ++j) {
        const float x = er[j];
        const float* wu = s_w + (u0 + j) * c_n;
#pragma unroll
        for (int c = 0; c < CMAX; ++c) {
          if (c < c_n) acc[c] = acc[c] + x * wu[c];
        }
      }
    }
  }

  // the block's results as one contiguous [rows, c_n] span
  __syncthreads();
  if (t < rows) {
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < c_n) s_t[t * c_n + c] = acc[c];
    }
  }
  __syncthreads();
  float* dst = out + row0 * c_n;
  for (int i = t; i < rows * c_n; i += kThreads) dst[i] = s_t[i];
}

template <int CMAX>
int launch(const float* e, const float* w, long long b, int u_n, int c_n,
           float* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (smem_floats(u_n, c_n) + 3);
  auto kernel = category_reduce_kernel<CMAX>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned nb = (unsigned)((b + kThreads - 1) / kThreads);
  kernel<<<nb, kThreads, smem, stream>>>(e, w, b, u_n, c_n, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// kMaxCols, checked by the wrapper before the first launch.
int repro_category_reduce_max_cols() { return kMaxCols; }

// out[b, c_n] = e[b, u_n] @ w[u_n, c_n], all row-major device pointers;
// returns the cudaError_t of the launch (0 on success).
int repro_category_reduce(const float* e, const float* w, long long b,
                          int u_n, int c_n, float* out, void* stream) {
  if (b <= 0 || u_n <= 0 || c_n <= 0 || c_n > kMaxCols ||
      (b + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (c_n <= 8) return launch<8>(e, w, b, u_n, c_n, out, s);
  if (c_n <= 10) return launch<10>(e, w, b, u_n, c_n, out, s);
  if (c_n <= 16) return launch<16>(e, w, b, u_n, c_n, out, s);
  return launch<kMaxCols>(e, w, b, u_n, c_n, out, s);
}

}  // extern "C"
