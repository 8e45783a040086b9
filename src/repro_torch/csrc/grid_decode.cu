// On-device cartesian-grid decode for the staged sweep (Hopper, sm_90a).
//
// Replaces the TPU kernel repro/kernels/grid_decode.py::_decode_kernel
// (the pl.pallas_call of grid_decode, repro/kernels/grid_decode.py:121).
// Flat stream indices [start, start + chunk) decode into the (n_axes,
// chunk) f32 axis-value matrix and the (chunk,) int32 variant ids:
// variant-major, C order within a variant, the tail clamped to
// total - 1.  The index arithmetic is decode_index of grid_decode.cuh.
//
// One thread per index.  What bounds it on the card: the bytes written,
// 4 * (n_axes + 1) per index (44 B at the registry's 10 axes); the axis
// table is a few KB read through the cache, and the integer divisions
// per axis are the only arithmetic.  The TPU kernel's one-hot matmul
// gather is not needed: a thread reads its table entry directly.
//
// Plain C interface (repro_grid_decode) for ctypes; the Python wrapper is
// repro_torch/kernels/grid_decode.py::grid_decode.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_decode.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAxes = 16;

struct DecodeParams {
  long long start, total, n_var, chunk;
  long long shape[kMaxAxes];
  long long stride[kMaxAxes];
  int n_axes, lmax, table_cols;
};

template <typename IdxT>
__global__ void __launch_bounds__(kThreads)
grid_decode_kernel(const float* __restrict__ table2,
                   const __grid_constant__ DecodeParams p,
                   float* __restrict__ vals, int* __restrict__ vid) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.chunk) return;
  const IdxT o = (IdxT)p.start + (IdxT)i;
  vid[i] = decode_index<IdxT>(o, (IdxT)p.total, (IdxT)p.n_var, p.n_axes,
                              p.shape, p.stride, table2, p.table_cols,
                              p.lmax, vals + i, p.chunk);
}

}  // namespace

extern "C" {

// kMaxAxes, checked by the wrapper before the first launch.
int repro_grid_decode_max_axes() { return kMaxAxes; }

// Decode [start, start + chunk) on `stream`; returns the cudaError_t of
// the launch (0 on success).  `shape` and `stride` are host arrays of
// n_axes entries; table2, vals and vid are device pointers.
int repro_grid_decode(const float* table2, long long start, long long total,
                      long long n_var, long long chunk, const long long* shape,
                      const long long* stride, int n_axes, int lmax,
                      int table_cols, int idx64, float* vals, int* vid,
                      void* stream) {
  if (n_axes > kMaxAxes || chunk <= 0) return (int)cudaErrorInvalidValue;
  DecodeParams p;
  p.start = start;
  p.total = total;
  p.n_var = n_var;
  p.chunk = chunk;
  for (int a = 0; a < kMaxAxes; ++a) {
    p.shape[a] = a < n_axes ? shape[a] : 1;
    p.stride[a] = a < n_axes ? stride[a] : 1;
  }
  p.n_axes = n_axes;
  p.lmax = lmax;
  p.table_cols = table_cols;
  const unsigned nb = (unsigned)((chunk + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (idx64) {
    grid_decode_kernel<long long><<<nb, kThreads, 0, s>>>(table2, p, vals, vid);
  } else {
    grid_decode_kernel<int><<<nb, kThreads, 0, s>>>(table2, p, vals, vid);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
