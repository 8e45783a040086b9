// Pixel binning for the functional simulator (Hopper, sm_90a):
// factor x factor average pooling with stride factor over a 2-D frame,
// f32, f16 or bf16 in, the same dtype out, f32 accumulation (the result
// rounded once, to nearest even, as torch's .to() rounds).
//
// Replaces the TPU kernel repro/kernels/binning.py::_binning_kernel (the
// pl.pallas_call of binning, :45), which reduces row strips on the VPU.
// Odd edges are cropped, as the reference crops them: the kernel reads
// only the first oh * factor rows and ow * factor columns of the [h, w]
// frame (row stride w), so no cropped copy is made.
//
// Arithmetic order: each output sums its window row by row (di outer, dj
// inner) from 0 and then multiplies by f32(1 / factor^2), passed in by
// the wrapper.  That is the reference's result bit for bit, and the
// plain-torch twin (repro_torch/kernels/binning.py::binning_torch) keeps
// the same order; a division by factor^2 differs at factor 3 by 6e-8.
//
// One thread per output pixel; a warp's 32 neighbouring outputs read
// 32 * factor neighbouring inputs of each window row.  What bounds it on
// the card: the bytes moved, (oh * ow) * (factor^2 + 1) elements; the
// arithmetic is factor^2 adds and one multiply per output.  The common
// factor 2 is compiled with its loops unrolled; any other factor runs the
// same loops with a run-time trip count.
//
// Plain C interface (repro_binning) for ctypes; the Python wrapper is
// repro_torch/kernels/binning.py::binning.

#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;

// F > 0 fixes the factor at compile time; F == 0 reads it from `factor`.
template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
binning_kernel(const T* __restrict__ x, T* __restrict__ out, long long w,
               int oh, int ow, int factor, float inv) {
  const int f = F > 0 ? F : factor;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)oh * ow) return;
  const long long r = i / ow;
  const long long c = i - r * ow;
  const T* base = x + r * f * w + c * f;
  float acc = 0.f;
#pragma unroll
  for (int di = 0; di < f; ++di) {
    const T* row = base + di * w;
#pragma unroll
    for (int dj = 0; dj < f; ++dj) acc = acc + to_f32(row[dj]);
  }
  out[i] = from_f32<T>(acc * inv);
}

template <typename T>
void launch(const void* x, void* out, long long w, int oh, int ow,
            int factor, float inv, cudaStream_t s) {
  const long long n = (long long)oh * ow;
  const unsigned nb = (unsigned)((n + kThreads - 1) / kThreads);
  if (factor == 2) {
    binning_kernel<T, 2><<<nb, kThreads, 0, s>>>(
        (const T*)x, (T*)out, w, oh, ow, factor, inv);
  } else {
    binning_kernel<T, 0><<<nb, kThreads, 0, s>>>(
        (const T*)x, (T*)out, w, oh, ow, factor, inv);
  }
}

}  // namespace

extern "C" {

// out[oh, ow] = the factor x factor window means of x (a contiguous
// [h, w] device frame with h >= oh * factor, w >= ow * factor), both of
// one dtype: 0 float32, 1 float16, 2 bfloat16; inv is f32(1 / factor^2).
// Returns the cudaError_t of the launch (0 on success).
int repro_binning(const void* x, void* out, int dtype, long long w, int oh,
                  int ow, int factor, float inv, void* stream) {
  if (oh <= 0 || ow <= 0 || factor < 1 || w < (long long)ow * factor ||
      dtype < 0 || dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    launch<float>(x, out, w, oh, ow, factor, inv, s);
  } else if (dtype == 1) {
    launch<__half>(x, out, w, oh, ow, factor, inv, s);
  } else {
    launch<__nv_bfloat16>(x, out, w, oh, ow, factor, inv, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
