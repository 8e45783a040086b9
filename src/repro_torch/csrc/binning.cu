// Pixel binning for the functional simulator (Hopper, sm_90a):
// factor x factor average pooling with stride factor over a 2-D frame,
// f32, f16 or bf16 in, the same dtype out, f32 accumulation (the result
// rounded once, to nearest even, as torch's .to() rounds).
//
// Replaces the TPU kernel repro/kernels/binning.py::_binning_kernel (the
// pl.pallas_call of binning, :45), which reduces row strips on the VPU.
// Odd edges are cropped, as the reference crops them: the kernels read
// only the first oh * factor rows and ow * factor columns of the [h, w]
// frame (row stride w), so no cropped copy is made.
//
// Arithmetic order: each output sums its window row by row (di outer, dj
// inner) from 0 and then multiplies by f32(1 / factor^2), passed in by
// the wrapper.  That is the reference's result bit for bit, and the
// plain-torch twin (repro_torch/kernels/binning.py::binning_torch) keeps
// the same order; a division by factor^2 differs at factor 3 by 6e-8.
//
// What bounds it on the card: the bytes moved, (oh * ow) * (factor^2 + 1)
// elements (1.84 MB for a 720 x 1280 f32 frame at factor 2, 0.55 us at
// 3.35 TB/s); the arithmetic is factor^2 adds and one multiply per output.
// Two kernels, picked by the wrapper's plan (binning.py::plan):
//
// * vec2 (factor 2, the functional path's): each thread makes V = 8 /
//   sizeof(T) adjacent outputs (2 in f32, 4 in f16/bf16) from one 16-byte
//   load of each of its two input rows, and writes them with one 8-byte
//   store: a warp's loads are 512 contiguous bytes of a row, its stores
//   256.  It needs a 16-byte-aligned frame whose row pitch w * sizeof(T)
//   is a multiple of 16 (then the output's, a fresh allocation, is one of
//   8);
// * scalar (every other case): one thread per output pixel; a warp's 32
//   neighbouring outputs read 32 * factor neighbouring inputs of each
//   window row.  Factor 2 is compiled with its loops unrolled; any other
//   factor runs the same loops with a run-time trip count.
//
// Plain C interface (repro_binning) for ctypes; the Python wrapper is
// repro_torch/kernels/binning.py::binning.  Two entries measure the launch
// path for chip_smoke.py: repro_binning_noop does nothing (a ctypes call
// alone), repro_binning_launch_us launches an empty kernel n times and
// returns the host microseconds a launch takes (the CUDA runtime alone).

#include <cuda_runtime.h>

#include <chrono>

#include "dtypes.cuh"
#include "vec16.cuh"

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

// Factor 2, V adjacent outputs a thread: groups = oh * ow / V of them,
// groups_per_row = ow / V.
template <typename T>
__global__ void __launch_bounds__(kThreads)
binning2_vec_kernel(const T* __restrict__ x, T* __restrict__ out,
                    long long w, unsigned groups_per_row, unsigned groups,
                    float inv) {
  constexpr int V = 8 / sizeof(T);
  const unsigned g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= groups) return;
  const unsigned r = g / groups_per_row;
  const unsigned c = (g - r * groups_per_row) * V;
  const T* top = x + (long long)(2 * r) * w + 2 * c;
  float a[2 * V], b[2 * V];               // the 2V inputs of each row
  load16(top, a);
  load16(top + w, b);
  float o[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float acc = 0.f;
    acc = acc + a[2 * v];
    acc = acc + a[2 * v + 1];
    acc = acc + b[2 * v];
    acc = acc + b[2 * v + 1];
    o[v] = acc * inv;
  }
  store8(out + (long long)r * (groups_per_row * V) + c, o);
}

__global__ void empty_kernel() {}

template <typename T>
void launch(const void* x, void* out, long long w, int oh, int ow,
            int factor, float inv, bool vec, cudaStream_t s) {
  if (vec) {
    constexpr int V = 8 / sizeof(T);
    const unsigned groups = (unsigned)((long long)oh * ow / V);
    binning2_vec_kernel<T><<<(groups + kThreads - 1) / kThreads, kThreads, 0,
                             s>>>((const T*)x, (T*)out, w,
                                  (unsigned)(ow / V), groups, inv);
    return;
  }
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
// vec = 1 takes the vec2 kernel, whose conditions (factor 2, 16-byte-
// aligned rows, fewer than 2^32 output groups) are checked here too.
// Returns the cudaError_t of the launch (0 on success).
int repro_binning(const void* x, void* out, int dtype, long long w, int oh,
                  int ow, int factor, float inv, int vec, void* stream) {
  if (oh <= 0 || ow <= 0 || factor < 1 || w < (long long)ow * factor ||
      dtype < 0 || dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec) {
    const int size = dtype == 0 ? 4 : 2;
    const int v = 8 / size;
    if (factor != 2 || ow % v != 0 || (w * size) % 16 != 0 ||
        (reinterpret_cast<unsigned long long>(x) |
         reinterpret_cast<unsigned long long>(out)) % 16 != 0 ||
        (long long)oh * ow / v >= (1LL << 32) - kThreads) {
      return (int)cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    launch<float>(x, out, w, oh, ow, factor, inv, vec != 0, s);
  } else if (dtype == 1) {
    launch<__half>(x, out, w, oh, ow, factor, inv, vec != 0, s);
  } else {
    launch<__nv_bfloat16>(x, out, w, oh, ow, factor, inv, vec != 0, s);
  }
  return (int)cudaGetLastError();
}

int repro_binning_noop() { return 0; }

double repro_binning_launch_us(int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  empty_kernel<<<1, 32, 0, s>>>();
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < n; ++i) empty_kernel<<<1, 32, 0, s>>>();
  const auto t1 = std::chrono::steady_clock::now();
  if (cudaGetLastError() != cudaSuccess || n < 1) return -1.0;
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / n;
}

}  // extern "C"
