// Frame differencing + threshold for the functional simulator's Ed-Gaze
// front end (Hopper, sm_90a): out = (|f32(cur) - f32(prev)| >= t), written
// in cur's dtype (f32, f16 or bf16), 1 for an event and 0 otherwise.
//
// Replaces the TPU kernel repro/kernels/frame_event.py::_event_kernel (the
// pl.pallas_call of frame_event, :34), which runs the compare over row
// strips on the VPU.
//
// The threshold arrives and stays a C float: the compare is in float32, as
// the reference's is (f32(0.7) - 0 >= 0.7 is an event in f32 and none in
// f64).  A NaN difference compares false and gives 0.  Every route
// computes the same compare on the same f32 values.
//
// What bounds it on the card: the bytes moved, two inputs read and one
// output written (12 B an f32 element, 6 B an f16/bf16 one; 0.77 MB for
// Ed-Gaze's 200 x 320 f32 frames, 0.23 us at 3.35 TB/s).  At that size
// the bytes are a fraction of what a launch costs the device: an empty
// kernel's span is ~0.86 us, this kernel's on a frame of one 16-byte
// vector (its launch floor) ~1.0 us and on Ed-Gaze's frame ~1.1 us
// (PERF.md).  So the design keeps each access 16 bytes and adds nothing
// to the launch:
//   * vec4 (f32) and vec8 (f16/bf16): one 16-byte load of each input and
//     one 16-byte store a thread, 4 or 8 elements, where the element
//     count is a multiple of 4 / 8 and the three pointers are 16-byte
//     aligned (every contiguous frame from the caching allocator);
//   * scalar: one element a thread, for ragged and unaligned frames;
//   * blocks of a compile-time 256 threads (63 at Ed-Gaze's f32 frame).
//     Smaller blocks that spread that frame over all 132 SMs measured
//     slower on the card, and so did a block size read at run time.
//
// Plain C interface (repro_frame_event) for ctypes; the Python wrapper is
// repro_torch/kernels/frame_event.py::frame_event.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vec16.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float event(float c, float p, float t) {
  return fabsf(c - p) >= t ? 1.f : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
frame_event_kernel(const T* __restrict__ cur, const T* __restrict__ prev,
                   T* __restrict__ out, long long n, float t) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = from_f32<T>(event(to_f32(cur[i]), to_f32(prev[i]), t));
}

// 16 / sizeof(T) elements a thread: vec4 for f32, vec8 for f16 / bf16.
template <typename T>
__global__ void __launch_bounds__(kThreads)
frame_event_vec_kernel(const T* __restrict__ cur, const T* __restrict__ prev,
                       T* __restrict__ out, long long n_vec, float t) {
  constexpr int kVec = 16 / sizeof(T);
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  float c[kVec], p[kVec], e[kVec];
  load16(cur + i * kVec, c);
  load16(prev + i * kVec, p);
#pragma unroll
  for (int j = 0; j < kVec; ++j) e[j] = event(c[j], p[j], t);
  unsigned w[4];
  to_words16<T>(e, w);
  reinterpret_cast<uint4*>(out)[i] = make_uint4(w[0], w[1], w[2], w[3]);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename T>
int run(const void* cur, const void* prev, void* out, long long n,
        float threshold, int vec, cudaStream_t s) {
  constexpr long long kVec = 16 / sizeof(T);
  const long long units = vec ? n / kVec : n;
  if (vec && (n % kVec || !aligned16(cur) || !aligned16(prev) ||
              !aligned16(out))) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((units + kThreads - 1) / kThreads);
  if (vec) {
    frame_event_vec_kernel<T><<<blocks, kThreads, 0, s>>>(
        (const T*)cur, (const T*)prev, (T*)out, units, threshold);
  } else {
    frame_event_kernel<T><<<blocks, kThreads, 0, s>>>(
        (const T*)cur, (const T*)prev, (T*)out, n, threshold);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[i] = |cur[i] - prev[i]| >= threshold for i < n, all device pointers
// to n contiguous elements of one dtype: 0 float32, 1 float16, 2 bfloat16;
// `vec` 1 takes the 16-byte route (vec4 / vec8), 0 the scalar one.
// Returns the cudaError_t of the launch (0 on success); a 16-byte route on
// a ragged or unaligned frame is refused with cudaErrorInvalidValue before
// anything runs.
int repro_frame_event(const void* cur, const void* prev, void* out,
                      int dtype, long long n, float threshold, int vec,
                      void* stream) {
  if (n <= 0 || dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return run<float>(cur, prev, out, n, threshold, vec, s);
  if (dtype == 1) return run<__half>(cur, prev, out, n, threshold, vec, s);
  return run<__nv_bfloat16>(cur, prev, out, n, threshold, vec, s);
}

}  // extern "C"
