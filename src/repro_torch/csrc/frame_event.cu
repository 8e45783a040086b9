// Frame differencing + threshold for the functional simulator's Ed-Gaze
// front end (Hopper, sm_90a): out = (|f32(cur) - f32(prev)| >= t), written
// in cur's dtype (f32 or f16), 1 for an event and 0 otherwise.
//
// Replaces the TPU kernel repro/kernels/frame_event.py::_event_kernel (the
// pl.pallas_call of frame_event, :34), which runs the compare over row
// strips on the VPU.
//
// The threshold arrives and stays a C float: the compare is in float32, as
// the reference's is (f32(0.7) - 0 >= 0.7 is an event in f32 and none in
// f64).  A NaN difference compares false and gives 0.
//
// One thread per element.  What bounds it on the card: the bytes moved,
// two inputs read and one output written (12 B per f32 element); there is
// one subtract, one abs and one compare per element.  When the element
// count is a multiple of 4 and the pointers are 16-byte aligned (every
// contiguous f32 frame from the caching allocator), f32 frames go through
// float4 loads and stores, four elements a thread; any other frame takes
// the scalar kernel.
//
// Plain C interface (repro_frame_event) for ctypes; the Python wrapper is
// repro_torch/kernels/frame_event.py::frame_event.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

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

__global__ void __launch_bounds__(kThreads)
frame_event_vec4_kernel(const float4* __restrict__ cur,
                        const float4* __restrict__ prev,
                        float4* __restrict__ out, long long n4, float t) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n4) return;
  const float4 c = cur[i];
  const float4 p = prev[i];
  out[i] = make_float4(event(c.x, p.x, t), event(c.y, p.y, t),
                       event(c.z, p.z, t), event(c.w, p.w, t));
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" {

// out[i] = |cur[i] - prev[i]| >= threshold for i < n, all device pointers
// to n contiguous elements of one dtype: 0 float32, 1 float16.  Returns
// the cudaError_t of the launch (0 on success).
int repro_frame_event(const void* cur, const void* prev, void* out,
                      int dtype, long long n, float threshold,
                      void* stream) {
  if (n <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (n % 4 == 0 && aligned16(cur) && aligned16(prev) && aligned16(out)) {
      frame_event_vec4_kernel<<<blocks_for(n / 4), kThreads, 0, s>>>(
          (const float4*)cur, (const float4*)prev, (float4*)out, n / 4,
          threshold);
    } else {
      frame_event_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
          (const float*)cur, (const float*)prev, (float*)out, n, threshold);
    }
  } else {
    frame_event_kernel<__half><<<blocks_for(n), kThreads, 0, s>>>(
        (const __half*)cur, (const __half*)prev, (__half*)out, n, threshold);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
