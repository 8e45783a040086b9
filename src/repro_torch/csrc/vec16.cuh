// 16-byte vectors of the port's element types (dtypes.cuh): 16 / sizeof(T)
// elements read from, or rounded and written to, a 16-byte-aligned address
// in one access (to_words16 gives the four 32-bit words to store; store8
// writes 8 / sizeof(T) elements to an 8-byte-aligned address), each element
// converted exactly as to_f32 / from_f32 do.

#pragma once

#include "dtypes.cuh"

namespace {

// The 16 bytes at p (16-byte aligned) as 16 / sizeof(T) f32 values.
__device__ __forceinline__ void load16(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ float2 to_f32x2(__half2 h) {
  return __half22float2(h);
}
__device__ __forceinline__ float2 to_f32x2(__nv_bfloat162 h) {
  return __bfloat1622float2(h);
}
template <typename H2, typename H>
__device__ __forceinline__ void load16_half(const H* p, float (&o)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = to_f32x2(*reinterpret_cast<const H2*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const __half* p, float (&o)[8]) {
  load16_half<__half2>(p, o);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&o)[8]) {
  load16_half<__nv_bfloat162>(p, o);
}

// 16 / sizeof(T) f32 values rounded to T, as the four 32-bit words of
// their 16 bytes (the first value in the low half of word 0).
__device__ __forceinline__ void words16(const float (&v)[4],
                                        unsigned (&w)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(v[i]);
}
__device__ __forceinline__ unsigned pack_pair(__half a, __half b) {
  return (unsigned)__half_as_ushort(a) |
         ((unsigned)__half_as_ushort(b) << 16);
}
__device__ __forceinline__ unsigned pack_pair(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  return (unsigned)__bfloat16_as_ushort(a) |
         ((unsigned)__bfloat16_as_ushort(b) << 16);
}
template <typename T>
__device__ __forceinline__ void words16(const float (&v)[8],
                                        unsigned (&w)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = pack_pair(from_f32<T>(v[2 * i]), from_f32<T>(v[2 * i + 1]));
  }
}

template <typename T>
__device__ __forceinline__ void to_words16(const float (&v)[16 / sizeof(T)],
                                           unsigned (&w)[4]) {
  if constexpr (sizeof(T) == 4) {
    words16(v, w);
  } else {
    words16<T>(v, w);
  }
}

// 8 / sizeof(T) f32 values rounded to T and written as 8 bytes at p
// (8-byte aligned).
__device__ __forceinline__ void store8(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_pair(from_f32<T>(v[0]), from_f32<T>(v[1])),
                 pack_pair(from_f32<T>(v[2]), from_f32<T>(v[3])));
}

}  // namespace
