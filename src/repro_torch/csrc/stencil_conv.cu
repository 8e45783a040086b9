// Stencil convolution for the functional simulator (Hopper, sm_90a):
// 'valid' 2-D correlation of an [h, w] frame (f32, f16 or bf16) with a
// kh x kw f32 stencil, out[r, c] = sum_{di, dj} k[di, dj] * x[r + di,
// c + dj] summed in f32, giving [h - kh + 1, w - kw + 1] in the frame's
// dtype (rounded once, to nearest even).  The reference's Pallas kernel
// casts taps and pixels to f32 the same way; the wrapper hands the taps
// over as f32 (an exact conversion from f16 or bf16).
//
// Replaces the TPU kernel repro/kernels/stencil_conv.py::_stencil_kernel
// (the pl.pallas_call of stencil_conv, :54).  The TPU kernel keeps the
// whole frame resident in VMEM and pads the rows so every output strip
// is full; neither is carried over.
//
// What bounds it on the card: the bytes moved, sizeof(T) * (h * w + oh *
// ow) for a 3 x 3 stencil (7.36 MB, 2.2 us at 3.35 TB/s, for a 720 x 1280
// f32 frame; 2 * kh * kw operations per output, 18 for 3 x 3, stay far
// below the FP32 rate).  So the design cuts the instructions and the
// shared-memory traffic per byte and fills the card with blocks:
//
// * A block of 128 threads makes one output tile.  It stages the tile's
//   (tile_h + kh - 1) rows of inputs in shared memory in the frame's
//   dtype, warps over rows and lanes over columns (no integer division):
//   with 16-byte cp.async copies that zero-fill past the frame's right and
//   bottom edges where the frame is 16-byte aligned (its base and its row
//   pitch), with element loads where it is not.  Outputs past the edges
//   are computed from those zeros and not written.
// * The wrapper's plan (stencil_conv.py::plan) sizes the tile from the
//   shape: rows a thread from 8 down to 1 until there are three blocks an
//   SM (a 360 x 640 frame has a quarter of a 720 x 1280 frame's outputs).
//   One tile a block: the blocks of a frame are co-resident, so one
//   block's copies overlap another's sums.
// * Three routes, each its own kernel:
//   - k3x3 (stencil_fixed_kernel<T, 3, 3>, the Sobel pair of Fig. 5 and
//     Rhythmic): 16 x 8 threads, each making V = 16 / sizeof(T) adjacent
//     columns (4 in f32, 8 in f16/bf16) of `rows` consecutive rows.  The
//     taps are read once into registers.  A window of 3 staged rows slides
//     down the strip in registers: each new row is two 16-byte shared
//     loads, read once per thread and row, converted to f32 there, and
//     serves 3 taps of V outputs.  Outputs leave with the widest store
//     their address allows (16, 8 or 4 bytes).
//   - generic (stencil_generic_kernel<T, true>, any other stencil whose
//     staged tile fits in 227 KB): 32 x 4 threads, each making up to 8 /
//     sizeof(T) columns 32 apart (conflict-free shared loads, coalesced
//     stores) of `rows` rows; taps read through the read-only cache.
//   - scalar (stencil_generic_kernel<T, false>): the generic kernel staged
//     with element loads, for frames whose base or row pitch is not 16-byte
//     aligned (an offset view of a contiguous buffer).
//
// Arithmetic order: each output sums its taps from 0 in di-outer,
// dj-inner order, one multiply and one add per tap; the build's
// --fmad=false keeps them separate, as the plain-torch twin
// (repro_torch/kernels/stencil_conv.py::stencil_conv_torch with
// acc_dtype=float32) and the reference's stencil_conv_ref compute them,
// so every route and the twin agree bit for bit.
//
// Plain C interface (repro_stencil_conv) for ctypes; the Python wrapper
// is repro_torch/kernels/stencil_conv.py::stencil_conv.

#include <cuda_runtime.h>

#include <cstdint>

#include "dtypes.cuh"
#include "vec16.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kFixedX = 16;                    // k3x3: threads across columns
constexpr int kFixedY = kThreads / kFixedX;    // 8
constexpr int kGenericX = 32;                  // generic: a warp per row
constexpr int kGenericY = kThreads / kGenericX;  // 4
constexpr size_t kMaxSmem = 232448;            // 227 KB, the opt-in ceiling

enum Route { kRoute3x3 = 0, kRouteGeneric = 1, kRouteScalar = 2 };

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;      // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// Rows [r0, r0 + sh) x columns [c0, c0 + sw) of the [h, w] frame into s
// (row pitch sw), zeros past the frame's edges; then a block barrier.
// ASYNC: 16-byte cp.async copies (the frame's base, w, c0 and sw multiples
// of 16 bytes, so a vector lies wholly inside the frame or wholly past its
// right edge); else element loads.
template <typename T, bool ASYNC>
__device__ __forceinline__ void stage(T* s, const T* __restrict__ x, int h,
                                      int w, int r0, int c0, int sh,
                                      int sw) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if constexpr (ASYNC) {
    constexpr int V = 16 / sizeof(T);
    for (int r = warp; r < sh; r += kWarps) {
      const int gr = r0 + r;
      for (int j = lane * V; j < sw; j += 32 * V) {
        const bool valid = gr < h && c0 + j < w;
        cp_async16(s + r * sw + j,
                   valid ? x + (long long)gr * w + c0 + j : x, valid);
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                     : "memory");
  } else {
    const T zero = from_f32<T>(0.f);
    for (int r = warp; r < sh; r += kWarps) {
      const int gr = r0 + r;
      for (int c = lane; c < sw; c += 32) {
        const int gc = c0 + c;
        s[r * sw + c] = (gr < h && gc < w) ? x[(long long)gr * w + gc] : zero;
      }
    }
  }
  __syncthreads();
}

// V f32 outputs rounded to T at p, of which the first n lie inside the
// row: the widest store the address allows when all V do.
template <typename T>
__device__ __forceinline__ void store_strip(T* p,
                                            const float (&v)[16 / sizeof(T)],
                                            int n) {
  constexpr int V = 16 / sizeof(T);
  if (n >= V) {
    const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p));
    unsigned wd[4];
    to_words16<T>(v, wd);
    if (a % 16 == 0) {
      *reinterpret_cast<uint4*>(p) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      return;
    }
    if (a % 8 == 0) {
      uint2* q = reinterpret_cast<uint2*>(p);
      q[0] = make_uint2(wd[0], wd[1]);
      q[1] = make_uint2(wd[2], wd[3]);
      return;
    }
    if (a % 4 == 0) {
      unsigned* q = reinterpret_cast<unsigned*>(p);
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = wd[i];
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (i < n) p[i] = from_f32<T>(v[i]);
  }
}

// Shared-memory columns of a k3x3 tile: its 16 V columns and one vector
// more (a thread reads two vectors from its first column).
template <typename T>
__host__ __device__ constexpr int fixed_width() {
  return (kFixedX + 1) * (16 / sizeof(T));
}

// The k3x3 route (KH x KW fixed at compile time; KW - 1 <= V).
template <typename T, int KH, int KW>
__global__ void __launch_bounds__(kThreads)
stencil_fixed_kernel(const T* __restrict__ x, const float* __restrict__ k,
                     T* __restrict__ out, int h, int w, int oh, int ow,
                     int rows) {
  constexpr int V = 16 / sizeof(T);
  constexpr int SW = fixed_width<T>();
  static_assert(KW - 1 <= V, "a row of the window is two vectors");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int tile_h = kFixedY * rows;
  const int r0 = blockIdx.y * tile_h;
  const int c0 = blockIdx.x * (kFixedX * V);
  float taps[KH * KW];
#pragma unroll
  for (int i = 0; i < KH * KW; ++i) taps[i] = __ldg(k + i);
  stage<T, true>(s, x, h, w, r0, c0, tile_h + KH - 1, SW);

  const int tx = threadIdx.x % kFixedX;
  const int lr = (threadIdx.x / kFixedX) * rows;  // first local output row
  const int col = c0 + tx * V;
  const int n = ow - col;                         // strip columns inside
  if (n <= 0) return;
  const T* src = s + lr * SW + tx * V;
  float win[KH][2][V];                            // KH rows of 2V inputs
#pragma unroll
  for (int i = 0; i < KH - 1; ++i) {
    load16(src + i * SW, win[i][0]);
    load16(src + i * SW + V, win[i][1]);
  }
  for (int r = 0; r < rows; ++r) {
    const int orow = r0 + lr + r;
    if (orow >= oh) break;
    load16(src + (r + KH - 1) * SW, win[KH - 1][0]);
    load16(src + (r + KH - 1) * SW + V, win[KH - 1][1]);
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      acc[v] = 0.f;
#pragma unroll
      for (int di = 0; di < KH; ++di) {
#pragma unroll
        for (int dj = 0; dj < KW; ++dj) {
          acc[v] = acc[v] +
                   taps[di * KW + dj] * win[di][(v + dj) / V][(v + dj) % V];
        }
      }
    }
    store_strip<T>(out + (long long)orow * ow + col, acc, n);
#pragma unroll
    for (int i = 0; i < KH - 1; ++i) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        win[i][0][e] = win[i + 1][0][e];
        win[i][1][e] = win[i + 1][1][e];
      }
    }
  }
}

// The generic and scalar routes: each thread makes nv <= 8 / sizeof(T)
// columns, 32 apart, of `rows` rows.
template <typename T, bool ASYNC>
__global__ void __launch_bounds__(kThreads)
stencil_generic_kernel(const T* __restrict__ x, const float* __restrict__ k,
                       T* __restrict__ out, int h, int w, int kh, int kw,
                       int oh, int ow, int rows, int nv, int sw) {
  constexpr int NV = 8 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int tile_h = kGenericY * rows;
  const int r0 = blockIdx.y * tile_h;
  const int c0 = blockIdx.x * (kGenericX * nv);
  stage<T, ASYNC>(s, x, h, w, r0, c0, tile_h + kh - 1, sw);

  const int tx = threadIdx.x % kGenericX;
  const int lr = (threadIdx.x / kGenericX) * rows;
  for (int r = 0; r < rows; ++r) {
    const int orow = r0 + lr + r;
    if (orow >= oh) break;
    float acc[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[v] = 0.f;
    for (int di = 0; di < kh; ++di) {
      const T* srow = s + (lr + r + di) * sw + tx;
      const float* krow = k + di * kw;
      for (int dj = 0; dj < kw; ++dj) {
        const float t = __ldg(krow + dj);
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          if (v < nv) acc[v] = acc[v] + t * to_f32(srow[dj + v * kGenericX]);
        }
      }
    }
    T* dst = out + (long long)orow * ow;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = c0 + tx + v * kGenericX;
      if (v < nv && c < ow) dst[c] = from_f32<T>(acc[v]);
    }
  }
}

// Shared-memory columns of a generic or scalar tile of nv * 32 columns:
// the tile's inputs rounded up to whole 16-byte vectors.
int generic_width(int nv, int kw, int size) {
  const int v = 16 / size;
  return (kGenericX * nv + kw - 1 + v - 1) / v * v;
}

// The shared-memory bytes one block stages; the wrapper's plan computes
// the same (stencil_conv.py::_smem_bytes).
size_t smem_bytes(int route, int kh, int kw, int rows, int nv, int size) {
  if (route == kRoute3x3) {
    return (size_t)(kFixedY * rows + 2) * (kFixedX + 1) * 16;
  }
  return (size_t)(kGenericY * rows + kh - 1) * generic_width(nv, kw, size) *
         size;
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
int launch(const void* x, const float* k, void* out, int h, int w, int kh,
           int kw, int route, int rows, int nv, size_t smem,
           cudaStream_t s) {
  const int oh = h - kh + 1;
  const int ow = w - kw + 1;
  const int tile_h = (route == kRoute3x3 ? kFixedY : kGenericY) * rows;
  const int tile_w = route == kRoute3x3 ? kFixedX * (16 / (int)sizeof(T))
                                        : kGenericX * nv;
  const dim3 grid((unsigned)((ow + tile_w - 1) / tile_w),
                  (unsigned)((oh + tile_h - 1) / tile_h));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (route == kRoute3x3) {
    auto kern = stencil_fixed_kernel<T, 3, 3>;
    if ((err = opt_in(kern, smem)) != cudaSuccess) return (int)err;
    kern<<<grid, kThreads, smem, s>>>((const T*)x, k, (T*)out, h, w, oh, ow,
                                      rows);
  } else {
    auto kern = route == kRouteGeneric ? stencil_generic_kernel<T, true>
                                       : stencil_generic_kernel<T, false>;
    if ((err = opt_in(kern, smem)) != cudaSuccess) return (int)err;
    kern<<<grid, kThreads, smem, s>>>((const T*)x, k, (T*)out, h, w, kh, kw,
                                      oh, ow, rows, nv,
                                      generic_width(nv, kw, sizeof(T)));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[(h - kh + 1), (w - kw + 1)] = the 'valid' correlation of the
// contiguous [h, w] frame x with the contiguous f32 [kh, kw] stencil k;
// x and out are device pointers of one dtype: 0 float32, 1 float16,
// 2 bfloat16.  route 0 (k3x3), 1 (generic) or 2 (scalar), `rows` output
// rows a thread and `nv` columns a thread (generic and scalar), as the
// wrapper's plan chose them; the k3x3 and generic routes need a 16-byte-
// aligned frame base and row pitch.  Returns the cudaError_t of the
// launch (0 on success); a plan the kernels do not take is refused.
int repro_stencil_conv(const void* x, const float* k, void* out, int dtype,
                       int h, int w, int kh, int kw, int route, int rows,
                       int nv, void* stream) {
  const int size = dtype == 0 ? 4 : 2;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       ((long long)w * size) % 16 == 0;
  if (kh < 1 || kw < 1 || h - kh + 1 < 1 || w - kw + 1 < 1 || dtype < 0 ||
      dtype > 2 || route < 0 || route > 2 || rows < 1 || rows > 64 ||
      (route == kRoute3x3 && (kh != 3 || kw != 3)) ||
      (route != kRouteScalar && !aligned) ||
      (route != kRoute3x3 && (nv < 1 || nv > 8 / size))) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(route, kh, kw, rows, nv, size);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch<float>(x, k, out, h, w, kh, kw, route, rows, nv, smem, s);
  }
  if (dtype == 1) {
    return launch<__half>(x, k, out, h, w, kh, kw, route, rows, nv, smem, s);
  }
  return launch<__nv_bfloat16>(x, k, out, h, w, kh, kw, route, rows, nv,
                               smem, s);
}

}  // extern "C"
