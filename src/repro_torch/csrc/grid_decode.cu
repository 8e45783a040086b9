// On-device cartesian-grid decode for the staged sweep (Hopper, sm_90a).
//
// Replaces the TPU kernel repro/kernels/grid_decode.py::_decode_kernel
// (the pl.pallas_call of grid_decode, repro/kernels/grid_decode.py:121).
// Flat stream indices [start, start + chunk) decode into the (n_axes,
// chunk) f32 axis-value matrix and the (chunk,) int32 variant ids:
// variant-major, C order within a variant, the tail clamped to
// total - 1.  The TPU kernel's one-hot matmul gather is not needed: a
// thread reads its table entries directly.
//
// What bounds it on the card: the bytes written, 4 * (n_axes + 1) per
// index (44 B at the registry's 10 axes, 11.5 MB a 2^18-point chunk); the
// axis table is a few KB read through the cache.  The first port decoded
// every index by runtime division (one by n_var, two per axis: 64-bit
// software routines on the int64 route), so the kernel was issue-bound,
// at 2.3x the time the same bytes take a plain store kernel.  This
// design:
//   * one output row a thread: a thread owns kPoints = 4 consecutive
//     positions of one axis row (blockIdx.y = the axis) or of the
//     variant-id row (blockIdx.y = n_axes), in 26-28 registers.  A thread
//     that owned every row of its positions held ~16 values a position
//     in 117 registers behind guarded, unrolled loops over 16 axes and ran
//     no faster than the runtime divisions (PERF.md's K2 findings);
//   * no runtime division: the thread decodes its first index once, by
//     the exact magic multipliers (fdiv, grid_decode.cuh; 64-bit only on
//     the int64 route): the variant, the offset in the variant, its axis's
//     digit and the offset in that digit's run of `stride` positions;
//   * odometer stepping in 32 bits: what the thread carries from one
//     position to the next is its digit, its variant id and two counts
//     of positions, to the end of the digit's run and to the end of the
//     variant, clamped to the positions left.  A position that ends the
//     run increments the digit (a carry out of the axis wraps it to 0);
//     one that ends the variant increments the variant id and resets the
//     digit.  An axis of size 1 has runs as long as a variant (the
//     wrapper's decode_strides), so it steps nothing.  Past total - 1 a
//     position repeats the last point, as the clamp does;
//   * values from registers: the thread re-reads its row of the
//     (n_axes, V * lmax) table only where its digit or variant changed;
//   * 16-byte stores: one float4 (or int4 of variant ids) a thread, on
//     the vec4 route (chunk % 4 == 0, 16-byte aligned outputs).  Any
//     other chunk takes the scalar route: the same decode, one position a
//     thread.
// Blocks of 256 threads: 256 blocks a row, 2,816 in all, at a 2^18 chunk
// of 10 axes.  The wrapper's plan() picks the route and the grid.
//
// Plain C interface (repro_grid_decode) for ctypes; the Python wrapper is
// repro_torch/kernels/grid_decode.py::grid_decode, which fills
// DecodeParams through its ctypes mirror _Params.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_decode.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAxes = 16;
constexpr int kPoints = 4;   // positions a thread on the vec4 route

}  // namespace

// Mirrored field for field by repro_torch.kernels.grid_decode._Params.
// Per axis a: its decode stride (decode_strides) and size, the exact
// magic multipliers of both for 32-bit and 64-bit dividends and their
// shifts ceil(log2 d).
// var_run and run[a] are n_var and stride[a] capped at 2^30: the counts
// a thread steps down never exceed kPoints, so any cap past it serves.
struct DecodeParams {
  long long start, last, n_var, chunk;   // last = total - 1
  unsigned long long mul64_var, mul64_stride[kMaxAxes];
  unsigned long long mul64_size[kMaxAxes], stride[kMaxAxes];
  unsigned int mul32_var, mul32_stride[kMaxAxes], mul32_size[kMaxAxes];
  int shift_var, shift_stride[kMaxAxes], shift_size[kMaxAxes];
  int size[kMaxAxes], run[kMaxAxes];
  int n_axes, lmax, table_cols, var_run;
};

namespace {

template <typename IdxT> struct Magic;
template <> struct Magic<int> {
  using U = unsigned int;
  static __device__ __forceinline__ U var(const DecodeParams& p) {
    return p.mul32_var;
  }
  static __device__ __forceinline__ U stride(const DecodeParams& p, int a) {
    return p.mul32_stride[a];
  }
  static __device__ __forceinline__ U size(const DecodeParams& p, int a) {
    return p.mul32_size[a];
  }
};
template <> struct Magic<long long> {
  using U = unsigned long long;
  static __device__ __forceinline__ U var(const DecodeParams& p) {
    return p.mul64_var;
  }
  static __device__ __forceinline__ U stride(const DecodeParams& p, int a) {
    return p.mul64_stride[a];
  }
  static __device__ __forceinline__ U size(const DecodeParams& p, int a) {
    return p.mul64_size[a];
  }
};

__device__ __forceinline__ int capped(unsigned long long n) {
  return n < (unsigned long long)kPoints ? (int)n : kPoints;
}

// kP consecutive positions of row blockIdx.y from position i: axis values
// (row < n_axes) or variant ids (row == n_axes), stored as one 16-byte
// vector when kP == 4.
template <typename IdxT, int kP>
__global__ void __launch_bounds__(kThreads)
grid_decode_kernel(const float* __restrict__ tab,
                   const __grid_constant__ DecodeParams p,
                   float* __restrict__ vals, int* __restrict__ vid) {
  using U = typename Magic<IdxT>::U;
  // blockDim.x (== kThreads): with the compile-time constant here the
  // kernel compiled to a schedule that measured slower on the card
  const long long i =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kP;
  if (i >= p.chunk) return;
  const int a = blockIdx.y;
  const IdxT o = (IdxT)p.start + (IdxT)i;
  const IdxT last = (IdxT)p.last;
  // positions of the run at or before total - 1 (the rest repeat it)
  const int live = o > last ? 1 : capped((U)(last - o) + 1);
  const U oc = (U)(o < last ? o : last);
  const U v0 = fdiv(oc, Magic<IdxT>::var(p), p.shift_var);
  const U local = oc - v0 * (U)p.n_var;
  int v = (int)v0;
  int to_var = capped((U)p.n_var - local);     // positions left in variant
  if (a == p.n_axes) {
    int ids[kP];
    ids[0] = v;
#pragma unroll
    for (int j = 1; j < kP; ++j) {
      if (j < live && --to_var == 0) {
        to_var = p.var_run;
        ++v;
      }
      ids[j] = v;
    }
    if constexpr (kP == kPoints) {
      *reinterpret_cast<int4*>(vid + i) =
          make_int4(ids[0], ids[1], ids[2], ids[3]);
    } else {
      vid[i] = ids[0];
    }
    return;
  }
  // the axis's digit, and the positions left in its run
  const U q = fdiv(local, Magic<IdxT>::stride(p, a), p.shift_stride[a]);
  const int size = p.size[a];
  int d = (int)(q - fdiv(q, Magic<IdxT>::size(p, a), p.shift_size[a])
                        * (U)size);
  int to_digit = capped((U)p.stride[a] - (local - q * (U)p.stride[a]));
  const float* row = tab + a * p.table_cols;
  float out[kP];
  out[0] = __ldg(row + v * p.lmax + d);
#pragma unroll
  for (int j = 1; j < kP; ++j) {
    out[j] = out[j - 1];
    if (j < live) {
      if (--to_var == 0) {            // the next variant: digit 0
        to_var = p.var_run;
        to_digit = p.run[a];
        ++v;
        d = 0;
        out[j] = __ldg(row + v * p.lmax);
      } else if (--to_digit == 0) {   // the next digit, wrapping at size
        to_digit = p.run[a];
        d = d + 1 == size ? 0 : d + 1;
        out[j] = __ldg(row + v * p.lmax + d);
      }
    }
  }
  float* dst = vals + a * p.chunk + i;
  if constexpr (kP == kPoints) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(out[0], out[1], out[2], out[3]);
  } else {
    *dst = out[0];
  }
}

template <int kP>
void launch_route(int idx64, int blocks, const float* tab,
                  const DecodeParams& p, float* vals, int* vid,
                  cudaStream_t s) {
  const dim3 grid((unsigned)blocks, (unsigned)(p.n_axes + 1));
  if (idx64) {
    grid_decode_kernel<long long, kP><<<grid, kThreads, 0, s>>>(tab, p, vals,
                                                                 vid);
  } else {
    grid_decode_kernel<int, kP><<<grid, kThreads, 0, s>>>(tab, p, vals, vid);
  }
}

}  // namespace

extern "C" {

// sizeof(DecodeParams), kMaxAxes, kPoints and kThreads, checked by the
// wrapper against its ctypes mirror before the first launch.
int repro_grid_decode_abi(int what) {
  switch (what) {
    case 0: return (int)sizeof(DecodeParams);
    case 1: return kMaxAxes;
    case 2: return kPoints;
    case 3: return kThreads;
    default: return -1;
  }
}

// Decode [p->start, p->start + p->chunk) on `stream` in `blocks` blocks of
// kThreads threads for each of the n_axes + 1 output rows: route 0
// scalar (one position a thread), 1 vec4 (kPoints a thread, 16-byte
// stores).  table2, vals and vid are device pointers, p a host one.
// Returns the cudaError_t of the launch (0 on success); a launch the
// kernel does not take (a vec4 route on a chunk that is no multiple of
// kPoints or on unaligned outputs, blocks that do not cover the chunk,
// too many axes) is refused with cudaErrorInvalidValue before anything
// runs.
int repro_grid_decode(const float* table2, const DecodeParams* p, int idx64,
                      int route, int blocks, float* vals, int* vid,
                      void* stream) {
  const long long per = route == 1 ? kPoints : 1;
  if (p->chunk <= 0 || p->n_axes < 1 || p->n_axes > kMaxAxes || route < 0 ||
      route > 1 || blocks < 1 ||
      (long long)blocks * kThreads * per < p->chunk ||
      (route == 1 && (p->chunk % kPoints || ((uintptr_t)vals & 15u) ||
                      ((uintptr_t)vid & 15u)))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    launch_route<kPoints>(idx64, blocks, table2, *p, vals, vid, s);
  } else {
    launch_route<1>(idx64, blocks, table2, *p, vals, vid, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
