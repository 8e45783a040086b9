// Per-block masked min / argmin / sum / count for the staged sweep's
// reducer (Hopper, sm_90a).
//
// Replaces two TPU kernels of repro/kernels/stream_reduce.py:
//   * _stats_kernel (the pl.pallas_call of block_stats, :58): for each
//     block of `bp` points of a [B] f32 metric vector, the masked min,
//     its block-relative argmin, the masked sum and the valid count;
//   * _stats_banked_kernel (the pl.pallas_call of block_stats_banked,
//     :116): the same per (block, variant id), [G, V]; padding rows carry
//     variant -1 and match no id.
// Masked and padding points count as +inf for the min and nothing for
// the sum and count, so an all-masked block gives min +inf, argmin 0 and
// count 0 (jnp.argmin's answer).  Ties go to the lowest position: each
// thread walks its points in increasing order and keeps strict minima,
// and the block combines (value, position) pairs lexicographically.
//
// One CUDA block per block of points (and per variant id in the banked
// kernel: a (G, V) grid), 256 threads striding over the block.  What
// bounds it on the card: the bytes read, 5 per point (an f32 value and a
// one-byte mask; 9 with the banked kernel's int32 variant id), so the
// first version keeps the arithmetic trivial.  Block sums add in another
// order than the plain-torch twin's.
//
// Plain C interface (repro_block_stats, repro_block_stats_banked) for
// ctypes; the Python wrappers are repro_torch/kernels/stream_reduce.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool pair_less(float v, int p, float ov, int op) {
  return v < ov || (v == ov && p < op);
}

// Scans positions q = tid, tid + kThreads, ... < bp of the block starting
// at `base` and writes the block's (min, argmin, sum, count).  A point
// counts iff it lies below b, its mask is set and, when `gid` is given,
// its variant id equals `want`.
__device__ __forceinline__ void block_scan(
    const float* __restrict__ v, const uint8_t* __restrict__ m,
    const int* __restrict__ gid, int want, long long b, long long base,
    int bp, float* min_out, int* amin_out, float* sum_out,
    float* count_out) {
  __shared__ float s_v[kWarps];
  __shared__ int s_p[kWarps];
  __shared__ float s_s[kWarps];
  __shared__ float s_c[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float tmin = INFINITY;
  int targ = tid < bp ? tid : INT32_MAX;
  float tsum = 0.f, tcnt = 0.f;
  for (int q = tid; q < bp; q += kThreads) {
    const long long i = base + q;
    bool ok = i < b && m[i] != 0;
    if (ok && gid != nullptr) ok = gid[i] == want;
    const float x = ok ? v[i] : INFINITY;
    if (x < tmin) {
      tmin = x;
      targ = q;
    }
    tsum += ok ? x : 0.f;
    tcnt += ok ? 1.f : 0.f;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, tmin, o);
    const int op = __shfl_down_sync(0xffffffffu, targ, o);
    if (pair_less(ov, op, tmin, targ)) {
      tmin = ov;
      targ = op;
    }
    tsum += __shfl_down_sync(0xffffffffu, tsum, o);
    tcnt += __shfl_down_sync(0xffffffffu, tcnt, o);
  }
  if (lane == 0) {
    s_v[warp] = tmin;
    s_p[warp] = targ;
    s_s[warp] = tsum;
    s_c[warp] = tcnt;
  }
  __syncthreads();
  if (tid == 0) {
    float bv = s_v[0], s = s_s[0], c = s_c[0];
    int bq = s_p[0];
    for (int w = 1; w < kWarps; ++w) {
      if (pair_less(s_v[w], s_p[w], bv, bq)) {
        bv = s_v[w];
        bq = s_p[w];
      }
      s += s_s[w];
      c += s_c[w];
    }
    *min_out = bv;
    *amin_out = bq == INT32_MAX ? 0 : bq;
    *sum_out = s;
    *count_out = c;
  }
}

__global__ void __launch_bounds__(kThreads)
block_stats_kernel(const float* __restrict__ v, const uint8_t* __restrict__ m,
                   long long b, int bp, float* __restrict__ mins,
                   int* __restrict__ amins, float* __restrict__ sums,
                   float* __restrict__ counts) {
  const long long g = blockIdx.x;
  block_scan(v, m, nullptr, 0, b, g * bp, bp, mins + g, amins + g, sums + g,
             counts + g);
}

__global__ void __launch_bounds__(kThreads)
block_stats_banked_kernel(const float* __restrict__ v,
                          const uint8_t* __restrict__ m,
                          const int* __restrict__ gid, long long b, int bp,
                          int n_variants, float* __restrict__ mins,
                          int* __restrict__ amins, float* __restrict__ sums,
                          float* __restrict__ counts) {
  const long long g = blockIdx.x;
  const int w = blockIdx.y;
  const long long at = g * n_variants + w;
  block_scan(v, m, gid, w, b, g * bp, bp, mins + at, amins + at, sums + at,
             counts + at);
}

}  // namespace

extern "C" {

// Per-block stats of a [b] vector in blocks of bp; outputs are [G] with
// G = ceil(b / bp).  Returns the cudaError_t of the launch.
int repro_block_stats(const float* v, const uint8_t* m, long long b, int bp,
                      float* mins, int* amins, float* sums, float* counts,
                      void* stream) {
  if (b <= 0 || bp <= 0) return (int)cudaErrorInvalidValue;
  const long long nb = (b + bp - 1) / bp;
  block_stats_kernel<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      v, m, b, bp, mins, amins, sums, counts);
  return (int)cudaGetLastError();
}

// Per-(block, variant) stats; outputs are [G, n_variants], row-major.
int repro_block_stats_banked(const float* v, const uint8_t* m, const int* gid,
                             long long b, int bp, int n_variants, float* mins,
                             int* amins, float* sums, float* counts,
                             void* stream) {
  if (b <= 0 || bp <= 0 || n_variants <= 0 || n_variants > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long long nb = (b + bp - 1) / bp;
  const dim3 grid((unsigned)nb, (unsigned)n_variants);
  block_stats_banked_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      v, m, gid, b, bp, n_variants, mins, amins, sums, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
