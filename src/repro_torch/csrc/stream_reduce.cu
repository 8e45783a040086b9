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
// and every combine takes (value, position) pairs lexicographically.
//
// block_stats_kernel spreads each block of `bp` points over a cluster of
// 1-8 CTAs of 128 threads (the wrapper's plan: a 2^18-point vector in
// blocks of 4096 is 64 blocks, so 4 CTAs a block, 256 in all, two
// 16-byte vectors a thread).  On the `vec4` route (values 16-byte and mask
// 4-byte aligned, bp and the CTA's slice whole vectors) a thread reads
// four values with one 16-byte load and their four mask bytes with one
// 4-byte load; a vector that crosses the end of the input takes element
// loads, which the `scalar` route takes throughout.  Warp shuffles reduce
// (min, argmin, sum, count), then rank 0 reads its cluster's partials
// through distributed shared memory in rank order.  What bounds it: the
// bytes read, 5 a point, 1.3 MB at 2^18 points (0.39 us at 3.35 TB/s);
// at that size the card spends its ~3.5 us on the launch, one round of
// load latency and the cluster barrier instead.  Block sums add in
// another order than the plain-torch twin's.
//
// block_stats_banked_kernel (no caller on the main path; checked
// directly): one CUDA block per (block, variant id), 256 threads striding
// over the block.
//
// Plain C interface (repro_block_stats, repro_block_stats_banked) for
// ctypes; the Python wrappers are repro_torch/kernels/stream_reduce.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;              // the banked kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kStatsThreads = 128;         // a CTA of block_stats_kernel
constexpr int kStatsWarps = kStatsThreads / 32;
constexpr int kMaxCluster = 8;

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

// One point into a thread's running (min, argmin, sum, count).
__device__ __forceinline__ void take(float x, bool ok, int q, float& tmin,
                                     int& targ, float& tsum, float& tcnt) {
  const float y = ok ? x : INFINITY;
  if (y < tmin) {
    tmin = y;
    targ = q;
  }
  tsum += ok ? x : 0.f;
  tcnt += ok ? 1.f : 0.f;
}

// CTA `rank` of a cluster reduces the points [rank * rank_points,
// (rank + 1) * rank_points) of block g (those below bp and b), then
// rank 0 combines the cluster's partials.  kVec: one 16-byte vector of
// values and one 4-byte word of mask bytes a step.
template <bool kVec>
__global__ void __launch_bounds__(kStatsThreads)
block_stats_kernel(const float* __restrict__ v, const uint8_t* __restrict__ m,
                   long long b, int bp, int cluster_size, int rank_points,
                   float* __restrict__ mins, int* __restrict__ amins,
                   float* __restrict__ sums, float* __restrict__ counts) {
  __shared__ float s_v[kStatsWarps];
  __shared__ int s_p[kStatsWarps];
  __shared__ float s_s[kStatsWarps];
  __shared__ float s_c[kStatsWarps];
  __shared__ float s_part[3];
  __shared__ int s_arg;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long g = blockIdx.x / cluster_size;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = rank * rank_points;
  const long long base = g * bp + q0;
  const int n_here = max(0, min(bp - q0, rank_points));
  // points past the end of the input are padding: masked
  const int n_live = (int)max(0LL, min((long long)n_here, b - base));

  float tmin = INFINITY, tsum = 0.f, tcnt = 0.f;
  int targ = INT32_MAX;
  if (kVec) {
    const int first = 4 * tid;
    if (first < n_here) targ = q0 + first;
    for (int j = tid; 4 * j < n_here; j += kStatsThreads) {
      const int q = 4 * j;
      if (q + 4 <= n_live) {
        const float4 x = *reinterpret_cast<const float4*>(v + base + q);
        const uint32_t w = *reinterpret_cast<const uint32_t*>(m + base + q);
        take(x.x, (w & 0xffu) != 0, q0 + q, tmin, targ, tsum, tcnt);
        take(x.y, (w & 0xff00u) != 0, q0 + q + 1, tmin, targ, tsum, tcnt);
        take(x.z, (w & 0xff0000u) != 0, q0 + q + 2, tmin, targ, tsum, tcnt);
        take(x.w, (w & 0xff000000u) != 0, q0 + q + 3, tmin, targ, tsum,
             tcnt);
      } else {
        for (int e = q; e < q + 4 && e < n_here; ++e) {
          const bool ok = e < n_live && m[base + e] != 0;
          take(ok ? v[base + e] : 0.f, ok, q0 + e, tmin, targ, tsum, tcnt);
        }
      }
    }
  } else {
    if (tid < n_here) targ = q0 + tid;
    for (int q = tid; q < n_here; q += kStatsThreads) {
      const bool ok = q < n_live && m[base + q] != 0;
      take(ok ? v[base + q] : 0.f, ok, q0 + q, tmin, targ, tsum, tcnt);
    }
  }
#pragma unroll
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
    for (int w = 1; w < kStatsWarps; ++w) {
      if (pair_less(s_v[w], s_p[w], bv, bq)) {
        bv = s_v[w];
        bq = s_p[w];
      }
      s += s_s[w];
      c += s_c[w];
    }
    s_part[0] = bv;
    s_part[1] = s;
    s_part[2] = c;
    s_arg = bq;
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    float bv = s_part[0], s = s_part[1], c = s_part[2];
    int bq = s_arg;
    for (int r = 1; r < cluster_size; ++r) {
      const float* part = cluster.map_shared_rank(s_part, r);
      const int arg = *cluster.map_shared_rank(&s_arg, r);
      if (pair_less(part[0], arg, bv, bq)) {
        bv = part[0];
        bq = arg;
      }
      s += part[1];
      c += part[2];
    }
    mins[g] = bv;
    amins[g] = bq == INT32_MAX ? 0 : bq;
    sums[g] = s;
    counts[g] = c;
  }
  cluster.sync();      // no CTA leaves while rank 0 reads its shared memory
}

template <bool kVec>
int launch_stats(const float* v, const uint8_t* m, long long b, int bp,
                 int cluster_size, int rank_points, float* mins, int* amins,
                 float* sums, float* counts, cudaStream_t stream) {
  const long long nb = (b + bp - 1) / bp;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nb * cluster_size));
  cfg.blockDim = dim3(kStatsThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster_size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, block_stats_kernel<kVec>, v, m, b, bp, cluster_size, rank_points,
      mins, amins, sums, counts);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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

// Per-block stats of a [b] vector in blocks of bp, each block over a
// cluster of `cluster_size` CTAs of `rank_points` points (the wrapper's
// plan); outputs are [G] with G = ceil(b / bp).  vec4 asks for the
// 16-byte route: the caller has checked that v is 16-byte and m 4-byte
// aligned and that bp and rank_points are multiples of 4.  Returns the
// cudaError_t of the launch; a plan the kernel does not take is refused
// with cudaErrorInvalidValue before anything runs.
int repro_block_stats(const float* v, const uint8_t* m, long long b, int bp,
                      int cluster_size, int rank_points, int vec4,
                      float* mins, int* amins, float* sums, float* counts,
                      void* stream) {
  if (b <= 0 || bp <= 0 || cluster_size < 1 || cluster_size > kMaxCluster
      || rank_points < 1 || (long long)cluster_size * rank_points < bp
      || (vec4 && (bp % 4 || rank_points % 4 || (uintptr_t)v % 16
                   || (uintptr_t)m % 4))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4) {
    return launch_stats<true>(v, m, b, bp, cluster_size, rank_points, mins,
                              amins, sums, counts, s);
  }
  return launch_stats<false>(v, m, b, bp, cluster_size, rank_points, mins,
                             amins, sums, counts, s);
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
