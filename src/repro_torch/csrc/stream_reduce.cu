// Per-block masked min / argmin / sum / count for the staged sweep's
// reducer (Hopper, sm_90a).
//
// Replaces two TPU kernels of repro/kernels/stream_reduce.py:
//   * _stats_kernel (the pl.pallas_call of block_stats, :58): for each
//     block of `bp` points of a [B] f32 metric vector, the masked min,
//     its block-relative argmin, the masked sum and the valid count;
//   * _stats_banked_kernel (the pl.pallas_call of block_stats_banked,
//     :116): the same per (block, variant id), [G, V]; padding rows and
//     ids outside [0, V) match no id.
// Masked and padding points count as +inf for the min and nothing for
// the sum and count, so an all-masked block gives min +inf, argmin 0 and
// count 0 (jnp.argmin's answer).  Points are ordered by (value,
// position) with NaN below every number, as jnp.argmin and torch.argmin
// order them: a NaN is the min and the first NaN its argmin.  Each thread
// walks its points in increasing order and keeps strict improvements;
// block_stats_kernel keeps the first NaN position apart and folds it by
// integer minima, block_stats_banked_kernel orders its runs and slots
// with NaN first (nan_first_less, key_less).
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
// block_stats_banked_kernel reads each point once for a tile of up to
// kMaxTile variant ids.  The first port launched a CTA per (block,
// variant), each re-reading the whole block (V x 9 bytes a point, scalar
// loads), and spent its time on issue and L2 traffic.  This design
// spreads a block over a cluster of 1-8 CTAs of 128 threads, as K3a, and
// keeps per-variant partials on chip:
//   * one pass: a thread takes a 16-byte float4 of values, the 4 mask
//     bytes and an int4 of variant ids a step (`vec4`: values and ids
//     16-byte, mask 4-byte aligned, bp and the slice whole vectors), or
//     one point a step (`scalar`);
//   * a register run: a thread accumulates (min, argmin, sum, count) of
//     the current run of one id and merges it into its slot only when the
//     id changes.  K2's variant rows hold runs of n_var points, so the
//     slots see a flush or two a thread; an interleaved layout flushes
//     every point;
//   * slots in shared memory, [tile][128 threads] of each of min, argmin,
//     sum and count: a thread owns its column, so lanes hit consecutive
//     words (no bank conflict) and no atomics are needed.  A slot's first
//     flush writes it whole (a mask of written slots a thread, in a
//     register, then in shared memory for the fold), so none is cleared;
//   * a fixed-order tree: 32, 16 or 8 lanes take a variant's 128 slots
//     (4, 8 or 16 a lane in order, then shuffles; every variant of the
//     tile at once), and rank 0 merges the cluster's [tile] partials
//     through distributed shared memory in rank order, so a repeated
//     launch is bit-equal, sums too;
//   * V past one tile: blockIdx.y takes tile t of the variants, each
//     tile one pass over the block (the wrapper's plan balances the
//     tiles).
// What bounds it: the bytes read, 9 a point (2.4 MB at 2^18 points,
// 0.70 us; 151 MB at 2^24, 45 us).
//
// Plain C interface (repro_block_stats, repro_block_stats_banked) for
// ctypes; the Python wrappers are repro_torch/kernels/stream_reduce.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kStatsThreads = 128;         // a CTA of either kernel
constexpr int kStatsWarps = kStatsThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kMaxTile = 16;               // variants a banked CTA keeps

// y improves on t for a walk in increasing position: NaN below every
// number, the earlier of two equals kept.  !(y >= t) is y < t or either
// one NaN (one unordered compare); a NaN t is never improved on.
__device__ __forceinline__ bool nan_first_less(float y, float t) {
  return !(y >= t) & (t == t);
}

// (v, p) before (ov, op): by value with NaN first, then by position.
__device__ __forceinline__ bool key_less(float v, int p, float ov, int op) {
  const bool same = (v == ov) | ((v != v) & (ov != ov));
  return nan_first_less(v, ov) | (same & (p < op));
}

// (v, p) before (ov, op) where neither value is NaN.
__device__ __forceinline__ bool pair_less(float v, int p, float ov, int op) {
  return v < ov || (v == ov && p < op);
}

// Shuffles fold each segment of kWidth lanes' (min, argmin, sum, count)
// into its first lane, in a fixed order (offsets kWidth / 2, ..., 1).
template <int kWidth, bool kNan, typename C>
__device__ __forceinline__ void shfl_fold(float& v, int& p, float& s,
                                          C& c) {
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, o, kWidth);
    const int op = __shfl_down_sync(0xffffffffu, p, o, kWidth);
    if (kNan ? key_less(ov, op, v, p) : pair_less(ov, op, v, p)) {
      v = ov;
      p = op;
    }
    s += __shfl_down_sync(0xffffffffu, s, o, kWidth);
    c += __shfl_down_sync(0xffffffffu, c, o, kWidth);
  }
}

// One point into a thread's running (min, argmin, sum, count) by the
// plain order, and its first NaN position tnan apart: one isnan a point,
// off the chain of compares through tmin.
__device__ __forceinline__ void take(float x, bool ok, int q, float& tmin,
                                     int& targ, float& tsum, float& tcnt,
                                     int& tnan) {
  const float y = ok ? x : INFINITY;
  if (y < tmin) {
    tmin = y;
    targ = q;
  }
  if (isnan(y)) tnan = min(tnan, q);
  tsum += ok ? x : 0.f;
  tcnt += ok ? 1.f : 0.f;
}

// CTA `rank` of a cluster reduces the points [rank * rank_points,
// (rank + 1) * rank_points) of block g (those below bp and b), then
// rank 0 combines the cluster's partials.  kVec: one 16-byte vector of
// values and one 4-byte word of mask bytes a step.  kOne: a cluster of
// one CTA, whose barriers are the CTA's own (with a barrier chosen at
// run time this kernel ran 4-6% slower on an H100; PERF.md, PR 20).
template <bool kVec, bool kOne>
__global__ void __launch_bounds__(kStatsThreads)
block_stats_kernel(const float* __restrict__ v, const uint8_t* __restrict__ m,
                   long long b, int bp, int cluster_size, int rank_points,
                   float* __restrict__ mins, int* __restrict__ amins,
                   float* __restrict__ sums, float* __restrict__ counts) {
  __shared__ float s_v[kStatsWarps];
  __shared__ int s_p[kStatsWarps];
  __shared__ float s_s[kStatsWarps];
  __shared__ float s_c[kStatsWarps];
  __shared__ int s_n[kStatsWarps];
  __shared__ float s_part[3];
  __shared__ int s_arg[2];             // argmin, first NaN position
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
  int targ = INT32_MAX, tnan = INT32_MAX;
  if (kVec) {
    const int first = 4 * tid;
    if (first < n_here) targ = q0 + first;
    for (int j = tid; 4 * j < n_here; j += kStatsThreads) {
      const int q = 4 * j;
      if (q + 4 <= n_live) {
        const float4 x = *reinterpret_cast<const float4*>(v + base + q);
        const uint32_t w = *reinterpret_cast<const uint32_t*>(m + base + q);
        take(x.x, (w & 0xffu) != 0, q0 + q, tmin, targ, tsum, tcnt, tnan);
        take(x.y, (w & 0xff00u) != 0, q0 + q + 1, tmin, targ, tsum, tcnt,
             tnan);
        take(x.z, (w & 0xff0000u) != 0, q0 + q + 2, tmin, targ, tsum, tcnt,
             tnan);
        take(x.w, (w & 0xff000000u) != 0, q0 + q + 3, tmin, targ, tsum,
             tcnt, tnan);
      } else {
        for (int e = q; e < q + 4 && e < n_here; ++e) {
          const bool ok = e < n_live && m[base + e] != 0;
          take(ok ? v[base + e] : 0.f, ok, q0 + e, tmin, targ, tsum, tcnt,
               tnan);
        }
      }
    }
  } else {
    if (tid < n_here) targ = q0 + tid;
    for (int q = tid; q < n_here; q += kStatsThreads) {
      const bool ok = q < n_live && m[base + q] != 0;
      take(ok ? v[base + q] : 0.f, ok, q0 + q, tmin, targ, tsum, tcnt,
           tnan);
    }
  }
  // (min, argmin, sum, count) fold in the plain order (no NaN reaches
  // tmin); the first NaN position folds apart, by integer minima
  shfl_fold<32, false>(tmin, targ, tsum, tcnt);
  tnan = __reduce_min_sync(0xffffffffu, tnan);
  if (lane == 0) {
    s_v[warp] = tmin;
    s_p[warp] = targ;
    s_s[warp] = tsum;
    s_c[warp] = tcnt;
    s_n[warp] = tnan;
  }
  __syncthreads();
  if (tid == 0) {
    float bv = s_v[0], s = s_s[0], c = s_c[0];
    int bq = s_p[0], bn = s_n[0];
    for (int w = 1; w < kStatsWarps; ++w) {
      if (pair_less(s_v[w], s_p[w], bv, bq)) {
        bv = s_v[w];
        bq = s_p[w];
      }
      s += s_s[w];
      c += s_c[w];
      bn = min(bn, s_n[w]);
    }
    s_part[0] = bv;
    s_part[1] = s;
    s_part[2] = c;
    s_arg[0] = bq;
    s_arg[1] = bn;
  }
  if (kOne) {
    __syncthreads();
  } else {
    cluster.sync();
  }
  if (rank == 0 && tid == 0) {
    float bv = s_part[0], s = s_part[1], c = s_part[2];
    int bq = s_arg[0], bn = s_arg[1];
    for (int r = 1; r < cluster_size; ++r) {
      const float* part = cluster.map_shared_rank(s_part, r);
      const int* arg = cluster.map_shared_rank(s_arg, r);
      if (pair_less(part[0], arg[0], bv, bq)) {
        bv = part[0];
        bq = arg[0];
      }
      s += part[1];
      c += part[2];
      bn = min(bn, arg[1]);
    }
    // a NaN is below every number: the block's first NaN is its min
    mins[g] = bn == INT32_MAX ? bv : __int_as_float(0x7fc00000);
    amins[g] = bn != INT32_MAX ? bn : bq == INT32_MAX ? 0 : bq;
    sums[g] = s;
    counts[g] = c;
  }
  // no CTA leaves while rank 0 reads its shared memory
  if (!kOne) cluster.sync();
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
      &cfg,
      cluster_size == 1 ? block_stats_kernel<kVec, true>
                        : block_stats_kernel<kVec, false>,
      v, m, b, bp, cluster_size, rank_points, mins, amins, sums, counts);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// A banked CTA's shared memory: the [tile][kStatsThreads] slots of min,
// argmin, sum and count, each thread's mask of the slots it wrote, then
// the CTA's [tile] partials of each.
struct BankedSmem {
  float* min;
  int* arg;
  float* sum;
  int* cnt;
  uint32_t* touched;
  float* p_min;
  int* p_arg;
  float* p_sum;
  int* p_cnt;
};

__host__ __device__ constexpr int banked_smem_bytes(int tile) {
  return 4 * (4 * tile * kStatsThreads + kStatsThreads + 4 * tile);
}

// A thread's running (min, argmin, sum, count) of its current run of
// variant slot w (-1: none yet), and the mask of its slots written so far
// (a slot is written whole at its first flush, so no slot is cleared).
struct Run {
  int w;
  float mn;
  int arg;
  float sum;
  int cnt;
  uint32_t touched;
};

__device__ __forceinline__ void flush(Run& r, const BankedSmem& s, int tid) {
  if (r.w < 0) return;
  const int i = r.w * kStatsThreads + tid;
  const uint32_t bit = 1u << r.w;
  if (!(r.touched & bit)) {
    r.touched |= bit;
    s.min[i] = r.mn;
    s.arg[i] = r.arg;
    s.sum[i] = r.sum;
    s.cnt[i] = r.cnt;
    return;
  }
  // the slot's points all precede the run's: a tie keeps the slot's
  if (nan_first_less(r.mn, s.min[i])) {
    s.min[i] = r.mn;
    s.arg[i] = r.arg;
  }
  s.sum[i] += r.sum;
  s.cnt[i] += r.cnt;
}

// Point q (block-relative) with value x, mask ok and variant id `id` into
// the run of a thread whose tile starts at variant tile0 and holds nt.
__device__ __forceinline__ void banked_take(float x, bool ok, int id, int q,
                                            int tile0, int nt, Run& r,
                                            const BankedSmem& s, int tid) {
  const unsigned w = (unsigned)id - (unsigned)tile0;
  if (!ok || w >= (unsigned)nt) return;       // -1, ids past V, other tiles
  if ((int)w == r.w) {
    if (nan_first_less(x, r.mn)) {
      r.mn = x;
      r.arg = q;
    }
    r.sum += x;
    r.cnt += 1;
  } else {
    flush(r, s, tid);
    r = Run{(int)w, x, q, x, 1, r.touched};
  }
}

// A CTA's slots folded into its [nt] partials, in a fixed order: lane l
// of warp k takes variant w = k * (32 / kLanes) + l / kLanes, folds its
// slots l % kLanes, l % kLanes + kLanes, ... in increasing order, and the
// kLanes lanes of w fold by shuffles into the first, which writes them.
template <int kLanes>
__device__ __forceinline__ void fold_slots(const BankedSmem& s, int nt,
                                           int warp, int lane) {
  const int w = warp * (32 / kLanes) + lane / kLanes;
  float bv = INFINITY, sm = 0.f;
  int bq = INT32_MAX, c = 0;
  if (w < nt) {
#pragma unroll
    for (int t = lane % kLanes; t < kStatsThreads; t += kLanes) {
      if (!(s.touched[t] >> w & 1u)) continue;   // the identity
      const int i = w * kStatsThreads + t;
      if (key_less(s.min[i], s.arg[i], bv, bq)) {
        bv = s.min[i];
        bq = s.arg[i];
      }
      sm += s.sum[i];
      c += s.cnt[i];
    }
  }
  shfl_fold<kLanes, true>(bv, bq, sm, c);
  if (lane % kLanes == 0 && w < nt) {
    s.p_min[w] = bv;
    s.p_arg[w] = bq;
    s.p_sum[w] = sm;
    s.p_cnt[w] = c;
  }
}

// CTA `rank` of a cluster reduces its slice of block g (as
// block_stats_kernel) for the variants [tile0, tile0 + nt) of tile
// blockIdx.y, then rank 0 merges the cluster's partials and writes the
// tile's [nt] outputs of row g.  kVec and kOne as block_stats_kernel's.
template <bool kVec, bool kOne>
__global__ void __launch_bounds__(kStatsThreads)
block_stats_banked_kernel(const float* __restrict__ v,
                          const uint8_t* __restrict__ m,
                          const int* __restrict__ gid, long long b, int bp,
                          int n_variants, int cluster_size, int rank_points,
                          int tile, float* __restrict__ mins,
                          int* __restrict__ amins, float* __restrict__ sums,
                          float* __restrict__ counts) {
  extern __shared__ __align__(16) float smem[];
  const int slots = tile * kStatsThreads;
  float* const part = smem + 4 * slots + kStatsThreads;
  const BankedSmem s{
      smem, reinterpret_cast<int*>(smem + slots), smem + 2 * slots,
      reinterpret_cast<int*>(smem + 3 * slots),
      reinterpret_cast<uint32_t*>(smem + 4 * slots), part,
      reinterpret_cast<int*>(part + tile), part + 2 * tile,
      reinterpret_cast<int*>(part + 3 * tile)};
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long g = blockIdx.x / cluster_size;
  const int tile0 = (int)blockIdx.y * tile;
  const int nt = min(tile, n_variants - tile0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = rank * rank_points;
  const long long base = g * bp + q0;
  const int n_here = max(0, min(bp - q0, rank_points));
  const int n_live = (int)max(0LL, min((long long)n_here, b - base));

  Run r{-1, INFINITY, INT32_MAX, 0.f, 0, 0u};
  if (kVec) {
    for (int j = tid; 4 * j < n_live; j += kStatsThreads) {
      const int q = 4 * j;
      if (q + 4 <= n_live) {
        const float4 x = *reinterpret_cast<const float4*>(v + base + q);
        const uint32_t mw = *reinterpret_cast<const uint32_t*>(m + base + q);
        const int4 id = *reinterpret_cast<const int4*>(gid + base + q);
        banked_take(x.x, (mw & 0xffu) != 0, id.x, q0 + q, tile0, nt, r, s,
                    tid);
        banked_take(x.y, (mw & 0xff00u) != 0, id.y, q0 + q + 1, tile0, nt, r,
                    s, tid);
        banked_take(x.z, (mw & 0xff0000u) != 0, id.z, q0 + q + 2, tile0, nt,
                    r, s, tid);
        banked_take(x.w, (mw & 0xff000000u) != 0, id.w, q0 + q + 3, tile0,
                    nt, r, s, tid);
      } else {                          // the vector that crosses b
        for (int e = q; e < n_live; ++e) {
          banked_take(v[base + e], m[base + e] != 0, gid[base + e], q0 + e,
                      tile0, nt, r, s, tid);
        }
      }
    }
  } else {
    for (int q = tid; q < n_live; q += kStatsThreads) {
      banked_take(v[base + q], m[base + q] != 0, gid[base + q], q0 + q, tile0,
                  nt, r, s, tid);
    }
  }
  flush(r, s, tid);
  s.touched[tid] = r.touched;
  __syncthreads();
  // the fold: all variants at once, 1, 2 or 4 a warp (nt up to 4, 8, 16)
  if (nt > 8) {
    fold_slots<8>(s, nt, warp, lane);
  } else if (nt > 4) {
    fold_slots<16>(s, nt, warp, lane);
  } else {
    fold_slots<32>(s, nt, warp, lane);
  }
  if (kOne) {
    __syncthreads();
  } else {
    cluster.sync();
  }
  if (rank == 0 && tid < nt) {
    const int w = tid;
    // every rank's partial loaded first (one round of remote latency),
    // then combined in rank order
    constexpr int kRanks = kOne ? 1 : kMaxCluster;
    float r_min[kMaxCluster], r_sum[kMaxCluster];
    int r_arg[kMaxCluster], r_cnt[kMaxCluster];
#pragma unroll
    for (int rr = 1; rr < kRanks; ++rr) {
      if (rr < cluster_size) {
        r_min[rr] = *cluster.map_shared_rank(s.p_min + w, rr);
        r_arg[rr] = *cluster.map_shared_rank(s.p_arg + w, rr);
        r_sum[rr] = *cluster.map_shared_rank(s.p_sum + w, rr);
        r_cnt[rr] = *cluster.map_shared_rank(s.p_cnt + w, rr);
      }
    }
    float bv = s.p_min[w], sm = s.p_sum[w];
    int bq = s.p_arg[w], c = s.p_cnt[w];
#pragma unroll
    for (int rr = 1; rr < kRanks; ++rr) {
      if (rr < cluster_size) {
        if (key_less(r_min[rr], r_arg[rr], bv, bq)) {
          bv = r_min[rr];
          bq = r_arg[rr];
        }
        sm += r_sum[rr];
        c += r_cnt[rr];
      }
    }
    const long long at = g * n_variants + tile0 + w;
    mins[at] = bv;
    // min +inf: every position of the block is +inf for this id, so the
    // first one wins (an empty (block, variant) included)
    amins[at] = bv == INFINITY ? 0 : bq;
    sums[at] = sm;
    counts[at] = (float)c;
  }
  // no CTA leaves while rank 0 reads its shared memory
  if (!kOne) cluster.sync();
}

template <bool kVec>
int launch_banked(const float* v, const uint8_t* m, const int* gid,
                  long long b, int bp, int n_variants, int cluster_size,
                  int rank_points, int tile, float* mins, int* amins,
                  float* sums, float* counts, cudaStream_t stream) {
  const long long nb = (b + bp - 1) / bp;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nb * cluster_size),
                     (unsigned)((n_variants + tile - 1) / tile));
  cfg.blockDim = dim3(kStatsThreads);
  cfg.dynamicSmemBytes = banked_smem_bytes(tile);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster_size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg,
      cluster_size == 1 ? block_stats_banked_kernel<kVec, true>
                        : block_stats_banked_kernel<kVec, false>,
      v, m, gid, b, bp, n_variants, cluster_size, rank_points, tile, mins,
      amins, sums, counts);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

static_assert(banked_smem_bytes(kMaxTile) <= 48 * 1024,
              "a banked tile's slots need no shared-memory opt-in");

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
// The plan as repro_block_stats's, and `tile` variants a CTA (1 to
// kMaxTile; ceil(n_variants / tile) tiles); vec4 also needs gid 16-byte
// aligned.
int repro_block_stats_banked(const float* v, const uint8_t* m, const int* gid,
                             long long b, int bp, int n_variants,
                             int cluster_size, int rank_points, int tile,
                             int vec4, float* mins, int* amins, float* sums,
                             float* counts, void* stream) {
  if (b <= 0 || bp <= 0 || n_variants <= 0 || n_variants > 65535
      || cluster_size < 1 || cluster_size > kMaxCluster || rank_points < 1
      || (long long)cluster_size * rank_points < bp || tile < 1
      || tile > kMaxTile
      || (vec4 && (bp % 4 || rank_points % 4 || (uintptr_t)v % 16
                   || (uintptr_t)gid % 16 || (uintptr_t)m % 4))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4) {
    return launch_banked<true>(v, m, gid, b, bp, n_variants, cluster_size,
                               rank_points, tile, mins, amins, sums, counts,
                               s);
  }
  return launch_banked<false>(v, m, gid, b, bp, n_variants, cluster_size,
                              rank_points, tile, mins, amins, sums, counts, s);
}

}  // extern "C"
