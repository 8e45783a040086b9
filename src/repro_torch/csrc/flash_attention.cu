// Flash attention with a GQA head map (Hopper, sm_90a): q [B, H, S, D],
// k and v [B, Hkv, S, D] with H % Hkv == 0, out [B, H, S, D] in q's dtype
// (f32, f16 or bf16; all three operands share it).  Query head h reads kv
// head h / (H / Hkv).  Scores are f32(q) . f32(k) times 1/sqrt(D), masked
// to row >= col under `causal`, and go through an online softmax in f32;
// the output is acc / max(l, 1e-30), rounded once (to nearest even) to the
// output dtype.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (the pl.pallas_call of flash_attention, :105).  On the TPU the grid's kv
// dimension runs in order on one core, so the running max, normaliser and
// accumulator carry across grid steps in VMEM scratch.  Blocks run in
// parallel here, so the kv walk is a loop inside the block, with the carry
// in registers.  Causal blocks stop at the diagonal tile, as the TPU kernel
// skips the blocks above it; the longest query tiles launch first.  Rows
// and columns past S are masked in the kernel, not padded in memory, so any
// S >= 1 is taken.  No atomics: each output row is written by one block,
// so two runs agree bit for bit.  Two routes, picked by the wrapper
// (repro_torch/kernels/flash_attention.py::route):
//
// * the tensor-core route (repro_flash_attention_wgmma) for f16/bf16
//   operands with D a multiple of 8 up to 128 and 16-byte-aligned bases;
// * the SIMT route (repro_flash_attention) for everything else it takes:
//   f32 (whose function does not survive the tensor cores' TF32 within
//   1e-5) and the rest, D up to 128.
//
// What bounds it on the card: the operations.  For qwen2-7b's attention at
// S = 4096 (H = 28, Hkv = 4, D = 128, causal) the tensor-core route does
// 6 D half operations per unmasked score (2 D for Q K^T, 4 D for the split
// P V below), 1.80e11, 0.182 ms at 989 TFLOP/s; its 2.35e8 exps take
// 0.056 ms at the SFU rate and the bytes ~0.02 ms.  The SIMT route does
// 4 D FP32 operations per score: 1.20e11, 1.80 ms at 67 TFLOP/s.
//
// The tensor-core route (flash_attention_wgmma_kernel): one block owns 192
// (D <= 64) or 128 query rows of one (batch, head): three or two consumer
// warpgroups of 64 rows (the wgmma M) and one producer warpgroup, of which
// one thread issues the loads (the warpgroup sheds its registers with
// setmaxnreg, and the consumers take them).
//   * Loads: Q once, then K and V tiles of 64 kv rows into a ring of
//     3 stages, by TMA through 3-D tensor maps (D, S, heads) built
//     on the host for each call, in the operand dtype, 128-byte swizzled;
//     each tile completes on an mbarrier and the next tile's copy overlaps
//     this tile's products.  A ragged last tile (S = 1500, 127, 1) is
//     zero-filled by TMA and never reads the next head's rows; D < 64 or
//     between 64 and 128 is zero-filled to 64 or 128 columns, which adds
//     nothing to either product.
//   * S = Q K^T: wgmma m64n64k16 from shared memory into f32 accumulators.
//     Products of half values are exact in f32: only the order of the sum
//     differs from the reference's f32 dot.
//   * Online softmax in registers on the accumulator layout (a thread
//     holds 2 rows x 16 columns): row max and sum by quad shuffles in a
//     fixed order; columns past S or above the diagonal are -inf against
//     a running max that starts at -1e30 (NEG_INF), so a fully masked row
//     of a tile adds exactly nothing (a zero-filled K row scores 0, not
//     -inf, so it is masked); tiles inside every row's range skip the
//     compares.  In base 2: scores times scale * log2(e), then exp2f (not
//     the approximate ex2 of fast math), which keeps P within the f32
//     rounding of exp's.
//   * O += P V keeps P's f32 precision: P = P_hi + P_lo with P_hi =
//     half(P) and P_lo = half(P - P_hi) (exact difference), two wgmma
//     m64nDk16 each with A from registers (the S accumulator layout is the
//     A fragment layout, so no shuffle) and V from shared memory as the
//     MN-major B.  P is left with ~2^-16 (bf16) or ~2^-22 (f16) of
//     relative error, against 2^-8 or 2^-11 for one rounding, which would
//     be another function than the reference's.  For f16, P is scaled by
//     2^8 first (exact) so that small probabilities keep their bits above
//     f16's subnormals; the epilogue divides it out.  l sums the f32 P.
//   * Epilogue: acc / max(l, 1e-30), rounded once to the output dtype,
//     stored from registers with masks at row S and column D.
//   * Overlap: tile i's Q K^T is issued before tile i - 1's P V, so the
//     softmax of tile i runs while the tensor cores multiply P V of tile
//     i - 1; O is rescaled once that product is done.
// A stage is released when every consumer warp has passed its wgmma wait
// on it; a warpgroup whose rows all lie past S or above a causal tile
// skips the products but still waits for the tile, so no warpgroup runs a
// stage ahead of the others.
//
// The SIMT kernel (flash_attention_kernel, and flash_attention_kernel_d64
// for 32 < D <= 64 with a register bound; the port's first design): one
// block owns 64 query rows, 8 warps of 8 rows, K/V tiles of 64 rows staged
// as f32 in dynamic shared memory, all arithmetic FP32 on the CUDA cores:
//   * Q K^T: lane j scores kv rows j and j + 32 against the warp's 8 rows,
//     explicit fmaf over d in order from 0 (the build has --fmad=false).
//     K rows are padded by one float, so the 32 lanes' reads of one column
//     fall in 32 banks; the query rows are read as float4 broadcasts.
//   * softmax: warp-shuffle max and sum (xor butterflies, the same order
//     on every run), masked as above.  A warp whose 8 rows all lie above a
//     kv tile skips that tile's arithmetic.
//   * P V: the warp's probabilities go through shared memory; lane c owns
//     columns c, c + 32, ... of the f32 accumulator of each of its rows.
// Head dims up to kMaxD = 128 are taken (staged as 32, 64 or 128 columns,
// zero-filled past D); the wrapper's _MAX_D holds the same cap.
//
// Plain C interfaces (repro_flash_attention, repro_flash_attention_wgmma)
// for ctypes; the Python wrapper is
// repro_torch/kernels/flash_attention.py::flash_attention.  A launch is
// refused (cudaErrorInvalidValue) past the caps or the grid's limits.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "dtypes.cuh"
#include "hopper.cuh"

namespace {

constexpr int kRows = 64;                      // query rows / kv rows a tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;   // 8
constexpr int kMaxD = 128;
constexpr float kMaxInit = -1e30f;             // the reference's NEG_INF

// f32 floats of shared memory one block stages at a staged width DP.
template <int DP>
constexpr size_t smem_floats() {
  return (size_t)kRows * DP              // Q tile
         + (size_t)kRows * (DP + 1)      // K tile, rows padded by one
         + (size_t)kRows * DP            // V tile
         + (size_t)kWarps * kRowsPerWarp * kRows;   // probabilities
}

// Rows [r0, r0 + 64) of a [s, d] slab into dst as f32 (row stride ld),
// zero past row s and past column d.
template <typename T, int DP>
__device__ __forceinline__ void stage(const T* __restrict__ src, float* dst,
                                      int ld, int r0, int s, int d) {
  for (int i = threadIdx.x; i < kRows * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i - r * DP;
    const int gr = r0 + r;
    float x = 0.f;
    if (gr < s && c < d) x = to_f32(src[(long long)gr * d + c]);
    dst[r * ld + c] = x;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = x + __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

template <typename T, int DP>
__device__ __forceinline__ void simt_block(const T* __restrict__ q,
                                           const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           T* __restrict__ out, int h,
                                           int hkv, int s, int d,
                                           float scale, int causal) {
  constexpr int kCols = DP / 32;               // accumulator columns a lane
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_k = s_q + kRows * DP;
  float* s_v = s_k + kRows * (DP + 1);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* s_p = s_v + kRows * DP + warp * kRowsPerWarp * kRows;

  const long long bh = blockIdx.x;
  const long long kvh = (bh / h) * hkv + (bh % h) / (h / hkv);
  const int n_qt = (s + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kRows;   // longest first
  const long long slab = (long long)s * d;
  const T* kp = k + kvh * slab;
  const T* vp = v + kvh * slab;
  stage<T, DP>(q + bh * slab, s_q, DP, q0, s, d);

  const int last_row = min(q0 + kRows, s) - 1;
  const int n_kt = causal ? last_row / kRows + 1 : n_qt;
  const int wr0 = q0 + warp * kRowsPerWarp;    // the warp's first row
  const float* q_w = s_q + warp * kRowsPerWarp * DP;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kMaxInit;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kCols; ++t) acc[r][t] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();                 // the last tile is consumed, Q staged
    stage<T, DP>(kp, s_k, DP + 1, k0, s, d);
    stage<T, DP>(vp, s_v, DP, k0, s, d);
    __syncthreads();
    if (wr0 >= s || (causal && wr0 + kRowsPerWarp - 1 < k0)) continue;

    // scores of kv rows k0 + lane and k0 + lane + 32
    float sc[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r][0] = sc[r][1] = 0.f;
    const float* k_a = s_k + lane * (DP + 1);
    const float* k_b = s_k + (lane + 32) * (DP + 1);
#pragma unroll 2
    for (int c = 0; c < DP; c += 4) {
      float ka[4], kb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ka[u] = k_a[c + u];
        kb[u] = k_b[c + u];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_w + r * DP + c);
        sc[r][0] = fmaf(qv.x, ka[0], sc[r][0]);
        sc[r][0] = fmaf(qv.y, ka[1], sc[r][0]);
        sc[r][0] = fmaf(qv.z, ka[2], sc[r][0]);
        sc[r][0] = fmaf(qv.w, ka[3], sc[r][0]);
        sc[r][1] = fmaf(qv.x, kb[0], sc[r][1]);
        sc[r][1] = fmaf(qv.y, kb[1], sc[r][1]);
        sc[r][1] = fmaf(qv.z, kb[2], sc[r][1]);
        sc[r][1] = fmaf(qv.w, kb[3], sc[r][1]);
      }
    }

    // online softmax, one row at a time across the warp
    const int c0 = k0 + lane;
    const int c1 = c0 + 32;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = wr0 + r;
      float s0 = sc[r][0] * scale;
      float s1 = sc[r][1] * scale;
      if (c0 >= s || (causal && c0 > row)) s0 = -INFINITY;
      if (c1 >= s || (causal && c1 > row)) s1 = -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
      s_p[r * kRows + lane] = p0;
      s_p[r * kRows + lane + 32] = p1;
#pragma unroll
      for (int t = 0; t < kCols; ++t) acc[r][t] = acc[r][t] * alpha;
    }
    __syncwarp();

    // acc += P V over the tile's 64 kv rows, in order
#pragma unroll 2
    for (int j = 0; j < kRows; j += 4) {
      float vv[4][kCols];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int t = 0; t < kCols; ++t) {
          vv[u][t] = s_v[(j + u) * DP + lane + 32 * t];
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pj = *reinterpret_cast<const float4*>(s_p + r * kRows + j);
#pragma unroll
        for (int t = 0; t < kCols; ++t) {
          acc[r][t] = fmaf(pj.x, vv[0][t], acc[r][t]);
          acc[r][t] = fmaf(pj.y, vv[1][t], acc[r][t]);
          acc[r][t] = fmaf(pj.z, vv[2][t], acc[r][t]);
          acc[r][t] = fmaf(pj.w, vv[3][t], acc[r][t]);
        }
      }
    }
    __syncwarp();
  }

  T* o = out + bh * slab;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = wr0 + r;
    if (row >= s) break;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const int c = lane + 32 * t;
      if (c < d) o[(long long)row * d + c] = from_f32<T>(acc[r][t] / denom);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int h,
                       int hkv, int s, int d, float scale, int causal) {
  simt_block<T, DP>(q, k, v, out, h, hkv, s, d, scale, causal);
}

// DP = 64: three blocks fit an SM's shared memory (65,792 B each) when a
// thread keeps to 80 registers, which the bound holds it to; unbounded,
// the compiler has given it 80 or 92 (two blocks an SM) as other kernels
// of this source changed.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
flash_attention_kernel_d64(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int h, int hkv, int s, int d, float scale,
                           int causal) {
  simt_block<T, 64>(q, k, v, out, h, hkv, s, d, scale, causal);
}

template <typename T, int DP>
constexpr auto simt_kernel() {
  if constexpr (DP == 64) {
    return flash_attention_kernel_d64<T>;
  } else {
    return flash_attention_kernel<T, DP>;
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out,
           long long bh, int h, int hkv, int s, int d, float scale,
           int causal, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<DP>();
  auto kernel = simt_kernel<T, DP>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)bh, (unsigned)((s + kRows - 1) / kRows));
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, h, hkv, s, d, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out,
             long long bh, int h, int hkv, int s, int d, float scale,
             int causal, cudaStream_t stream) {
  if (d <= 32) {
    return launch<T, 32>(q, k, v, out, bh, h, hkv, s, d, scale, causal,
                         stream);
  }
  if (d <= 64) {
    return launch<T, 64>(q, k, v, out, bh, h, hkv, s, d, scale, causal,
                         stream);
  }
  return launch<T, 128>(q, k, v, out, bh, h, hkv, s, d, scale, causal,
                        stream);
}


// ------------------------------------------------------ tensor-core route

namespace tc {

using namespace hopper;

constexpr int kBN = 64;                  // kv rows a tile (the S wgmma N)
constexpr int kStages = 3;               // K/V tiles in flight
constexpr uint32_t kAtomBytes = kBN * 128;   // 64 columns of a K or V tile
constexpr int kProducerRegs = 24;

// A block's consumer warpgroups (64 query rows each) at a staged head
// width DP: three at DP = 64, two at DP = 128, where O takes twice the
// registers.  Registers a thread: __launch_bounds__(kThreads, 1) gives
// 128 (three) or 168 (two) at entry, one block an SM; the producer
// warpgroup sheds all but kProducerRegs and the consumers take what it
// sheds, up to kConsumerRegs.
template <int DP>
struct Blocks {
  static constexpr int kConsumers = DP == 64 ? 3 : 2;
  static constexpr int kBM = 64 * kConsumers;     // query rows a block
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;
};

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (p0, p1) = hi + lo: hi the pair rounded to T, lo the rest rounded to T
// (p - round(p) is exact in f32).
template <typename T>
__device__ __forceinline__ void split2(float p0, float p1, uint32_t& hi,
                                       uint32_t& lo) {
  const float h0 = to_f32(from_f32<T>(p0));
  const float h1 = to_f32(from_f32<T>(p1));
  hi = pack2<T>(h0, h1);
  lo = pack2<T>(p0 - h0, p1 - h1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = x + __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S = Q K^T of one tile, issued (not waited): DP / 16 k16 slices, Q of
// this warpgroup and K both K-major in 128-byte-swizzled atoms.
template <typename T, int DP>
__device__ __forceinline__ void issue_scores(float (&sc)[32], uint32_t q_wg,
                                             uint32_t q_atom_bytes,
                                             uint32_t k_tile) {
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;    // within the atom
    Wgmma<T>::ss_n64(
        sc, desc_sw128(q_wg + (kk / 4) * q_atom_bytes + off, 16, 1024),
        desc_sw128(k_tile + (kk / 4) * kAtomBytes + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P_hi V + P_lo V of one tile, issued (not waited): A from registers,
// V MN-major, 16 kv rows (2048 bytes) a k16 slice.
template <typename T, int DP>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         uint32_t (&p_hi)[4][4],
                                         uint32_t (&p_lo)[4][4],
                                         uint32_t v_tile) {
  fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_regs(p_hi[kk]);
    fence_regs(p_lo[kk]);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dv = desc_sw128(v_tile + kk * 2048, kAtomBytes, 1024);
    if constexpr (DP == 128) {
      Wgmma<T>::rs_n128_tb(o, p_hi[kk], dv, 1);
      Wgmma<T>::rs_n128_tb(o, p_lo[kk], dv, 1);
    } else {
      Wgmma<T>::rs_n64_tb(o, p_hi[kk], dv, 1);
      Wgmma<T>::rs_n64_tb(o, p_lo[kk], dv, 1);
    }
  }
  wgmma_commit();
}

// Pins the registers of an issued P V (o, P's fragments) after its wait,
// so that none of them is reused while the product reads or writes it.
template <int DP>
__device__ __forceinline__ void fence_pv(float (&o)[DP / 2],
                                         uint32_t (&p_hi)[4][4],
                                         uint32_t (&p_lo)[4][4]) {
  fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_regs(p_hi[kk]);
    fence_regs(p_lo[kk]);
  }
}

// The online softmax of one tile on the S accumulator layout, in base 2:
// scores times scale2 = scale * log2(e), so that exp(x - m) is exp2 of the
// scaled difference.  Under kMask the thread's rows (0, 1) attend to
// columns up to lim0, lim1 (the rest are -inf); a tile that lies wholly
// inside every row's range of its warpgroup skips the compares.  sc
// becomes P (times pscale), m (base 2) and l are updated, and alpha (the
// rescale of O) is returned.
template <bool kMask>
__device__ __forceinline__ void online_softmax(float (&sc)[32], int k0, int t,
                                               int lim0, int lim1,
                                               float scale2, float pscale,
                                               float& m0, float& m1,
                                               float& l0, float& l1,
                                               float& al0, float& al1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x0 = sc[4 * j + e] * scale2;
      float x1 = sc[4 * j + 2 + e] * scale2;
      if (kMask) {
        const int col = k0 + 8 * j + 2 * t + e;
        if (col > lim0) x0 = -INFINITY;
        if (col > lim1) x1 = -INFINITY;
      }
      sc[4 * j + e] = x0;
      sc[4 * j + 2 + e] = x1;
      mx0 = fmaxf(mx0, x0);
      mx1 = fmaxf(mx1, x1);
    }
  }
  const float mn0 = fmaxf(m0, quad_max(mx0));
  const float mn1 = fmaxf(m1, quad_max(mx1));
  al0 = exp2f(m0 - mn0);
  al1 = exp2f(m1 - mn1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float p0 = exp2f(sc[4 * j + e] - mn0);
      const float p1 = exp2f(sc[4 * j + 2 + e] - mn1);
      sum0 = sum0 + p0;
      sum1 = sum1 + p1;
      sc[4 * j + e] = p0 * pscale;
      sc[4 * j + 2 + e] = p1 * pscale;
    }
  }
  l0 = l0 * al0 + quad_sum(sum0);
  l1 = l1 * al1 + quad_sum(sum1);
  m0 = mn0;
  m1 = mn1;
}

// O *= alpha (per row), then P (in sc) split into the A fragments of the
// four k16 slices of the tile: slice kk holds columns 16 kk .. 16 kk + 15,
// which the S accumulator already lays out as the A fragment.
template <typename T, int DP>
__device__ __forceinline__ void rescale_and_split(float (&o)[DP / 2],
                                                  const float (&sc)[32],
                                                  float al0, float al1,
                                                  uint32_t (&p_hi)[4][4],
                                                  uint32_t (&p_lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    o[4 * j] = o[4 * j] * al0;
    o[4 * j + 1] = o[4 * j + 1] * al0;
    o[4 * j + 2] = o[4 * j + 2] * al1;
    o[4 * j + 3] = o[4 * j + 3] * al1;
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      split2<T>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], p_hi[kk][r],
                p_lo[kk][r]);
    }
  }
}

// Dynamic shared memory of one block: Q (DP / 64 atoms of kBM rows),
// kStages K and V tiles, the barriers, and 1024 bytes to align the base.
template <int DP>
constexpr size_t smem_bytes() {
  return (size_t)(DP / 64) * (Blocks<DP>::kBM * 128) +
         2 * (size_t)kStages * (DP / 64) * kAtomBytes +
         8 * (1 + 3 * kStages) + 1024;
}

template <typename T, int DP>
__global__ void __launch_bounds__(Blocks<DP>::kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             T* __restrict__ out, int h, int hkv, int s,
                             int d, float scale, int causal) {
  constexpr int kAtoms = DP / 64;
  constexpr int kConsumers = Blocks<DP>::kConsumers;
  constexpr int kBM = Blocks<DP>::kBM;
  constexpr uint32_t kQAtom = kBM * 128;
  constexpr uint32_t kTile = kAtoms * kAtomBytes;  // one K or V tile
  constexpr float kPScale = std::is_same<T, __half>::value ? 256.f : 1.f;
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  const uint32_t s_q = (smem_u32(tc_smem) + 1023u) & ~1023u;
  const uint32_t s_k = s_q + kAtoms * kQAtom;
  const uint32_t s_v = s_k + kStages * kTile;
  // barriers: Q full, then per stage K full, V full, stage free
  const uint32_t bar_q = s_v + kStages * kTile;
  const uint32_t bar_k = bar_q + 8;
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_free = bar_v + 8 * kStages;

  const int bh = blockIdx.x;
  const int kvh = (bh / h) * hkv + (bh % h) / (h / hkv);
  const int n_qt = (s + kBM - 1) / kBM;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kBM;   // longest first
  const int n_kt = causal ? (min(q0 + kBM, s) - 1) / kBN + 1
                          : (s + kBN - 1) / kBN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_k + 8 * st, 1);
      mbar_init(bar_v + 8 * st, 1);
      mbar_init(bar_free + 8 * st, 4 * kConsumers);   // every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread issues every load of the block
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      mbar_arrive_expect_tx(bar_q, kAtoms * kQAtom);
      for (int a = 0; a < kAtoms; ++a) {
        tma_load_3d(s_q + a * kQAtom, &tm_q, bar_q, 64 * a, q0, bh);
      }
      for (int i = 0; i < n_kt; ++i) {
        const int st = i % kStages;
        mbar_wait(bar_free + 8 * st, ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(bar_k + 8 * st, kTile);
        for (int a = 0; a < kAtoms; ++a) {
          tma_load_3d(s_k + st * kTile + a * kAtomBytes, &tm_k,
                      bar_k + 8 * st, 64 * a, i * kBN, kvh);
        }
        mbar_arrive_expect_tx(bar_v + 8 * st, kTile);
        for (int a = 0; a < kAtoms; ++a) {
          tma_load_3d(s_v + st * kTile + a * kAtomBytes, &tm_v,
                      bar_v + 8 * st, 64 * a, i * kBN, kvh);
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows [row_wg, row_wg + 64); this
    // thread holds rows r0 and r0 + 8, columns 8 j + 2 t + {0, 1}
    setmaxnreg_inc<Blocks<DP>::kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int row_wg = q0 + 64 * wg;
    const int r0 = row_wg + 16 * warp + lane / 4;
    // the last column each of the thread's two rows attends to
    const int lim0 = causal ? min(r0, s - 1) : s - 1;
    const int lim1 = causal ? min(r0 + 8, s - 1) : s - 1;
    // tiles with a column some row of the warpgroup attends to: a prefix
    // (none past S; a causal tile above all of its rows adds nothing)
    const int n_act = row_wg >= s ? 0
                      : causal    ? min(n_kt, (row_wg + 63) / kBN + 1)
                                  : n_kt;
    // the first tile with a column past the first row's last one: it and
    // the tiles after it are masked, those before it attended to whole
    const int first_masked = ((causal ? min(row_wg, s - 1) : s - 1) + 1) / kBN;
    const float scale2 = scale * 1.44269504088896341f;   // log2(e)
    const uint32_t q_wg = s_q + wg * 64 * 128;
    const auto k_tile = [&](int i) { return s_k + (i % kStages) * kTile; };
    const auto v_tile = [&](int i) { return s_v + (i % kStages) * kTile; };
    const auto wait_k = [&](int i) {
      mbar_wait(bar_k + 8 * (i % kStages), (i / kStages) & 1);
    };
    const auto wait_v = [&](int i) {
      mbar_wait(bar_v + 8 * (i % kStages), (i / kStages) & 1);
    };
    const auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_free + 8 * (i % kStages));
    };

    float o[DP / 2], sc[32];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    uint32_t p_hi[4][4], p_lo[4][4];
    float m0 = kMaxInit, m1 = kMaxInit, l0 = 0.f, l1 = 0.f, al0, al1;
    const auto softmax = [&](int i) {
      if (i >= first_masked) {
        online_softmax<true>(sc, i * kBN, t, lim0, lim1, scale2, kPScale,
                             m0, m1, l0, l1, al0, al1);
      } else {
        online_softmax<false>(sc, i * kBN, t, lim0, lim1, scale2, kPScale,
                              m0, m1, l0, l1, al0, al1);
      }
    };
    mbar_wait(bar_q, 0);

    // tile i's scores are issued before tile i - 1's P V, so the softmax
    // of tile i runs while the tensor cores multiply P V of tile i - 1;
    // O is rescaled once that product is done
    if (n_act > 0) {
      wait_k(0);
      issue_scores<T, DP>(sc, q_wg, kQAtom, k_tile(0));
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(0);
      rescale_and_split<T, DP>(o, sc, al0, al1, p_hi, p_lo);
      for (int i = 1; i < n_act; ++i) {
        wait_k(i);
        issue_scores<T, DP>(sc, q_wg, kQAtom, k_tile(i));
        wait_v(i - 1);
        issue_pv<T, DP>(o, p_hi, p_lo, v_tile(i - 1));
        wgmma_wait<1>();                     // the scores of tile i
        fence_regs(sc);
        softmax(i);
        wgmma_wait<0>();                     // P V of tile i - 1
        fence_pv<DP>(o, p_hi, p_lo);
        release(i - 1);
        rescale_and_split<T, DP>(o, sc, al0, al1, p_hi, p_lo);
      }
      wait_v(n_act - 1);
      issue_pv<T, DP>(o, p_hi, p_lo, v_tile(n_act - 1));
      wgmma_wait<0>();
      fence_pv<DP>(o, p_hi, p_lo);
      release(n_act - 1);
    }
    // the rest of the block's tiles: wait for them (so that no warpgroup
    // runs a stage ahead of the others) and release them
    for (int i = n_act; i < n_kt; ++i) {
      wait_k(i);
      wait_v(i);
      release(i);
    }

    if (n_act > 0) {
      const float den0 = fmaxf(l0, 1e-30f);
      const float den1 = fmaxf(l1, 1e-30f);
      T* o_bh = out + (long long)bh * s * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col >= d) break;
        if (r0 < s) {
          *reinterpret_cast<uint32_t*>(o_bh + (long long)r0 * d + col) =
              pack2<T>(o[4 * j] * (1.f / kPScale) / den0,
                       o[4 * j + 1] * (1.f / kPScale) / den0);
        }
        if (r0 + 8 < s) {
          *reinterpret_cast<uint32_t*>(o_bh + (long long)(r0 + 8) * d +
                                       col) =
              pack2<T>(o[4 * j + 2] * (1.f / kPScale) / den1,
                       o[4 * j + 3] * (1.f / kPScale) / den1);
        }
      }
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out,
           long long b, int h, int hkv, int s, int d, float scale,
           int causal, cudaStream_t stream) {
  constexpr bool half = std::is_same<T, __half>::value;
  CUtensorMap tm_q, tm_k, tm_v;
  constexpr int kBM = Blocks<DP>::kBM;
  int err = encode_3d_sw128(&tm_q, q, half, d, s, b * h, kBM);
  if (!err) err = encode_3d_sw128(&tm_k, k, half, d, s, b * hkv, kBN);
  if (!err) err = encode_3d_sw128(&tm_v, v, half, d, s, b * hkv, kBN);
  if (err) return -err;
  constexpr size_t smem = smem_bytes<DP>();
  auto kernel = flash_attention_wgmma_kernel<T, DP>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)(b * h), (unsigned)((s + kBM - 1) / kBM));
  kernel<<<grid, Blocks<DP>::kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, (T*)out, h, hkv, s, d, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out,
             long long b, int h, int hkv, int s, int d, float scale,
             int causal, cudaStream_t stream) {
  if (d <= 64) {
    return launch<T, 64>(q, k, v, out, b, h, hkv, s, d, scale, causal,
                         stream);
  }
  return launch<T, 128>(q, k, v, out, b, h, hkv, s, d, scale, causal,
                        stream);
}

}  // namespace tc

}  // namespace

extern "C" {

// out[b, h, s, d] = softmax(scale * q k^T (masked)) v over contiguous
// device tensors q [b, h, s, d], k and v [b, hkv, s, d], out like q, all
// of one dtype: 0 float32, 1 float16, 2 bfloat16.  bh = b * h.  Returns
// the cudaError_t of the launch (0 on success).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int dtype, long long bh, int h, int hkv,
                          int s, int d, float scale, int causal,
                          void* stream) {
  if (bh < 1 || bh > 0x7fffffffLL || h < 1 || hkv < 1 || h % hkv ||
      bh % h || s < 1 || (s + kRows - 1) / kRows > 65535 || d < 1 ||
      d > kMaxD || dtype < 0 || dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch_d<float>(q, k, v, out, bh, h, hkv, s, d, scale, causal,
                           st);
  }
  if (dtype == 1) {
    return launch_d<__half>(q, k, v, out, bh, h, hkv, s, d, scale, causal,
                            st);
  }
  return launch_d<__nv_bfloat16>(q, k, v, out, bh, h, hkv, s, d, scale,
                                 causal, st);
}

// The tensor-core route: the same function over f16 (dtype 1) or bf16
// (dtype 2) operands, q [b, h, s, d], k and v [b, hkv, s, d], out like q,
// contiguous with 16-byte-aligned bases, d a multiple of 8 up to 128.
// Returns the cudaError_t of the launch (0 on success), or minus the
// CUresult of a tensor map the driver refuses.
int repro_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                void* out, int dtype, long long b, int h,
                                int hkv, int s, int d, float scale,
                                int causal, void* stream) {
  const long long bh = b * h;
  const auto misaligned = [](const void* p) {
    return ((unsigned long long)p & 15ull) != 0;
  };
  if (b < 1 || h < 1 || bh > 0x7fffffffLL || hkv < 1 || h % hkv || s < 1 ||
      (s + 127) / 128 > 65535 || d < 8 || d > kMaxD || d % 8 ||
      (dtype != 1 && dtype != 2) || misaligned(q) || misaligned(k) ||
      misaligned(v) || misaligned(out)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    return tc::launch_d<__half>(q, k, v, out, b, h, hkv, s, d, scale,
                                causal, st);
  }
  return tc::launch_d<__nv_bfloat16>(q, k, v, out, b, h, hkv, s, d, scale,
                                     causal, st);
}

}  // extern "C"
