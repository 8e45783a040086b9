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
// parallel here, so the kv walk is a loop inside the block: one block owns
// one tile of 64 query rows of one (batch, head) and walks the kv tiles of
// 64 rows, staging each (K and V, converted to f32) in dynamic shared
// memory.  Causal blocks stop at the diagonal tile, as the TPU kernel skips
// the blocks above it, and a warp whose 8 rows all lie above a kv tile
// skips that tile's arithmetic (it would add exactly nothing).  The block
// sizes do not change the function, and any S >= 1 is taken: rows and
// columns past S are masked in the kernel, not padded in memory.
//
// 8 warps, each owning 8 query rows:
//   * Q K^T: lane j scores kv rows j and j + 32 against the warp's 8 rows,
//     explicit fmaf over d in order from 0 (the build has --fmad=false).
//     K rows are padded by one float, so the 32 lanes' reads of one column
//     fall in 32 banks; the query rows are read as float4 broadcasts.
//   * softmax: warp-shuffle max and sum (xor butterflies, the same order
//     on every run); masked scores are -inf against a running max that
//     starts at -1e30, so a fully masked row of a tile gives exp(-inf) = 0
//     and alpha = 1: it adds nothing, never NaN.  expf, not __expf.
//   * P V: the warp's probabilities go through shared memory; lane c owns
//     columns c, c + 32, ... of the f32 accumulator of each of its rows.
// No atomics: each output row is written by one block, so two runs agree
// bit for bit.  Head dims up to kMaxD = 128 are taken (staged as 32, 64 or
// 128 columns, zero-filled past D); the wrapper's _MAX_D holds the same
// cap and raises above it.  The launch is refused (cudaErrorInvalidValue)
// past the cap or the grid's limits.
//
// What bounds it on the card: the operations, 4 D per unmasked score (2 D
// for Q K^T, 2 D for P V): for qwen2-7b's attention at S = 4096 (H = 28,
// Hkv = 4, D = 128, causal) 1.20e11, 1.80 ms at the 67 TFLOP/s FP32 rate
// in f32.  With f16/bf16 operands the Q K^T products are exact in f32 and
// fit the tensor cores' 989 TFLOP/s; only P V needs FP32, 0.96 ms.  The
// bytes (q, k, v read once, out written once) take ~0.02 ms.  This simple
// design reads shared memory for every few FMAs and stages K/V without
// overlapping the copy.  It computes in FP32 because the reference's
// kernel body does: the tensor cores would round P (and f32 inputs) to
// bf16 or TF32, which is another function.
//
// Plain C interface (repro_flash_attention) for ctypes; the Python wrapper
// is repro_torch/kernels/flash_attention.py::flash_attention.

#include <cuda_runtime.h>
#include <math.h>

#include "dtypes.cuh"

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
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int h,
                       int hkv, int s, int d, float scale, int causal) {
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
int launch(const void* q, const void* k, const void* v, void* out,
           long long bh, int h, int hkv, int s, int d, float scale,
           int causal, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<DP>();
  auto kernel = flash_attention_kernel<T, DP>;
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

}  // extern "C"
