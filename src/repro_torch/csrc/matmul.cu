// Matrix product with an f32 accumulator for the functional simulator's
// DNN stage (Hopper, sm_90a): out[M, N] = f32(a[M, K]) @ f32(b[K, N]),
// row-major, any M, N, K.  a and b are each f32, f16 or bf16 (converted
// to f32 as they are loaded, so no f32 copy of an operand is made); out
// is in a's dtype, rounded once (to nearest even) from the f32 sums, as
// the reference's Pallas kernel casts its f32 accumulator.
//
// Replaces the TPU kernel repro/kernels/matmul.py::_matmul_kernel (the
// pl.pallas_call of matmul, :52).  The TPU kernel pads every dimension to
// its 128 blocks in device memory and carries the accumulator in VMEM
// across a sequential K grid dimension.  Neither translates: blocks run in
// parallel here, so the ragged edges are masked (or zero-filled by TMA)
// inside the kernels and a long K is split across blocks instead.
//
// Three kernels, one per route; the wrapper (repro_torch/kernels/
// matmul.py::plan) picks the route from the shapes, dtypes and alignment
// alone, before the launch, and a route whose launch fails raises:
//   * matmul_wgmma_kernel (the tensor cores): a and b of one half dtype,
//     M > 8, K and N multiples of 8 and 16-byte-aligned bases (TMA's
//     conditions on global strides and addresses).  A block owns 128 x BN
//     outputs (BN = 128, or 64 when 128-wide tiles would leave SMs idle):
//     two consumer warpgroups of 64 rows run wgmma m64nBNk16 and one
//     producer warpgroup, whose registers setmaxnreg sheds, issues the TMA
//     loads of 64-deep A and B tiles into a ring of kStages stages, each
//     completing on an mbarrier.  A is K-major (128-byte swizzled atoms of
//     64 K-elements, +32 B a k16 slice); the row-major b[K, N] is the
//     MN-major B operand, BN / 64 atoms of 64 columns a tile (LBO = the
//     atom stride, +2048 B a k16 slice), as V is in K9's P V.  TMA
//     zero-fills past M, N and K, which adds exact zeros.  Products of two
//     half values are exact in f32, but the tensor cores' f32 accumulation
//     is not IEEE round-to-nearest: it truncates, and with positive
//     operands the bias adds up along K (half an ulp of the sum a k16
//     step on average: 2.1 times the 1e-5 rule at K = 16384 in the CPU
//     emulation of tests/test_torch_matmul.py).  So each 64-deep tile's four
//     wgmmas run into a fresh accumulator, which is then added into the
//     block's f32 sums with an IEEE add (the "promotion"): the truncation
//     is bounded by one tile's share of the sum.
//   * matmul_tile_kernel (FP32 on the CUDA cores, M > 8 otherwise: f32,
//     mixed dtypes, unaligned operands): a block of BN / 8 x 16 threads
//     owns 128 x BN outputs, 8 x 8 a thread (rows ty + 16 i, columns
//     4 tx + j and BN / 2 + 4 tx + j), over 16-deep shared tiles of A (as
//     copied, rows padded by 16 bytes) and B in two buffers: the next
//     tile's loads are in flight (cp.async, 16 bytes at a time, where both
//     operands are 16-byte aligned row by row; else loads into registers
//     that are stored after the products) while this tile multiplies.
//     Explicit fmaf, 4 K values of 8 rows and 8 columns a step.  TF32
//     would compute another function.
//   * matmul_skinny_kernel (M <= 8, the DNN's M = 1 rows): a block reads
//     128 columns of B, 8 warps over interleaved K rows, each lane 4
//     columns x M rows in registers; the warps' partial sums meet in
//     shared memory and add in warp order.  A 128-row tile would spend
//     127/128 of its multiplies on masked rows.
// When the output tiles leave SMs idle (the wgmma route: half of them;
// the DNN's [1, 64000] @ [64000, 900] makes 8 column tiles for 132 SMs, to
// stream 230 MB), K is cut into S slices of kps rows, blockIdx.z (tile,
// wgmma) or blockIdx.y (skinny) picks the slice, each slice writes its f32
// partial sums to an [S, M, N] scratch, and matmul_sum_kernel adds the S
// partials in slice order and rounds them into out.  No atomics: the
// result is the same from run to run.  Without a split (S = 1) the main
// kernel rounds its sums into out itself: one launch, no scratch.
//
// What bounds it on the card: for the DNN's GEMV the bytes, each operand
// read once and out written once (f32: 230.4 MB, 69 us at 3.35 TB/s; half
// that for bf16 operands); for a square 1024^3 product the operations,
// 2 M N K at the 67 TFLOP/s FP32 rate (32 us), or at the tensor cores'
// 989 TFLOP/s for two half operands (2.2 us).  The summation order
// differs from the plain-torch twin's, so the two agree within
// 1e-5 * (|a| @ |b|) in f32, not bit for bit (and one rounding of a half
// output dtype beyond that).
//
// Plain C interfaces (repro_matmul, repro_matmul_wgmma) for ctypes.

#include <cuda_runtime.h>
#include <stdint.h>
#include <time.h>

#include <type_traits>

#include "dtypes.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;          // the sum kernel
constexpr int kSkinnyMaxM = 8;
constexpr int kSkinnyCols = 128;

// ----------------------------------------------------------- epilogue

// Stores one f32 sum of output (row, col): rounded into out's dtype when
// the block owns the whole K range, else into this slice's f32 partials.
template <typename TO>
__device__ __forceinline__ void put(void* dst, int direct, long long i,
                                    float x) {
  if (direct) {
    static_cast<TO*>(dst)[i] = from_f32<TO>(x);
  } else {
    static_cast<float*>(dst)[i] = x;
  }
}

// ------------------------------------------------------------ tile route

constexpr int kTileBM = 128;
constexpr int kTileBK = 16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = hopper::smem_u32(dst);
  const int bytes = valid ? 16 : 0;      // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                   : "memory");
}

// 4 consecutive elements of a shared tile as f32 (one 16- or 8-byte load)
__device__ __forceinline__ void ld4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void ld4(const __half* p, float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
  o[0] = lo.x;
  o[1] = lo.y;
  o[2] = hi.x;
  o[3] = hi.y;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = lo.x;
  o[1] = lo.y;
  o[2] = hi.x;
  o[3] = hi.y;
}

// One 128 x BN output tile over the block's K slice.  VEC: both operands
// are copied 16 bytes at a time with cp.async (16-byte-aligned bases, rows
// of 16-byte multiples); else element by element through registers.  (A
// runtime choice between the two kept both paths' registers live: 250 a
// thread against 165, two blocks an SM instead of three.)
template <typename TA, typename TB, int BN, bool VEC>
__global__ void __launch_bounds__(BN / 8 * 16)
matmul_tile_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                   void* __restrict__ dst, int direct, int m, int n, int k,
                   int kps) {
  constexpr int kT = BN / 8 * 16;               // threads
  constexpr int kTX = BN / 8;
  // elements of one padded A row: 16 bytes of padding keep the rows of a
  // warp's loads in distinct banks and 16-byte aligned
  constexpr int kLdA = kTileBK + 16 / (int)sizeof(TA);
  constexpr int kEA = 16 / (int)sizeof(TA);     // elements a 16-byte chunk
  constexpr int kEB = 16 / (int)sizeof(TB);
  constexpr int kChA = kTileBM * kTileBK / kEA; // 16-byte chunks a tile
  constexpr int kChB = kTileBK * BN / kEB;
  constexpr int kRegA = kTileBM * kTileBK / kT; // elements a thread stages
  constexpr int kRegB = kTileBK * BN / kT;
  __shared__ __align__(16) TA s_a[2][kTileBM * kLdA];
  __shared__ __align__(16) TB s_b[2][kTileBK * BN];

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int m0 = blockIdx.y * kTileBM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * kps;
  const int k_end = min(k, k_begin + kps);
  const int n_kt = k_end > k_begin ? (k_end - k_begin + kTileBK - 1) / kTileBK
                                   : 0;
  TA ra[VEC ? 1 : kRegA];
  TB rb[VEC ? 1 : kRegB];

  // tile kt of the slice into buffer buf: issued here, landed by finish()
  const auto issue = [&](int kt, int buf) {
    const int k0 = k_begin + kt * kTileBK;
    if constexpr (VEC) {
      for (int c = tid; c < kChA; c += kT) {
        const int r = c / (kTileBK / kEA);
        const int e = (c % (kTileBK / kEA)) * kEA;
        const bool ok = m0 + r < m && k0 + e < k_end;
        cp_async16(&s_a[buf][r * kLdA + e],
                   ok ? a + (long long)(m0 + r) * k + k0 + e : a, ok);
      }
      for (int c = tid; c < kChB; c += kT) {
        const int r = c / (BN / kEB);
        const int e = (c % (BN / kEB)) * kEB;
        const bool ok = k0 + r < k_end && n0 + e < n;
        cp_async16(&s_b[buf][r * BN + e],
                   ok ? b + (long long)(k0 + r) * n + n0 + e : b, ok);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRegA; ++j) {
        const int i = tid + j * kT;
        const int r = i / kTileBK;
        const int c = i % kTileBK;
        ra[j] = (m0 + r < m && k0 + c < k_end)
                    ? a[(long long)(m0 + r) * k + k0 + c]
                    : from_f32<TA>(0.f);
      }
#pragma unroll
      for (int j = 0; j < kRegB; ++j) {
        const int i = tid + j * kT;
        const int r = i / BN;
        const int c = i % BN;
        rb[j] = (k0 + r < k_end && n0 + c < n)
                    ? b[(long long)(k0 + r) * n + n0 + c]
                    : from_f32<TB>(0.f);
      }
    }
  };
  const auto finish = [&](int buf) {
    if constexpr (VEC) {
      cp_async_commit_wait();
    } else {
#pragma unroll
      for (int j = 0; j < kRegA; ++j) {
        const int i = tid + j * kT;
        s_a[buf][(i / kTileBK) * kLdA + i % kTileBK] = ra[j];
      }
#pragma unroll
      for (int j = 0; j < kRegB; ++j) s_b[buf][tid + j * kT] = rb[j];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  if (n_kt > 0) {
    issue(0, 0);
    finish(0);
  }
  __syncthreads();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) issue(kt + 1, buf ^ 1);
    const TA* sa = s_a[buf];
    const TB* sb = s_b[buf];
#pragma unroll
    for (int k4 = 0; k4 < kTileBK; k4 += 4) {
      float av[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) ld4(sa + (ty + 16 * i) * kLdA + k4, av[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b0[4], b1[4];
        ld4(sb + (k4 + kk) * BN + 4 * tx, b0);
        ld4(sb + (k4 + kk) * BN + BN / 2 + 4 * tx, b1);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(av[i][kk], j < 4 ? b0[j] : b1[j - 4], acc[i][j]);
          }
        }
      }
    }
    if (kt + 1 < n_kt) finish(buf ^ 1);
    __syncthreads();
  }

  const long long plane = (long long)blockIdx.z * m * n;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? 4 * tx + j : BN / 2 + 4 * tx + j - 4);
      if (col < n) put<TA>(dst, direct, plane + (long long)row * n + col,
                           acc[i][j]);
    }
  }
}

// ---------------------------------------------------------- skinny route

// MR: the row capacity, the least of 1, 2, 4, 8 that holds m, so that an
// M = 1 product keeps 4 accumulators a thread, not 32.  WARPS: 8 when K is
// split across blocks; more when one block walks the whole K of its
// columns (a tiny product such as the DNN's (1, 900, 2) is one block,
// bound by the latency of its warps' dependent loads).  TO: f32 partial
// sums (or an f32 out), or a's half dtype when one slice writes out.  The
// output type is a template parameter, not a branch: with a runtime
// choice in the epilogue the compiler scheduled the half-B loop's loads
// with less overlap (40 -> 37 registers) and the bandwidth-bound GEMV ran
// 2.8x slower on the card.
template <int MR, int WARPS, typename TA, typename TB, typename TO>
__global__ void __launch_bounds__(WARPS * 32)
matmul_skinny_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                     TO* __restrict__ out, int m, int n, int k, int kps) {
  constexpr int kWarps = WARPS;
  constexpr int kThreads = WARPS * 32;
  __shared__ float s_red[kWarps][MR][kSkinnyCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kSkinnyCols;
  const int k_begin = blockIdx.y * kps;
  const int k_end = min(k, k_begin + kps);
  int col[4];
  bool ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    col[j] = n0 + lane + 32 * j;
    ok[j] = col[j] < n;
  }
  float acc[MR][4];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  }
#pragma unroll 4
  for (int kk = k_begin + warp; kk < k_end; kk += kWarps) {
    const TB* brow = b + (long long)kk * n;
    float bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = ok[j] ? to_f32(__ldg(brow + col[j])) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r < m) {
        const float av = to_f32(__ldg(a + (long long)r * k + kk));
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(av, bv[j], acc[r][j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MR; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s_red[warp][r][lane + 32 * j] = acc[r][j];
  }
  __syncthreads();
  TO* o = out + (long long)blockIdx.y * m * n;
  for (int idx = threadIdx.x; idx < m * kSkinnyCols; idx += kThreads) {
    const int r = idx / kSkinnyCols;
    const int c = idx - r * kSkinnyCols;
    if (n0 + c >= n) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s = s + s_red[w][r][c];
    o[(long long)r * n + n0 + c] = from_f32<TO>(s);
  }
}

template <typename TO>
__global__ void __launch_bounds__(kThreads)
matmul_sum_kernel(const float* __restrict__ part, TO* __restrict__ out,
                  int splits, long long mn) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s = s + part[(long long)z * mn + i];
  out[i] = from_f32<TO>(s);
}

// ----------------------------------------------------------- wgmma route

namespace tc {

using namespace hopper;

constexpr int kBM = 128;                 // two consumer warpgroups of 64
constexpr int kBK = 64;                  // K depth of a stage: one atom
constexpr int kStages = 4;
constexpr int kThreads = 384;            // 2 consumer + 1 producer groups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr uint32_t kABytes = kBM * 128;  // 128 rows x 64 K-elements
constexpr uint32_t kBAtom = kBK * 128;   // 64 K-rows x 64 N-columns

template <int BN>
struct Stage {
  static constexpr uint32_t kBytes = kABytes + (BN / 64) * kBAtom;
};

// Dynamic shared memory: the stages, the full and empty barriers of each,
// and 1024 bytes to align the base.
template <int BN>
constexpr size_t smem_bytes() {
  return (size_t)kStages * Stage<BN>::kBytes + 16 * kStages + 1024;
}

// (lo, hi) rounded to T (to nearest even), packed as one 4-byte store
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

// acc (+)= the stage's A (this warpgroup's 64 rows) . B, four k16 slices
// into `part` from zero, issued and waited.
template <typename T, int BN>
__device__ __forceinline__ void tile_products(float (&part)[BN / 2],
                                              uint32_t a_wg, uint32_t b_st) {
  fence_regs(part);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = desc_sw128(a_wg + kk * 32, 16, 1024);
    const uint64_t db = desc_sw128(b_st + kk * 2048, kBAtom, 1024);
    if constexpr (BN == 128) {
      Wgmma<T>::ss_n128_tb(part, da, db, kk > 0);
    } else {
      Wgmma<T>::ss_n64_tb(part, da, db, kk > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(part);
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_b,
                    void* __restrict__ dst, int direct, int m, int n, int k,
                    int kps) {
  constexpr uint32_t kStage = Stage<BN>::kBytes;
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  const uint32_t base = (smem_u32(tc_smem) + 1023u) & ~1023u;
  const uint32_t bar_full = base + kStages * kStage;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * kps;
  const int k_end = min(k, k_begin + kps);
  const int n_kt = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 8);   // every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every load of the block
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      tma_prefetch(&tm_a);
      tma_prefetch(&tm_b);
      for (int i = 0; i < n_kt; ++i) {
        const int st = i % kStages;
        const uint32_t s_st = base + st * kStage;
        const int k0 = k_begin + i * kBK;
        mbar_wait(bar_empty + 8 * st, ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(bar_full + 8 * st, kStage);
        tma_load_3d(s_st, &tm_a, bar_full + 8 * st, k0, m0, 0);
        for (int at = 0; at < BN / 64; ++at) {
          tma_load_3d(s_st + kABytes + at * kBAtom, &tm_b, bar_full + 8 * st,
                      n0 + 64 * at, k0, 0);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [m0 + 64 wg, + 64); this thread holds rows
  // r0 and r0 + 8, columns 8 j + 2 t + {0, 1}
  setmaxnreg_inc<kConsumerRegs>();
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int r0 = m0 + 64 * wg + 16 * warp + lane / 4;
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
  for (int i = 0; i < n_kt; ++i) {
    const int st = i % kStages;
    const uint32_t s_st = base + st * kStage;
    mbar_wait(bar_full + 8 * st, (i / kStages) & 1);
    tile_products<T, BN>(part, s_st + wg * 64 * 128, s_st + kABytes);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = acc[j] + part[j];   // IEEE
  }

  const long long plane = (long long)blockIdx.z * m * n;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col >= n) break;                  // n % 8 == 0: pairs stay whole
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= m) continue;
      const long long at = plane + (long long)row * n + col;
      const float x0 = acc[4 * j + 2 * h];
      const float x1 = acc[4 * j + 2 * h + 1];
      if (direct) {
        *reinterpret_cast<uint32_t*>(static_cast<T*>(dst) + at) =
            pack2<T>(x0, x1);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(dst) + at) =
            make_float2(x0, x1);
      }
    }
  }
}

template <typename T, int BN>
int launch(const void* a, const void* b, void* dst, int direct, int m, int n,
           int k, int splits, int kps, cudaStream_t s) {
  constexpr bool half = std::is_same<T, __half>::value;
  CUtensorMap tm_a, tm_b;
  int err = encode_3d_sw128(&tm_a, a, half, k, m, 1, kBM);
  if (!err) err = encode_3d_sw128(&tm_b, b, half, n, k, 1, kBK);
  if (err) return -err;
  constexpr size_t smem = smem_bytes<BN>();
  auto kernel = matmul_wgmma_kernel<T, BN>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((n + BN - 1) / BN),
                  (unsigned)((m + kBM - 1) / kBM), (unsigned)splits);
  kernel<<<grid, kThreads, smem, s>>>(tm_a, tm_b, dst, direct, m, n, k, kps);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ------------------------------------------------------------ launching

template <int MR, int WARPS, typename TA, typename TB, typename TO>
void launch_skinny_mr(const TA* a, const TB* b, TO* out, int m, int n, int k,
                      int splits, int kps, cudaStream_t s) {
  const dim3 grid((unsigned)((n + kSkinnyCols - 1) / kSkinnyCols),
                  (unsigned)splits);
  matmul_skinny_kernel<MR, WARPS, TA, TB, TO>
      <<<grid, WARPS * 32, 0, s>>>(a, b, out, m, n, k, kps);
}

// Split K: 8 warps a block; one slice: 32 warps (16, 8 at MR 4, 8, so the
// reduction's shared memory stays within 32 KB).
template <typename TA, typename TB, typename TO>
void launch_skinny(const TA* a, const TB* b, TO* out, int m, int n, int k,
                   int splits, int kps, cudaStream_t s) {
  const bool one = splits == 1;
  if (m == 1) {
    one ? launch_skinny_mr<1, 32>(a, b, out, m, n, k, splits, kps, s)
        : launch_skinny_mr<1, 8>(a, b, out, m, n, k, splits, kps, s);
  } else if (m == 2) {
    one ? launch_skinny_mr<2, 32>(a, b, out, m, n, k, splits, kps, s)
        : launch_skinny_mr<2, 8>(a, b, out, m, n, k, splits, kps, s);
  } else if (m <= 4) {
    one ? launch_skinny_mr<4, 16>(a, b, out, m, n, k, splits, kps, s)
        : launch_skinny_mr<4, 8>(a, b, out, m, n, k, splits, kps, s);
  } else {
    launch_skinny_mr<8, 8>(a, b, out, m, n, k, splits, kps, s);
  }
}

template <typename TA, typename TB, int BN>
void launch_tile(const TA* a, const TB* b, void* dst, int direct, int m,
                 int n, int k, int splits, int kps, int vec, cudaStream_t s) {
  const dim3 grid((unsigned)((n + BN - 1) / BN),
                  (unsigned)((m + kTileBM - 1) / kTileBM), (unsigned)splits);
  if (vec) {
    matmul_tile_kernel<TA, TB, BN, true><<<grid, BN / 8 * 16, 0, s>>>(
        a, b, dst, direct, m, n, k, kps);
  } else {
    matmul_tile_kernel<TA, TB, BN, false><<<grid, BN / 8 * 16, 0, s>>>(
        a, b, dst, direct, m, n, k, kps);
  }
}

template <typename TA, typename TB>
void launch_main(const void* a, const void* b, void* dst, int direct, int m,
                 int n, int k, int splits, int kps, int route, int tile_n,
                 int vec, cudaStream_t s) {
  const TA* pa = (const TA*)a;
  const TB* pb = (const TB*)b;
  if (route == 1) {
    if (direct) {
      launch_skinny(pa, pb, (TA*)dst, m, n, k, splits, kps, s);
    } else {
      launch_skinny(pa, pb, (float*)dst, m, n, k, splits, kps, s);
    }
  } else if (tile_n == 128) {
    launch_tile<TA, TB, 128>(pa, pb, dst, direct, m, n, k, splits, kps, vec,
                             s);
  } else {
    launch_tile<TA, TB, 64>(pa, pb, dst, direct, m, n, k, splits, kps, vec,
                            s);
  }
}

template <typename TA>
void launch_main_a(const void* a, const void* b, int b_dtype, void* dst,
                   int direct, int m, int n, int k, int splits, int kps,
                   int route, int tile_n, int vec, cudaStream_t s) {
  if (b_dtype == 0) {
    launch_main<TA, float>(a, b, dst, direct, m, n, k, splits, kps, route,
                           tile_n, vec, s);
  } else if (b_dtype == 1) {
    launch_main<TA, __half>(a, b, dst, direct, m, n, k, splits, kps, route,
                            tile_n, vec, s);
  } else {
    launch_main<TA, __nv_bfloat16>(a, b, dst, direct, m, n, k, splits, kps,
                                   route, tile_n, vec, s);
  }
}

// The [S, M, N] partials into out (slice order), rounded to out's dtype.
int launch_sum(const float* part, void* out, int dtype, int splits,
               long long mn, cudaStream_t s) {
  const unsigned nb = (unsigned)((mn + kThreads - 1) / kThreads);
  if (dtype == 0) {
    matmul_sum_kernel<float><<<nb, kThreads, 0, s>>>(part, (float*)out,
                                                     splits, mn);
  } else if (dtype == 1) {
    matmul_sum_kernel<__half><<<nb, kThreads, 0, s>>>(part, (__half*)out,
                                                      splits, mn);
  } else {
    matmul_sum_kernel<__nv_bfloat16><<<nb, kThreads, 0, s>>>(
        part, (__nv_bfloat16*)out, splits, mn);
  }
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" {

// The CUDA-core routes: out[m, n] = a[m, k] @ b[k, n], contiguous device
// pointers of dtypes a_dtype (also out's) and b_dtype: 0 float32, 1
// float16, 2 bfloat16.  route 1: the skinny kernel (m <= 8); route 0: the
// tile kernel, tile_n 128 or 64 columns a block.  K is cut into `splits`
// slices of `kps` rows (kps a multiple of 16, splits * kps >= k); with one
// slice the kernel rounds its sums into out, with more each writes
// part[splits, m, n] (f32) and a second launch adds them (in slice order)
// into out.  Returns the cudaError_t of the launches (0 on success).
int repro_matmul(const void* a, const void* b, void* out, float* part,
                 int a_dtype, int b_dtype, int m, int n, int k, int splits,
                 int kps, int route, int tile_n, void* stream) {
  if (m < 1 || n < 1 || k < 0 || splits < 1 || splits > 65535 || kps < 1 ||
      kps % 16 || (long long)splits * kps < k || route < 0 || route > 1 ||
      (route == 1 && m > kSkinnyMaxM) ||
      (route == 0 && tile_n != 128 && tile_n != 64) ||
      (m + kTileBM - 1) / kTileBM > 65535 || a_dtype < 0 || a_dtype > 2 ||
      b_dtype < 0 || b_dtype > 2 || (splits > 1 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int direct = splits == 1;
  void* dst = direct ? out : (void*)part;
  // cp.async moves 16 bytes: bases and rows of both operands aligned
  const int a_size = a_dtype == 0 ? 4 : 2;
  const int b_size = b_dtype == 0 ? 4 : 2;
  const int vec = aligned16(a) && aligned16(b) && (k * a_size) % 16 == 0 &&
                  (n * b_size) % 16 == 0;
  if (a_dtype == 0) {
    launch_main_a<float>(a, b, b_dtype, dst, direct, m, n, k, splits, kps,
                         route, tile_n, vec, s);
  } else if (a_dtype == 1) {
    launch_main_a<__half>(a, b, b_dtype, dst, direct, m, n, k, splits, kps,
                          route, tile_n, vec, s);
  } else {
    launch_main_a<__nv_bfloat16>(a, b, b_dtype, dst, direct, m, n, k, splits,
                                 kps, route, tile_n, vec, s);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  return launch_sum(part, out, a_dtype, splits, (long long)m * n, s);
}

// The tensor-core route: a [m, k] and b [k, n] of one half dtype (1
// float16, 2 bfloat16), out [m, n] of it; m > 8, k and n multiples of 8
// (k > 0), every base 16-byte aligned.  tile_n 128 or 64 columns a block;
// K cut into `splits` slices of `kps` rows (kps a multiple of 64) as
// repro_matmul cuts it.  Returns the cudaError_t of the launches (0 on
// success), or minus the CUresult of a tensor map the driver refuses.
int repro_matmul_wgmma(const void* a, const void* b, void* out, float* part,
                       int dtype, int m, int n, int k, int splits, int kps,
                       int tile_n, void* stream) {
  if (m <= kSkinnyMaxM || n < 8 || k < 8 || n % 8 || k % 8 || splits < 1 ||
      splits > 65535 || kps < 1 || kps % tc::kBK ||
      (long long)splits * kps < k || (tile_n != 128 && tile_n != 64) ||
      (m + tc::kBM - 1) / tc::kBM > 65535 || (dtype != 1 && dtype != 2) ||
      !aligned16(a) || !aligned16(b) || !aligned16(out) ||
      (splits > 1 && (part == nullptr || !aligned16(part)))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int direct = splits == 1;
  void* dst = direct ? out : (void*)part;
  int err;
  if (dtype == 1) {
    err = tile_n == 128
              ? tc::launch<__half, 128>(a, b, dst, direct, m, n, k, splits,
                                        kps, s)
              : tc::launch<__half, 64>(a, b, dst, direct, m, n, k, splits,
                                       kps, s);
  } else {
    err = tile_n == 128
              ? tc::launch<__nv_bfloat16, 128>(a, b, dst, direct, m, n, k,
                                               splits, kps, s)
              : tc::launch<__nv_bfloat16, 64>(a, b, dst, direct, m, n, k,
                                              splits, kps, s);
  }
  if (err || direct) return err;
  return launch_sum(part, out, dtype, splits, (long long)m * n, s);
}

// Host microseconds of encoding the wgmma route's two tensor maps for an
// [m, k] @ [k, n] product, averaged over `reps` encodes (what each launch
// of that route spends before it launches); -1 without the driver's
// encoder.
double repro_matmul_encode_us(const void* a, const void* b, int dtype, int m,
                              int n, int k, int reps) {
  CUtensorMap tm_a, tm_b;
  const bool half = dtype == 1;
  struct timespec t0, t1;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  for (int i = 0; i < reps; ++i) {
    if (hopper::encode_3d_sw128(&tm_a, a, half, k, m, 1, tc::kBM) ||
        hopper::encode_3d_sw128(&tm_b, b, half, n, k, 1, tc::kBK)) {
      return -1.0;
    }
  }
  clock_gettime(CLOCK_MONOTONIC, &t1);
  return ((t1.tv_sec - t0.tv_sec) * 1e6 + (t1.tv_nsec - t0.tv_nsec) * 1e-3) /
         (reps > 0 ? reps : 1);
}

}  // extern "C"
