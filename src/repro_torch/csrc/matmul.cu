// Matrix product with an f32 accumulator for the functional simulator's
// DNN stage (Hopper, sm_90a): out[M, N] = a[M, K] @ b[K, N], all f32,
// row-major, any M, N, K.
//
// Replaces the TPU kernel repro/kernels/matmul.py::_matmul_kernel (the
// pl.pallas_call of matmul, :52).  The TPU kernel pads every dimension to
// its 128 blocks in device memory and carries the accumulator in VMEM
// across a sequential K grid dimension.  Neither translates: blocks run in
// parallel here, so the ragged edges are masked inside the kernels and a
// long K is split across blocks instead.
//
// Two main kernels, one per shape class, both on CUDA cores in FP32 with
// explicit fmaf (TF32 or the tensor cores would compute another
// function):
//   * matmul_tile_kernel (M > 8): a 64 x 64 output tile per block of 256
//     threads, each thread 4 x 4 outputs; 64 x 16 tiles of A (stored
//     transposed) and 16 x 64 tiles of B staged in shared memory.
//   * matmul_skinny_kernel (M <= 8, the DNN's M = 1 rows): a block reads
//     128 columns of B, 8 warps over interleaved K rows, each lane 4
//     columns x M rows in registers; the warps' partial sums meet in
//     shared memory and add in warp order.  A 64-row tile would spend
//     63/64 of its multiplies on masked rows.
// When the output tiles are fewer than the card's SMs (the DNN's
// [1, 64000] @ [64000, 900] makes 8 column tiles for 132 SMs, to stream
// 230 MB), K is cut into S slices of kps rows, blockIdx.z (tile) or
// blockIdx.y (skinny) picks the slice, each slice writes its partial sums
// to an [S, M, N] f32 scratch, and matmul_sum_kernel adds the S partials
// in slice order.  No atomics: the result is the same from run to run.
// The wrapper (repro_torch/kernels/matmul.py) picks the kernel and S and
// allocates the scratch.
//
// What bounds it on the card: for the DNN's GEMV the bytes, 4 * (M K +
// K N + M N) (B read once: 230.4 MB, 69 us at 3.35 TB/s); for a square
// 1024^3 product the operations, 2 M N K at the 67 TFLOP/s FP32 rate
// (32 us).  The summation order differs from the plain-torch twin's, so
// the two agree within 1e-5 * (|a| @ |b|), not bit for bit.
//
// Plain C interface (repro_matmul) for ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kSkinnyMaxM = 8;
constexpr int kSkinnyCols = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
matmul_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out, int m, int n, int k, int kps) {
  __shared__ float s_a[kBK][kBM + 1];
  __shared__ float s_b[kBK][kBN];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * kps;
  const int k_end = min(k, k_begin + kps);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int ar = e / kBK;
      const int ac = e % kBK;
      const int gm = m0 + ar;
      const int gk = k0 + ac;
      s_a[ac][ar] = (gm < m && gk < k_end) ? a[(long long)gm * k + gk] : 0.f;
      const int br = e / kBN;
      const int bc = e % kBN;
      const int gk2 = k0 + br;
      const int gn = n0 + bc;
      s_b[br][bc] = (gk2 < k_end && gn < n) ? b[(long long)gk2 * n + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = s_a[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = s_b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* o = out + (long long)blockIdx.z * m * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) o[(long long)row * n + col] = acc[i][j];
    }
  }
}

// MR: the row capacity, the least of 1, 2, 4, 8 that holds m, so that an
// M = 1 product keeps 4 accumulators a thread, not 32.
template <int MR>
__global__ void __launch_bounds__(kThreads)
matmul_skinny_kernel(const float* __restrict__ a,
                     const float* __restrict__ b, float* __restrict__ out,
                     int m, int n, int k, int kps) {
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
    const float* brow = b + (long long)kk * n;
    float bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = ok[j] ? __ldg(brow + col[j]) : 0.f;
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r < m) {
        const float av = __ldg(a + (long long)r * k + kk);
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
  float* o = out + (long long)blockIdx.y * m * n;
  for (int idx = threadIdx.x; idx < m * kSkinnyCols; idx += kThreads) {
    const int r = idx / kSkinnyCols;
    const int c = idx - r * kSkinnyCols;
    if (n0 + c >= n) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s = s + s_red[w][r][c];
    o[(long long)r * n + n0 + c] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
matmul_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                  int splits, long long mn) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s = s + part[(long long)z * mn + i];
  out[i] = s;
}

}  // namespace

extern "C" {

// kSkinnyMaxM: the wrapper sends M <= this to the skinny kernel.
int repro_matmul_skinny_max_m() { return kSkinnyMaxM; }

// out[m, n] = a[m, k] @ b[k, n], all contiguous f32 device pointers.  K
// is cut into `splits` slices of `kps` rows (kps a multiple of 16,
// splits * kps >= k); with splits > 1 the slices' partial sums go to
// part[splits, m, n] and a second launch adds them into out.  `skinny`
// picks the M <= 8 kernel.  Returns the cudaError_t of the launches (0 on
// success).
int repro_matmul(const float* a, const float* b, float* out, float* part,
                 int m, int n, int k, int splits, int kps, int skinny,
                 void* stream) {
  if (m < 1 || n < 1 || k < 0 || splits < 1 || splits > 65535 || kps < 1 ||
      kps % kBK || (long long)splits * kps < k ||
      (skinny && m > kSkinnyMaxM) || (m + kBM - 1) / kBM > 65535 ||
      (splits > 1 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  float* dst = splits > 1 ? part : out;
  if (skinny) {
    const dim3 grid((unsigned)((n + kSkinnyCols - 1) / kSkinnyCols),
                    (unsigned)splits);
    auto skinny_kernel = m == 1   ? matmul_skinny_kernel<1>
                         : m == 2 ? matmul_skinny_kernel<2>
                         : m <= 4 ? matmul_skinny_kernel<4>
                                  : matmul_skinny_kernel<8>;
    skinny_kernel<<<grid, kThreads, 0, s>>>(a, b, dst, m, n, k, kps);
  } else {
    const dim3 grid((unsigned)((n + kBN - 1) / kBN),
                    (unsigned)((m + kBM - 1) / kBM), (unsigned)splits);
    matmul_tile_kernel<<<grid, kThreads, 0, s>>>(a, b, dst, m, n, k, kps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long mn = (long long)m * n;
  matmul_sum_kernel<<<(unsigned)((mn + kThreads - 1) / kThreads), kThreads,
                      0, s>>>(part, out, splits, mn);
  return (int)cudaGetLastError();
}

}  // extern "C"
