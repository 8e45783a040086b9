// Stencil convolution for the functional simulator (Hopper, sm_90a):
// 'valid' 2-D correlation of an [h, w] f32 frame with a kh x kw f32
// stencil, out[r, c] = sum_{di, dj} k[di, dj] * x[r + di, c + dj], giving
// [h - kh + 1, w - kw + 1] in f32.
//
// Replaces the TPU kernel repro/kernels/stencil_conv.py::_stencil_kernel
// (the pl.pallas_call of stencil_conv, :54).  The TPU kernel keeps the
// whole frame resident in VMEM and pads the rows so every output strip
// is full; neither is carried over.  Here one block of 32 x 8 threads
// makes one 32 x 32 output tile: it stages the (32 + kh - 1) x
// (32 + kw - 1) inputs the tile needs and the kh * kw taps in shared
// memory (inputs past the frame's edge read as 0 and feed only outputs
// past the edge, which are not written), then each thread makes the
// tile's column threadIdx.x in rows threadIdx.y, + 8, + 16 and + 24.
//
// Arithmetic order: each output sums its taps from 0 in di-outer,
// dj-inner order, one multiply and one add per tap; the build's
// --fmad=false keeps them separate, as the plain-torch twin
// (repro_torch/kernels/stencil_conv.py::stencil_conv_torch) and the
// reference's stencil_conv_ref compute them, so kernel and twin agree
// bit for bit.
//
// What bounds it on the card: the bytes moved, 4 * (h * w + oh * ow) for
// a 3 x 3 stencil (2 * kh * kw operations per output, 18 for 3 x 3, stay
// far below the FP32 rate); the staged tile re-reads (34 / 32)^2 = 1.13
// of the input from L2.  Any kh, kw whose staged tile fits in shared
// memory (227 KB, above 48 KB by opt-in) is taken.
//
// Plain C interface (repro_stencil_conv) for ctypes; the Python wrapper
// is repro_torch/kernels/stencil_conv.py::stencil_conv.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr size_t kMaxSmem = 232448;   // 227 KB, the opt-in ceiling

__global__ void __launch_bounds__(kThreads)
stencil_conv_kernel(const float* __restrict__ x, const float* __restrict__ k,
                    float* __restrict__ out, int h, int w, int kh, int kw,
                    int oh, int ow) {
  extern __shared__ float smem[];
  const int sw = kTile + kw - 1;
  const int sh = kTile + kh - 1;
  float* s_k = smem;
  float* s_x = smem + kh * kw;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  for (int i = tid; i < kh * kw; i += kThreads) s_k[i] = k[i];
  for (int i = tid; i < sh * sw; i += kThreads) {
    const int rr = i / sw;
    const int cc = i - rr * sw;
    const int gr = r0 + rr;
    const int gc = c0 + cc;
    s_x[i] = (gr < h && gc < w) ? x[(long long)gr * w + gc] : 0.f;
  }
  __syncthreads();
  const int c = threadIdx.x;
  const int ocol = c0 + c;
  if (ocol >= ow) return;
  for (int rr = threadIdx.y; rr < kTile; rr += kThreadsY) {
    const int orow = r0 + rr;
    if (orow >= oh) break;
    float acc = 0.f;
    for (int di = 0; di < kh; ++di) {
      const float* srow = s_x + (rr + di) * sw + c;
      const float* krow = s_k + di * kw;
      for (int dj = 0; dj < kw; ++dj) acc = acc + krow[dj] * srow[dj];
    }
    out[(long long)orow * ow + ocol] = acc;
  }
}

size_t smem_bytes(int kh, int kw) {
  return sizeof(float) *
         ((size_t)kh * kw + (size_t)(kTile + kh - 1) * (kTile + kw - 1));
}

}  // namespace

extern "C" {

// The largest shared-memory tile a launch may stage, in bytes; the
// wrapper checks smem_bytes(kh, kw) against it before the first launch.
long long repro_stencil_conv_smem_bytes(int kh, int kw) {
  return (long long)smem_bytes(kh, kw);
}
long long repro_stencil_conv_max_smem() { return (long long)kMaxSmem; }

// out[(h - kh + 1), (w - kw + 1)] = the 'valid' correlation of the
// contiguous [h, w] frame x with the contiguous [kh, kw] stencil k, all
// f32 device pointers.  Returns the cudaError_t of the launch (0 on
// success).
int repro_stencil_conv(const float* x, const float* k, float* out, int h,
                       int w, int kh, int kw, void* stream) {
  const int oh = h - kh + 1;
  const int ow = w - kw + 1;
  const size_t smem = smem_bytes(kh, kw);
  if (kh < 1 || kw < 1 || oh < 1 || ow < 1 || smem > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stencil_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((ow + kTile - 1) / kTile),
                  (unsigned)((oh + kTile - 1) / kTile));
  const dim3 block(kThreadsX, kThreadsY);
  stencil_conv_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      x, k, out, h, w, kh, kw, oh, ow);
  return (int)cudaGetLastError();
}

}  // extern "C"
