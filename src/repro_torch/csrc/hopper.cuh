// Hopper (sm_90a) building blocks of the port's tensor-core kernels, in raw
// PTX: mbarriers, TMA tensor loads and the host-side tensor map, wgmma
// shared-memory descriptors, the wgmma fence / commit / wait and the
// instructions themselves, and setmaxnreg.
//
// The tensor map is encoded through cuTensorMapEncodeTiled, which lives in
// the driver library; the build links only the runtime, so the function is
// looked up once with cudaGetDriverEntryPoint(ByVersion).  <cuda.h> is
// included for the CUtensorMap type and its enums alone.
//
// Shared-memory layout the helpers assume (what TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B): a tile of 16-bit elements is cut into
// column atoms of 64 elements (128 bytes a row); an atom holds its rows at
// 128 bytes each, the 16-byte chunks of row r XOR-swizzled by r % 8, and
// starts on a 1024-byte boundary.  A K-major operand (its reduction axis
// contiguous) advances by 32 bytes for each k16 slice inside an atom, 8-row
// groups 1024 bytes apart; an MN-major operand advances by 16 rows (2048
// bytes) a k16 slice, and its descriptor's LBO is the distance to its next
// 64-column atom.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA);
// follow it with a __syncthreads() before any thread uses them.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// One arrival that also announces `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` has completed.  A wait that
// lasts 10 s is a fault of the pipeline (a tile takes microseconds): it
// traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (globaltimer_ns() - t0 > 10000000000ull) __trap();
  }
}

// --------------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// The box of `map` at element coordinates (c0, c1, c2), innermost first,
// into shared memory at dst; completes `bar`'s transactions.  Elements out
// of the tensor's bounds arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once; null when the
// driver does not offer it.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map of a contiguous [dim2, dim1, dim0] tensor of 16-bit elements
// (f16 if half, else bf16) with boxes of (64, box1, 1) elements, 128-byte
// swizzled, zero-filled out of bounds.  Returns the CUresult (0 on
// success; CUDA_ERROR_NOT_FOUND without the driver's entry point).
inline int encode_3d_sw128(CUtensorMap* map, const void* base, bool half,
                           unsigned long long dim0, unsigned long long dim1,
                           unsigned long long dim2, unsigned box1) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {dim0, dim1, dim2};
  const cuuint64_t strides[2] = {dim0 * 2, dim0 * dim1 * 2};
  const cuuint32_t box[3] = {64, box1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return (int)fn(map,
                 half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 3, const_cast<void*>(base), dims, strides, box, unit,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// ------------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor of a 128-byte-swizzled operand at
// shared address `addr`: `lbo` and `sbo` in bytes (K-major: sbo = 1024,
// the 8-row group stride, lbo unused; MN-major: lbo = the stride of
// 64-column atoms, sbo = 1024).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Orders this warpgroup's register and shared-memory accesses before the
// wgmma that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins registers an async wgmma writes: reads of them are not moved above
// this point (after wgmma_wait), nor writes below it (before the wgmma).
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define HOPPER_ACC32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
   "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, " \
   "%26, %27, %28, %29, %30, %31}"
#define HOPPER_ACC32_OPS(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31])
#define HOPPER_ACC64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
   "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, " \
   "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
   "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
   "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
   "%62, %63}"
#define HOPPER_ACC64_OPS(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// The wgmma instructions of one operand type AB ("bf16" or "f16"), f32
// accumulators in the wgmma D fragment (warp w of the warpgroup holds rows
// 16w..16w+15; thread lane holds rows lane/4 and lane/4 + 8, columns
// 8j + 2(lane%4) + {0, 1} in d[4j..4j+1] and d[4j+2..4j+3]):
//   ss_n64     d[32] (+)= A . B, m64n64k16, A and B K-major in shared
//              memory; scale_d = 0 overwrites d;
//   ss_n{64,128}_tb  d (+)= A . B, m64n{64,128}k16, A K-major and B
//              MN-major in shared memory;
//   rs_n{64,128}_tb  d (+)= A . B, m64n{64,128}k16, A from registers (the
//              A fragment: pairs (row lane/4, cols 2(lane%4) + {0, 1}),
//              (row + 8, same), (row, cols + 8), (row + 8, cols + 8)),
//              B MN-major in shared memory.
#define HOPPER_WGMMA_OPS(AB)                                                 \
  static __device__ __forceinline__ void ss_n64(                             \
      float(&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " " \
                 HOPPER_ACC32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"              \
                 : HOPPER_ACC32_OPS(d)                                       \
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d));                  \
  }                                                                          \
  static __device__ __forceinline__ void ss_n64_tb(                          \
      float(&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " " \
                 HOPPER_ACC32 ", %32, %33, p, 1, 1, 0, 1;\n}\n"              \
                 : HOPPER_ACC32_OPS(d)                                       \
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d));                  \
  }                                                                          \
  static __device__ __forceinline__ void ss_n128_tb(                         \
      float(&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB    \
                 " " HOPPER_ACC64 ", %64, %65, p, 1, 1, 0, 1;\n}\n"          \
                 : HOPPER_ACC64_OPS(d)                                       \
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d));                  \
  }                                                                          \
  static __device__ __forceinline__ void rs_n64_tb(                          \
      float(&d)[32], const uint32_t(&a)[4], uint64_t desc_b, int scale_d) {  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " " \
                 HOPPER_ACC32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
                 : HOPPER_ACC32_OPS(d)                                       \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),               \
                   "l"(desc_b), "r"(scale_d));                               \
  }                                                                          \
  static __device__ __forceinline__ void rs_n128_tb(                         \
      float(&d)[64], const uint32_t(&a)[4], uint64_t desc_b, int scale_d) {  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB    \
                 " " HOPPER_ACC64                                            \
                 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"              \
                 : HOPPER_ACC64_OPS(d)                                       \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),               \
                   "l"(desc_b), "r"(scale_d));                               \
  }

template <typename T>
struct Wgmma;
template <>
struct Wgmma<__nv_bfloat16> {
  HOPPER_WGMMA_OPS("bf16")
};
template <>
struct Wgmma<__half> {
  HOPPER_WGMMA_OPS("f16")
};

// --------------------------------------------------------------- setmaxnreg

// Lowers (dec) or raises (inc) the registers of each thread of this
// warpgroup to R; all of its warps execute it together.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

}  // namespace hopper
