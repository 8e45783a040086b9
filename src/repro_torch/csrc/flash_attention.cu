// Flash attention with a GQA head map (Hopper, sm_90a): q [B, H, S, D],
// k and v [B, Hkv, S, D] with H % Hkv == 0, out [B, H, S, D] in q's dtype
// (each operand f32, f16 or bf16, as the reference casts each to f32), any
// D >= 1.  Query head h reads kv
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
// so two runs agree bit for bit.  Four routes, picked by the wrapper
// (repro_torch/kernels/flash_attention.py::route), all on the tensor cores:
//
// * the tensor-core route (repro_flash_attention_wgmma) for f16/bf16
//   operands of one dtype with D a multiple of 8 up to 128 and
//   16-byte-aligned bases;
// * the 3xTF32 route (repro_flash_attention_tf32x3) for f32 and mixed
//   operands with D up to 128, rows of a 16-byte multiple (D % 4 == 0 all
//   f32, D % 8 == 0 with a half operand) and 16-byte-aligned bases.  One
//   TF32 product keeps 11 bits of each operand, ~2^-11 of a score, which is
//   another function than the reference's f32 one; three keep ~2^-22;
// * the 3xTF32 route through registers (repro_flash_attention_tf32x3_any)
//   for every other call with D up to 256, any dtype mix: D > 128, rows TMA
//   does not move, misaligned bases;
// * the 3xTF32 route for D > 256 (repro_flash_attention_tf32x3_wide), any
//   dtype mix, alignment and D: O's columns split over a pair of warps.
//
// What bounds it on the card: the operations.  For qwen2-7b's attention at
// S = 4096 (H = 28, Hkv = 4, D = 128, causal) the tensor-core route does
// 6 D half operations per unmasked score (2 D for Q K^T, 4 D for the split
// P V below), 1.80e11, 0.182 ms at 989 TFLOP/s; its 2.35e8 exps take
// 0.056 ms at the SFU rate and the bytes ~0.02 ms.  The 3xTF32 route does
// 12 D TF32 operations per score (2 D fewer for each half operand),
// 3.61e11, 0.729 ms at 495 TFLOP/s.  The route through registers counts
// as the 3xTF32 one: at gemma-2-9b's width (H = 16, Hkv = 8, D = 256,
// S = 4096, causal) 12 D TF32 operations per score, 4.12e11, 0.833 ms in
// f32.  With every operand half, the 6 D left are products of
// half values, as the wgmma route's: 2.06e11, 0.208 ms at 989 TFLOP/s.
// The route for D > 256 counts the same: f32 at D = 320 (1 x 16 x 16 x 1500,
// full) 12 D TF32 operations per score, 1.38e11, 0.279 ms; 0.447 ms at
// D = 512; bf16 at D = 320 6 D half ones, 0.0699 ms.
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
// The 3xTF32 route (flash_attention_tf32x3_kernel): one block owns 64
// query rows of one (batch, head): one consumer warpgroup (the wgmma M)
// and one producer warpgroup of 128 threads.  256 threads a block may
// each hold 255 registers, so no setmaxnreg is needed; a third warpgroup
// would cap every thread at 168 and spill the consumer's 218.
//   * Split: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both
//     rounded to nearest, ties away, as cvt.rna.tf32.f32 (hopper.cuh's
//     tf32_rna: two integer instructions); x - hi is exact in f32.  hi is
//     stored rounded (low 13 bits zero): the tensor cores read a .tf32
//     operand by dropping those bits, so an unrounded hi would be
//     truncated and lo would not be its remainder.  A half operand is
//     exact in TF32: its lo is zero and every product it feeds is skipped.
//     a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, each term exact in f32,
//     accumulated in f32; the dropped a_lo b_lo is ~2^-22 of a b.
//   * Loads: Q once (f32 into its Q_lo slot, a half Q in its own dtype),
//     then K and V tiles of 32 kv rows by TMA (tensor maps of 32 f32 or 64
//     half columns a box, 128-byte swizzled; ragged S and D < 64 or < 128
//     zero-filled) into a ring of 2 raw stages; thread 0 of the producer
//     reloads a raw stage as soon as the producer has split it.
//   * The producer splits each raw tile: K into K_hi and K_lo in the same
//     layout (interleaved by 32-column atom, so that [K_hi; K_lo] is one
//     64-row operand); V into V_hi^T and V_lo^T ([D, 32 kv], one 128-byte
//     atom: .tf32 has no transposed B, so P V needs V K-major), with V's
//     rows permuted within each group of 8 (0, 2, 4, 6, 1, 3, 5, 7) because
//     a k8 A fragment holds columns (t, t + 4) where the S accumulator
//     holds (2t, 2t + 1): P goes from the accumulator to the A operand
//     with no shuffle.  Each split tile completes on an mbarrier of 128
//     arrivals after a proxy fence (generic stores, then wgmma reads).
//   * The consumer splits Q once: Q_hi into registers (its A fragments),
//     Q_lo in place in shared memory.  S: Q_lo K_hi (m64n32k8, A from
//     shared memory) first, then Q_hi [K_hi; K_lo]^T (m64n64k8, A from
//     registers), whose two 32-column halves are added.  The online
//     softmax is the tensor-core route's, on 32 columns.  O += P_lo V_hi +
//     P_hi V_lo + P_hi V_hi (m64nDk8, A from registers).  The overlap is
//     the tensor-core route's.
//   * Shared memory (DP = 64 or 128 staged columns): Q 64 DP * 4 bytes;
//     per stage a raw K and a raw V tile of 32 DP * 4, a split K tile of
//     2 * 32 DP * 4, V_hi^T and V_lo^T of 32 DP * 4 each: 224 KB at
//     DP = 128 (of the 227 a block may have), 112 KB at DP = 64.
//   * What holds it back is not measured: a profiler's stall breakdown of
//     the producer and consumer warpgroups does not run on the card we
//     have.  Our guess, in order: the producer's split (V's transpose above
//     all) on 4 warps, then a single consumer warpgroup whose softmax the
//     tensor cores wait on.
//
// The 3xTF32 route through registers (flash_attention_tf32x3_any_kernel,
// namespace ta): the tf32x3 route's arithmetic for what TMA does not move
// (any D up to 256, rows of any length, any base), in warp-level
// mma.sync.m16n8k8 .tf32 products, whose A fragment comes from registers.
// One block owns 64 query rows of one (batch, head): four consumer warps of
// 16 rows and a producer warpgroup of 128 threads; 256 threads, one block
// an SM (__launch_bounds__(256, 1): up to 255 registers a thread).
//   * Staged head width DP: D rounded up to 32, 64, 128, 160, 192 or 256
//     (one instantiation each; columns past D zero-filled in shared
//     memory, so they add nothing).  kv rows a tile T: 32 up to DP = 160,
//     24 at 192, 16 at 256, so that Q (256 DP bytes, f32) and two stages
//     of K_hi, K_lo, V_hi, V_lo (16 T DP bytes each) fit: 192 KB at
//     DP = 256, 192 KB at 192, 200 KB at 160, 160 KB at 128, 80 KB at 64.
//   * Shared memory holds 16-byte units, each one lane's operand of one
//     mma: Q's A fragment (f32; a half q's four 16-bit values, 8 bytes), K's
//     B fragment of S = Q K^T (hi, then lo), V's of O += P V.  A warp's 32
//     lanes read 32 consecutive units, swizzled within each 128-byte row
//     (unit_k, unit_v), so loads and the producer's stores are free of bank
//     conflicts.  A half K or V is exact in TF32: its unit is its two values
//     alone (8 bytes), and its lo products are not issued.
//   * Loads through registers, not TMA: the producer reads a chunk of 8
//     columns of a row (K), or of two rows (V), by 16-byte loads where the
//     base is 16-byte aligned and a row a 16-byte multiple, element by
//     element otherwise (a half operand 2 bytes off a 4-byte boundary takes
//     no vector load, not even cp.async's 4 bytes), zero past row S and
//     column D; each load is predicated, not branched around, so a
//     thread's loads of a tile are in flight together.  Tile i + 1 is
//     loaded into registers as soon as tile i is split and stored, while
//     the consumers multiply tile i; then it is widened to f32, split
//     (hi = tf32_rna(x), lo = tf32_rna(x - hi), hi stored rounded) and
//     stored once its stage is free.  mbarriers: full (128 producer
//     arrivals), empty (4 consumer warps), two stages.
//   * S: Q is split at each use (two integer instructions a value for hi;
//     a pre-split Q_hi + Q_lo would take 128 KB at DP = 256, and Q_hi in
//     registers DP / 2 of them beside O's DP / 2).  Q_lo K_hi and Q_hi K_lo
//     accumulate apart from Q_hi K_hi (three independent chains for each
//     n8 tile; the chain a half operand frees takes every second or third
//     slice's Q_hi K_hi), then (lo hi + hi lo) + hi hi.
//   * Online softmax in base 2 from a running max of -1e30 on the m16n8
//     accumulator layout (the wgmma route's, on T columns); O is rescaled
//     only when some row of the warp changed its max (alpha is exactly 1
//     otherwise).  P passes from the S accumulator to the A fragment with
//     no shuffle: the accumulator holds columns (2t, 2t + 1) where the A
//     fragment means (t, t + 4), so V's rows are permuted within each
//     group of 8 as (0, 2, 4, 6, 1, 3, 5, 7): V's unit holds rows 2t and
//     2t + 1.  O += P_lo V_hi + P_hi V_lo + P_hi V_hi, small terms first.
//   * Registers (ptxas): 254 at DP = 256 (8 bytes spilled), 255 at 192,
//     244 at 160, 214 at 128; O takes DP / 2 of them.
//   * Causal blocks stop at the diagonal tile, the longest query tiles
//     first; a warp whose rows all lie above a tile skips it (it still
//     waits for the tile and frees it).  No atomics.
//   * What holds it back is not measured (no stall breakdown runs on this
//     card); our guess: one consumer warp an SM sub-partition waits on its
//     own shared-memory loads and mma chains (registers leave no room for
//     a second), each warp reads the whole K and V tile from shared memory,
//     and the producer's split and stores take issue slots beside it.
//
// The 3xTF32 route for D > 256 (flash_attention_tf32x3_wide_kernel, in
// namespace ta, built from its units, swizzles, loads, splits, mbarrier
// ring and softmax): O of DP columns takes DP / 2 registers a thread, more
// than one warp has past DP = 256, so O's columns are split over a pair of
// consumer warps for each group of 16 query rows.  One block owns 32 query
// rows of one (batch, head): warps 2 p and 2 p + 1 share rows 16 p ..
// 16 p + 15, warp 2 p + c owns columns [c W, (c + 1) W) of each slab, W =
// DP / 2; one block an SM.
//   * Producers: one warpgroup at DP = 320 (256 threads: a step's K and V
//     take 88 registers a producer thread, so a second register set or a
//     second warpgroup at setmaxnreg's 120 spills); two at 384 and 512
//     (384 threads), each taking every second step into its own stage, so
//     each step's loads are in flight through the other's step;
//     setmaxnreg gives the producers 120 registers and the consumers 256.
//   * Staged slab width DP: D rounded up to 320 or 384, else 512 (W = 160,
//     192, 256: the widths the route through registers gives one warp).
//     Past D = 512 O is written in slabs of 512 columns, one kv walk a
//     slab, and every walk sums each score over all of D's slabs in order.
//   * S = Q K^T over the halves: each warp multiplies its half of Q by its
//     half of K (the route through registers' three chains, its units,
//     swizzles and producer), writes its 16 x T partial to shared memory,
//     and the pair meets at a named barrier (bar.sync 1 + p, 64); both
//     warps add half 0's partial to half 1's, so both hold the same S bit
//     for bit, take the same maxima and run the same softmax.  Each warp
//     then multiplies P by its half of V.  Each warp reads half of each K
//     and V tile, and Q's units of its half.
//   * Shared memory: Q 4 * 32 * DP bytes, two stages of K_hi, K_lo, V_hi,
//     V_lo of 16 T DP bytes each, the exchange (2 parities x 4 warps x
//     16 x T floats) and 4 mbarriers: 213,024 bytes at DP = 320 (T = 16),
//     151,584 at 384 (T = 8: T = 16 would take 240 KB), 200,736 at 512
//     (T = 8), of the 232,448 a block may have.
//   * Q is staged once up to D = 512, the largest D the plan takes without
//     re-staging; past it each consumer thread re-stages its own units of
//     Q's slab at each step (Q at full D does not fit beside the stages).
//   * Registers (ptxas): 249 a thread at DP = 320, no spills; 168 at
//     launch at 384 and 512 (setmaxnreg then 256 a consumer), spilling 12
//     and 28 bytes.  O takes DP / 4 of a consumer's.
//   * No atomics; a repeated launch is bit-equal.
//   * What holds it back is not measured (no stall breakdown runs on this
//     card); our guess: the producer (one warp an SM sub-partition loads,
//     splits and stores a tile beside the consumer at DP = 320), then the
//     consumers' Q K^T, which reads Q's units again every kv tile.
//
// Plain C interfaces (repro_flash_attention_wgmma,
// repro_flash_attention_tf32x3, repro_flash_attention_tf32x3_any,
// repro_flash_attention_tf32x3_wide) for ctypes; the Python wrapper is
// repro_torch/kernels/flash_attention.py::flash_attention.  A launch is
// refused (cudaErrorInvalidValue) past the caps or the grid's limits.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "dtypes.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxD = 128;                     // the TMA routes' largest D
constexpr float kMaxInit = -1e30f;             // the reference's NEG_INF

// Operand access of the routes through registers: each operand is read
// through its own runtime dtype code (0 f32, 1 f16, 2 bf16) and the output
// written in q's.
struct AnyDtype {
  const void* p;
  int code;
};
struct AnyOut {
  void* p;
  int code;
};

__device__ __forceinline__ float load(AnyDtype a, long long i) {
  if (a.code == 0) return static_cast<const float*>(a.p)[i];
  if (a.code == 1) return __half2float(static_cast<const __half*>(a.p)[i]);
  return __bfloat162float(static_cast<const __nv_bfloat16*>(a.p)[i]);
}

__device__ __forceinline__ AnyDtype advance(AnyDtype a, long long i) {
  return {static_cast<const char*>(a.p) + i * (a.code == 0 ? 4 : 2), a.code};
}

__device__ __forceinline__ void store(AnyOut o, long long i, float x) {
  if (o.code == 0) {
    static_cast<float*>(o.p)[i] = x;
  } else if (o.code == 1) {
    static_cast<__half*>(o.p)[i] = __float2half_rn(x);
  } else {
    static_cast<__nv_bfloat16*>(o.p)[i] = __float2bfloat16_rn(x);
  }
}

__device__ __forceinline__ AnyOut advance_out(AnyOut o, long long i) {
  return {static_cast<char*>(o.p) + i * (o.code == 0 ? 4 : 2), o.code};
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

// The online softmax of one tile of N / 4 columns on the S accumulator
// layout, in base 2: scores times scale2 = scale * log2(e), so that
// exp(x - m) is exp2 of the scaled difference.  Under kMask the thread's
// rows (0, 1) attend to columns up to lim0, lim1 (the rest are -inf); a
// tile that lies wholly inside every row's range of its warpgroup skips the
// compares.  sc becomes P (times pscale), m (base 2) and l are updated, and
// alpha (the rescale of O) is returned.
template <bool kMask, int N>
__device__ __forceinline__ void online_softmax(float (&sc)[N], int k0, int t,
                                               int lim0, int lim1,
                                               float scale2, float pscale,
                                               float& m0, float& m1,
                                               float& l0, float& l1,
                                               float& al0, float& al1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
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
  for (int j = 0; j < N / 4; ++j) {
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

// ------------------------------------------------ 3xTF32 tensor-core route

namespace t3 {

using namespace hopper;

constexpr int kBM = 64;          // query rows a block: one consumer warpgroup
constexpr int kBN = 32;          // kv rows a tile: one 128-byte row of V^T
constexpr int kStages = 2;       // raw and split K and V tiles in flight
constexpr int kThreads = 256;    // consumer warpgroup 0, producer 1
constexpr uint32_t kKBox = kBN * 128;   // one TMA box (128-byte rows) of K, V
constexpr uint32_t kQBox = kBM * 128;   // one TMA box of Q

// Shared memory of one block at a staged head width DP, in bytes from the
// 1024-aligned base: Q's landing tile (which becomes Q_lo), kStages raw K
// and V tiles (TMA's landing tiles, in the operand's dtype), kStages split
// K tiles (K_hi and K_lo interleaved by column atom) and V tiles (V_hi^T,
// V_lo^T), all in f32 slots, then the barriers.  At DP = 128: 32 + 64 +
// 64 + 64 KB = 224 KB of the 227 a block can have; half of it at DP = 64.
template <int DP>
struct Smem {
  static constexpr uint32_t kQ = kBM * DP * 4;
  static constexpr uint32_t kTile = kBN * DP * 4;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t raw_k = q + kQ;
  static constexpr uint32_t raw_v = raw_k + kStages * kTile;
  static constexpr uint32_t k = raw_v + kStages * kTile;   // 2 kTile each
  static constexpr uint32_t v_hi = k + kStages * 2 * kTile;
  static constexpr uint32_t v_lo = v_hi + kStages * kTile;
  static constexpr uint32_t bars = v_lo + kStages * kTile;
  // Q full; per stage: raw K full, raw V full, K full, K free, V full,
  // V free
  static constexpr uint32_t kBars = 1 + 6 * kStages;
  static constexpr size_t bytes = bars + 8 * kBars + 1024;
};

// Bytes of an element of dtype code CODE (0 f32, 1 f16, 2 bf16).
template <int CODE>
__host__ __device__ constexpr int esize() {
  return CODE == 0 ? 4 : 2;
}

// Byte offset of element (r, c) of a 128-byte-swizzled tile of `rows` rows
// a column atom, elements of dtype code CODE.
template <int CODE>
__device__ __forceinline__ uint32_t sw_off(int r, int c, int rows) {
  constexpr int kPer = 128 / esize<CODE>();       // elements a 128-byte row
  const int byte = (c % kPer) * esize<CODE>();
  return (c / kPer) * rows * 128 + r * 128 + (((byte / 16) ^ (r & 7)) * 16) +
         byte % 16;
}

// One element of dtype code CODE as f32.
template <int CODE>
__device__ __forceinline__ float ld1(const uint8_t* p) {
  if constexpr (CODE == 0) {
    return *reinterpret_cast<const float*>(p);
  } else if constexpr (CODE == 1) {
    return __half2float(*reinterpret_cast<const __half*>(p));
  } else {
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  }
}

// x = hi + lo: hi = tf32_rna(x), lo = tf32_rna(x - hi) (x - hi is exact).
__device__ __forceinline__ void split1(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float (&x)[4], uint4& hi,
                                       uint4& lo) {
  split1(x[0], hi.x, lo.x);
  split1(x[1], hi.y, lo.y);
  split1(x[2], hi.z, lo.z);
  split1(x[3], hi.w, lo.w);
}

// A K tile: raw (TMA's tile in the operand's dtype) into K_hi and, for an
// f32 K, K_lo, both in the f32 layout (32-column atoms of kBN rows), by
// 16-byte chunks: chunk c is atom c / (8 kBN), row (c / 8) % kBN,
// physical 16-byte slot c % 8.  Column atom a of the split tile holds K_hi
// at 2 a kKBox and K_lo right after it, so that one 64-row B operand is
// [K_hi; K_lo].  An f32 raw tile has the chunk layout already; a half one
// is read at the chunk's four columns and widened (exact in TF32, so its
// lo is zero and not written).
template <int DP, int CODE>
__device__ __forceinline__ void split_k(const uint8_t* raw, uint8_t* dst,
                                        int ptid) {
#pragma unroll 4
  for (int c = ptid; c < kBN * DP / 4; c += 128) {
    float x[4];
    if constexpr (CODE == 0) {
      const float4 v = *reinterpret_cast<const float4*>(raw + 16 * c);
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else {
      const int r = (c / 8) % kBN;
      const int col = (c / (8 * kBN)) * 32 + 4 * ((c % 8) ^ (r & 7));
      const uint8_t* p = raw + sw_off<CODE>(r, col, kBN);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = ld1<CODE>(p + 2 * e);
    }
    uint4 h, l;
    split4(x, h, l);
    uint8_t* hi = dst + (c / (8 * kBN)) * 2 * kKBox + 16 * (c % (8 * kBN));
    *reinterpret_cast<uint4*>(hi) = h;
    if constexpr (CODE == 0) *reinterpret_cast<uint4*>(hi + kKBox) = l;
  }
}

// A V tile: raw [kBN kv rows, DP] into V_hi^T and, for an f32 V, V_lo^T:
// [DP rows, kBN kv columns], one 32-column atom, K-major for P V (.tf32
// has no transposed B).  Logical column kappa of k8 slice j holds kv row
// 8 j + perm(kappa), perm = (0, 2, 4, 6, 1, 3, 5, 7): the A fragment reads
// P's accumulator columns (2t, 2t + 1) as its columns (t, t + 4), and V's
// rows are permuted to match instead of P's registers being shuffled.  A
// thread writes one 16-byte chunk a step, of V^T row d (lanes on
// consecutive d: the reads of one kv row and the swizzled writes are free
// of bank conflicts), logical chunk lc: kv rows k0, k0 + 2, k0 + 4, k0 + 6
// with k0 = 8 (lc / 2) + lc % 2.
template <int DP, int CODE>
__device__ __forceinline__ void split_v(const uint8_t* raw, uint8_t* hi,
                                        uint8_t* lo, int ptid) {
  const int d = ptid % DP;
  // the offset of (row r, column d) for r = 0..7; row r + 8 g is 8 g rows on
  uint32_t row[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) row[r] = sw_off<CODE>(r, d, kBN);
#pragma unroll
  for (int it = 0; it < DP / 16; ++it) {
    const int lc = ptid / DP + (128 / DP) * it;
    const uint8_t* base = raw + (lc / 2) * 8 * 128;
    float x[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      // kv row 8 (lc / 2) + lc % 2 + 2 m
      const uint32_t off = lc % 2 ? row[1 + 2 * m] : row[2 * m];
      x[m] = ld1<CODE>(base + off);
    }
    uint4 h, l;
    split4(x, h, l);
    const uint32_t out = d * 128 + ((lc ^ (d & 7)) * 16);
    *reinterpret_cast<uint4*>(hi + out) = h;
    if constexpr (CODE == 0) *reinterpret_cast<uint4*>(lo + out) = l;
  }
}

template <int DP>
__device__ __forceinline__ void split_k_code(const uint8_t* raw, uint8_t* dst,
                                             int code, int ptid) {
  if (code == 0) {
    split_k<DP, 0>(raw, dst, ptid);
  } else if (code == 1) {
    split_k<DP, 1>(raw, dst, ptid);
  } else {
    split_k<DP, 2>(raw, dst, ptid);
  }
}

template <int DP>
__device__ __forceinline__ void split_v_code(const uint8_t* raw, uint8_t* hi,
                                             uint8_t* lo, int code,
                                             int ptid) {
  if (code == 0) {
    split_v<DP, 0>(raw, hi, lo, ptid);
  } else if (code == 1) {
    split_v<DP, 1>(raw, hi, lo, ptid);
  } else {
    split_v<DP, 2>(raw, hi, lo, ptid);
  }
}

// Q's A fragments: the thread's elements of every k8 slice rounded to TF32
// (qh, held in registers for every tile); for an f32 Q, the remainder
// rounded again (Q_lo) is written back in place, where the Q_lo . K_hi
// product reads it from shared memory.  Element e of slice kk: row
// 16 warp + lane / 4 + 8 (e & 1), column 8 kk + lane % 4 + 4 (e >> 1).
template <int DP, int CODE>
__device__ __forceinline__ void split_q(uint8_t* q, int warp, int lane,
                                        uint32_t (&qh)[DP / 8][4]) {
  const int r = 16 * warp + lane / 4;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint8_t* p = q + sw_off<CODE>(r + 8 * (e & 1),
                                    8 * kk + lane % 4 + 4 * (e >> 1), kBM);
      uint32_t lo;
      split1(ld1<CODE>(p), qh[kk][e], lo);
      if constexpr (CODE == 0) *reinterpret_cast<uint32_t*>(p) = lo;
    }
  }
}

// S of one tile, issued (not waited), into sc[32] zeroed first.  Q_lo
// K_hi (an f32 Q) is m64n32k8 with Q_lo from shared memory, into columns
// 0-31, issued first (small terms first).  With an f32 K, Q_hi [K_hi;
// K_lo]^T is one m64n64k8 product a k8 slice with Q_hi from registers:
// columns 0-31 take Q_hi K_hi, columns 32-63 Q_hi K_lo, added once the
// tile is done (half the instructions).  With a half K,
// Q_hi K_hi is m64n32k8 and columns 32-63 stay zero.
template <int DP>
__device__ __forceinline__ void issue_scores(float (&sc)[32],
                                             uint32_t (&qh)[DP / 8][4],
                                             uint32_t q_lo, uint32_t k_tile,
                                             bool q32, bool k32) {
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  fence_regs(sc);
  wgmma_fence();
  const auto kdesc = [&](int kk) {
    return desc_sw128(k_tile + (kk / 4) * 2 * kKBox + (kk % 4) * 32, 16,
                      1024);
  };
  if (q32) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      WgmmaTf32::ss_n32(
          sc, desc_sw128(q_lo + (kk / 4) * kQBox + (kk % 4) * 32, 16, 1024),
          kdesc(kk), 1);
    }
  }
  if (k32) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      WgmmaTf32::rs_n64(sc, qh[kk], kdesc(kk), 1);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      WgmmaTf32::rs_n32(sc, qh[kk], kdesc(kk), 1);
    }
  }
  wgmma_commit();
}

template <int DP>
__device__ __forceinline__ void pv_mma(float (&o)[DP / 2],
                                       const uint32_t (&a)[4], uint64_t b) {
  if constexpr (DP == 128) {
    WgmmaTf32::rs_n128(o, a, b, 1);
  } else {
    WgmmaTf32::rs_n64(o, a, b, 1);
  }
}

// O += P_lo V_hi + P_hi V_lo + P_hi V_hi of one tile, issued (not waited),
// small products first (P_hi V_lo skipped for a half V); A from registers,
// V^T K-major, k8 slice j 32 bytes into its one atom.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         uint32_t (&ph)[4][4],
                                         uint32_t (&pl)[4][4], uint32_t v_hi,
                                         uint32_t v_lo, bool v32) {
  fence_regs(o);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    fence_regs(ph[j]);
    fence_regs(pl[j]);
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pv_mma<DP>(o, pl[j], desc_sw128(v_hi + 32 * j, 16, 1024));
  }
  if (v32) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pv_mma<DP>(o, ph[j], desc_sw128(v_lo + 32 * j, 16, 1024));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pv_mma<DP>(o, ph[j], desc_sw128(v_hi + 32 * j, 16, 1024));
  }
  wgmma_commit();
}

template <int DP>
__device__ __forceinline__ void fence_pv(float (&o)[DP / 2],
                                         uint32_t (&ph)[4][4],
                                         uint32_t (&pl)[4][4]) {
  fence_regs(o);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    fence_regs(ph[j]);
    fence_regs(pl[j]);
  }
}

// O *= alpha (per row), then P (in sc) split into the A fragments of the
// tile's four k8 slices: slice j takes accumulator columns 8 j + 2t and
// 8 j + 2t + 1 of rows g and g + 8 as its a[0], a[2] and a[1], a[3].
template <int DP>
__device__ __forceinline__ void rescale_and_split(float (&o)[DP / 2],
                                                  const float (&sc)[16],
                                                  float al0, float al1,
                                                  uint32_t (&ph)[4][4],
                                                  uint32_t (&pl)[4][4]) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    o[4 * j] = o[4 * j] * al0;
    o[4 * j + 1] = o[4 * j + 1] * al0;
    o[4 * j + 2] = o[4 * j + 2] * al1;
    o[4 * j + 3] = o[4 * j + 3] * al1;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split1(sc[4 * j], ph[j][0], pl[j][0]);
    split1(sc[4 * j + 2], ph[j][1], pl[j][1]);
    split1(sc[4 * j + 1], ph[j][2], pl[j][2]);
    split1(sc[4 * j + 3], ph[j][3], pl[j][3]);
  }
}

__device__ __forceinline__ void store2(void* out, int code, long long i,
                                       float a, float b) {
  if (code == 0) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) =
        make_float2(a, b);
  } else if (code == 1) {
    *reinterpret_cast<__half2*>(static_cast<__half*>(out) + i) =
        __floats2half2_rn(a, b);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                       i) = __floats2bfloat162_rn(a, b);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              void* __restrict__ out, int qc, int kc, int vc,
                              int h, int hkv, int s, int d, float scale,
                              int causal) {
  using L = Smem<DP>;
  extern __shared__ __align__(1024) uint8_t t3_smem[];
  const uint32_t sb = (smem_u32(t3_smem) + 1023u) & ~1023u;
  uint8_t* gb = t3_smem + (sb - smem_u32(t3_smem));
  const uint32_t bar_q = sb + L::bars;
  const uint32_t bar_rk = bar_q + 8;                  // raw K full
  const uint32_t bar_rv = bar_rk + 8 * kStages;       // raw V full
  const uint32_t bar_kf = bar_rv + 8 * kStages;       // K split
  const uint32_t bar_ke = bar_kf + 8 * kStages;       // K read
  const uint32_t bar_vf = bar_ke + 8 * kStages;       // V split
  const uint32_t bar_ve = bar_vf + 8 * kStages;       // V read

  const int bh = blockIdx.x;
  const int kvh = (bh / h) * hkv + (bh % h) / (h / hkv);
  const int n_qt = (s + kBM - 1) / kBM;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kBM;   // longest first
  const int n_kt = causal ? (min(q0 + kBM, s) - 1) / kBN + 1
                          : (s + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_rk + 8 * st, 1);
      mbar_init(bar_rv + 8 * st, 1);
      mbar_init(bar_kf + 8 * st, 128);      // every producer thread
      mbar_init(bar_ke + 8 * st, 4);        // every consumer warp
      mbar_init(bar_vf + 8 * st, 128);
      mbar_init(bar_ve + 8 * st, 4);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer warpgroup: thread 0 issues the loads, all 128 split
    const int ptid = threadIdx.x - 128;
    const auto load = [&](const CUtensorMap* map, uint32_t dst, uint32_t bar,
                          int code, int rows, int r0, int z) {
      const int per = code == 0 ? 32 : 64;          // columns a box
      const int boxes = DP / per;
      mbar_arrive_expect_tx(bar, boxes * rows * 128);
      for (int a = 0; a < boxes; ++a) {
        tma_load_3d(dst + a * rows * 128, map, bar, a * per, r0, z);
      }
    };
    const auto load_kv = [&](int i, bool is_k) {
      const int st = i % kStages;
      load(is_k ? &tm_k : &tm_v,
           sb + (is_k ? L::raw_k : L::raw_v) + st * L::kTile,
           (is_k ? bar_rk : bar_rv) + 8 * st, is_k ? kc : vc, kBN, i * kBN,
           kvh);
    };
    if (ptid == 0) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      load(&tm_q, sb + L::q, bar_q, qc, kBM, q0, bh);
      for (int i = 0; i < min(kStages, n_kt); ++i) {
        load_kv(i, true);
        load_kv(i, false);
      }
    }
    for (int i = 0; i < n_kt; ++i) {
      const int st = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      mbar_wait(bar_rk + 8 * st, ph);
      mbar_wait(bar_ke + 8 * st, ph ^ 1);   // K of tile i - 2 is read
      split_k_code<DP>(gb + L::raw_k + st * L::kTile,
                       gb + L::k + st * 2 * L::kTile, kc, ptid);
      fence_proxy_async();
      mbar_arrive(bar_kf + 8 * st);
      named_bar_sync(1, 128);               // raw K of stage st is read
      if (ptid == 0 && i + kStages < n_kt) load_kv(i + kStages, true);
      mbar_wait(bar_rv + 8 * st, ph);
      mbar_wait(bar_ve + 8 * st, ph ^ 1);   // V^T of tile i - 2 is read
      split_v_code<DP>(gb + L::raw_v + st * L::kTile,
                       gb + L::v_hi + st * L::kTile,
                       gb + L::v_lo + st * L::kTile, vc, ptid);
      fence_proxy_async();
      mbar_arrive(bar_vf + 8 * st);
      named_bar_sync(1, 128);               // raw V of stage st is read
      if (ptid == 0 && i + kStages < n_kt) load_kv(i + kStages, false);
    }
  } else {
    // consumer warpgroup: query rows [q0, q0 + 64); this thread holds rows
    // r0 and r0 + 8, columns 8 j + 2 t + {0, 1}
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int r0 = q0 + 16 * warp + lane / 4;
    const int lim0 = causal ? min(r0, s - 1) : s - 1;
    const int lim1 = causal ? min(r0 + 8, s - 1) : s - 1;
    // tiles before first_masked lie inside every row's range
    const int first_masked = ((causal ? q0 : s - 1) + 1) / kBN;
    const float scale2 = scale * 1.44269504088896341f;   // log2(e)
    const bool q32 = qc == 0, k32 = kc == 0, v32 = vc == 0;
    const auto wait_k = [&](int i) {
      mbar_wait(bar_kf + 8 * (i % kStages), (i / kStages) & 1);
    };
    const auto wait_v = [&](int i) {
      mbar_wait(bar_vf + 8 * (i % kStages), (i / kStages) & 1);
    };
    const auto free_k = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_ke + 8 * (i % kStages));
    };
    const auto free_v = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_ve + 8 * (i % kStages));
    };
    const auto tile = [&](uint32_t buf, int i) {
      return sb + buf + (i % kStages) * L::kTile;
    };

    uint32_t qh[DP / 8][4];
    mbar_wait(bar_q, 0);
    if (qc == 0) {
      split_q<DP, 0>(gb + L::q, warp, lane, qh);
    } else if (qc == 1) {
      split_q<DP, 1>(gb + L::q, warp, lane, qh);
    } else {
      split_q<DP, 2>(gb + L::q, warp, lane, qh);
    }
    fence_proxy_async();
    named_bar_sync(2, 128);                 // Q_lo is written

    float o[DP / 2], sc[32];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    // the tile's scores: columns 0-31 once the K_lo columns 32-63 are added
    float(&sv)[16] = *reinterpret_cast<float(*)[16]>(sc);
    uint32_t ph[4][4], pl[4][4];
    float m0 = kMaxInit, m1 = kMaxInit, l0 = 0.f, l1 = 0.f, al0, al1;
    const auto softmax = [&](int i) {
#pragma unroll
      for (int e = 0; e < 16; ++e) sc[e] = sc[e] + sc[16 + e];
      if (i >= first_masked) {
        tc::online_softmax<true>(sv, i * kBN, t, lim0, lim1, scale2, 1.f, m0,
                                 m1, l0, l1, al0, al1);
      } else {
        tc::online_softmax<false>(sv, i * kBN, t, lim0, lim1, scale2, 1.f,
                                  m0, m1, l0, l1, al0, al1);
      }
    };
    const auto scores = [&](int i) {
      issue_scores<DP>(sc, qh, sb + L::q,
                       sb + L::k + (i % kStages) * 2 * L::kTile, q32, k32);
    };
    const auto pv = [&](int i) {
      issue_pv<DP>(o, ph, pl, tile(L::v_hi, i), tile(L::v_lo, i), v32);
    };

    // tile i's scores are issued before tile i - 1's P V, so the softmax
    // of tile i runs while the tensor cores multiply P V of tile i - 1;
    // O is rescaled once that product is done
    wait_k(0);
    scores(0);
    wgmma_wait<0>();
    fence_regs(sc);
    free_k(0);
    softmax(0);
    rescale_and_split<DP>(o, sv, al0, al1, ph, pl);
    for (int i = 1; i < n_kt; ++i) {
      wait_k(i);
      scores(i);
      wait_v(i - 1);
      pv(i - 1);
      wgmma_wait<1>();                      // the scores of tile i
      fence_regs(sc);
      free_k(i);
      softmax(i);
      wgmma_wait<0>();                      // P V of tile i - 1
      fence_pv<DP>(o, ph, pl);
      free_v(i - 1);
      rescale_and_split<DP>(o, sv, al0, al1, ph, pl);
    }
    wait_v(n_kt - 1);
    pv(n_kt - 1);
    wgmma_wait<0>();
    fence_pv<DP>(o, ph, pl);
    free_v(n_kt - 1);

    const float den0 = fmaxf(l0, 1e-30f);
    const float den1 = fmaxf(l1, 1e-30f);
    const long long row0 = (long long)bh * s;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= d) break;
      if (r0 < s) {
        store2(out, qc, (row0 + r0) * d + col, o[4 * j] / den0,
               o[4 * j + 1] / den0);
      }
      if (r0 + 8 < s) {
        store2(out, qc, (row0 + r0 + 8) * d + col, o[4 * j + 2] / den1,
               o[4 * j + 3] / den1);
      }
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int qc,
           int kc, int vc, long long b, int h, int hkv, int s, int d,
           float scale, int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int err = encode_3d_sw128_code(&tm_q, q, qc, d, s, b * h, kBM);
  if (!err) err = encode_3d_sw128_code(&tm_k, k, kc, d, s, b * hkv, kBN);
  if (!err) err = encode_3d_sw128_code(&tm_v, v, vc, d, s, b * hkv, kBN);
  if (err) return -err;
  constexpr size_t smem = Smem<DP>::bytes;
  auto kernel = flash_attention_tf32x3_kernel<DP>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)(b * h), (unsigned)((s + kBM - 1) / kBM));
  kernel<<<grid, kThreads, smem, stream>>>(tm_q, tm_k, tm_v, out, qc, kc, vc,
                                           h, hkv, s, d, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace t3

// ------------------------------ 3xTF32 through registers: any D up to 256

namespace ta {

using namespace hopper;

constexpr int kBM = 64;            // query rows a block: 4 consumer warps
constexpr int kThreads = 256;      // consumer warps 0-3, producer warps 4-7
constexpr int kProducers = 128;

// The tiles of a kv walk at a staged head width DP (a multiple of 32;
// columns past D are zero) and BN kv rows a tile.  Shared memory is kept
// in units, each one thread's operand of one mma.sync (16 bytes; 8 for a
// half operand): a K or V tile [kBN / 8][DP / 8][32 lanes].
template <int DP, int BN>
struct Tiles {
  static constexpr int kBN = BN;
  static constexpr int kSlices = DP / 8;   // k8 slices of Q K^T, n8 of P V
  static constexpr int kNT = BN / 8;       // n8 tiles of S, k8 slices of P V
  static constexpr int kTileUnits = kNT * kSlices * 32;
  // the producer's work a tile: K in (row, slice) chunks of 8 columns, V
  // in (kv slice, n8 tile, t) chunks of 2 rows by 8 columns
  static constexpr int kKChunks = BN * kSlices;
  static constexpr int kVChunks = kNT * kSlices * 4;
  static constexpr int kKIters = (kKChunks + kProducers - 1) / kProducers;
  static constexpr int kVIters = (kVChunks + kProducers - 1) / kProducers;
};

// The tile plan of the route through registers (D up to 256): kBN kv rows
// a tile, so that Q (256 DP bytes) and two stages of K_hi, K_lo, V_hi,
// V_lo (16 kBN DP bytes each) fit the 227 KB a block may have; Q's units
// are [4 warps][DP / 8 slices][32 lanes].
constexpr int any_bn(int dp) { return dp <= 160 ? 32 : dp <= 192 ? 24 : 16; }

template <int DP>
struct Plan : Tiles<DP, any_bn(DP)> {
  using Base = Tiles<DP, any_bn(DP)>;
  static constexpr int kQUnits = 4 * Base::kSlices * 32;
  // units, then the barriers: full[2] (128 producer arrivals), empty[2]
  // (4 consumer warps)
  static constexpr size_t kBytes =
      16 * (size_t)(kQUnits + 4 * Base::kTileUnits) + 8 * 4;
};

// Columns c0 .. c0 + 7 of row `row` of a [s, d] slab, zero past row s and
// column d, as loaded: where `vec` (the slab's base 16-byte aligned and its
// rows a 16-byte multiple) by 16-byte loads of the raw words (f32: columns
// 0-3 in a, 4-7 in b; a half type: all eight in a), each predicated rather
// than branched around, so that all of a thread's loads of a tile are in
// flight together; otherwise element by element, widened to f32 at once.
struct Raw8 {
  uint4 a, b;
};

__device__ __forceinline__ Raw8 load_raw(AnyDtype slab, int row, int c0,
                                         int s, int d, bool vec) {
  Raw8 r;
  r.a = r.b = make_uint4(0u, 0u, 0u, 0u);
  const bool in = row < s;
  const long long at = (long long)(in ? row : 0) * d + c0;
  if (vec) {
    if (slab.code == 0) {
      const uint4* p = reinterpret_cast<const uint4*>(
          static_cast<const float*>(slab.p) + at);
      if (in && c0 + 4 <= d) r.a = p[0];
      if (in && c0 + 8 <= d) r.b = p[1];
    } else {
      const uint4* p = reinterpret_cast<const uint4*>(
          static_cast<const uint16_t*>(slab.p) + at);
      if (in && c0 + 8 <= d) r.a = p[0];
    }
  } else {
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      x[e] = in && c0 + e < d ? load(slab, at + e) : 0.f;
    }
    r.a = make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                     __float_as_uint(x[2]), __float_as_uint(x[3]));
    r.b = make_uint4(__float_as_uint(x[4]), __float_as_uint(x[5]),
                     __float_as_uint(x[6]), __float_as_uint(x[7]));
  }
  return r;
}

// A 16-bit value of dtype code QC (1 f16, 2 bf16) as an f32's bits: exact
// in TF32.
template <int QC>
__device__ __forceinline__ uint32_t widen16(uint32_t bits) {
  if constexpr (QC == 1) {
    return __float_as_uint(
        __half2float(__ushort_as_half((unsigned short)bits)));
  } else {
    return bits << 16;
  }
}

// The eight values of a Raw8 as f32.
__device__ __forceinline__ void widen(const Raw8& r, int code, bool vec,
                                      float (&x)[8]) {
  if (!vec || code == 0) {
    const uint32_t w[8] = {r.a.x, r.a.y, r.a.z, r.a.w,
                           r.b.x, r.b.y, r.b.z, r.b.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = __uint_as_float(w[e]);
    return;
  }
  const uint32_t w[4] = {r.a.x, r.a.y, r.a.z, r.a.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t bits = (w[e / 2] >> (16 * (e % 2))) & 0xffffu;
    x[e] = __uint_as_float(code == 1 ? widen16<1>(bits) : widen16<2>(bits));
  }
}

// The 16-byte unit (hi(a), hi(b), lo(a), lo(b)) of x = hi + lo, hi =
// tf32_rna(x), lo = tf32_rna(x - hi).
__device__ __forceinline__ uint4 split_pair(float a, float b) {
  uint4 u;
  t3::split1(a, u.x, u.z);
  t3::split1(b, u.y, u.w);
  return u;
}

// The unit of a half operand: (a, b), exact in TF32, with no lo.
__device__ __forceinline__ uint2 half_pair(float a, float b) {
  return make_uint2(__float_as_uint(a), __float_as_uint(b));
}

// Where lane l's unit lies in its 32-unit block: l ^ (l / 8), and for an
// odd n8 tile of V also ^ 4.  It permutes each 8-unit (128-byte) row, so a
// quarter warp's loads stay on eight distinct 16-byte bank groups, and it
// spreads the producer's stores of one step (units 4 g + t of one t, or of
// one g) over eight of them as well.
__device__ __forceinline__ int unit_k(int l) { return l ^ (l >> 3); }
__device__ __forceinline__ int unit_v(int l, int nt) {
  return l ^ (l >> 3) ^ ((nt & 1) << 2);
}

// K of one tile into registers: chunk c is row 8 nt + g, columns c0 + 8 sl
// .. c0 + 8 sl + 7 (g = c % 8, then sl, then nt), so lanes 0-7 read the
// same slice of eight rows; c0 is the staged slab's first column (0 but
// for the wide route's slabs past 512 columns).
template <class P>
__device__ __forceinline__ void load_k(AnyDtype kp, int k0, int c0, int s,
                                       int d, bool vec, int ptid,
                                       Raw8 (&x)[P::kKIters]) {
#pragma unroll
  for (int it = 0; it < P::kKIters; ++it) {
    const int c = ptid + kProducers * it;
    if (P::kKChunks % kProducers == 0 || c < P::kKChunks) {
      const int g = c % 8, sl = (c / 8) % P::kSlices, nt = (c / 8) / P::kSlices;
      x[it] = load_raw(kp, k0 + 8 * nt + g, c0 + 8 * sl, s, d, vec);
    }
  }
}

// ... split and stored as the B operand of S = Q K^T: unit (nt, sl, lane
// 4 g + t) holds K row 8 nt + g at columns 8 sl + t and 8 sl + t + 4 (b0,
// b1), at unit_k(4 g + t) of its block: an f32 K's hi then lo (16 bytes),
// a half K's values alone (8 bytes; the tile's first half).
template <class P>
__device__ __forceinline__ void store_k(uint4* kt, int code, bool vec,
                                        int ptid, Raw8 (&r)[P::kKIters]) {
#pragma unroll
  for (int it = 0; it < P::kKIters; ++it) {
    const int c = ptid + kProducers * it;
    if (P::kKChunks % kProducers == 0 || c < P::kKChunks) {
      const int g = c % 8, sl = (c / 8) % P::kSlices, nt = (c / 8) / P::kSlices;
      const int blk = (nt * P::kSlices + sl) * 32;
      float x[8];
      widen(r[it], code, vec, x);
      if (code == 0) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          kt[blk + unit_k(4 * g + t)] = split_pair(x[t], x[t + 4]);
        }
      } else {
        uint2* kh = reinterpret_cast<uint2*>(kt);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          kh[blk + unit_k(4 * g + t)] = half_pair(x[t], x[t + 4]);
        }
      }
    }
  }
}

// V of one tile into registers: chunk c is kv rows 8 j + 2 t and 8 j + 2 t
// + 1, columns c0 + 8 nt .. c0 + 8 nt + 7 (t = c % 4, then nt, then j).
template <class P>
__device__ __forceinline__ void load_v(AnyDtype vp, int k0, int c0, int s,
                                       int d, bool vec, int ptid,
                                       Raw8 (&x)[P::kVIters][2]) {
#pragma unroll
  for (int it = 0; it < P::kVIters; ++it) {
    const int c = ptid + kProducers * it;
    if (P::kVChunks % kProducers == 0 || c < P::kVChunks) {
      const int t = c % 4, nt = (c / 4) % P::kSlices, j = (c / 4) / P::kSlices;
      const int r = k0 + 8 * j + 2 * t;
      x[it][0] = load_raw(vp, r, c0 + 8 * nt, s, d, vec);
      x[it][1] = load_raw(vp, r + 1, c0 + 8 * nt, s, d, vec);
    }
  }
}

// ... split and stored as the B operand of O += P V.  P reaches the A
// fragment straight from the S accumulator, whose lane (g, t) holds
// columns 2t and 2t + 1 where the A fragment means t and t + 4: logical
// column kappa of kv slice j is P's column 8 j + perm(kappa), perm = (0, 2,
// 4, 6, 1, 3, 5, 7), so V's rows are permuted alike: unit (j, nt, lane 4 g
// + t) holds V rows 8 j + 2 t and 8 j + 2 t + 1 (b0 = row perm(t), b1 = row
// perm(t + 4)) at column 8 nt + g, at unit_v(4 g + t, nt) of its block: an
// f32 V's hi then lo, a half V's values alone.
template <class P>
__device__ __forceinline__ void store_v(uint4* vt, int code, bool vec,
                                        int ptid, Raw8 (&r)[P::kVIters][2]) {
#pragma unroll
  for (int it = 0; it < P::kVIters; ++it) {
    const int c = ptid + kProducers * it;
    if (P::kVChunks % kProducers == 0 || c < P::kVChunks) {
      const int t = c % 4, nt = (c / 4) % P::kSlices, j = (c / 4) / P::kSlices;
      const int blk = (j * P::kSlices + nt) * 32;
      float a[8], b[8];
      widen(r[it][0], code, vec, a);
      widen(r[it][1], code, vec, b);
      if (code == 0) {
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          vt[blk + unit_v(4 * g + t, nt)] = split_pair(a[g], b[g]);
        }
      } else {
        uint2* vh = reinterpret_cast<uint2*>(vt);
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          vh[blk + unit_v(4 * g + t, nt)] = half_pair(a[g], b[g]);
        }
      }
    }
  }
}

// Q's A fragments of a warp's 16 rows at columns c0 .. c0 + 8 kSl - 1, one
// unit a k8 slice, written and read by this thread alone: (row r0, col t),
// (r0 + 8, t), (r0, t + 4), (r0 + 8, t + 4) of the slice, as f32 (16 bytes)
// or, for a half q, as its 16-bit values (8 bytes); zero past row S and
// column D.
template <int kSl>
__device__ __forceinline__ void stage_q(uint4* qw, AnyDtype qp, int r0,
                                        int c0, int s, int d, int t,
                                        int lane) {
  const auto at = [&](int r, int c) { return (long long)r * d + c; };
  const auto in = [&](int r, int c) { return r < s && c < d; };
#pragma unroll 4
  for (int sl = 0; sl < kSl; ++sl) {
    const int c = c0 + 8 * sl + t;
    const int c1 = c + 4;
    if (qp.code == 0) {
      const auto ld = [&](int r, int cc) {
        return in(r, cc) ? __float_as_uint(load(qp, at(r, cc))) : 0u;
      };
      qw[sl * 32 + lane] = make_uint4(ld(r0, c), ld(r0 + 8, c),
                                      ld(r0, c1), ld(r0 + 8, c1));
    } else {
      const uint16_t* q16 = static_cast<const uint16_t*>(qp.p);
      const auto ld = [&](int r, int cc) {
        return in(r, cc) ? (uint32_t)q16[at(r, cc)] : 0u;
      };
      reinterpret_cast<uint2*>(qw)[sl * 32 + lane] =
          make_uint2(ld(r0, c) | ld(r0 + 8, c) << 16,
                     ld(r0, c1) | ld(r0 + 8, c1) << 16);
    }
  }
}

// S = Q K^T of one tile for a warp's 16 rows over kSl k8 slices (its column
// group: kt points at the group's first slice of the tile, whose n8 tiles
// lie P::kSlices slices apart), n8 tile nt into x[4 nt .. 4 nt + 3] (the
// m16n8 accumulator layout).  An f32 Q is split at each use (its f32 unit
// is the A fragment); a half Q (dtype code QC) is widened from its 8-byte
// unit.  Q_lo K_hi and Q_hi K_lo go to accumulators of their own, added to
// each other and then to Q_hi K_hi once the slices are done (small terms
// first).  A half operand's lo is zero and its product is not issued; the
// accumulator it frees takes every second (or third) slice's Q_hi K_hi, so
// that a tile always has three independent chains for each n8 tile.
template <class P, int kSl, int QC, bool kK32>
__device__ __forceinline__ void scores(float (&x)[P::kNT * 4],
                                       const uint4* qw, const uint4* kt,
                                       int lane) {
  constexpr bool kQ32 = QC == 0;
  // the accumulators Q_hi K_hi takes in turn: sc, then sa (a half Q),
  // then sb (a half K)
  constexpr int kTurns = 1 + !kQ32 + !kK32;
  const int uk = unit_k(lane);
  float sa[P::kNT][4], sb[P::kNT][4], sc[P::kNT][4];
#pragma unroll
  for (int nt = 0; nt < P::kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sa[nt][e] = sb[nt][e] = sc[nt][e] = 0.f;
  }
#pragma unroll
  for (int sl = 0; sl < kSl; ++sl) {
    uint32_t qh[4], ql[4];
    if constexpr (kQ32) {
      const uint4 qv = qw[sl * 32 + lane];
      t3::split1(__uint_as_float(qv.x), qh[0], ql[0]);
      t3::split1(__uint_as_float(qv.y), qh[1], ql[1]);
      t3::split1(__uint_as_float(qv.z), qh[2], ql[2]);
      t3::split1(__uint_as_float(qv.w), qh[3], ql[3]);
    } else {
      const uint2 qv = reinterpret_cast<const uint2*>(qw)[sl * 32 + lane];
      qh[0] = widen16<QC>(qv.x & 0xffffu);
      qh[1] = widen16<QC>(qv.x >> 16);
      qh[2] = widen16<QC>(qv.y & 0xffffu);
      qh[3] = widen16<QC>(qv.y >> 16);
    }
    const int turn = sl % kTurns;          // a constant once unrolled
#pragma unroll
    for (int nt = 0; nt < P::kNT; ++nt) {
      const int at = (nt * P::kSlices + sl) * 32 + uk;
      uint32_t kh0, kh1;
      if constexpr (kK32) {
        const uint4 kv = kt[at];
        kh0 = kv.x;
        kh1 = kv.y;
        if constexpr (kQ32) mma_tf32_m16n8k8(sa[nt], ql, kh0, kh1);
        mma_tf32_m16n8k8(sb[nt], qh, kv.z, kv.w);
      } else {
        const uint2 kv = reinterpret_cast<const uint2*>(kt)[at];
        kh0 = kv.x;
        kh1 = kv.y;
        if constexpr (kQ32) mma_tf32_m16n8k8(sa[nt], ql, kh0, kh1);
      }
      if (turn == 0) {
        mma_tf32_m16n8k8(sc[nt], qh, kh0, kh1);
      } else if (turn == 1 && !kQ32) {
        mma_tf32_m16n8k8(sa[nt], qh, kh0, kh1);
      } else {
        mma_tf32_m16n8k8(sb[nt], qh, kh0, kh1);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < P::kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[4 * nt + e] = (sa[nt][e] + sb[nt][e]) + sc[nt][e];
    }
  }
}

// scores() for the operands' dtype codes: q's, and whether K is f32.
template <class P, int kSl>
__device__ __forceinline__ void scores_any(float (&x)[P::kNT * 4],
                                           int q_code, bool k32,
                                           const uint4* qw, const uint4* kt,
                                           int lane) {
  if (q_code == 0) {
    if (k32) {
      scores<P, kSl, 0, true>(x, qw, kt, lane);
    } else {
      scores<P, kSl, 0, false>(x, qw, kt, lane);
    }
  } else if (q_code == 1) {
    if (k32) {
      scores<P, kSl, 1, true>(x, qw, kt, lane);
    } else {
      scores<P, kSl, 1, false>(x, qw, kt, lane);
    }
  } else if (k32) {
    scores<P, kSl, 2, true>(x, qw, kt, lane);
  } else {
    scores<P, kSl, 2, false>(x, qw, kt, lane);
  }
}

// P (the softmax's output in x) split into the A fragments of the tile's
// kv slices: slice j takes accumulator columns 8 j + 2t, 8 j + 2t + 1 of
// rows g, g + 8 as its a[0], a[2] and a[1], a[3].
template <class P>
__device__ __forceinline__ void split_p(const float (&x)[P::kNT * 4],
                                        uint32_t (&ph)[P::kNT][4],
                                        uint32_t (&pl)[P::kNT][4]) {
#pragma unroll
  for (int j = 0; j < P::kNT; ++j) {
    t3::split1(x[4 * j], ph[j][0], pl[j][0]);
    t3::split1(x[4 * j + 2], ph[j][1], pl[j][1]);
    t3::split1(x[4 * j + 1], ph[j][2], pl[j][2]);
    t3::split1(x[4 * j + 3], ph[j][3], pl[j][3]);
  }
}

// O *= alpha (per row), skipped when no row of the warp changed its max
// (alpha is exactly 1 then, so the result is the same).
template <int kCols>
__device__ __forceinline__ void rescale(float (&o)[kCols][4], float al0,
                                        float al1) {
  if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
    for (int nt = 0; nt < kCols; ++nt) {
      o[nt][0] = o[nt][0] * al0;
      o[nt][1] = o[nt][1] * al0;
      o[nt][2] = o[nt][2] * al1;
      o[nt][3] = o[nt][3] * al1;
    }
  }
}

// O += P_lo V_hi + P_hi V_lo + P_hi V_hi of one tile over kCols n8 tiles
// of O (a column group: vt points at the group's first n8 tile, an even
// one, so the swizzle's parity is the local tile's), small products first
// (P_hi V_lo not issued for a half V): kv slice j's A fragments are P's
// (ph[j], pl[j]); n8 tile nt of O its own accumulator.
template <class P, int kCols, bool kV32>
__device__ __forceinline__ void pv(float (&o)[kCols][4],
                                   uint32_t (&ph)[P::kNT][4],
                                   uint32_t (&pl)[P::kNT][4],
                                   const uint4* vt, int lane) {
#pragma unroll
  for (int j = 0; j < P::kNT; ++j) {
#pragma unroll
    for (int nt = 0; nt < kCols; ++nt) {
      const int at = (j * P::kSlices + nt) * 32 + unit_v(lane, nt);
      if constexpr (kV32) {
        const uint4 vv = vt[at];
        mma_tf32_m16n8k8(o[nt], pl[j], vv.x, vv.y);
        mma_tf32_m16n8k8(o[nt], ph[j], vv.z, vv.w);
        mma_tf32_m16n8k8(o[nt], ph[j], vv.x, vv.y);
      } else {
        const uint2 vv = reinterpret_cast<const uint2*>(vt)[at];
        mma_tf32_m16n8k8(o[nt], pl[j], vv.x, vv.y);
        mma_tf32_m16n8k8(o[nt], ph[j], vv.x, vv.y);
      }
    }
  }
}

// O / l of a warp's rows r0, r0 + 8 at columns c0 + 8 nt + 2t + {0, 1},
// rounded once to the output dtype, masked at row S and column D.
template <int kCols>
__device__ __forceinline__ void store_o(AnyOut ob, float (&o)[kCols][4],
                                        int r0, int c0, int s, int d, int t,
                                        float l0, float l1) {
  const float den0 = fmaxf(l0, 1e-30f);
  const float den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int nt = 0; nt < kCols; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 8 * nt + 2 * t + e;
      if (c >= d) continue;
      if (r0 < s) store(ob, (long long)r0 * d + c, o[nt][e] / den0);
      if (r0 + 8 < s) {
        store(ob, (long long)(r0 + 8) * d + c, o[nt][2 + e] / den1);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tf32x3_any_kernel(AnyDtype q, AnyDtype k, AnyDtype v,
                                  AnyOut out, int h, int hkv, int s, int d,
                                  float scale, int causal, int vec_k,
                                  int vec_v) {
  using P = Plan<DP>;
  constexpr int T = P::kBN;
  extern __shared__ __align__(16) uint4 ta_smem[];
  uint4* s_q = ta_smem;
  uint4* s_k = s_q + P::kQUnits;                  // 2 stages
  uint4* s_v = s_k + 2 * P::kTileUnits;           // 2 stages
  const uint32_t bar_full = smem_u32(s_v + 2 * P::kTileUnits);
  const uint32_t bar_empty = bar_full + 16;

  const long long bh = blockIdx.x;
  const long long kvh = (bh / h) * hkv + (bh % h) / (h / hkv);
  const int n_qt = (s + kBM - 1) / kBM;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kBM;   // longest first
  const int n_kt = causal ? (min(q0 + kBM, s) - 1) / T + 1 : (s + T - 1) / T;
  const long long slab = (long long)s * d;

  if (threadIdx.x == 0) {
    for (int st = 0; st < 2; ++st) {
      mbar_init(bar_full + 8 * st, kProducers);   // every producer thread
      mbar_init(bar_empty + 8 * st, 4);           // every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: tile i + 1's K and V are loaded into registers as soon as
    // tile i's are split and stored, so the loads are in flight while the
    // consumers multiply and the producer waits for a free stage
    const int ptid = threadIdx.x - 128;
    const AnyDtype kp = advance(k, kvh * slab);
    const AnyDtype vp = advance(v, kvh * slab);
    Raw8 kx[P::kKIters], vx[P::kVIters][2];
    load_k<P>(kp, 0, 0, s, d, vec_k, ptid, kx);
    load_v<P>(vp, 0, 0, s, d, vec_v, ptid, vx);
    for (int i = 0; i < n_kt; ++i) {
      const int st = i & 1;
      mbar_wait(bar_empty + 8 * st, ((i >> 1) & 1) ^ 1);
      store_k<P>(s_k + st * P::kTileUnits, k.code, vec_k, ptid, kx);
      store_v<P>(s_v + st * P::kTileUnits, v.code, vec_v, ptid, vx);
      mbar_arrive(bar_full + 8 * st);
      if (i + 1 < n_kt) {
        load_k<P>(kp, (i + 1) * T, 0, s, d, vec_k, ptid, kx);
        load_v<P>(vp, (i + 1) * T, 0, s, d, vec_v, ptid, vx);
      }
    }
    return;
  }

  // consumer warp: query rows [w0, w0 + 16); this thread holds rows r0 and
  // r0 + 8, columns 8 nt + 2 t + {0, 1} of S's n8 tiles and of O's
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int w0 = q0 + 16 * warp;
  const int r0 = w0 + g;
  uint4* qw = s_q + warp * P::kSlices * 32;
  stage_q<P::kSlices>(qw, advance(q, bh * slab), r0, 0, s, d, t, lane);
  const float scale2 = scale * 1.44269504088896341f;   // log2(e)
  const int lim0 = causal ? min(r0, s - 1) : s - 1;
  const int lim1 = causal ? min(r0 + 8, s - 1) : s - 1;
  const int lim_w = causal ? min(w0, s - 1) : s - 1;   // the warp's least
  const bool k32 = k.code == 0, v32 = v.code == 0;

  float o[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  }
  float m0 = kMaxInit, m1 = kMaxInit, l0 = 0.f, l1 = 0.f;
  for (int i = 0; i < n_kt; ++i) {
    const int st = i & 1;
    const int k0 = i * T;
    mbar_wait(bar_full + 8 * st, (i >> 1) & 1);
    // a warp whose rows all lie past S, or above a causal tile, skips it
    if (w0 < s && (!causal || k0 <= w0 + 15)) {
      float x[P::kNT * 4];
      scores_any<P, P::kSlices>(x, q.code, k32, qw, s_k + st * P::kTileUnits,
                                lane);
      float al0, al1;
      if (k0 + T - 1 > lim_w) {
        tc::online_softmax<true>(x, k0, t, lim0, lim1, scale2, 1.f, m0, m1,
                                 l0, l1, al0, al1);
      } else {
        tc::online_softmax<false>(x, k0, t, lim0, lim1, scale2, 1.f, m0, m1,
                                  l0, l1, al0, al1);
      }
      rescale(o, al0, al1);
      uint32_t ph[P::kNT][4], pl[P::kNT][4];
      split_p<P>(x, ph, pl);
      const uint4* vt = s_v + st * P::kTileUnits;
      if (v32) {
        pv<P, DP / 8, true>(o, ph, pl, vt, lane);
      } else {
        pv<P, DP / 8, false>(o, ph, pl, vt, lane);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
  }

  if (w0 >= s) return;
  store_o(advance_out(out, bh * slab), o, r0, 0, s, d, t, l0, l1);
}

// 16-byte loads: a 16-byte-aligned base and rows of a 16-byte multiple.
inline int vec16(AnyDtype a, int d) {
  return (int)(((unsigned long long)a.p & 15ull) == 0 &&
               (long long)d * (a.code == 0 ? 4 : 2) % 16 == 0);
}

template <int DP>
int launch(AnyDtype q, AnyDtype k, AnyDtype v, AnyOut out, long long b,
           int h, int hkv, int s, int d, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = Plan<DP>::kBytes;
  auto kernel = flash_attention_tf32x3_any_kernel<DP>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)(b * h), (unsigned)((s + kBM - 1) / kBM));
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, h, hkv, s, d, scale,
                                           causal, vec16(k, d), vec16(v, d));
  return (int)cudaGetLastError();
}

// ------------------- 3xTF32 through registers, D > 256: O over a warp pair

constexpr int kWideRows = 32;   // query rows a block: 2 row groups of 16
// registers a thread after setmaxnreg where a plan has two producer
// warpgroups (the block holds 384 x 168 at launch)
constexpr int kWideProducerRegs = 120;
constexpr int kWideConsumerRegs = 256;
static_assert(128 * kWideConsumerRegs + 256 * kWideProducerRegs <= 384 * 168,
              "the block's registers");

// The plan of the wide route at a staged slab width DP (320, 384 or 512;
// columns past D are zero): kv tiles of 16 rows at DP = 320 and of 8 at
// 384 and 512, so that Q (4 * 32 * DP bytes) and two stages of K_hi, K_lo,
// V_hi, V_lo (16 kBN DP bytes each) fit; the route through registers'
// units and producer, one warpgroup of it or two.  A warp owns one column
// half of its row group: kHalf k8 slices of Q K^T and n8 tiles of O.  Q's units are [4 warps][kHalf][32
// lanes]; the exchange of partial scores [2 parities][4 warps][kNT][32
// lanes] of float4.
template <int DP>
struct WidePlan : Tiles<DP, DP <= 320 ? 16 : 8> {
  using Base = Tiles<DP, DP <= 320 ? 16 : 8>;
  // producer warpgroups: one at 16-row tiles (a step's K and V take 88
  // registers a thread), two at 8-row tiles, each taking every second
  // step (setmaxnreg gives the consumers what they shed)
  static constexpr int kProducerGroups = Base::kBN == 8 ? 2 : 1;
  static constexpr int kThreads = 128 * (1 + kProducerGroups);
  static constexpr int kHalf = DP / 16;
  static constexpr int kQUnits = 4 * kHalf * 32;
  static constexpr int kXUnits = 2 * 4 * Base::kNT * 32;
  // units, then the barriers: full[2] (128 producer arrivals), empty[2]
  // (4 consumer warps)
  static constexpr size_t kBytes =
      16 * (size_t)(kQUnits + 4 * Base::kTileUnits + kXUnits) + 8 * 4;
  static_assert(kHalf % 2 == 0, "a half starts on an even n8 tile of O");
  static_assert(kBytes <= 232448, "the plan fits the 227 KB of a block");
};

// Warps 2 p and 2 p + 1 own query rows [q0 + 16 p, q0 + 16 p + 16); warp
// 2 p + c owns columns [c DP / 2, (c + 1) DP / 2) of each DP-column slab.
// Each walk over the kv tiles writes one slab of O (one walk up to D = DP,
// ceil(D / 512) past it); in each walk every score is the sum over the
// slabs of Q and K in order, each warp adding its halves' partials and
// the pair adding half 0's sum to half 1's, so every walk sees the same
// scores and softmax.  A step is one (walk, kv tile, slab) in that order:
// K's slab of the tile, and V's slab of the walk with the last slab.
template <int DP>
__global__ void __launch_bounds__(WidePlan<DP>::kThreads, 1)
flash_attention_tf32x3_wide_kernel(AnyDtype q, AnyDtype k, AnyDtype v,
                                   AnyOut out, int h, int hkv, int s, int d,
                                   float scale, int causal, int vec_k,
                                   int vec_v) {
  using P = WidePlan<DP>;
  constexpr int T = P::kBN;
  constexpr int W = DP / 2;
  extern __shared__ __align__(16) uint4 ta_smem[];
  uint4* s_q = ta_smem;
  uint4* s_k = s_q + P::kQUnits;                  // 2 stages
  uint4* s_v = s_k + 2 * P::kTileUnits;           // 2 stages
  float4* s_x = reinterpret_cast<float4*>(s_v + 2 * P::kTileUnits);
  const uint32_t bar_full = smem_u32(s_x + P::kXUnits);
  const uint32_t bar_empty = bar_full + 16;

  const long long bh = blockIdx.x;
  const long long kvh = (bh / h) * hkv + (bh % h) / (h / hkv);
  const int n_qt = (s + kWideRows - 1) / kWideRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * kWideRows;   // longest first
  const int n_kt = causal ? (min(q0 + kWideRows, s) - 1) / T + 1
                          : (s + T - 1) / T;
  const int n_ds = (d + DP - 1) / DP;              // slabs of DP columns
  const int n_steps = n_ds * n_kt * n_ds;
  const long long slab = (long long)s * d;

  if (threadIdx.x == 0) {
    for (int st = 0; st < 2; ++st) {
      mbar_init(bar_full + 8 * st, kProducers);   // every producer thread
      mbar_init(bar_empty + 8 * st, 4);           // every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer warpgroup wg takes every kProducerGroups-th step from step
    // wg: its next step's K (and V) slab is loaded into registers as soon
    // as this one's is split and stored, so the loads are in flight while
    // the consumers multiply (and the other warpgroup stores) and it waits
    // for a free stage
    constexpr int stride = P::kProducerGroups;
    if constexpr (stride == 2) setmaxnreg_dec<kWideProducerRegs>();
    const int wg = stride == 1 ? 0 : threadIdx.x / 128 - 1;
    const int ptid = threadIdx.x % 128;
    const AnyDtype kp = advance(k, kvh * slab);
    const AnyDtype vp = advance(v, kvh * slab);
    Raw8 kx[P::kKIters], vx[P::kVIters][2];
    // step = (oc * n_kt + i) * n_ds + dc: K's columns of slab dc of kv
    // tile i, with V's of slab oc at the last dc
    const auto fetch = [&](int step) {
      const int dc = step % n_ds;
      const int k0 = (step / n_ds) % n_kt * T;
      load_k<P>(kp, k0, dc * DP, s, d, vec_k, ptid, kx);
      if (dc == n_ds - 1) {
        load_v<P>(vp, k0, step / (n_ds * n_kt) * DP, s, d, vec_v, ptid, vx);
      }
    };
    if (wg < n_steps) fetch(wg);
    for (int step = wg; step < n_steps; step += stride) {
      const int st = step & 1;
      mbar_wait(bar_empty + 8 * st, ((step >> 1) & 1) ^ 1);
      store_k<P>(s_k + st * P::kTileUnits, k.code, vec_k, ptid, kx);
      if (step % n_ds == n_ds - 1) {
        store_v<P>(s_v + st * P::kTileUnits, v.code, vec_v, ptid, vx);
      }
      mbar_arrive(bar_full + 8 * st);
      if (step + stride < n_steps) fetch(step + stride);
    }
    return;
  }
  if constexpr (P::kProducerGroups == 2) setmaxnreg_inc<kWideConsumerRegs>();

  // consumer warp 2 p + c: rows [w0, w0 + 16), column half c; this thread
  // holds rows r0 and r0 + 8, columns 8 nt + 2 t + {0, 1} of S's n8 tiles
  // and of its half's n8 tiles of O
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pair = warp >> 1, c = warp & 1;
  const int g = lane / 4, t = lane % 4;
  const int w0 = q0 + 16 * pair;
  const int r0 = w0 + g;
  const AnyDtype qp = advance(q, bh * slab);
  uint4* qw = s_q + warp * P::kHalf * 32;
  if (n_ds == 1) stage_q<P::kHalf>(qw, qp, r0, c * W, s, d, t, lane);
  const float scale2 = scale * 1.44269504088896341f;   // log2(e)
  const int lim0 = causal ? min(r0, s - 1) : s - 1;
  const int lim1 = causal ? min(r0 + 8, s - 1) : s - 1;
  const int lim_w = causal ? min(w0, s - 1) : s - 1;   // the pair's least
  const bool k32 = k.code == 0, v32 = v.code == 0;
  const bool live = w0 < s;
  const AnyOut ob = advance_out(out, bh * slab);
  // this warp's half of a K or V tile: its first unit, 16 bytes (f32) or 8
  // (a half operand) each
  const auto group = [c](const uint4* tile, bool f32) {
    return f32 ? tile + c * P::kHalf * 32
               : reinterpret_cast<const uint4*>(
                     reinterpret_cast<const uint2*>(tile) + c * P::kHalf * 32);
  };
  int step = 0, n_x = 0;
  for (int oc = 0; oc < n_ds; ++oc) {
    float o[P::kHalf][4];
#pragma unroll
    for (int nt = 0; nt < P::kHalf; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
    }
    float m0 = kMaxInit, m1 = kMaxInit, l0 = 0.f, l1 = 0.f;
    for (int i = 0; i < n_kt; ++i) {
      const int k0 = i * T;
      // a pair whose rows all lie past S, or above a causal tile, skips it
      const bool act = live && (!causal || k0 <= w0 + 15);
      float x[P::kNT * 4];
      for (int dc = 0; dc < n_ds; ++dc, ++step) {
        const int st = step & 1;
        mbar_wait(bar_full + 8 * st, (step >> 1) & 1);
        if (act) {
          if (n_ds > 1) {
            stage_q<P::kHalf>(qw, qp, r0, dc * DP + c * W, s, d, t, lane);
          }
          float part[P::kNT * 4];
          scores_any<P, P::kHalf>(part, q.code, k32, qw,
                                  group(s_k + st * P::kTileUnits, k32), lane);
#pragma unroll
          for (int e = 0; e < P::kNT * 4; ++e) {
            x[e] = dc == 0 ? part[e] : x[e] + part[e];
          }
        }
        if (act && dc == n_ds - 1) {
          // the pair's exchange: each warp's partial into its buffer of
          // this parity, then half 0's + half 1's in both warps
          float4* xs = s_x + (n_x & 1) * 4 * P::kNT * 32;
#pragma unroll
          for (int nt = 0; nt < P::kNT; ++nt) {
            xs[(warp * P::kNT + nt) * 32 + lane] = make_float4(
                x[4 * nt], x[4 * nt + 1], x[4 * nt + 2], x[4 * nt + 3]);
          }
          named_bar_sync(1 + pair, 64);
#pragma unroll
          for (int nt = 0; nt < P::kNT; ++nt) {
            const float4 y = xs[((warp ^ 1) * P::kNT + nt) * 32 + lane];
            const float yy[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float mine = x[4 * nt + e];
              x[4 * nt + e] = c == 0 ? mine + yy[e] : yy[e] + mine;
            }
          }
          ++n_x;
          float al0, al1;
          if (k0 + T - 1 > lim_w) {
            tc::online_softmax<true>(x, k0, t, lim0, lim1, scale2, 1.f, m0,
                                     m1, l0, l1, al0, al1);
          } else {
            tc::online_softmax<false>(x, k0, t, lim0, lim1, scale2, 1.f, m0,
                                      m1, l0, l1, al0, al1);
          }
          rescale(o, al0, al1);
          uint32_t ph[P::kNT][4], pl[P::kNT][4];
          split_p<P>(x, ph, pl);
          const uint4* vt = group(s_v + st * P::kTileUnits, v32);
          if (v32) {
            pv<P, P::kHalf, true>(o, ph, pl, vt, lane);
          } else {
            pv<P, P::kHalf, false>(o, ph, pl, vt, lane);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * st);
      }
    }
    if (live) store_o(ob, o, r0, oc * DP + c * W, s, d, t, l0, l1);
  }
}

template <int DP>
int launch_wide(AnyDtype q, AnyDtype k, AnyDtype v, AnyOut out, long long b,
                int h, int hkv, int s, int d, float scale, int causal,
                cudaStream_t stream) {
  constexpr size_t smem = WidePlan<DP>::kBytes;
  auto kernel = flash_attention_tf32x3_wide_kernel<DP>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)(b * h),
                  (unsigned)((s + kWideRows - 1) / kWideRows));
  kernel<<<grid, WidePlan<DP>::kThreads, smem, stream>>>(
      q, k, v, out, h, hkv, s, d, scale, causal, vec16(k, d), vec16(v, d));
  return (int)cudaGetLastError();
}

}  // namespace ta

}  // namespace

extern "C" {

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


// The 3xTF32 tensor-core route: the same function over operands of dtype
// codes q_dtype, k_dtype, v_dtype (0 float32, 1 float16, 2 bfloat16),
// q [b, h, s, d], k and v [b, hkv, s, d], out like q in q's dtype,
// contiguous with 16-byte-aligned bases, d up to 128 and a multiple of 4
// (all f32) or 8 (any half operand).  Returns the cudaError_t of the
// launch (0 on success), or minus the CUresult of a tensor map the driver
// refuses.
int repro_flash_attention_tf32x3(const void* q, const void* k, const void* v,
                                 void* out, int q_dtype, int k_dtype,
                                 int v_dtype, long long b, int h, int hkv,
                                 int s, int d, float scale, int causal,
                                 void* stream) {
  const long long bh = b * h;
  const auto misaligned = [](const void* p) {
    return ((unsigned long long)p & 15ull) != 0;
  };
  const auto bad_code = [](int c) { return c < 0 || c > 2; };
  const int row = (q_dtype || k_dtype || v_dtype) ? 8 : 4;
  if (b < 1 || h < 1 || bh > 0x7fffffffLL || hkv < 1 || h % hkv || s < 1 ||
      (s + t3::kBM - 1) / t3::kBM > 65535 || d < row || d > kMaxD ||
      d % row || bad_code(q_dtype) || bad_code(k_dtype) ||
      bad_code(v_dtype) || misaligned(q) || misaligned(k) ||
      misaligned(v) || misaligned(out)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 64) {
    return t3::launch<64>(q, k, v, out, q_dtype, k_dtype, v_dtype, b, h, hkv,
                          s, d, scale, causal, st);
  }
  return t3::launch<128>(q, k, v, out, q_dtype, k_dtype, v_dtype, b, h, hkv,
                         s, d, scale, causal, st);
}

// The 3xTF32 route through registers: the same function over operands of
// dtype codes q_dtype, k_dtype, v_dtype, q [b, h, s, d], k and v
// [b, hkv, s, d], out like q in q's dtype, contiguous, any alignment, any
// d from 1 to 256.  Returns the cudaError_t of the launch (0 on success).
int repro_flash_attention_tf32x3_any(const void* q, const void* k,
                                     const void* v, void* out, int q_dtype,
                                     int k_dtype, int v_dtype, long long b,
                                     int h, int hkv, int s, int d,
                                     float scale, int causal, void* stream) {
  const long long bh = b * h;
  const auto bad_code = [](int c) { return c < 0 || c > 2; };
  if (b < 1 || h < 1 || bh > 0x7fffffffLL || hkv < 1 || h % hkv || s < 1 ||
      (s + ta::kBM - 1) / ta::kBM > 65535 || d < 1 || d > 256 ||
      bad_code(q_dtype) || bad_code(k_dtype) || bad_code(v_dtype)) {
    return (int)cudaErrorInvalidValue;
  }
  const AnyDtype qa{q, q_dtype}, ka{k, k_dtype}, va{v, v_dtype};
  const AnyOut oa{out, q_dtype};
  cudaStream_t st = (cudaStream_t)stream;
  // the staged head width: d rounded up to one of six instantiations
  if (d <= 32) {
    return ta::launch<32>(qa, ka, va, oa, b, h, hkv, s, d, scale, causal, st);
  }
  if (d <= 64) {
    return ta::launch<64>(qa, ka, va, oa, b, h, hkv, s, d, scale, causal, st);
  }
  if (d <= 128) {
    return ta::launch<128>(qa, ka, va, oa, b, h, hkv, s, d, scale, causal,
                           st);
  }
  if (d <= 160) {
    return ta::launch<160>(qa, ka, va, oa, b, h, hkv, s, d, scale, causal,
                           st);
  }
  if (d <= 192) {
    return ta::launch<192>(qa, ka, va, oa, b, h, hkv, s, d, scale, causal,
                           st);
  }
  return ta::launch<256>(qa, ka, va, oa, b, h, hkv, s, d, scale, causal, st);
}

// The 3xTF32 route for D > 256 (O's columns over a pair of warps): the
// same function over operands of dtype codes q_dtype, k_dtype, v_dtype,
// q [b, h, s, d], k and v [b, hkv, s, d], out like q in q's dtype,
// contiguous, any alignment, any d >= 1 (the wrapper sends it d > 256).
// Returns the cudaError_t of the launch (0 on success).
int repro_flash_attention_tf32x3_wide(const void* q, const void* k,
                                      const void* v, void* out, int q_dtype,
                                      int k_dtype, int v_dtype, long long b,
                                      int h, int hkv, int s, int d,
                                      float scale, int causal, void* stream) {
  const long long bh = b * h;
  const auto bad_code = [](int c) { return c < 0 || c > 2; };
  if (b < 1 || h < 1 || bh > 0x7fffffffLL || hkv < 1 || h % hkv || s < 1 ||
      (s + ta::kWideRows - 1) / ta::kWideRows > 65535 || d < 1 ||
      bad_code(q_dtype) || bad_code(k_dtype) || bad_code(v_dtype)) {
    return (int)cudaErrorInvalidValue;
  }
  const AnyDtype qa{q, q_dtype}, ka{k, k_dtype}, va{v, v_dtype};
  const AnyOut oa{out, q_dtype};
  cudaStream_t st = (cudaStream_t)stream;
  // the staged slab width: d rounded up to 320 or 384, else slabs of 512
  if (d <= 320) {
    return ta::launch_wide<320>(qa, ka, va, oa, b, h, hkv, s, d, scale,
                                causal, st);
  }
  if (d <= 384) {
    return ta::launch_wide<384>(qa, ka, va, oa, b, h, hkv, s, d, scale,
                                causal, st);
  }
  return ta::launch_wide<512>(qa, ka, va, oa, b, h, hkv, s, d, scale, causal,
                              st);
}

}  // extern "C"
