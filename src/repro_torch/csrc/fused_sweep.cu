// Fused decode -> evaluate -> reduce sweep megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused_sweep.py::_fused_kernel
// (the pl.pallas_call of repro/kernels/fused_sweep.py::fused_sweep_block),
// which inlines grid_decode.decode_axis_values and the coefficient-form
// Eq. 1-17 physics repro/core/batch.py::build_coeff_compute.
//
// One CUDA block per block of `bp` flat stream indices, one thread per
// design point (strided when bp exceeds the 256 threads):
//   1. decode   - flat index -> variant slot + per-axis grid index
//                 (variant-major, C order) -> axis value from the
//                 (n_axes, V * Lmax) table staged in shared memory;
//   2. evaluate - the banked Eq. 1-17 physics scalar-wise against the
//                 chunk's fused (W,) coefficient row, also in shared
//                 memory, in the SAME operation order as the plain-torch
//                 twin (repro_torch/core/batch.py); built with
//                 --fmad=false so no multiply/add pair is contracted;
//   3. reduce   - each thread keeps its own ascending (value, position)
//                 list of at most kk entries, then kk rounds of block-wide
//                 argmin over (value, position) pairs write the block's
//                 kk smallest masked metric values (ties to the lowest
//                 position, +inf padded); plus the block's masked metric
//                 sum and feasible count.
// Only (G, kk) candidates and (G,) sums / counts leave the kernel.
//
// What bounds it on the card: FP32 and SFU arithmetic per point (expf,
// logf, powf over the interpolated process-node and Walden-FoM tables,
// and IEEE divisions), not memory: the reads are O(W + table) floats per
// block and the writes O(kk) per block.  This first version is simple
// and exact rather than fast; fewer transcendental calls, a warp-level
// top-k and one launch per superchunk (or a CUDA graph) are later work.
//
// Plain C interface (repro_fused_sweep) for ctypes; the Python wrapper is
// repro_torch/kernels/fused_sweep.py::fused_sweep_block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAxes = 16;
constexpr int kMaxSlots = 16;    // cap on A, L, F, D and M
constexpr int kMaxList = 32;     // per-thread candidate list
constexpr int kTables = 4;       // dyn scale, SRAM leak, SRAM-HP leak, FoM
constexpr int kMaxKnots = 32;
constexpr int kCategories = 8;   // len(CATEGORIES)
constexpr int kRed = kCategories + 2;

// Fused-row slots, in repro_torch.core.plan_bank.LAYOUT_FIELDS order.
enum Field {
  A_CONST, A_PAD_COEFF, A_OPS,
  LIN_ARR, LIN_COEFF, LIN_INV,
  FOM_ARR, FOM_SCALE, FOM_INV, FOM_BITS,
  D_VALID, D_IS_SYS, D_DYN, D_ROLE, D_NODE, D_STATIC, D_CLOCK, D_CYCLES,
  D_MACS, D_UTIL, D_EDGE_W, D_EDGE_MASK,
  M_READS_FIXED, M_READS_DNN2, M_WRITES, M_BITS_TOTAL, M_BITS_PA,
  M_SIZE_F, M_ALPHA, M_ROLE, M_NODE, M_AREA_ROLE, M_TECH,
  M_READ_X, M_WRITE_X, M_LEAK_X,
  N_PHASES, STACKED, N_PIXELS, UTSV_BYTES, MIPI_BYTES,
  WEIGHTS,
  N_FIELDS
};

// Interpolation tables, in repro_torch.core.batch.interp_tables() order.
enum Table { T_DYN = 0, T_LEAK = 1, T_HP = 2, T_FOM = 3 };

// Axis rows of the decode table, in repro_torch.core.axes.AXES order.
enum Axis {
  X_CIS, X_SOC, X_MEM_TECH, X_SYS_ROWS, X_SYS_COLS, X_FRAME_RATE,
  X_AFS, X_PITCH, X_VDD, X_ADC, N_AXES_USED
};

// Metric codes, in repro_torch.kernels.fused_sweep.KERNEL_OUTPUTS order:
// the categories' sums, then these.
enum Out {
  O_TOTAL = kCategories, O_ON_SENSOR, O_T_D, O_T_A, O_FEASIBLE, O_AREA,
  O_POWER, O_DENSITY
};

}  // namespace

// Mirrored field for field by repro_torch.kernels.fused_sweep._Params.
struct SweepParams {
  long long start, low, limit, total, n_var, chunk;
  long long shape[kMaxAxes];
  long long stride[kMaxAxes];
  int bp, kk, list_len, lmax, table_cols, width, n_axes, metric;
  int A, L, F, D, M, n_units;
  int off[N_FIELDS];
  int n_knots[kTables];
  float xs[kTables][kMaxKnots];
  float ys[kTables][kMaxKnots];
  float dx[kTables][kMaxKnots];
  float dy[kTables][kMaxKnots];
  float c_sram_access, c_stt_read, c_stt_write, c_stt_leak, c_utsv, c_mipi;
  float c_ln2, c_inv_ln10;
};

namespace {

// NaN-propagating max / min, like torch.maximum and jnp.maximum.
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// Clamped piecewise-linear interpolation over static f32 knots: locates
// the one segment xs[i] <= x < xs[i+1] and evaluates the same
// ys[i] + ((x - xs[i]) / dx[i]) * dy[i] as the twin, which computes every
// segment and keeps that one.  Below the first knot (or NaN) gives ys[0].
__device__ __forceinline__ float interp(const SweepParams& p, int t,
                                        float x) {
  const int n = p.n_knots[t];
  if (x >= p.xs[t][n - 1]) return p.ys[t][n - 1];
  if (!(x >= p.xs[t][0])) return p.ys[t][0];
  int i = 0;
  while (!(x < p.xs[t][i + 1])) ++i;    // ends: x < xs[n - 1]
  return p.ys[t][i] + ((x - p.xs[t][i]) / p.dx[t][i]) * p.dy[t][i];
}

__device__ __forceinline__ float node_for(float role, float declared,
                                          float cis, float soc) {
  return role == 0.f ? cis : (role == 1.f ? soc : declared);
}

// The Eq. 1-17 physics of one design point against one fused row;
// returns the selected metric and whether the point is feasible.
__device__ __forceinline__ float evaluate(const SweepParams& p,
                                          const float* __restrict__ r,
                                          const float* v,
                                          bool* feasible_out) {
  const int* off = p.off;
  const int A = p.A, L = p.L, F = p.F, D = p.D, M = p.M;
  const float cis = v[X_CIS], soc = v[X_SOC], mem_tech = v[X_MEM_TECH];
  const float rows = v[X_SYS_ROWS], cols = v[X_SYS_COLS];
  const float fr = v[X_FRAME_RATE], afs = v[X_AFS], pitch_um = v[X_PITCH];
  const float vdd = v[X_VDD], adc = v[X_ADC];

  const float frame_time = 1.f / fr;
  const float dyn_v = vdd * vdd;
  const float stat_v = vdd;

  // ----- Sec. 4.1 digital timing over padded slots ------------------------
  float durs[kMaxSlots], starts[kMaxSlots];
  float t_d = 0.f;
  if (D) {
    const float rc = rows * cols;
    const float rpc = rows + cols;
    for (int d = 0; d < D; ++d) {
      const float thr = rc * r[off[D_UTIL] + d];
      const float cyc = r[off[D_IS_SYS] + d] > 0.5f
                            ? ceilf(r[off[D_MACS] + d] / thr) + rpc
                            : r[off[D_CYCLES] + d];
      durs[d] = cyc / r[off[D_CLOCK] + d];
    }
    for (int i = 0; i < D; ++i) {
      float s = 0.f;
      for (int j = 0; j < i; ++j) {
        const float cand = r[off[D_EDGE_MASK] + i * D + j] > 0.5f
                               ? starts[j] + r[off[D_EDGE_W] + i * D + j] * durs[j]
                               : 0.f;
        s = nmax(s, cand);
      }
      starts[i] = s;
    }
    float mx = -INFINITY, mn = INFINITY;
    bool any = false;
    for (int d = 0; d < D; ++d) {
      if (r[off[D_VALID] + d] > 0.5f) {
        mx = nmax(mx, starts[d] + durs[d]);
        mn = nmin(mn, starts[d]);
        any = true;
      }
    }
    t_d = any ? mx - mn : 0.f;
  }
  const float t_a = (frame_time - t_d) / r[off[N_PHASES]];
  const bool feasible = t_a > 0.f;

  // per-category sums, accumulated in unit order
  // [analog | digital | memory | utsv | mipi]
  float red[kRed];
  for (int c = 0; c < kRed; ++c) red[c] = 0.f;
  int u = 0;
  auto add_unit = [&](float e) {
    const float* w = r + off[WEIGHTS] + u * kRed;
    for (int c = 0; c < kRed; ++c) red[c] = red[c] + w[c] * e;
    ++u;
  };

  // ----- analog rows (Eqs. 2-13) ------------------------------------------
  if (A) {
    float e_access[kMaxSlots], acc[kMaxSlots];
    for (int a = 0; a < A; ++a) e_access[a] = r[off[A_CONST] + a] * dyn_v;
    if (L) {
      for (int a = 0; a < A; ++a) acc[a] = 0.f;
      for (int l = 0; l < L; ++l) {
        const int la = (int)r[off[LIN_ARR] + l];
        const float pad = t_a * r[off[A_PAD_COEFF] + la];
        const float t_cell = nmax(pad * r[off[LIN_INV] + l], 1e-12f);
        acc[la] = acc[la] + r[off[LIN_COEFF] + l] * t_cell * stat_v;
      }
      for (int a = 0; a < A; ++a) e_access[a] = e_access[a] + acc[a];
    }
    if (F) {
      for (int a = 0; a < A; ++a) acc[a] = 0.f;
      for (int f = 0; f < F; ++f) {
        const int fa = (int)r[off[FOM_ARR] + f];
        const float pad = t_a * r[off[A_PAD_COEFF] + fa];
        const float t_cell = nmax(pad * r[off[FOM_INV] + f], 1e-12f);
        const float rate = 1.f / t_cell;
        // log10 and exp2 as the reference evaluates them
        float fom = powf(10.f, interp(p, T_FOM, logf(rate) * p.c_inv_ln10));
        const float ref_bits = r[off[FOM_BITS] + f];
        const float mod = (adc < 0.f || ref_bits <= 1.f)
                              ? 1.f
                              : expf(p.c_ln2 * (adc - ref_bits));
        fom = fom * mod;
        acc[fa] = acc[fa] + r[off[FOM_SCALE] + f] * fom * dyn_v;
      }
      for (int a = 0; a < A; ++a) e_access[a] = e_access[a] + acc[a];
    }
    for (int a = 0; a < A; ++a) add_unit(e_access[a] * r[off[A_OPS] + a]);
  }

  // ----- digital compute rows (Eqs. 14-15) --------------------------------
  for (int d = 0; d < D; ++d) {
    const float node = node_for(r[off[D_ROLE] + d], r[off[D_NODE] + d], cis, soc);
    const float s_u = expf(interp(p, T_DYN, node));
    add_unit(r[off[D_DYN] + d] * s_u * dyn_v
             + r[off[D_STATIC] + d] * durs[d] * stat_v);
  }

  // ----- memory rows (Eq. 16) ---------------------------------------------
  for (int m = 0; m < M; ++m) {
    const float node = node_for(r[off[M_ROLE] + m], r[off[M_NODE] + m], cis, soc);
    const float s_m = expf(interp(p, T_DYN, node));
    const float tech = mem_tech >= 0.f ? mem_tech : r[off[M_TECH] + m];
    const bool is_stt = tech == 2.f;
    const float bits = r[off[M_BITS_PA] + m];
    const float sram_access = p.c_sram_access * bits * r[off[M_SIZE_F] + m] * s_m;
    float read_e = is_stt ? p.c_stt_read * bits * s_m : sram_access;
    float write_e = is_stt ? p.c_stt_write * bits * s_m : sram_access;
    const float rx = r[off[M_READ_X] + m];
    const float wx = r[off[M_WRITE_X] + m];
    const float lx = r[off[M_LEAK_X] + m];
    if (!isnan(rx)) read_e = rx;
    if (!isnan(wx)) write_e = wx;
    // both interpolations are evaluated, as in the twin's torch.where
    const float hp = expf(interp(p, T_HP, node));
    const float lk = expf(interp(p, T_LEAK, node));
    const float leak_bit = is_stt ? p.c_stt_leak : (tech == 1.f ? hp : lk);
    float leak = leak_bit * r[off[M_BITS_TOTAL] + m];
    if (!isnan(lx)) leak = lx;
    const float reads = r[off[M_READS_FIXED] + m]
                        + r[off[M_READS_DNN2] + m] / nmax(rows, 1.f);
    const float alpha = r[off[M_ALPHA] + m] * afs;
    add_unit((read_e * reads + write_e * r[off[M_WRITES] + m]) * dyn_v
             + leak * frame_time * alpha * stat_v);
  }

  // ----- communication rows (Eq. 17) --------------------------------------
  add_unit(r[off[UTSV_BYTES]] * p.c_utsv);
  add_unit(r[off[MIPI_BYTES]] * p.c_mipi);

  // ----- Sec. 6.2 power density -------------------------------------------
  const float pitch = pitch_um * 1e-3f;
  const float analog_area = r[off[N_PIXELS]] * (pitch * pitch);
  float digital_area = 0.f;
  for (int m = 0; m < M; ++m) {
    const float na = node_for(r[off[M_AREA_ROLE] + m], r[off[M_NODE] + m],
                              cis, soc) * 1e-6f;
    const float cell_area = 150.f * (na * na);
    digital_area = digital_area + r[off[M_BITS_TOTAL] + m] * cell_area;
  }
  const float area = r[off[STACKED]] > 0.f ? nmax(analog_area, digital_area)
                                           : analog_area + digital_area;

  *feasible_out = feasible;
  const int k = p.metric;
  if (k < kRed) return red[k];
  switch (k) {
    case O_T_D: return t_d;
    case O_T_A: return t_a;
    case O_FEASIBLE: return feasible ? 1.f : 0.f;
    case O_AREA: return area;
    default: break;
  }
  const float power = red[O_ON_SENSOR] * fr * 1e3f;
  if (k == O_POWER) return power;
  return power / nmax(area, 1e-9f);     // O_DENSITY
}

// (value, position) lexicographic less-than: ties go to the lower position.
__device__ __forceinline__ bool pair_less(float v, int p, float ov, int op) {
  return v < ov || (v == ov && p < op);
}

template <typename IdxT>
__global__ void __launch_bounds__(kThreads)
fused_sweep_kernel(const float* __restrict__ table2,
                   const float* __restrict__ row,
                   const __grid_constant__ SweepParams p,
                   float* __restrict__ cand_v, int* __restrict__ cand_l,
                   float* __restrict__ sums, float* __restrict__ counts) {
  extern __shared__ float smem[];
  float* s_row = smem;
  float* s_tab = smem + p.width;
  __shared__ float s_wv[kWarps];
  __shared__ int s_wp[kWarps];
  __shared__ float s_ws[kWarps];
  __shared__ float s_wc[kWarps];
  __shared__ float s_best_v;
  __shared__ int s_best_p;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < p.width; i += kThreads) s_row[i] = row[i];
  const int tab_n = p.n_axes * p.table_cols;
  for (int i = tid; i < tab_n; i += kThreads) s_tab[i] = table2[i];
  __syncthreads();

  const IdxT g = (IdxT)blockIdx.x;
  const IdxT start = (IdxT)p.start, low = (IdxT)p.low, limit = (IdxT)p.limit;
  const IdxT total = (IdxT)p.total, n_var = (IdxT)p.n_var;
  const IdxT chunk = (IdxT)p.chunk;

  float lv[kMaxList];
  int lp[kMaxList];
  int ln = 0;
  float tsum = 0.f, tcnt = 0.f;

  for (int q = tid; q < p.bp; q += kThreads) {
    const IdxT pos = g * (IdxT)p.bp + (IdxT)q;
    const bool in_chunk = pos < chunk;
    // padding positions decode index `start`: never past the int range
    const IdxT o = start + (in_chunk ? pos : (IdxT)0);
    const bool valid = in_chunk && o >= low && o < limit;
    const IdxT oc = o < total - 1 ? o : total - 1;   // clamp the tail
    const IdxT vid = oc / n_var;
    const IdxT local = oc - vid * n_var;
    float vals[kMaxAxes];
    for (int a = 0; a < p.n_axes; ++a) {
      const IdxT ia = (local / (IdxT)p.stride[a]) % (IdxT)p.shape[a];
      vals[a] = s_tab[a * p.table_cols + (int)vid * p.lmax + (int)ia];
    }
    bool feas;
    const float mv = evaluate(p, s_row, vals, &feas);
    const bool ok = feas && valid;
    const float m = ok ? mv : INFINITY;
    tsum += ok ? mv : 0.f;
    tcnt += ok ? 1.f : 0.f;
    // ascending insert; positions arrive in increasing order, so a tie
    // keeps the earlier position ahead (strict compares)
    if (ln < p.list_len || m < lv[ln - 1]) {
      int i = ln < p.list_len ? ln++ : p.list_len - 1;
      while (i > 0 && lv[i - 1] > m) {
        lv[i] = lv[i - 1];
        lp[i] = lp[i - 1];
        --i;
      }
      lv[i] = m;
      lp[i] = q;
    }
  }

  // ----- block sum / count of the masked metric ---------------------------
  for (int o = 16; o > 0; o >>= 1) {
    tsum += __shfl_down_sync(0xffffffffu, tsum, o);
    tcnt += __shfl_down_sync(0xffffffffu, tcnt, o);
  }
  if (lane == 0) {
    s_ws[warp] = tsum;
    s_wc[warp] = tcnt;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f, c = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      s += s_ws[w];
      c += s_wc[w];
    }
    sums[blockIdx.x] = s;
    counts[blockIdx.x] = c;
  }

  // ----- block top-kk: kk rounds of block-wide (value, position) argmin ---
  int head = 0;
  for (int j = 0; j < p.kk; ++j) {
    float bv = head < ln ? lv[head] : INFINITY;
    int bq = head < ln ? lp[head] : INT32_MAX;
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, o);
      const int oq = __shfl_down_sync(0xffffffffu, bq, o);
      if (pair_less(ov, oq, bv, bq)) {
        bv = ov;
        bq = oq;
      }
    }
    if (lane == 0) {
      s_wv[warp] = bv;
      s_wp[warp] = bq;
    }
    __syncthreads();
    if (tid == 0) {
      float v = s_wv[0];
      int q = s_wp[0];
      for (int w = 1; w < kWarps; ++w) {
        if (pair_less(s_wv[w], s_wp[w], v, q)) {
          v = s_wv[w];
          q = s_wp[w];
        }
      }
      s_best_v = v;
      s_best_p = q;
      const size_t at = (size_t)blockIdx.x * p.kk + j;
      cand_v[at] = v;
      cand_l[at] = q == INT32_MAX ? 0 : q;   // exhausted: +inf, index 0
    }
    __syncthreads();
    if (head < ln && lp[head] == s_best_p) ++head;
  }
}

template <typename IdxT>
int launch(const float* table2, const float* row, const SweepParams& p,
           float* cand_v, int* cand_l, float* sums, float* counts,
           cudaStream_t stream) {
  const long long nb = (p.chunk + p.bp - 1) / p.bp;
  const size_t smem = (size_t)(p.width + p.n_axes * p.table_cols) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_sweep_kernel<IdxT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_sweep_kernel<IdxT><<<(unsigned)nb, kThreads, smem, stream>>>(
      table2, row, p, cand_v, cand_l, sums, counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// sizeof(SweepParams) and the layout/table caps, checked by the wrapper
// against its ctypes mirror before the first launch.
int repro_fused_sweep_abi(int what) {
  switch (what) {
    case 0: return (int)sizeof(SweepParams);
    case 1: return N_FIELDS;
    case 2: return kMaxAxes;
    case 3: return kMaxSlots;
    case 4: return kMaxList;
    case 5: return kMaxKnots;
    case 6: return kCategories;
    case 7: return N_AXES_USED;
    // metric codes, in the wrapper's _OTHER_METRICS order
    case 8: return O_TOTAL;
    case 9: return O_ON_SENSOR;
    case 10: return O_T_D;
    case 11: return O_T_A;
    case 12: return O_FEASIBLE;
    case 13: return O_AREA;
    case 14: return O_POWER;
    case 15: return O_DENSITY;
    default: return -1;
  }
}

// Launch the megakernel on `stream`; returns the cudaError_t of the
// launch (0 on success).  All pointers are device pointers except `p`.
int repro_fused_sweep(const float* table2, const float* row,
                      const SweepParams* p, int idx64, float* cand_v,
                      int* cand_l, float* sums, float* counts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (idx64) {
    return launch<long long>(table2, row, *p, cand_v, cand_l, sums, counts, s);
  }
  return launch<int>(table2, row, *p, cand_v, cand_l, sums, counts, s);
}

}  // extern "C"
