// Fused decode -> evaluate -> reduce sweep megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused_sweep.py::_fused_kernel
// (the pl.pallas_call of repro/kernels/fused_sweep.py::fused_sweep_block),
// which inlines grid_decode.decode_axis_values and the coefficient-form
// Eq. 1-17 physics repro/core/batch.py::build_coeff_compute.
//
// Each logical block of `bp` flat stream indices is spread over a
// thread-block cluster of `cluster` CTAs of 256 threads (1-8, picked by
// the wrapper's plan: a 2^18-point chunk in blocks of 4096 takes clusters
// of 4, 256 CTAs, about two on each of the 132 SMs); CTA `rank` owns the
// block's points [rank * rank_points, (rank + 1) * rank_points) and takes
// them in passes of at most `span` points (`ppt` a thread; one pass at
// the main-path shape, more for CTAs of more than 8,192 points or for
// tables too wide for the variants a whole tile may reach):
//   1. prologue - the fused (W,) coefficient row and the interpolation
//                 knots are staged in shared memory once; for each pass
//                 that reaches other variants than the last, those
//                 variants' axis values (each axis's own length, back to
//                 back) are staged, and every term that depends on one
//                 axis value alone is tabled from them, by the same
//                 expressions the per-point code used to evaluate:
//                 exp(interp(T_DYN | T_HP | T_LEAK, node)) and the cell
//                 area 150 (node 1e-6)^2 over the cis_node and soc_node
//                 values (and each slot's declared node, once), the
//                 Walden-FoM ADC factor exp(ln2 (adc - ref_bits)) over the
//                 adc_bits values for each FoM row, and, when it fits the
//                 shared memory left, the Sec. 4.1 digital timing (each
//                 stage's duration, the DAG's span) with each memory row's
//                 reads for each (sys_rows, sys_cols) pair (else each
//                 point times its own).  The same code on the same floats
//                 gives the same bits;
//   2. decode   - flat index -> variant slot + per-axis digit without a
//                 division: each divisor (n_var and every axis size) has
//                 an exact magic multiplier made on the host
//                 (q = (umulhi(n, m) + n) >> s, Granlund-Montgomery);
//   3. evaluate - the banked Eq. 1-17 physics against the row, in the
//                 SAME operation order as the plain-torch twin
//                 (repro_torch/core/batch.py), built with --fmad=false;
//                 per-slot loops are unrolled to a compile-time bound S
//                 (4 or 16, a template argument) and guarded, so every
//                 per-point array lives in registers; of the per-unit
//                 category fold only the column the metric reads is
//                 summed (the columns sum independently);
//   4. reduce   - each point's masked metric goes to shared memory as a
//                 key that orders as the float does; each warp takes its
//                 kw least (key, position) pairs of the pass by successive
//                 lexicographic successors, two redux.sync a round (ties
//                 to the lowest position); warp 0 merges the warps' lists
//                 and the CTA's running list into the CTA's kc least;
//                 after the last pass rank 0 gathers the cluster's lists
//                 and partial sums through distributed shared memory and
//                 merges them the same way into the block's kk candidates
//                 (+inf, position 0 padded past bp), and adds the ranks'
//                 masked sums and counts in rank order.
// Only (G, kk) candidates and (G,) sums / counts leave the kernel.
//
// What bounds it on the card: the issue of the per-point instructions,
// not memory (the reads are O(W + a pass's variants' axis values) floats
// per CTA, the writes O(kk) per block).  After the hoisting a point still
// pays the FoM row's log / pow and its interpolation, the frame time's and
// t_a's IEEE divisions, the decode's 10 multiply-high divisions and one
// category column; at the main-path shape that is most of a CTA's time,
// and the rest is the prologue (O(8 (cis + soc) + F adc) expf for each
// variant a pass reaches: one, mostly), the merge rounds and two cluster
// barriers, whose latency no other work hides; so clusters of 8 (twice
// the CTAs) lose to clusters of 4 (chip_smoke.py's fused_probe, PERF.md).
//
// Plain C interface (repro_fused_sweep) for ctypes; the Python wrapper is
// repro_torch/kernels/fused_sweep.py::fused_sweep_block, whose plan()
// picks cluster, rank_points, tile and ppt, whose staging() picks span,
// nv and tim from the table's geometry, and whose smem_floats() lays out
// the same shared memory as layout_of() below.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grid_decode.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAxes = 16;
constexpr int kMaxSlots = 16;    // cap on A, L, F, D and M
constexpr int kTables = 4;       // dyn scale, SRAM leak, SRAM-HP leak, FoM
constexpr int kMaxKnots = 32;
constexpr int kCategories = 8;   // len(CATEGORIES)
constexpr int kRed = kCategories + 2;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kNodeKinds = 4;    // dyn, HP leak, leak, cell area
constexpr int kDecl = 5;         // per-slot declared: dyn_d, dyn_m, hp, lk, area

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

// Hoisted node tables: kind (this enum) x [cis values | soc values] of the
// staged variants.
enum NodeKind { K_DYN = 0, K_HP = 1, K_LK = 2, K_AREA = 3 };

}  // namespace

// Mirrored field for field by repro_torch.kernels.fused_sweep._Params.
struct SweepParams {
  long long start, low, limit, total, n_var, chunk;
  long long shape[kMaxAxes];
  // exact magic multipliers of n_var and each axis size, for 32-bit and
  // 64-bit dividends, and their common shift ceil(log2 d)
  unsigned long long mul64_var, mul64[kMaxAxes];
  unsigned int mul32_var, mul32[kMaxAxes];
  int shift_var, shift[kMaxAxes];
  int bp, kk, cluster, rank_points, tile, ppt, kw, kc, kout, smem;
  // a pass: at most `span` points, reaching at most `nv` variants, whose
  // axis values take `sum_shape` words each (axis a from pre[a]); `tim`:
  // the (sys_rows, sys_cols) timing is tabled
  int span, nv, tim, sum_shape;
  int pre[kMaxAxes];
  int lmax, table_cols, width, n_axes, metric;
  int A, L, F, D, M, n_units;
  int off[N_FIELDS];
  int n_knots[kTables];
  float c_sram_access, c_stt_read, c_stt_write, c_stt_leak, c_utsv, c_mipi;
  float c_ln2, c_inv_ln10;
};

namespace {

// Offsets (in 4-byte words) of the shared-memory regions; the wrapper's
// smem_floats() computes the same total.  The per-pass tables hold `nv`
// variants: their axis values, the node tables over their cis and soc
// values, the ADC factors over their adc values and, when `tim`, the
// timing of their (sys_rows, sys_cols) pairs.
struct Layout {
  int row, knots, decl, tab, node, adc, tim, key, wk, wq, rk, rq, ck, cq,
      gk, gq, red, total;
};

__host__ __device__ inline Layout layout_of(const SweepParams& p) {
  Layout l;
  const int cis = (int)p.shape[X_CIS], soc = (int)p.shape[X_SOC];
  const int n_rc = (int)(p.shape[X_SYS_ROWS] * p.shape[X_SYS_COLS]);
  l.row = 0;
  l.knots = l.row + p.width;
  l.decl = l.knots + 4 * kTables * kMaxKnots;
  l.tab = l.decl + kDecl * kMaxSlots;
  l.node = l.tab + p.nv * p.sum_shape;
  l.adc = l.node + kNodeKinds * p.nv * (cis + soc);
  l.tim = l.adc + p.F * p.nv * (int)p.shape[X_ADC];
  l.key = l.tim + (p.tim ? p.nv * n_rc * (p.D + 1 + p.M) : 0);
  l.wk = l.key + p.tile;
  l.wq = l.wk + kWarps * p.kw;
  l.rk = l.wq + kWarps * p.kw;
  l.rq = l.rk + p.kc;
  l.ck = l.rq + p.kc;
  l.cq = l.ck + p.kc;
  l.gk = l.cq + p.kc;
  l.gq = l.gk + p.cluster * p.kc;
  l.red = l.gq + p.cluster * p.kc;
  l.total = l.red + 2 * kWarps + 2 + 2 * p.cluster;
  return l;
}

// NaN-propagating max / min, like torch.maximum and jnp.maximum.
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// Clamped piecewise-linear interpolation over the f32 knots staged in
// shared memory (`kn`: xs, ys, dx, dy, each [kTables][kMaxKnots]):
// locates the one segment xs[i] <= x < xs[i+1] (a binary search: the
// wrapper checks that the knots increase strictly) and evaluates the same
// ys[i] + ((x - xs[i]) / dx[i]) * dy[i] as the twin, which computes every
// segment and keeps that one.  Below the first knot (or NaN) gives ys[0].
__device__ __forceinline__ float interp(const float* kn, int n, int t,
                                        float x) {
  const float* xs = kn + t * kMaxKnots;
  const float* ys = xs + kTables * kMaxKnots;
  const float* dx = ys + kTables * kMaxKnots;
  const float* dy = dx + kTables * kMaxKnots;
  if (x >= xs[n - 1]) return ys[n - 1];
  if (!(x >= xs[0])) return ys[0];
  int i = 0, hi = n - 1;           // xs[i] <= x < xs[hi]
  while (hi - i > 1) {
    const int mid = (i + hi) >> 1;
    if (x < xs[mid]) {
      hi = mid;
    } else {
      i = mid;
    }
  }
  return ys[i] + ((x - xs[i]) / dx[i]) * dy[i];
}

// The divisors' magic multipliers by index type (fdiv: grid_decode.cuh).
template <typename IdxT> struct Magic;
template <> struct Magic<int> {
  using U = unsigned int;
  static __device__ __forceinline__ U var(const SweepParams& p) {
    return p.mul32_var;
  }
  static __device__ __forceinline__ U axis(const SweepParams& p, int a) {
    return p.mul32[a];
  }
};
template <> struct Magic<long long> {
  using U = unsigned long long;
  static __device__ __forceinline__ U var(const SweepParams& p) {
    return p.mul64_var;
  }
  static __device__ __forceinline__ U axis(const SweepParams& p, int a) {
    return p.mul64[a];
  }
};

// One design point: the axis values the physics reads, and its entries
// in the hoisted tables (cis, soc and adc values; (sys_rows, sys_cols)
// pair) of the staged variants.
struct Point {
  float mem_tech, rows, cols, fr, afs, pitch, vdd;
  int cc, sc, ac, te;
};

// Flat index o (clamped to total - 1) -> its point, variant-major and C
// order within a variant, the digits taken innermost first; its variant
// is one of those staged from v_lo on.
template <typename IdxT>
__device__ __forceinline__ Point decode(const SweepParams& p, IdxT o,
                                        const float* s_tab, int v_lo) {
  using U = typename Magic<IdxT>::U;
  const U oc = (U)(o < (IdxT)p.total - 1 ? o : (IdxT)p.total - 1);
  const U vid = fdiv(oc, Magic<IdxT>::var(p), p.shift_var);
  U local = oc - vid * (U)p.n_var;
  int col[N_AXES_USED];
#pragma unroll
  for (int a = N_AXES_USED - 1; a > 0; --a) {
    const U q = fdiv(local, Magic<IdxT>::axis(p, a), p.shift[a]);
    col[a] = (int)(local - q * (U)p.shape[a]);
    local = q;
  }
  col[0] = (int)local;
  const int vr = (int)vid - v_lo;
  const float* t = s_tab + vr * p.sum_shape;
  Point x;
  x.cc = vr * (int)p.shape[X_CIS] + col[X_CIS];
  x.sc = vr * (int)p.shape[X_SOC] + col[X_SOC];
  x.ac = vr * (int)p.shape[X_ADC] + col[X_ADC];
  x.te = (vr * (int)p.shape[X_SYS_ROWS] + col[X_SYS_ROWS])
             * (int)p.shape[X_SYS_COLS]
         + col[X_SYS_COLS];
  x.mem_tech = t[p.pre[X_MEM_TECH] + col[X_MEM_TECH]];
  x.rows = t[p.pre[X_SYS_ROWS] + col[X_SYS_ROWS]];
  x.cols = t[p.pre[X_SYS_COLS] + col[X_SYS_COLS]];
  x.fr = t[p.pre[X_FRAME_RATE] + col[X_FRAME_RATE]];
  x.afs = t[p.pre[X_AFS] + col[X_AFS]];
  x.pitch = t[p.pre[X_PITCH] + col[X_PITCH]];
  x.vdd = t[p.pre[X_VDD] + col[X_VDD]];
  return x;
}

// The hoisted shared-memory tables of one CTA.
struct Hoisted {
  const float* node;   // [kNodeKinds][nv * cis | nv * soc]
  const float* decl;   // [kDecl][kMaxSlots]
  const float* adc;    // [F][nv * adc]
  const float* tim;    // [nv * pairs][D + 1 + M], or null: evaluate per point
  const float* knots;
  int n_cis, kind_stride, adc_stride;
  // what node_for(role, declared, cis, soc) selects, looked up
  __device__ __forceinline__ float pick(int kind, float role, int decl_row,
                                        int slot, const Point& x) const {
    const float* t = node + kind * kind_stride;
    return role == 0.f ? t[x.cc]
                       : (role == 1.f ? t[n_cis + x.sc]
                                      : decl[decl_row * kMaxSlots + slot]);
  }
};

// What depends on (sys_rows, sys_cols) alone: the Sec. 4.1 digital
// stages' durations and their DAG's span t_d, and each memory row's reads
// (Eq. 16), in the twin's operation order.
template <int S>
__device__ __forceinline__ void timing(const SweepParams& p,
                                       const float* __restrict__ r,
                                       float rows, float cols, float* durs,
                                       float& t_d, float* reads) {
  const int* off = p.off;
  const int D = p.D, M = p.M;
  t_d = 0.f;
#pragma unroll
  for (int d = 0; d < S; ++d) durs[d] = 0.f;
  if (D) {
    const float rc = rows * cols;
    const float rpc = rows + cols;
#pragma unroll
    for (int d = 0; d < S; ++d) {
      if (d < D) {
        const float thr = rc * r[off[D_UTIL] + d];
        const float cyc = r[off[D_IS_SYS] + d] > 0.5f
                              ? ceilf(r[off[D_MACS] + d] / thr) + rpc
                              : r[off[D_CYCLES] + d];
        durs[d] = cyc / r[off[D_CLOCK] + d];
      }
    }
    float starts[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      float s = 0.f;
      if (i < D) {
#pragma unroll
        for (int j = 0; j < i; ++j) {
          const float cand = r[off[D_EDGE_MASK] + i * D + j] > 0.5f
                                 ? starts[j] + r[off[D_EDGE_W] + i * D + j] * durs[j]
                                 : 0.f;
          s = nmax(s, cand);
        }
      }
      starts[i] = s;
    }
    float mx = -INFINITY, mn = INFINITY;
    bool any = false;
#pragma unroll
    for (int d = 0; d < S; ++d) {
      if (d < D && r[off[D_VALID] + d] > 0.5f) {
        mx = nmax(mx, starts[d] + durs[d]);
        mn = nmin(mn, starts[d]);
        any = true;
      }
    }
    t_d = any ? mx - mn : 0.f;
  }
#pragma unroll
  for (int m = 0; m < S; ++m) {
    reads[m] = m < M ? r[off[M_READS_FIXED] + m]
                           + r[off[M_READS_DNN2] + m] / nmax(rows, 1.f)
                     : 0.f;
  }
}

// The Eq. 1-17 physics of one design point against one fused row;
// returns the selected metric and whether the point is feasible.  S
// bounds A, L, F, D and M at compile time (the wrapper picks it).
template <int S>
__device__ __forceinline__ float evaluate(const SweepParams& p,
                                          const float* __restrict__ r,
                                          const Hoisted& h, const Point& x,
                                          bool* feasible_out) {
  const int* off = p.off;
  const int A = p.A, L = p.L, F = p.F, D = p.D, M = p.M;
  const float rows = x.rows, cols = x.cols, fr = x.fr, vdd = x.vdd;

  const float frame_time = 1.f / fr;
  const float dyn_v = vdd * vdd;
  const float stat_v = vdd;

  // ----- Sec. 4.1 digital timing and the memory rows' reads ---------------
  // (tabled for the CTA's (sys_rows, sys_cols) pairs when they fit)
  float durs[S], reads[S], t_d;
  if (h.tim != nullptr) {
    const float* e = h.tim + x.te * (D + 1 + M);
#pragma unroll
    for (int d = 0; d < S; ++d) durs[d] = d < D ? e[d] : 0.f;
    t_d = e[D];
#pragma unroll
    for (int m = 0; m < S; ++m) reads[m] = m < M ? e[D + 1 + m] : 0.f;
  } else {
    timing<S>(p, r, rows, cols, durs, t_d, reads);
  }
  const float t_a = (frame_time - t_d) / r[off[N_PHASES]];
  const bool feasible = t_a > 0.f;

  // The one category sum the metric reads (the metric's own, on-sensor
  // energy for power and density, none for the rest), accumulated in
  // unit order [analog | digital | memory | utsv | mipi]: each category
  // sums on its own, so this is the twin's sum of that category.
  const int k = p.metric;
  const int col = k < kRed ? k
                           : ((k == O_POWER || k == O_DENSITY) ? O_ON_SENSOR
                                                               : -1);
  float red = 0.f;
  int u = 0;
  auto add_unit = [&](float e) {
    if (col >= 0) red = red + r[off[WEIGHTS] + u * kRed + col] * e;
    ++u;
  };

  // ----- analog rows (Eqs. 2-13) ------------------------------------------
  if (A) {
    float e_access[S], acc[S];
#pragma unroll
    for (int a = 0; a < S; ++a) {
      e_access[a] = a < A ? r[off[A_CONST] + a] * dyn_v : 0.f;
    }
    if (L) {
#pragma unroll
      for (int a = 0; a < S; ++a) acc[a] = 0.f;
#pragma unroll
      for (int l = 0; l < S; ++l) {
        if (l < L) {
          const int la = (int)r[off[LIN_ARR] + l];
          const float pad = t_a * r[off[A_PAD_COEFF] + la];
          const float t_cell = nmax(pad * r[off[LIN_INV] + l], 1e-12f);
          const float term = r[off[LIN_COEFF] + l] * t_cell * stat_v;
#pragma unroll
          for (int a = 0; a < S; ++a) {
            if (a == la) acc[a] = acc[a] + term;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < S; ++a) {
        if (a < A) e_access[a] = e_access[a] + acc[a];
      }
    }
    if (F) {
#pragma unroll
      for (int a = 0; a < S; ++a) acc[a] = 0.f;
#pragma unroll
      for (int f = 0; f < S; ++f) {
        if (f < F) {
          const int fa = (int)r[off[FOM_ARR] + f];
          const float pad = t_a * r[off[A_PAD_COEFF] + fa];
          const float t_cell = nmax(pad * r[off[FOM_INV] + f], 1e-12f);
          const float rate = 1.f / t_cell;
          // log10 and exp2 as the reference evaluates them; the ADC
          // factor exp(ln2 (adc - ref_bits)), or 1, is hoisted
          float fom = powf(10.f, interp(h.knots, p.n_knots[T_FOM], T_FOM,
                                        logf(rate) * p.c_inv_ln10));
          fom = fom * h.adc[f * h.adc_stride + x.ac];
          const float term = r[off[FOM_SCALE] + f] * fom * dyn_v;
#pragma unroll
          for (int a = 0; a < S; ++a) {
            if (a == fa) acc[a] = acc[a] + term;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < S; ++a) {
        if (a < A) e_access[a] = e_access[a] + acc[a];
      }
    }
#pragma unroll
    for (int a = 0; a < S; ++a) {
      if (a < A) add_unit(e_access[a] * r[off[A_OPS] + a]);
    }
  }

  // ----- digital compute rows (Eqs. 14-15) --------------------------------
#pragma unroll
  for (int d = 0; d < S; ++d) {
    if (d < D) {
      const float s_u = h.pick(K_DYN, r[off[D_ROLE] + d], 0, d, x);
      add_unit(r[off[D_DYN] + d] * s_u * dyn_v
               + r[off[D_STATIC] + d] * durs[d] * stat_v);
    }
  }

  // ----- memory rows (Eq. 16) ---------------------------------------------
#pragma unroll
  for (int m = 0; m < S; ++m) {
    if (m < M) {
      const float role = r[off[M_ROLE] + m];
      const float s_m = h.pick(K_DYN, role, 1, m, x);
      const float tech = x.mem_tech >= 0.f ? x.mem_tech : r[off[M_TECH] + m];
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
      const float hp = h.pick(K_HP, role, 2, m, x);
      const float lk = h.pick(K_LK, role, 3, m, x);
      const float leak_bit = is_stt ? p.c_stt_leak : (tech == 1.f ? hp : lk);
      float leak = leak_bit * r[off[M_BITS_TOTAL] + m];
      if (!isnan(lx)) leak = lx;
      const float alpha = r[off[M_ALPHA] + m] * x.afs;
      add_unit((read_e * reads[m] + write_e * r[off[M_WRITES] + m]) * dyn_v
               + leak * frame_time * alpha * stat_v);
    }
  }

  // ----- communication rows (Eq. 17) --------------------------------------
  add_unit(r[off[UTSV_BYTES]] * p.c_utsv);
  add_unit(r[off[MIPI_BYTES]] * p.c_mipi);

  // ----- Sec. 6.2 power density -------------------------------------------
  const float pitch = x.pitch * 1e-3f;
  const float analog_area = r[off[N_PIXELS]] * (pitch * pitch);
  float digital_area = 0.f;
#pragma unroll
  for (int m = 0; m < S; ++m) {
    if (m < M) {
      const float cell_area = h.pick(K_AREA, r[off[M_AREA_ROLE] + m], 4, m, x);
      digital_area = digital_area + r[off[M_BITS_TOTAL] + m] * cell_area;
    }
  }
  const float area = r[off[STACKED]] > 0.f ? nmax(analog_area, digital_area)
                                           : analog_area + digital_area;

  *feasible_out = feasible;
  if (k < kRed) return red;
  switch (k) {
    case O_T_D: return t_d;
    case O_T_A: return t_a;
    case O_FEASIBLE: return feasible ? 1.f : 0.f;
    case O_AREA: return area;
    default: break;
  }
  const float power = red * fr * 1e3f;     // red: on-sensor energy
  if (k == O_POWER) return power;
  return power / nmax(area, 1e-9f);     // O_DENSITY
}

// A float's bits as an unsigned key in IEEE total order (a sign-bit NaN
// below -inf, -0 below +0, a positive NaN above +inf: the order of the
// reference's lax.top_k(-x)), so (key, position) pairs order as the
// reference ranks and one redux.sync finds a warp's least key.  The bits
// go in unchanged: an arithmetic op would canonicalize a NaN's sign.
__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float value_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}
// a masked point's key: +inf, at its own position
constexpr unsigned kInfKey = 0xff800000u;   // key_of(+inf)
// the pair that pads an exhausted list, above every real pair (a positive
// NaN's key reaches 0xffffffff, but a position stays below 2^31); it is
// written out as (+inf, 0)
constexpr unsigned kNoneKey = 0xffffffffu;
constexpr unsigned kNonePos = 0xffffffffu;
constexpr unsigned long long kNonePair = ~0ull;

// Every lane ends with the warp's least (key, position) pair.
__device__ __forceinline__ void warp_least(unsigned& k, unsigned& q) {
  const unsigned m = __reduce_min_sync(0xffffffffu, k);
  q = __reduce_min_sync(0xffffffffu, k == m ? q : 0xffffffffu);
  k = m;
}

// One warp merges up to 32 ascending lists (each lane hands in its own:
// len entries at lk, lq; len 0 for none) into their n least pairs,
// handed to emit(j, key, position) on lane 0 in order.
template <typename Emit>
__device__ __forceinline__ void warp_merge(const unsigned* lk,
                                           const unsigned* lq, int len,
                                           int n, Emit emit) {
  const int lane = threadIdx.x & 31;
  int head = 0;
  for (int j = 0; j < n; ++j) {
    const bool has = head < len;
    unsigned k = has ? lk[head] : kNoneKey;
    unsigned q = has ? lq[head] : kNonePos;
    const unsigned mk = k, mq = q;
    warp_least(k, q);
    if (has && mk == k && mq == q) ++head;
    if (lane == 0) emit(j, k, q);
  }
}

// Stages into shared memory, four loads in flight a thread: the axis
// values of variants v_lo .. v_lo + n_v - 1 (each variant's axes back to
// back, axis a's shape[a] values from pre[a]) and, with `first`, the row
// and the knots.
__device__ __forceinline__ void stage(const SweepParams& p,
                                      const Layout& lay, float* smem,
                                      const float* __restrict__ table2,
                                      const float* __restrict__ row,
                                      const float* __restrict__ knots,
                                      bool first, int v_lo, int n_v) {
  const int n_tab = n_v * p.sum_shape;
  const int n_all = n_tab + (first ? p.width + 4 * kTables * kMaxKnots : 0);
  for (int base = 0; base < n_all; base += 4 * kThreads) {
    float v[4];
    int dst[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = base + k * kThreads + threadIdx.x;
      dst[k] = -1;
      if (i < n_tab) {
        const int vr = i / p.sum_shape;
        const int r = i - vr * p.sum_shape;
        int a = 0;
        while (a + 1 < N_AXES_USED && r >= p.pre[a + 1]) ++a;
        v[k] = table2[a * p.table_cols + (v_lo + vr) * p.lmax + r - p.pre[a]];
        dst[k] = lay.tab + i;
      } else if (i < n_tab + p.width) {
        v[k] = row[i - n_tab];
        dst[k] = lay.row + i - n_tab;
      } else if (i < n_all) {
        v[k] = knots[i - n_tab - p.width];
        dst[k] = lay.knots + i - n_tab - p.width;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (dst[k] >= 0) smem[dst[k]] = v[k];
    }
  }
}

// One entry a thread, from the staged values of n_v variants: the node
// tables, kind x [cis | soc] (dyn for any digital or memory row, the rest
// for memory rows); with `first`, the declared nodes of the slots; the
// ADC factor of each FoM row; and, with p.tim, the timing of each
// (sys_rows, sys_cols) pair.
template <int S>
__device__ __forceinline__ void hoist(const SweepParams& p,
                                      const Layout& lay, float* smem,
                                      bool first, int n_v) {
  const float* s_row = smem + lay.row;
  const float* s_tab = smem + lay.tab;
  const float* s_knots = smem + lay.knots;
  const int* off = p.off;
  const int n_c = (int)p.shape[X_CIS], n_s = (int)p.shape[X_SOC];
  const int n_a = (int)p.shape[X_ADC];
  const int n_cis = p.nv * n_c, kind_stride = p.nv * (n_c + n_s);
  const int n_node = (p.M ? kNodeKinds : (p.D ? 1 : 0)) * kind_stride;
  const int n_decl = first ? kDecl * kMaxSlots : 0;
  const int n_adc = p.F * p.nv * n_a;
  const int n_rc = (int)(p.shape[X_SYS_ROWS] * p.shape[X_SYS_COLS]);
  const int width_te = p.D + 1 + p.M;
  const int n_te = p.tim ? n_v * n_rc : 0;
  for (int i = threadIdx.x; i < n_node + n_decl + n_adc + n_te;
       i += kThreads) {
    if (i < n_node) {
      const int kind = i / kind_stride;
      const int r = i - kind * kind_stride;
      const bool is_cis = r < n_cis;
      const int e = is_cis ? r : r - n_cis;
      const int n_ax = is_cis ? n_c : n_s;
      const int vr = e / n_ax;
      if (vr >= n_v) continue;              // past the staged variants
      const float node = s_tab[vr * p.sum_shape
                               + p.pre[is_cis ? X_CIS : X_SOC] + e % n_ax];
      float val;
      if (kind == K_AREA) {
        const float na = node * 1e-6f;
        val = 150.f * (na * na);
      } else {
        const int t = kind == K_DYN ? T_DYN : (kind == K_HP ? T_HP : T_LEAK);
        val = expf(interp(s_knots, p.n_knots[t], t, node));
      }
      smem[lay.node + i] = val;
    } else if (i < n_node + n_decl) {
      const int e = i - n_node;
      const int what = e / kMaxSlots, sl = e % kMaxSlots;
      if (what == 0 ? sl >= p.D : sl >= p.M) continue;
      const float node = what == 0 ? s_row[off[D_NODE] + sl]
                                   : s_row[off[M_NODE] + sl];
      float val;
      if (what == 4) {
        const float na = node * 1e-6f;
        val = 150.f * (na * na);
      } else {
        const int t = what <= 1 ? T_DYN : (what == 2 ? T_HP : T_LEAK);
        val = expf(interp(s_knots, p.n_knots[t], t, node));
      }
      smem[lay.decl + e] = val;
    } else if (i < n_node + n_decl + n_adc) {
      const int e = i - n_node - n_decl;
      const int f = e / (p.nv * n_a);
      const int r = e - f * p.nv * n_a;
      const int vr = r / n_a;
      if (vr >= n_v) continue;
      const float adc = s_tab[vr * p.sum_shape + p.pre[X_ADC] + r % n_a];
      const float ref_bits = s_row[off[FOM_BITS] + f];
      smem[lay.adc + e] = (adc < 0.f || ref_bits <= 1.f)
                              ? 1.f
                              : expf(p.c_ln2 * (adc - ref_bits));
    } else {
      const int e = i - n_node - n_decl - n_adc;
      const int vr = e / n_rc;
      const int dr = e % n_rc / (int)p.shape[X_SYS_COLS];
      const int dc = e % (int)p.shape[X_SYS_COLS];
      const float* t = s_tab + vr * p.sum_shape;
      float durs[S], reads[S], t_d;
      timing<S>(p, s_row, t[p.pre[X_SYS_ROWS] + dr],
                t[p.pre[X_SYS_COLS] + dc], durs, t_d, reads);
      float* out = smem + lay.tim + e * width_te;
#pragma unroll
      for (int d = 0; d < S; ++d) {
        if (d < p.D) out[d] = durs[d];
      }
      out[p.D] = t_d;
#pragma unroll
      for (int m = 0; m < S; ++m) {
        if (m < p.M) out[p.D + 1 + m] = reads[m];
      }
    }
  }
}

// At least one CTA an SM: without that hint ptxas held S = 4 at 64
// registers and spilled; with it every instantiation keeps a 0-byte stack
// (75-140 registers; the main path needs two CTAs an SM, not four).
template <typename IdxT, int S>
__global__ void __launch_bounds__(kThreads, 1)
fused_sweep_kernel(const float* __restrict__ table2,
                   const float* __restrict__ row,
                   const float* __restrict__ knots,
                   const __grid_constant__ SweepParams p,
                   float* __restrict__ cand_v, int* __restrict__ cand_l,
                   float* __restrict__ sums, float* __restrict__ counts) {
  using U = typename Magic<IdxT>::U;
  extern __shared__ float smem[];
  const Layout lay = layout_of(p);
  const float* s_row = smem + lay.row;
  const float* s_tab = smem + lay.tab;
  unsigned* s_key = reinterpret_cast<unsigned*>(smem + lay.key);
  unsigned* s_wk = reinterpret_cast<unsigned*>(smem + lay.wk);
  unsigned* s_wq = reinterpret_cast<unsigned*>(smem + lay.wq);
  unsigned* s_rk = reinterpret_cast<unsigned*>(smem + lay.rk);
  unsigned* s_rq = reinterpret_cast<unsigned*>(smem + lay.rq);
  unsigned* s_ck = reinterpret_cast<unsigned*>(smem + lay.ck);
  unsigned* s_cq = reinterpret_cast<unsigned*>(smem + lay.cq);
  unsigned* s_gk = reinterpret_cast<unsigned*>(smem + lay.gk);
  unsigned* s_gq = reinterpret_cast<unsigned*>(smem + lay.gq);
  float* s_red = smem + lay.red;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const IdxT g = (IdxT)(blockIdx.x / p.cluster);
  const IdxT start = (IdxT)p.start, low = (IdxT)p.low, limit = (IdxT)p.limit;
  const IdxT chunk = (IdxT)p.chunk, bp = (IdxT)p.bp;
  const IdxT top = (IdxT)p.total - 1;
  const int q0 = rank * p.rank_points;
  const int n_here = max(0, min(p.bp - q0, p.rank_points));
  const Hoisted h{smem + lay.node, smem + lay.decl, smem + lay.adc,
                  p.tim ? smem + lay.tim : nullptr, smem + lay.knots,
                  p.nv * (int)p.shape[X_CIS],
                  p.nv * (int)(p.shape[X_CIS] + p.shape[X_SOC]),
                  p.nv * (int)p.shape[X_ADC]};

  // the CTA's running candidates start empty
  for (int j = tid; j < p.kc; j += kThreads) {
    s_ck[j] = kNoneKey;
    s_cq[j] = kNonePos;
  }
  float tsum = 0.f, tcnt = 0.f;
  int v_lo = -1, n_v = 0;          // the variants staged in shared memory
  for (int p0 = 0; p0 < n_here; p0 += p.span) {
    const int n_pass = min(p.span, n_here - p0);
    const IdxT first = g * bp + (IdxT)(q0 + p0);
    // ----- 1. prologue: the variants this pass's points reach ------------
    // (none when the pass is all padding: its points only list +inf keys)
    if (first < chunk) {
      const IdxT end = first + (IdxT)n_pass;
      const IdxT last = (end < chunk ? end : chunk) - 1;
      const IdxT o_lo = start + first < top ? start + first : top;
      const IdxT o_hi = start + last < top ? start + last : top;
      const int lo = (int)fdiv((U)o_lo, Magic<IdxT>::var(p), p.shift_var);
      const int hi = (int)fdiv((U)o_hi, Magic<IdxT>::var(p), p.shift_var);
      if (lo < v_lo || hi >= v_lo + n_v) {
        const bool with_row = v_lo < 0;
        stage(p, lay, smem, table2, row, knots, with_row, lo, hi - lo + 1);
        __syncthreads();
        hoist<S>(p, lay, smem, with_row, hi - lo + 1);
        __syncthreads();
        v_lo = lo;
        n_v = hi - lo + 1;
      }
    }
    // ----- 2-3. decode and evaluate the pass's points ---------------------
    for (int i = 0; i < p.ppt; ++i) {
      const int qr = i * kThreads + tid;
      if (qr >= n_pass) break;
      const IdxT pos = first + (IdxT)qr;
      unsigned key = kInfKey;
      if (pos < chunk) {
        const IdxT o = start + pos;
        const bool valid = o >= low && o < limit;
        const Point x = decode<IdxT>(p, o, s_tab, v_lo);
        bool feas;
        const float mv = evaluate<S>(p, s_row, h, x, &feas);
        const bool ok = feas && valid;
        tsum += ok ? mv : 0.f;
        tcnt += ok ? 1.f : 0.f;
        if (ok) key = key_of(mv);
      }
      s_key[qr] = key;
    }
    // ----- 4. reduce: each warp's kw least, by lexicographic successors ---
    {
      unsigned long long last = 0;    // below every (key, position) pair
      for (int j = 0; j < p.kw; ++j) {
        unsigned long long best = kNonePair;   // none left: the pad pair
        for (int i = 0; i < p.ppt; ++i) {
          const int qr = i * kThreads + tid;
          if (qr >= n_pass) break;
          const unsigned long long kq =
              ((unsigned long long)s_key[qr] << 32) | (unsigned)(q0 + p0 + qr);
          if (kq >= last && kq < best) best = kq;
        }
        unsigned k = (unsigned)(best >> 32), q = (unsigned)best;
        warp_least(k, q);
        if (lane == 0) {
          s_wk[warp * p.kw + j] = k;
          s_wq[warp * p.kw + j] = q;
        }
        const unsigned long long got = ((unsigned long long)k << 32) | q;
        last = got == kNonePair ? got : got + 1;   // no wrap past the pad
      }
    }
    __syncthreads();
    if (warp == 0) {
      // the CTA's kc least of the warps' lists and its running list
      for (int j = lane; j < p.kc; j += 32) {
        s_rk[j] = s_ck[j];
        s_rq[j] = s_cq[j];
      }
      __syncwarp();
      const bool own = lane < kWarps;
      warp_merge(own ? s_wk + lane * p.kw : s_rk,
                 own ? s_wq + lane * p.kw : s_rq,
                 own ? p.kw : (lane == kWarps ? p.kc : 0), p.kc,
                 [&](int j, unsigned k, unsigned q) {
                   s_ck[j] = k;
                   s_cq[j] = q;
                 });
    }
    __syncthreads();               // before the next pass reuses the tables
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    tsum += __shfl_down_sync(0xffffffffu, tsum, o);
    tcnt += __shfl_down_sync(0xffffffffu, tcnt, o);
  }
  if (lane == 0) {
    s_red[warp] = tsum;
    s_red[kWarps + warp] = tcnt;
  }
  __syncthreads();
  if (tid == 0) {
    // the CTA's sum and count in warp order
    float s = 0.f, c = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      s += s_red[w];
      c += s_red[kWarps + w];
    }
    s_red[2 * kWarps] = s;
    s_red[2 * kWarps + 1] = c;
  }
  cluster.sync();
  if (rank == 0) {
    // rank 0 gathers the cluster's lists and partials through distributed
    // shared memory, then merges the lists into the block's kout least
    float* s_part = s_red + 2 * kWarps + 2;
    for (int e = tid; e < p.cluster * (p.kc + 1); e += kThreads) {
      const int r = e / (p.kc + 1), j = e % (p.kc + 1);
      if (j < p.kc) {
        s_gk[r * p.kc + j] = cluster.map_shared_rank(s_ck, r)[j];
        s_gq[r * p.kc + j] = cluster.map_shared_rank(s_cq, r)[j];
      } else {
        const float* red = cluster.map_shared_rank(s_red, r);
        s_part[2 * r] = red[2 * kWarps];
        s_part[2 * r + 1] = red[2 * kWarps + 1];
      }
    }
    __syncthreads();
    const size_t at = (size_t)g * p.kk;
    if (warp == 0) {
      const bool own = lane < p.cluster;
      warp_merge(s_gk + (own ? lane * p.kc : 0),
                 s_gq + (own ? lane * p.kc : 0), own ? p.kc : 0, p.kout,
                 [&](int j, unsigned k, unsigned q) {
                   const bool none = q == kNonePos;
                   cand_v[at + j] = value_of(none ? kInfKey : k);
                   cand_l[at + j] = none ? 0 : (int)q;
                 });
      if (lane == 0) {
        float s = 0.f, c = 0.f;
        for (int r = 0; r < p.cluster; ++r) {
          s += s_part[2 * r];
          c += s_part[2 * r + 1];
        }
        sums[g] = s;
        counts[g] = c;
      }
    }
    for (int j = p.kout + tid; j < p.kk; j += kThreads) {
      cand_v[at + j] = INFINITY;             // kk > bp: the pad contract
      cand_l[at + j] = 0;
    }
  }
  cluster.sync();      // no CTA leaves while rank 0 reads its shared memory
}

template <typename IdxT, int S>
int launch(const float* table2, const float* row, const float* knots,
           const SweepParams& p, float* cand_v, int* cand_l, float* sums,
           float* counts, cudaStream_t stream) {
  const long long nb = (p.chunk + p.bp - 1) / p.bp;
  const size_t smem = (size_t)p.smem * sizeof(float);
  auto kernel = fused_sweep_kernel<IdxT, S>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nb * p.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, table2, row, knots,
                                           p, cand_v, cand_l, sums, counts);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename IdxT>
int launch_idx(const float* table2, const float* row, const float* knots,
               const SweepParams& p, float* cand_v, int* cand_l, float* sums,
               float* counts, cudaStream_t stream) {
  if (p.A <= 4 && p.L <= 4 && p.F <= 4 && p.D <= 4 && p.M <= 4) {
    return launch<IdxT, 4>(table2, row, knots, p, cand_v, cand_l, sums,
                           counts, stream);
  }
  return launch<IdxT, kMaxSlots>(table2, row, knots, p, cand_v, cand_l,
                                 sums, counts, stream);
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
    case 4: return kMaxCluster;
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
    case 16: return kThreads;
    case 17: return kNodeKinds * 2;
    case 18: return kDecl * kMaxSlots;
    default: return -1;
  }
}

// Launch the megakernel on `stream`; returns the cudaError_t of the
// launch (0 on success).  All pointers are device pointers except `p`;
// `knots` holds the interpolation tables as xs, ys, dx, dy, each
// [kTables][kMaxKnots] f32.  A plan the kernel does not take (its
// shared-memory size not the one layout_of() gives, a cluster past 8,
// ranks that do not cover bp, a tile its threads do not cover, passes
// longer than the tile) is refused with cudaErrorInvalidValue before
// anything runs.
int repro_fused_sweep(const float* table2, const float* row,
                      const float* knots, const SweepParams* p, int idx64,
                      float* cand_v, int* cand_l, float* sums,
                      float* counts, void* stream) {
  if (layout_of(*p).total != p->smem || p->n_axes != N_AXES_USED
      || p->cluster < 1 || p->cluster > kMaxCluster
      || (long long)p->cluster * p->rank_points < p->bp
      || (long long)p->ppt * kThreads < p->tile || p->span < 1
      || p->span > p->tile || p->tile > p->rank_points || p->nv < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (idx64) {
    return launch_idx<long long>(table2, row, knots, *p, cand_v, cand_l,
                                 sums, counts, s);
  }
  return launch_idx<int>(table2, row, knots, *p, cand_v, cand_l, sums,
                         counts, s);
}

}  // extern "C"
