"""GPU smoke run of the PyTorch/CUDA port (``repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
per source, all eight started together): K1 ``fused_sweep.cu``, K2
``grid_decode.cu``, K3a/K3b ``stream_reduce.cu``, K4
``category_reduce.cu``, and the functional simulator's K5
``binning.cu``, K6 ``stencil_conv.cu``, K7 ``frame_event.cu`` and K8
``matmul.cu``.  Holds each kernel against its plain-torch twin on the
card at the main paths' shapes (and ragged ones), then drives every
engine of ``explore()`` and the functional simulator at full width, each
with the launch counters zeroed just before it and read just after:

* fused (the main path) — the ``mega_sweep`` space (all 5 Ed-Gaze + 3
  Rhythmic variants, 1.26e7 design points, ``chunk_size=2**18``,
  ``k=3``) through K1, checked against the twin lane, the int64 index
  path and the scalar ``estimate_energy`` oracle;
* staged — the same space through K2 -> banked evaluator -> K3a, equal
  to the fused result;
* chunked (through ``auto``) — Ed-Gaze over the mega grids without
  ``active_fraction_scale`` (1.57e6 points) through K4, equal to fused;
* monolithic (through ``auto``) — the ``design_sweep`` grids of
  ``benchmarks/run.py`` (21,504 points) through K4, equal to fused, the
  winner against the scalar oracle;
* functional — 30 frames each, at the use cases' sensor sizes: Ed-Gaze
  (400 x 640: kT/C noise at 10 fF, ``edgaze_frontend`` through K5 and
  K7, then ``simple_dnn`` through K8 at the paper's S3 width,
  ``[1, 64000] @ [64000, 900] @ [900, 2]``), ``fig5_pipeline`` at the
  Rhythmic sensor's 720 x 1280 (K5, K6 twice) and
  ``rhythmic_pixel_frontend`` at 720 x 1280 (K6 twice); the first 2
  frames of each against the same pipeline run by the port on the CPU.

It times every kernel, prints its findings as JSON lines, and ends with
the ``kernels`` line and the run's verdict::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Every check raises on failure, so the script exits nonzero and prints no
verdict; it also exits nonzero without a CUDA device or without the
repository's ``src/`` beside it.  It imports nothing of ``jax`` or of the
JAX package ``repro``.  A ``torch.profiler`` pass over one sweep of each
engine (and one pass of the functional pipelines) reports device time
by kernel and the device's busy share, and writes chrome traces to
``build/traces/``.
"""
from __future__ import annotations

import importlib
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402

# Grids of the mega_sweep space (benchmarks/run.py): ~1.57e6 points per
# structural variant, ~1.26e7 across the 5 Ed-Gaze + 3 Rhythmic variants.
MEGA_GRIDS = {
    "cis_node": [130., 110., 90., 80., 65., 55., 45., 40., 32., 28., 22.,
                 16., 14.],
    "soc_node": [14., 22., 28.],
    "frame_rate": [15., 24., 30., 45., 60., 90., 120., 240.],
    "sys_rows": [4., 8., 16., 32., 48., 64., 96., 128.],
    "sys_cols": [4., 8., 16., 32., 64., 128.],
    "mem_tech": ["sram", "sram_hp", "stt"],
    "active_fraction_scale": [0.1, 0.25, 0.5, 0.75, 1.0],
    "pixel_pitch_um": [2., 2.5, 3., 3.5, 4., 5., 6.],
}
MEGA_POINTS = 8 * 13 * 3 * 8 * 8 * 6 * 3 * 5 * 7
CHUNK = 1 << 18
# the int64 lane: 2.25e9 points in one variant (flat indices past 2**31)
WIDE_GRIDS = {"variant": ["3d_in"],
              "cis_node": list(np.linspace(28.0, 130.0, 1500)),
              "frame_rate": list(np.linspace(15.0, 120.0, 1500)),
              "active_fraction_scale": list(np.linspace(0.1, 1.0, 1000))}
WIDE_POINTS = 1500 * 1500 * 1000

# the chunked lane: Ed-Gaze over the mega grids without the gating axis,
# 5 x 314,496 = 1,572,480 points, which `auto` sends to `chunked`
CHUNKED_GRIDS = {k: v for k, v in MEGA_GRIDS.items()
                 if k != "active_fraction_scale"}
CHUNKED_POINTS = 5 * 13 * 3 * 8 * 8 * 6 * 3 * 7
# the monolithic lane: the design_sweep grids of benchmarks/run.py over
# Ed-Gaze + Rhythmic, 8 x 2,688 = 21,504 points
DESIGN_GRIDS = {"cis_node": [130., 110., 90., 65., 45., 32., 28.],
                "frame_rate": [15.0, 30.0, 60.0, 120.0],
                "sys_rows": [4.0, 8.0, 16.0, 32.0],
                "sys_cols": [8.0, 16.0, 32.0],
                "mem_tech": ["sram_hp", "stt"],
                "active_fraction_scale": [0.25, 1.0],
                "pixel_pitch_um": [3.0, 5.0]}
DESIGN_POINTS = 8 * 7 * 4 * 4 * 3 * 2 * 2 * 2
KERNEL_SOURCES = ("fused_sweep", "grid_decode", "stream_reduce",
                  "category_reduce", "binning", "stencil_conv",
                  "frame_event", "matmul")
# the functional path: 30 frames (one second at the use cases' 30 FPS);
# kT/C noise at 10 fF; Ed-Gaze's event threshold; its DNN's hidden width,
# DNN_MACS / (200 * 320) = 900 (core/usecases/edgaze.py)
FUNC_KERNELS = ("binning", "stencil_conv", "frame_event", "matmul")
FUNC_FRAMES = 30
FUNC_CAPACITANCE = 10e-15
EDGAZE_THRESHOLD = 0.05
RHYTHMIC_TILE = 16
RHYTHMIC_KEEP = 0.5
FUNC_COMPARED = 2          # frames held against the port run on the CPU
MATMUL_RULE = 1e-5         # |kernel - twin| <= 1e-5 * (|a| @ |b|)

REL = 1e-6          # the reference's parity tolerance (values, top-k)
REL_SUM = 1e-5      # block sums: 4096 f32 terms summed in another order
REL_MEAN = 1e-5     # per-variant means: sums of such sums

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit):
# FP32 outside the tensor cores, HBM3 bandwidth, and the special-function
# units (16 per SM x 132 SMs at the 1.98 GHz boost clock).
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_SFU = 132 * 16 * 1.98e9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# kernel vs twin
# ---------------------------------------------------------------------------
def compare_blocks(name, ker, twin):
    """Kernel vs twin block outputs: cand_v at rel 1e-6, cand_l equal
    where finite (near-ties within the tolerance are reported), counts
    exact, sums at rel 1e-5.  Returns the error record."""
    kv, kl, ks, kc = (t.cpu().numpy() for t in ker)
    tv, tl, ts, tc = (t.cpu().numpy() for t in twin)
    kv, ks, tv, ts = (a.astype(np.float64) for a in (kv, ks, tv, ts))
    check(kv.shape == tv.shape and kl.shape == tl.shape, f"{name}: shapes")
    fin = np.isfinite(tv)
    check(np.array_equal(np.isfinite(kv), fin), f"{name}: +inf pattern")
    check(np.array_equal(kc, tc), f"{name}: counts differ")
    abs_err = np.abs(kv[fin] - tv[fin])
    rel_err = abs_err / np.maximum(np.abs(tv[fin]), 1e-300)
    max_rel = float(rel_err.max()) if rel_err.size else 0.0
    check(max_rel <= REL, f"{name}: cand_v rel err {max_rel}")
    # an all-masked block sums to 0 in both: no error
    sum_rel = float(np.max(np.abs(ks - ts)
                           / np.maximum(np.abs(ts), 1e-300)))
    check(sum_rel <= REL_SUM, f"{name}: sums rel err {sum_rel}")
    near_ties = 0
    for g, j in zip(*np.nonzero(fin & (kl != tl))):
        other = np.flatnonzero(tl[g] == kl[g, j])
        check(other.size > 0 and np.isclose(tv[g, other[0]], tv[g, j],
                                            rtol=REL, atol=0),
              f"{name}: cand_l differs at block {g} slot {j}")
        near_ties += 1
    rec = dict(case=name, blocks=int(kv.shape[0]), kk=int(kv.shape[1]),
               finite=int(fin.sum()), feasible=float(tc.sum()),
               max_abs_err=float(abs_err.max()) if abs_err.size else 0.0,
               max_rel_err=max_rel, sums_max_rel_err=sum_rel,
               near_ties=near_ties)
    emit({"kernel_vs_twin": rec})
    return rec


def run_case(prep, fs, compute, *, name, variant, start, low, limit, chunk,
             bp, kk, idx_dtype=torch.int32):
    kw = dict(compute=compute, metric="total_j",
              axis_names=tuple(prep.vgrids[0].names),
              shape=prep.vgrids[0].shape, n_var=prep.n_var,
              total=prep.total, chunk=chunk, lmax=prep.lmax,
              block_points=bp, kk=kk, idx_dtype=idx_dtype)
    row = prep.bank.fused[variant]
    ker = fs.fused_sweep_block(prep.table2, row, start, low, limit, **kw)
    torch.cuda.synchronize()
    twin = fs.fused_sweep_block_torch(prep.table2, row, start, low, limit,
                                      **kw)
    return compare_blocks(name, ker, twin)


def synthetic_case(fs):
    """The synthetic L=2 / D=3 bank row of the physics tests, from seed 0."""
    from repro_torch.core.batch import build_coeff_compute
    from repro_torch.core.grid import ChunkedGrid, axis_tables, fused_table2
    from repro_torch.core.plan_bank import bank_from_reference
    from repro_torch.testing import synthetic_bank
    dims, fused = synthetic_bank(0)
    grid = ChunkedGrid({"cis_node": [130.0, 90.0, 45.0, 22.0],
                        "soc_node": [14.0, 22.0],
                        "mem_tech": [-1.0, 0.0, 1.0, 2.0],
                        "sys_rows": [8.0, 64.0], "sys_cols": [16.0, 32.0],
                        "frame_rate": [30.0, 120.0, 500.0, 3000.0],
                        "active_fraction_scale": [0.25, 1.0],
                        "pixel_pitch_um": [3.0, 5.0],
                        "vdd_scale": [0.8, 1.0, 1.2],
                        "adc_bits": [-1.0, 6.0, 12.0]})
    table2 = torch.from_numpy(fused_table2(axis_tables([grid]))).cuda()
    row = bank_from_reference({"fused": fused}, dims, device="cuda").fused[0]
    kw = dict(compute=build_coeff_compute(dims), metric="total_j",
              axis_names=tuple(grid.names), shape=grid.shape,
              n_var=len(grid), total=len(grid), chunk=len(grid),
              lmax=max(grid.shape), block_points=4096, kk=8)
    ker = fs.fused_sweep_block(table2, row, 0, 0, len(grid), **kw)
    torch.cuda.synchronize()
    twin = fs.fused_sweep_block_torch(table2, row, 0, 0, len(grid), **kw)
    return compare_blocks("synthetic_L2_D3", ker, twin)


# ---------------------------------------------------------------------------
# K2, K3a, K3b, K4 vs their twins
# ---------------------------------------------------------------------------
def decode_case(gd, prep, *, name, start, chunk, idx_dtype=torch.int32):
    """K2 against its twin: axis values and variant ids bit-equal."""
    kw = dict(shape=prep.vgrids[0].shape, n_var=prep.n_var,
              total=prep.total, chunk=chunk, lmax=prep.lmax,
              idx_dtype=idx_dtype)
    kv, kid = gd.grid_decode(prep.table2, start, **kw)
    torch.cuda.synchronize()
    tv, tid = gd.grid_decode_torch(prep.table2, start, **kw)
    check(torch.equal(kv, tv) and torch.equal(kid, tid),
          f"{name}: grid_decode differs from its twin")
    rec = dict(case=name, points=chunk, start=int(start),
               past_total=max(0, start + chunk - prep.total),
               max_abs_err=float((kv - tv).abs().max()))
    emit({"kernel_vs_twin": rec})
    return rec


def stats_case(sr, *, name, values, mask, bp, variant=None, n_variants=0):
    """K3a/K3b against their twins: min, argmin and counts exact, sums
    at rel 1e-5."""
    if variant is None:
        ker = sr.block_stats(values, mask, bp)
        torch.cuda.synchronize()
        twin = sr.block_stats_torch(values, mask, bp)
    else:
        ker = sr.block_stats_banked(values, mask, variant, n_variants, bp)
        torch.cuda.synchronize()
        twin = sr.block_stats_banked_torch(values, mask, variant,
                                           n_variants, bp)
    km, ka, ks, kc = (t.cpu().numpy() for t in ker)
    tm, ta, ts, tc = (t.cpu().numpy() for t in twin)
    check(np.array_equal(km, tm) and np.array_equal(ka, ta),
          f"{name}: min/argmin differ from the twin")
    check(np.array_equal(kc, tc), f"{name}: counts differ")
    ks, ts = ks.astype(np.float64), ts.astype(np.float64)
    sum_rel = float(np.max(np.abs(ks - ts)
                           / np.maximum(np.abs(ts), 1e-30)))
    check(sum_rel <= REL_SUM, f"{name}: sums rel err {sum_rel}")
    rec = dict(case=name, points=int(values.numel()), blocks=int(km.size),
               empty_blocks=int((tc == 0).sum()),
               max_abs_err=float(np.max(np.abs(ks - ts))),
               sums_max_rel_err=sum_rel)
    emit({"kernel_vs_twin": rec})
    return rec


def reduce_case(cr, *, name, e, w):
    """K4 against its twin: bit-equal."""
    ker = cr.category_reduce(e, w)
    torch.cuda.synchronize()
    twin = cr.category_reduce_torch(e, w)
    check(torch.equal(ker, twin), f"{name}: category_reduce differs from "
          f"its twin by {float((ker - twin).abs().max())}")
    rec = dict(case=name, rows=int(e.shape[0]), units=int(e.shape[1]),
               cols=int(w.shape[1]), max_abs_err=0.0)
    emit({"kernel_vs_twin": rec})
    return rec


def stats_inputs(n, seed, *, ties=False, empty_block=None):
    # positive, energy-like values: block sums without cancellation
    rng = np.random.default_rng(seed)
    vals = (rng.choice(np.float32([0.5, 1.25, 2.0]), n) if ties
            else rng.uniform(0.5, 2.0, n).astype(np.float32))
    mask = rng.uniform(size=n) > 0.3
    if empty_block is not None:
        mask[empty_block[0]:empty_block[1]] = False
    return (torch.from_numpy(vals).cuda(), torch.from_numpy(mask).cuda())


def reduce_inputs(b, u, c, seed):
    rng = np.random.default_rng(seed)
    e = rng.uniform(1e-12, 1e-6, size=(b, u)).astype(np.float32)
    w = (rng.uniform(size=(u, c)) > 0.5).astype(np.float32)
    w[:, c - 2] = 1.0
    return torch.from_numpy(e).cuda(), torch.from_numpy(w).cuda()


# ---------------------------------------------------------------------------
# roofline bound of one launch
# ---------------------------------------------------------------------------
def ops_per_point(dims, knots):
    """FP32 operations and special-function calls per design point that
    the function itself needs (integer index arithmetic not counted).

    This counts the work of ``build_coeff_compute`` at the bank's dims,
    not the instructions of one implementation, so it stays put when the
    kernel changes.  An interpolation over n knots locates its one
    segment (two clamp compares and a binary search of ceil(log2(n - 1))
    compares), then does a sub, a div, a mul and an add; a unit's category
    fold is 2 (C + 2); exp and log are one SFU call each, pow two.
    ``knots`` are the (dyn, leak, hp, fom) table lengths.
    """
    _v, A, L, F, D, M = dims
    n_dyn, n_leak, n_hp, n_fom = knots
    interp = lambda n: 2 + math.ceil(math.log2(n - 1)) + 4  # noqa: E731
    red = 2 * 10
    units = A + D + M + 2
    fp = 2                                   # frame time, vdd^2
    if D:
        fp += 2 + 6 * D + 4 * D * (D - 1) // 2 + 4 * D + 1
    fp += 3                                  # t_a, feasibility
    fp += 2 * A + 6 * L + (A if L else 0)
    fp += F * (14 + interp(n_fom)) + (A if F else 0)
    fp += D * (7 + interp(n_dyn))
    fp += M * (30 + interp(n_dyn) + interp(n_leak) + interp(n_hp))
    fp += 2 + 3 + 7 * M + 2 + 3 + 4          # comm, area, metric, reduce
    fp += red * units
    sfu = D + 3 * M + F * 4                  # exp per node lookup; log+pow+exp
    return fp, sfu


def bound_ms(n_points, dims, knots, bytes_moved):
    fp, sfu = ops_per_point(dims, knots)
    t_ops = max(n_points * fp / PEAK_FP32, n_points * sfu / PEAK_SFU)
    t_bytes = bytes_moved / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes
            else "bytes", fp, sfu)


def time_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, needle, reps=20):
    """Device time per launch of the kernels named ``*needle*`` over
    ``reps`` back-to-back calls of ``fn``, from ``torch.profiler`` (the
    CUDA-event time of such a loop also holds the host's per-launch
    work)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and needle in e.name)
    return us * 1e-3 / reps


# ---------------------------------------------------------------------------
# scalar oracle (the jax-free estimate_energy walk, one design point)
# ---------------------------------------------------------------------------
def scalar_total(algorithm, variant, point):
    """total_j of one design point through the scalar estimate_energy,
    the model the batched physics is lowered from."""
    from repro_torch.core.digital import SystolicArray
    from repro_torch.core.energy import estimate_energy
    from repro_torch.core.grid import build_variant
    from repro_torch.core.plan import TECH_INDEX
    hw, stages, mapping, _ = build_variant(
        algorithm, variant, cis_node=int(point["cis_node"]),
        soc_node=int(point["soc_node"]))
    hw.frame_rate = float(point["frame_rate"])
    hw.pixel_pitch_um = float(point["pixel_pitch_um"])
    for binding in hw.digital.values():
        if isinstance(binding.unit, SystolicArray):
            binding.unit.rows = int(point["sys_rows"])
            binding.unit.cols = int(point["sys_cols"])
    tech = int(point["mem_tech"])
    names = {v: k for k, v in TECH_INDEX.items()}
    for mem in hw.memories.values():
        if tech >= 0:
            mem.technology = names[tech]
        mem.active_fraction *= float(point["active_fraction_scale"])
    return estimate_energy(hw, stages, mapping, strict=False).total()


# ---------------------------------------------------------------------------
def compare_results(name, a, b):
    """Kernel lane vs twin lane of one explore(): top-k rows and
    summaries (values rel 1e-6, means rel 1e-5, counts exact)."""
    check(a.n_points == b.n_points and a.n_feasible == b.n_feasible,
          f"{name}: counts {a.n_points}/{a.n_feasible} vs "
          f"{b.n_points}/{b.n_feasible}")
    check(len(a.topk) == len(b.topk), f"{name}: top-k length")
    worst = 0.0
    for ra, rb in zip(a.topk, b.topk):
        check((ra["variant"], ra["algorithm"], ra["index"])
              == (rb["variant"], rb["algorithm"], rb["index"]),
              f"{name}: top-k rows differ: {ra} vs {rb}")
        for key, va in ra.items():
            if isinstance(va, float):
                err = abs(va - rb[key]) / max(abs(rb[key]), 1e-300)
                worst = max(worst, err)
                check(err <= REL, f"{name}: {key} rel err {err}")
    for label, sa in a.summaries.items():
        sb = b.summaries[label]
        check((sa["n"], sa["n_feasible"], sa["argmin_index"])
              == (sb["n"], sb["n_feasible"], sb["argmin_index"]),
              f"{name}: {label} summary counts")
        for key, tol in (("metric_min", REL), ("metric_mean", REL_MEAN)):
            if math.isnan(sa[key]) and math.isnan(sb[key]):
                continue
            err = abs(sa[key] - sb[key]) / max(abs(sb[key]), 1e-300)
            check(err <= tol, f"{name}: {label}.{key} rel err {err}")
    return worst


def profile_path(name, run) -> dict:
    """torch.profiler over one sweep ``run()``: device time by kernel
    name and the device's busy share of the sweep's wall time; writes
    the chrome trace to build/traces/trace_<name>.json."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = Path(__file__).resolve().parent / "build" / "traces"
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(out / f"trace_{name}.json"))
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    by_name, busy, reach = {}, 0.0, None
    for start, end, kname in spans:
        by_name[kname] = by_name.get(kname, 0.0) + (end - start)
        if reach is None or start >= reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    rec = {"wall_s": wall, "eval_s": getattr(res, "eval_s", None),
           "device_kernels": len(spans), "device_busy_s": busy * 1e-6,
           "device_busy_share_of_wall": busy * 1e-6 / wall,
           "device_s_by_kernel": {k[:80]: us * 1e-6 for k, us in top}}
    emit({f"profile_{name}": rec})
    return rec


def count_syncs(run) -> int:
    """Host syncs of one ``run()``, under the sync debug mode (which
    slows every op, so never in a timed run)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


# ---------------------------------------------------------------------------
# K5-K8 and the functional path
# ---------------------------------------------------------------------------
def exact_case(name, ker, twin):
    """A kernel against its twin on the same inputs: bit-equal."""
    k = ker()
    torch.cuda.synchronize()
    t = twin()
    diff = float((k.float() - t.float()).abs().max()) if k.numel() else 0.0
    check(k.shape == t.shape and k.dtype == t.dtype and torch.equal(k, t),
          f"{name}: differs from its twin by {diff}")
    rec = dict(case=name, shape=list(k.shape), dtype=str(k.dtype),
               max_abs_err=diff)
    emit({"kernel_vs_twin": rec})
    return rec


def gaussian(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            .astype(dtype)).cuda()


def matmul_case(mm, *, name, m, k, n, seed):
    """K8 against its twin: |kernel - twin| <= 1e-5 * (|a| @ |b|)
    elementwise (another summation order), and equal from run to run."""
    a, b = gaussian((m, k), seed), gaussian((k, n), seed + 1)
    ker = mm.matmul(a, b)
    again = mm.matmul(a, b)
    torch.cuda.synchronize()
    twin = mm.matmul_torch(a, b)
    scale = a.double().abs() @ b.double().abs()     # the rule's yardstick
    err = (ker.double() - twin.double()).abs()
    ratio = float((err / (MATMUL_RULE * scale).clamp_min(1e-300)).max()) \
        if err.numel() else 0.0
    check(ratio <= 1.0, f"{name}: matmul off its twin by {ratio} x the rule")
    check(torch.equal(ker, again), f"{name}: matmul differs run to run")
    rec = dict(case=name, mkn=[m, k, n],
               max_abs_err=float(err.max()) if err.numel() else 0.0,
               max_err_over_rule=ratio)
    emit({"kernel_vs_twin": rec})
    return rec


def functional_kernel_cases(fmods):
    """K5-K8 against their twins at the functional path's shapes and at
    ragged ones; returns the records by kernel."""
    bn, sc, fe, mm = (fmods[name] for name in FUNC_KERNELS)
    cases = {"binning": [], "stencil_conv": [], "frame_event": [],
             "matmul": []}
    for shape, f, dt in (((400, 640), 2, np.float32),
                         ((720, 1280), 2, np.float32),
                         ((17, 33), 3, np.float32), ((17, 33), 4, np.float32),
                         ((17, 33), 2, np.float16),
                         ((720, 1280), 2, np.float16)):
        x = gaussian(shape, sum(shape) + f, dt)
        cases["binning"].append(exact_case(
            f"binning_{shape[0]}x{shape[1]}_f{f}_{np.dtype(dt).name}",
            lambda: bn.binning(x, f), lambda: bn.binning_torch(x, f)))
    for shape, k in (((360, 640), (3, 3)), ((720, 1280), (3, 3)),
                     ((100, 140), (3, 5)), ((77, 45), (5, 5)),
                     ((1000, 33), (2, 2))):
        x, taps = gaussian(shape, shape[0]), gaussian(k, 10 * k[0] + k[1])
        cases["stencil_conv"].append(exact_case(
            f"stencil_{shape[0]}x{shape[1]}_k{k[0]}x{k[1]}",
            lambda: sc.stencil_conv(x, taps),
            lambda: sc.stencil_conv_torch(x, taps)))
    for shape, dt, t in (((200, 320), np.float32, EDGAZE_THRESHOLD),
                         ((33, 47), np.float32, 0.5),
                         ((33, 47), np.float16, 0.5)):
        cur, prev = gaussian(shape, 1, dt), gaussian(shape, 2, dt)
        cases["frame_event"].append(exact_case(
            f"frame_event_{shape[0]}x{shape[1]}_{np.dtype(dt).name}",
            lambda: fe.frame_event(cur, prev, t),
            lambda: fe.frame_event_torch(cur, prev, t)))
    # the f32 rounding case: f32(0.7) - 0 >= 0.7 is an event; NaN is not
    cur = torch.tensor([[0.7, float("nan"), 0.69999]], device="cuda")
    prev = torch.zeros_like(cur)
    rec = exact_case("frame_event_f32_threshold_and_nan",
                     lambda: fe.frame_event(cur, prev, 0.7),
                     lambda: fe.frame_event_torch(cur, prev, 0.7))
    check(fe.frame_event(cur, prev, 0.7).tolist() == [[1.0, 0.0, 0.0]],
          "frame_event: 0.7 rounding case")
    cases["frame_event"].append(rec)
    for m, k, n in ((1, 64000, 900), (1, 900, 2), (130, 150, 70), (1, 64, 1),
                    (1024, 1024, 1024), (7, 5000, 333)):
        cases["matmul"].append(matmul_case(
            mm, name=f"matmul_{m}x{k}x{n}", m=m, k=k, n=n, seed=m + k + n))
    return cases


def scene(n_frames, h, w, seed):
    """``n_frames`` [h, w] frames in [0, 0.9] of a still texture with a
    bright disk circling over it (the moving eye or object that makes
    events); numpy from a seed, moved to the card in one copy."""
    rng = np.random.default_rng(seed)
    texture = 0.3 * rng.uniform(size=(h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.empty((n_frames, h, w), np.float32)
    r2 = (0.12 * min(h, w)) ** 2
    for t in range(n_frames):
        phase = 2 * math.pi * t / n_frames
        cy = h / 2 + 0.25 * h * math.sin(phase)
        cx = w / 2 + 0.3 * w * math.cos(phase)
        frames[t] = texture + 0.6 * (((yy - cy) ** 2 + (xx - cx) ** 2)
                                     <= r2)
    return torch.from_numpy(frames).cuda()


def functional_counts(mods):
    return {name: dict(mod.COUNTS) for name, mod in mods.items()}


def timed_frames(run):
    """``run()`` under the host clock, ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kept = run()
    torch.cuda.synchronize()
    return kept, time.perf_counter() - t0


def dnn_rule(x, w1, w2, hidden):
    """The matmul rule through both DNN layers, in f64 on the host:
    1e-5 * ((|x| @ |w1|) @ |w2| + |relu(h)| @ |w2|)."""
    x, w1, w2 = (np.abs(np.asarray(t, np.float64)) for t in (x, w1, w2))
    h = np.maximum(np.asarray(hidden, np.float64), 0)
    return MATMUL_RULE * ((x @ w1) @ w2 + h @ w2)


def functional_path(fmods, kernel_mods):
    """Ed-Gaze, Fig. 5 and Rhythmic, 30 frames each, with the launch
    counters zeroed just before each and read just after; the first 2
    frames of each against the port on the CPU.  Returns the record, a
    ``run_all`` for the profiler and the path's inputs (for timing)."""
    from repro_torch import functional as fn
    from repro_torch.core.usecases import edgaze, rhythmic
    hidden = int(edgaze.DNN_MACS / (edgaze.DH * edgaze.DW))
    rng = np.random.default_rng(13)
    n_in = edgaze.DH * edgaze.DW
    w1_np = (rng.standard_normal((n_in, hidden), dtype=np.float32)
             / np.float32(math.sqrt(n_in)))
    w2_np = rng.standard_normal((hidden, 2), dtype=np.float32)
    w1, w2 = fn.params_from_reference(w1_np, w2_np, "cuda")
    eg_frames = scene(FUNC_FRAMES, edgaze.H, edgaze.W, 21)
    rh_frames = scene(FUNC_FRAMES, rhythmic.H, rhythmic.W, 22)

    def run_edgaze(n=FUNC_FRAMES):
        gen = torch.Generator(device="cuda").manual_seed(5)
        prev = torch.zeros(edgaze.DH, edgaze.DW, device="cuda")
        kept = []
        for t in range(n):
            noisy = fn.with_thermal_noise(gen, eg_frames[t],
                                          FUNC_CAPACITANCE)
            events, prev = fn.edgaze_frontend(noisy, prev,
                                              threshold=EDGAZE_THRESHOLD)
            out = fn.simple_dnn(events, w1, w2)
            if t < FUNC_COMPARED:
                kept.append((noisy, events, prev, out))
        return kept

    def run_fig5(n=FUNC_FRAMES):
        kept = []
        for t in range(n):
            out = fn.fig5_pipeline(rh_frames[t])
            if t < FUNC_COMPARED:
                kept.append(out)
        return kept

    def run_rhythmic(n=FUNC_FRAMES):
        kept = []
        for t in range(n):
            out = fn.rhythmic_pixel_frontend(rh_frames[t], tile=RHYTHMIC_TILE,
                                             keep_fraction=RHYTHMIC_KEEP)
            if t < FUNC_COMPARED:
                kept.append(out)
        return kept

    expected = {"edgaze": {"binning": 1, "frame_event": 1, "matmul": 2},
                "fig5": {"binning": 1, "stencil_conv": 2},
                "rhythmic": {"stencil_conv": 2}}
    rec, kept = {}, {}
    for name, run in (("edgaze", run_edgaze), ("fig5", run_fig5),
                      ("rhythmic", run_rhythmic)):
        run(2)                                    # warm-up
        reset_all(kernel_mods)
        kept[name], wall = timed_frames(run)
        counts = functional_counts(fmods)
        twins = sum(m.COUNTS[k] for m in kernel_mods for k in m.COUNTS
                    if "twin" in k)
        launches = {k: c["kernel_launches"] for k, c in counts.items()}
        want = {k: FUNC_FRAMES * expected[name].get(k, 0) for k in fmods}
        check(launches == want and twins == 0,
              f"functional {name}: launches {launches} (want {want}), "
              f"{twins} twin calls")
        rec[name] = {"frames": FUNC_FRAMES, "wall_s": wall,
                     "frames_per_s": FUNC_FRAMES / wall,
                     "kernel_launches": launches, "twin_calls": twins,
                     "launches_per_frame": expected[name]}

    # the first frames against the same pipelines on the CPU
    w1_c, w2_c = fn.params_from_reference(w1_np, w2_np, "cpu")
    prev_c = torch.zeros(edgaze.DH, edgaze.DW)
    err = {"events": 0.0, "binned": 0.0, "dnn": 0.0}
    rule_ratio = 0.0
    for noisy, events, binned, out in kept["edgaze"]:
        ev_c, prev_c = fn.edgaze_frontend(noisy.cpu(), prev_c,
                                          threshold=EDGAZE_THRESHOLD)
        out_c = fn.simple_dnn(ev_c, w1_c, w2_c)
        check(torch.equal(events.cpu(), ev_c)
              and torch.equal(binned.cpu(), prev_c),
              "edgaze: events or binned frame differ from the CPU run")
        check(out.shape == (1, 2) and bool(torch.isfinite(out).all()),
              "edgaze: DNN output not finite [1, 2]")
        x = ev_c.reshape(1, -1).numpy()
        hidden_c = x.astype(np.float64) @ w1_np.astype(np.float64)
        bound = dnn_rule(x, w1_np, w2_np, hidden_c)
        d = np.abs(out.cpu().double().numpy() - out_c.double().numpy())
        rule_ratio = max(rule_ratio, float((d / bound).max()))
        err["dnn"] = max(err["dnn"], float(d.max()))
    check(rule_ratio <= 1.0, f"edgaze: DNN off the CPU run by {rule_ratio} "
          f"x the matmul rule")
    events_per_frame = float(kept["edgaze"][-1][1].sum())
    check(0 < events_per_frame < edgaze.DH * edgaze.DW,
          f"edgaze: {events_per_frame} events in a frame")
    for t, out in enumerate(kept["fig5"]):
        want = fn.fig5_pipeline(rh_frames[t].cpu())
        check(out.shape == (rhythmic.H // 2 - 2, rhythmic.W // 2 - 2)
              and torch.equal(out.cpu(), want),
              "fig5: edge map differs from the CPU run")
    for t, out in enumerate(kept["rhythmic"]):
        want = fn.rhythmic_pixel_frontend(rh_frames[t].cpu(),
                                          tile=RHYTHMIC_TILE,
                                          keep_fraction=RHYTHMIC_KEEP)
        check(out.shape == (rhythmic.H, rhythmic.W)
              and torch.equal(out.cpu(), want),
              "rhythmic: output differs from the CPU run")
    kept_share = float((kept["rhythmic"][0] != 0).float().mean())
    rec["edgaze"].update(frame=[edgaze.H, edgaze.W], dnn=[n_in, hidden, 2],
                         capacitance_f=FUNC_CAPACITANCE,
                         events_in_frame_2=events_per_frame,
                         vs_cpu_max_abs_err=err,
                         dnn_err_over_rule=rule_ratio)
    rec["fig5"].update(frame=[rhythmic.H, rhythmic.W], vs_cpu_max_abs_err=0.0)
    rec["rhythmic"].update(frame=[rhythmic.H, rhythmic.W],
                           tile=RHYTHMIC_TILE, kept_pixel_share=kept_share,
                           vs_cpu_max_abs_err=0.0)
    rec["compared_frames"] = FUNC_COMPARED
    emit({"functional_path": rec})

    def run_all():
        t0 = time.perf_counter()
        run_edgaze()
        run_fig5()
        run_rhythmic()
        torch.cuda.synchronize()
        return SimpleNamespace(eval_s=time.perf_counter() - t0)

    shapes = dict(eg_frames=eg_frames, rh_frames=rh_frames, w1=w1, w2=w2)
    return rec, run_all, shapes


def functional_timing(fmods, inputs):
    """ms, device ms, plain and library ms and the bound of K5-K8 at the
    functional path's shapes; the first shape of each is its headline."""
    import torch.nn.functional as F
    bn, sc, fe, mm = (fmods[name] for name in FUNC_KERNELS)
    eg, rh = inputs["eg_frames"][0], inputs["rh_frames"][0]
    binned = bn.binning(rh, 2)
    sobel = torch.tensor([[1., 0., -1.], [2., 0., -2.], [1., 0., -1.]],
                         device="cuda")
    ev_a, ev_b = bn.binning(eg, 2), bn.binning(inputs["eg_frames"][1], 2)
    events = fe.frame_event(ev_a, ev_b, EDGAZE_THRESHOLD).reshape(1, -1)
    hidden = torch.relu(mm.matmul(events, inputs["w1"]))
    big_a, big_b = gaussian((1024, 1024), 1), gaussian((1024, 1024), 2)

    def binning_row(x, f):
        h, w = x.shape
        n_out = (h // f) * (w // f)
        return (f"{h}x{w} f{f}", lambda: bn.binning(x, f),
                lambda: bn.binning_torch(x, f),
                lambda: F.avg_pool2d(x[None, None], f),
                4 * n_out * (f * f + 1), n_out * (f * f + 1))

    def stencil_row(x, k):
        (h, w), (kh, kw) = x.shape, k.shape
        n_out = (h - kh + 1) * (w - kw + 1)
        return (f"{h}x{w} k{kh}x{kw}", lambda: sc.stencil_conv(x, k),
                lambda: sc.stencil_conv_torch(x, k),
                lambda: F.conv2d(x[None, None], k[None, None]),
                4 * (h * w + kh * kw + n_out), 2 * kh * kw * n_out)

    def matmul_row(a, b):
        (m, k), n = a.shape, b.shape[1]
        return (f"{m}x{k}x{n}", lambda: mm.matmul(a, b),
                lambda: mm.matmul_torch(a, b), lambda: torch.matmul(a, b),
                4 * (m * k + k * n + m * n), 2 * m * n * k)

    rows = {
        "binning": ("binning_kernel",
                    [binning_row(rh, 2), binning_row(eg, 2)]),
        "stencil_conv": ("stencil_conv_kernel",
                         [stencil_row(rh, sobel),
                          stencil_row(binned, sobel)]),
        "frame_event": ("frame_event", [(
            f"{ev_a.shape[0]}x{ev_a.shape[1]}",
            lambda: fe.frame_event(ev_a, ev_b, EDGAZE_THRESHOLD),
            lambda: fe.frame_event_torch(ev_a, ev_b, EDGAZE_THRESHOLD),
            None, 12 * ev_a.numel(), 3 * ev_a.numel())]),
        "matmul": ("matmul_", [matmul_row(events, inputs["w1"]),
                               matmul_row(hidden, inputs["w2"]),
                               matmul_row(big_a, big_b)]),
    }
    out = {}
    for name, (needle, shape_rows) in rows.items():
        by_shape = []
        for label, ker, plain, lib, nbytes, nops in shape_rows:
            t_bytes, t_ops = nbytes / PEAK_BYTES, nops / PEAK_FP32
            by_shape.append(dict(
                shape=label, ms=time_ms(ker),
                device_ms=device_ms(ker, needle),
                plain_ms=time_ms(plain, reps=5),
                library_ms=time_ms(lib) if lib is not None else None,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, operations=nops))
        out[name] = by_shape
    return out


def reset_all(mods) -> None:
    for mod in mods:
        mod.reset_counts()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.batch import build_coeff_compute, interp_tables
    from repro_torch.core.shard_sweep import _prepare_stream
    from repro_torch.core.sweep import scalar_point
    from repro_torch.explore import DesignSpace, explore
    from repro_torch.kernels import cuda_build
    fs = importlib.import_module("repro_torch.kernels.fused_sweep")
    gd = importlib.import_module("repro_torch.kernels.grid_decode")
    sr = importlib.import_module("repro_torch.kernels.stream_reduce")
    cr = importlib.import_module("repro_torch.kernels.category_reduce")
    fmods = {name: importlib.import_module(f"repro_torch.kernels.{name}")
             for name in FUNC_KERNELS}
    kernel_mods = (fs, gd, sr, cr, *fmods.values())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    emit({"device": kind, "nvidia_smi": smi[0] if smi else None,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    # ----- 1. build: one nvcc per source, all started together -------------
    t0 = time.perf_counter()
    cuda_build.build_libraries(KERNEL_SOURCES)
    for mod in kernel_mods:
        mod.load_kernel_library()
    emit({"build": {
        "seconds": time.perf_counter() - t0,
        "ptxas": {name: [ln.strip() for ln in
                         cuda_build.build_info(name)["log"].splitlines()
                         if "registers" in ln or "spill" in ln]
                  for name in KERNEL_SOURCES}}})

    # ----- 2. each kernel vs its twin on the card ---------------------------
    prep = _prepare_stream(["edgaze", "rhythmic"], MEGA_GRIDS, device="cuda")
    check(prep.total == MEGA_POINTS, f"mega space has {prep.total} points")
    compute = build_coeff_compute(prep.bank.dims)
    n_var = prep.n_var
    recs = []
    for kk in (3, 16):                        # the main-path chunk
        recs.append(run_case(prep, fs, compute, name=f"main_chunk_kk{kk}",
                             variant=2, start=2 * n_var + CHUNK, low=0,
                             limit=3 * n_var, chunk=CHUNK, bp=4096, kk=kk))
    cpv = -(-n_var // CHUNK)                  # the variant's masked tail
    recs.append(run_case(prep, fs, compute, name="masked_tail_chunk",
                         variant=6, start=6 * n_var + (cpv - 1) * CHUNK,
                         low=0, limit=7 * n_var, chunk=CHUNK, bp=4096, kk=3))
    recs.append(run_case(prep, fs, compute, name="ragged_chunk",
                         variant=0, start=12345, low=0, limit=n_var,
                         chunk=100_003, bp=4096, kk=5))
    recs.append(run_case(prep, fs, compute, name="low_limit_inside",
                         variant=4, start=4 * n_var + 5000,
                         low=4 * n_var + 5000 + 777,
                         limit=4 * n_var + 5000 + 9000, chunk=16384,
                         bp=4096, kk=16))
    recs.append(run_case(prep, fs, compute, name="kk_above_bp",
                         variant=1, start=n_var, low=0, limit=2 * n_var,
                         chunk=64, bp=8, kk=16))
    recs.append(synthetic_case(fs))
    wide = _prepare_stream("edgaze", WIDE_GRIDS, device="cuda")
    wide_compute = build_coeff_compute(wide.bank.dims)
    recs.append(run_case(wide, fs, wide_compute, name="int64_beyond_2^31",
                         variant=0, start=WIDE_POINTS - 70_000, low=0,
                         limit=WIDE_POINTS, chunk=CHUNK, bp=4096, kk=4,
                         idx_dtype=torch.int64))

    k2 = [decode_case(gd, prep, name="decode_main_chunk",
                      start=2 * n_var + CHUNK, chunk=CHUNK),
          decode_case(gd, prep, name="decode_tail_past_total",
                      start=prep.total - 1000, chunk=4099),
          decode_case(gd, wide, name="decode_int64_beyond_2^31",
                      start=WIDE_POINTS - 70_000, chunk=CHUNK,
                      idx_dtype=torch.int64)]
    check(k2[1]["past_total"] > 0, "decode tail does not cross total")
    vals, mask = stats_inputs(CHUNK, 1, empty_block=(5 * 4096, 6 * 4096))
    k3a = [stats_case(sr, name="stats_main_chunk", values=vals, mask=mask,
                      bp=4096)]
    rvals, rmask = stats_inputs(CHUNK - 1234, 2, ties=True)
    k3a.append(stats_case(sr, name="stats_ragged_ties", values=rvals,
                          mask=rmask, bp=4096))
    check(k3a[0]["empty_blocks"] >= 1, "no all-masked block in the case")
    vid = (torch.arange(CHUNK, device="cuda") % 8).to(torch.int32)
    vid[-5000:] = -1                          # padding rows
    k3b = [stats_case(sr, name="stats_banked_8_variants", values=vals,
                      mask=mask, bp=4096, variant=vid, n_variants=8)]
    e_main, w_main = reduce_inputs(CHUNK, 11, 10, 3)
    e_rag, w_rag = reduce_inputs(100_003, 11, 10, 4)
    k4 = [reduce_case(cr, name="reduce_main_chunk", e=e_main, w=w_main),
          reduce_case(cr, name="reduce_ragged", e=e_rag, w=w_rag)]
    fcases = functional_kernel_cases(fmods)

    # ----- 3. the main path at full width: fused ----------------------------
    space = DesignSpace(["edgaze", "rhythmic"], MEGA_GRIDS)
    explore(space, engine="fused", chunk_size=CHUNK, k=3)   # warm-up
    reset_all(kernel_mods)
    res = explore(space, engine="fused", chunk_size=CHUNK, k=3)
    launches = fs.COUNTS["kernel_launches"]
    twin_calls = fs.COUNTS["twin_calls"]
    # folding stays on the device, so only prep and finalize may
    # synchronise, never once per chunk
    syncs = count_syncs(lambda: explore(space, engine="fused",
                                        chunk_size=CHUNK, k=3))
    check(syncs < launches, f"main path: {syncs} host syncs for "
          f"{launches} kernel launches")
    check(res.n_points == MEGA_POINTS, f"swept {res.n_points} points")
    check(res.backend == "cuda", f"main path ran backend {res.backend}")
    check(launches > 0 and twin_calls == 0,
          f"main path: {launches} kernel launches, {twin_calls} twin calls")
    check(len(res.topk) == 3 and all(
        math.isfinite(r[key]) for r in res.topk for key in r
        if isinstance(r[key], float)), "main path: top-k rows not finite")
    emit({"main_path": {
        "points": res.n_points, "n_feasible": res.n_feasible,
        "points_per_s": res.points_per_sec, "eval_s": res.eval_s,
        "compile_s": res.compile_s, "wall_s": res.wall_s,
        "dispatches": res.dispatches, "superchunk": res.superchunk,
        "occupancy": res.occupancy, "kernel_launches": launches,
        "twin_calls": twin_calls, "host_syncs": syncs,
        "best_total_j": res.topk[0]["total_j"]}})

    fs.reset_counts()
    twin_res = explore(space, engine="fused", chunk_size=CHUNK, k=3,
                       backend="torch")
    check(fs.COUNTS["kernel_launches"] == 0, "twin lane launched the kernel")
    worst = compare_results("mega_kernel_vs_twin", res, twin_res)
    best = res.topk[0]
    oracle = scalar_total(best["algorithm"], best["variant"], best)
    oracle_err = abs(best["total_j"] - oracle) / abs(oracle)
    check(oracle_err <= 5e-4, f"scalar oracle rel err {oracle_err}")
    emit({"main_path_checks": {
        "kernel_vs_twin_max_rel_err": worst,
        "twin_eval_s": twin_res.eval_s,
        "scalar_oracle_total_j": oracle, "scalar_oracle_rel_err": oracle_err,
        "best": {k: best[k] for k in ("algorithm", "variant", "index")}}})

    wide_space = DesignSpace(["edgaze"], WIDE_GRIDS)
    rng = (WIDE_POINTS - 150, WIDE_POINTS)
    fs.reset_counts()
    w_ker = explore(wide_space, chunk_size=64, k=4, index_range=rng)
    w_launches = fs.COUNTS["kernel_launches"]
    w_twin = explore(wide_space, chunk_size=64, k=4, index_range=rng,
                     backend="torch")
    compare_results("int64_tail", w_ker, w_twin)
    check(w_launches > 0 and w_ker.n_points == 150
          and all(r["index"] >= 2 ** 31 for r in w_ker.topk),
          "int64 tail: wrong span or indices")
    emit({"int64_path": {"points": w_ker.n_points, "launches": w_launches,
                         "best_index": w_ker.topk[0]["index"]}})

    # ----- 4. staged at full width: K2 -> banked evaluator -> K3a -----------
    def staged():
        return explore(space, engine="staged", chunk_size=CHUNK, k=3)
    staged()                                  # warm-up
    reset_all(kernel_mods)
    st = staged()
    st_counts = dict(decode=gd.COUNTS["kernel_launches"],
                     stats=sr.COUNTS["kernel_launches"],
                     twins=sum(m.COUNTS[k] for m in kernel_mods
                               for k in m.COUNTS if "twin" in k))
    st_syncs = count_syncs(staged)
    n_chunks = 8 * cpv
    check(st.engine == "staged" and st.dispatches == n_chunks,
          f"staged: engine {st.engine}, {st.dispatches} dispatches")
    check(st_counts["decode"] == n_chunks and st_counts["stats"] == n_chunks
          and st_counts["twins"] == 0, f"staged: launches {st_counts}")
    check(st_syncs < st_counts["decode"], f"staged: {st_syncs} host syncs "
          f"for {st_counts['decode']} chunks")
    st_worst = compare_results("staged_vs_fused", st, res)
    emit({"staged_path": {
        "points": st.n_points, "eval_s": st.eval_s,
        "points_per_s": st.points_per_sec, "dispatches": st.dispatches,
        "grid_decode_launches": st_counts["decode"],
        "block_stats_launches": st_counts["stats"],
        "twin_calls": st_counts["twins"], "host_syncs": st_syncs,
        "vs_fused_max_rel_err": st_worst}})

    # ----- 5. chunked through auto: K4 --------------------------------------
    ch_space = DesignSpace(["edgaze"], CHUNKED_GRIDS)
    check(ch_space.n_points == CHUNKED_POINTS, "chunked space size")
    reset_all(kernel_mods)
    ch = explore(ch_space, k=3)
    ch_counts = (cr.COUNTS["kernel_launches"], cr.COUNTS["twin_calls"])
    check(ch.engine == "chunked" and ch.chunk_size == CHUNK,
          f"auto picked {ch.engine} / chunk {ch.chunk_size}")
    check(ch_counts == (10, 0), f"chunked: K4 launches/twin {ch_counts}")
    ch_fused = explore(ch_space, engine="fused", chunk_size=CHUNK, k=3)
    ch_worst = compare_results("chunked_vs_fused", ch, ch_fused)
    emit({"chunked_path": {
        "points": ch.n_points, "eval_s": ch.eval_s, "wall_s": ch.wall_s,
        "points_per_s": ch.points_per_sec, "dispatches": ch.dispatches,
        "category_reduce_launches": ch_counts[0],
        "twin_calls": ch_counts[1], "vs_fused_max_rel_err": ch_worst}})

    # ----- 6. monolithic through auto: K4 -----------------------------------
    mo_space = DesignSpace(["edgaze", "rhythmic"], DESIGN_GRIDS)
    check(mo_space.n_points == DESIGN_POINTS, "design_sweep space size")
    reset_all(kernel_mods)
    mo = explore(mo_space, k=3)
    mo_counts = (cr.COUNTS["kernel_launches"], cr.COUNTS["twin_calls"])
    check(mo.engine == "monolithic", f"auto picked {mo.engine}")
    check(mo_counts == (8, 0), f"monolithic: K4 launches/twin {mo_counts}")
    mo_fused = explore(mo_space, engine="fused", chunk_size=CHUNK, k=3)
    mo_worst = compare_results("monolithic_vs_fused", mo, mo_fused)
    win = mo.topk[0]
    sp = scalar_point(win["algorithm"], win["variant"], **{
        ax: win[ax] for ax in ("cis_node", "soc_node", "mem_tech",
                               "sys_rows", "sys_cols", "frame_rate",
                               "active_fraction_scale", "pixel_pitch_um")})
    mo_oracle = abs(win["total_j"] - sp["total_j"]) / abs(sp["total_j"])
    check(mo_oracle <= 5e-4, f"monolithic winner vs scalar oracle "
          f"{mo_oracle}")
    emit({"monolithic_path": {
        "points": mo.n_points, "eval_s": mo.eval_s, "wall_s": mo.wall_s,
        "points_per_s": mo.points_per_sec, "dispatches": mo.dispatches,
        "category_reduce_launches": mo_counts[0],
        "twin_calls": mo_counts[1], "vs_fused_max_rel_err": mo_worst,
        "scalar_oracle_rel_err": mo_oracle}})

    # ----- 7. the functional simulator: K5-K8 -------------------------------
    func, run_functional, func_inputs = functional_path(fmods, kernel_mods)

    # ----- 8. timing at the main paths' shapes ------------------------------
    kw = dict(compute=compute, metric="total_j",
              axis_names=tuple(prep.vgrids[0].names),
              shape=prep.vgrids[0].shape, n_var=n_var, total=prep.total,
              chunk=CHUNK, lmax=prep.lmax, block_points=4096, kk=3)
    row = prep.bank.fused[2]
    start = 2 * n_var + CHUNK
    def k1():
        return fs.fused_sweep_block(prep.table2, row, start, 0, 3 * n_var,
                                    **kw)
    kernel_ms = time_ms(k1)
    twin_ms = time_ms(lambda: fs.fused_sweep_block_torch(
        prep.table2, row, start, 0, 3 * n_var, **kw), reps=5)
    knots = tuple(len(xs) for xs, _ in interp_tables())
    n_blocks = CHUNK // 4096
    bytes_moved = 4 * (prep.table2.numel() + row.numel()) \
        + n_blocks * (3 * 8 + 8)
    b_ms, b_by, fp, sfu = bound_ms(CHUNK, prep.bank.dims, knots,
                                   bytes_moved)

    dkw = dict(shape=prep.vgrids[0].shape, n_var=n_var, total=prep.total,
               chunk=CHUNK, lmax=prep.lmax)
    n_axes = len(prep.vgrids[0].shape)
    timed = {
        "grid_decode": (
            lambda: gd.grid_decode(prep.table2, start, **dkw),
            lambda: gd.grid_decode_torch(prep.table2, start, **dkw),
            None, 4 * prep.table2.numel() + CHUNK * 4 * (n_axes + 1), 0),
        "block_stats": (
            lambda: sr.block_stats(vals, mask, 4096),
            lambda: sr.block_stats_torch(vals, mask, 4096),
            None, CHUNK * 5 + n_blocks * 16, CHUNK * 3),
        "block_stats_banked": (
            lambda: sr.block_stats_banked(vals, mask, vid, 8, 4096),
            lambda: sr.block_stats_banked_torch(vals, mask, vid, 8, 4096),
            None, CHUNK * 9 + n_blocks * 8 * 16, CHUNK * 3),
        "category_reduce": (
            lambda: cr.category_reduce(e_main, w_main),
            lambda: cr.category_reduce_torch(e_main, w_main),
            lambda: torch.matmul(e_main, w_main),
            4 * (CHUNK * 11 + 11 * 10 + CHUNK * 10), 2 * CHUNK * 11 * 10),
    }
    times = {}
    for name, (ker, plain, lib, nbytes, nops) in timed.items():
        t_bytes = nbytes / PEAK_BYTES
        t_ops = nops / PEAK_FP32
        times[name] = dict(
            ms=time_ms(ker), device_ms=device_ms(ker, f"{name}_kernel"),
            plain_ms=time_ms(plain, reps=5),
            library_ms=time_ms(lib) if lib is not None else None,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, operations=nops)

    profile_path("main_path", lambda: explore(space, engine="fused",
                                              chunk_size=CHUNK, k=3))
    profile_path("staged", staged)
    profile_path("chunked", lambda: explore(ch_space, k=3))
    profile_path("monolithic", lambda: explore(mo_space, k=3))
    ftimes = functional_timing(fmods, func_inputs)
    profile_path("functional", run_functional)

    src = "src/repro_torch/csrc/"
    power = smi[0] if smi else None
    entries = [{
        "name": "fused_sweep", "route": "cuda",
        "source": src + "fused_sweep.cu",
        "replaces": "src/repro/kernels/fused_sweep.py:47",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "max_rel_err": max(r["max_rel_err"] for r in recs),
        "ms": kernel_ms, "plain_ms": twin_ms, "bound_ms": b_ms,
        "bound_by": b_by, "device_ms": device_ms(k1, "fused_sweep_kernel"),
        "library_ms": None, "points": CHUNK, "fp32_ops_per_point": fp,
        "sfu_calls_per_point": sfu, "power_limit": power,
    }]
    for name, source, replaces, n_launch, cases, path in (
            ("grid_decode", "grid_decode.cu",
             "src/repro/kernels/grid_decode.py:73", st_counts["decode"], k2,
             "staged"),
            ("block_stats", "stream_reduce.cu",
             "src/repro/kernels/stream_reduce.py:30", st_counts["stats"],
             k3a, "staged"),
            ("block_stats_banked", "stream_reduce.cu",
             "src/repro/kernels/stream_reduce.py:79", 0, k3b,
             "none (direct check only)"),
            ("category_reduce", "category_reduce.cu",
             "src/repro/kernels/category_reduce.py:22",
             ch_counts[0] + mo_counts[0], k4, "chunked + monolithic")):
        entries.append(dict(
            name=name, route="cuda", source=src + source,
            replaces=replaces, launches=n_launch, path=path,
            max_abs_err=max(r["max_abs_err"] for r in cases),
            points=CHUNK, power_limit=power, **times[name]))
    for name, line in zip(FUNC_KERNELS, (23, 26, 18, 21)):
        launches_f = sum(func[p]["kernel_launches"][name]
                         for p in ("edgaze", "fig5", "rhythmic"))
        head = ftimes[name][0]
        entries.append(dict(
            name=name, route="cuda", source=src + f"{name}.cu",
            replaces=f"src/repro/kernels/{name}.py:{line}",
            launches=launches_f,
            path="functional (edgaze + fig5 + rhythmic)",
            max_abs_err=max(r["max_abs_err"] for r in fcases[name]),
            power_limit=power, **head,
            by_shape=ftimes[name]))
    emit({"kernels": entries})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
