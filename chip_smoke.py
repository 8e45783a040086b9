"""GPU smoke run of the PyTorch/CUDA port (``repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
per source, all nine started together): K1 ``fused_sweep.cu``, K2
``grid_decode.cu``, K3a/K3b ``stream_reduce.cu``, K4
``category_reduce.cu``, the functional simulator's K5 ``binning.cu``,
K6 ``stencil_conv.cu``, K7 ``frame_event.cu`` and K8 ``matmul.cu``, and
K9 ``flash_attention.cu``.  Holds each kernel against its plain-torch
twin on the card at the main paths' shapes (and ragged ones; K5-K9 also
in f16 and bf16; K8 on each of its three routes, the wgmma route also
with positive operands at K = 16384, where its own f32 sums are held to
the rule, and offset views on the tile route; K9 also with mixed operand
dtypes and head dims past 128 on its SIMT route), then drives every
engine of ``explore()``, the functional simulator and the attention path
at full width, each with the launch counters zeroed just before it and
read just after:

* fused (the main path) — the ``mega_sweep`` space (all 5 Ed-Gaze + 3
  Rhythmic variants, 1.26e7 design points, ``chunk_size=2**18``,
  ``k=3``) through K1, checked against the twin lane, the int64 index
  path and the scalar ``estimate_energy`` oracle; ``progress`` calls and
  the host syncs of ``pipeline_depth=1`` counted exactly;
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
  frames of each against the same pipeline run by the port on the CPU;
* attention — ``ops.flash_attention`` (K9) at the widths of two
  configured models, bf16: qwen2-7b's causal attention at 4096 tokens
  (28 heads over 4 kv heads, D = 128) and whisper-medium's encoder
  self-attention over its 1500 frames (16 heads, D = 64), each one
  launch of the tensor-core (wgmma) route, within one bf16 rounding of
  the twin, timed beside the twin and ``scaled_dot_product_attention``
  (whose distance from the twin is reported: it rounds P to bf16 once);
  then K9's SIMT route (f32) at the same widths.

It times every kernel (K8 also at 4096^3 bf16, with a probe of its tile
widths, tensor-map encodes and enqueue times), prints its findings as
JSON lines, and ends with the ``kernels`` line and the run's verdict::

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
                  "frame_event", "matmul", "flash_attention")
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
# K9 against its twin, atol = rtol, compared in f32: another summation
# order and an online softmax (f32), plus one rounding of a half dtype
FA_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}
# (B, H, Hkv, S, D): MHA, GQA with a ragged S, MQA, S = 1, and S = 127 at
# the largest head dim the kernel stages
FA_SHAPES = ((2, 4, 4, 256, 64), (2, 8, 2, 200, 32), (1, 8, 1, 128, 64),
             (1, 4, 2, 1, 16), (1, 4, 2, 127, 128))
# the attention path at the widths of two configured models, bf16 as the
# configs declare (src/repro/models/config.py:50), (B, H, Hkv, S, D,
# causal): qwen2-7b (src/repro/configs/qwen2_7b.py: 28 heads, 4 kv heads,
# d_head 128) at the train_4k sequence of 4096 (src/repro/launch/
# shapes.py:20); whisper-medium's encoder self-attention
# (src/repro/configs/whisper_medium.py: d_model 1024, 16 heads and kv
# heads, so D = 64, encoder_seq 1500), not causal
ATTENTION_MODELS = {
    "qwen2_7b": (1, 28, 4, 4096, 128, True),
    "whisper_medium_encoder": (1, 16, 16, 1500, 64, False),
}

REL = 1e-6          # the reference's parity tolerance (values, top-k)
REL_SUM = 1e-5      # block sums: 4096 f32 terms summed in another order
REL_MEAN = 1e-5     # per-variant means: sums of such sums

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit):
# FP32 outside the tensor cores, dense f16/bf16 on the tensor cores (f32
# accumulation; a product of two half values is exact in f32, so work
# whose products all have half operands is bounded at this rate), HBM3
# bandwidth, and the special-function units (16 per SM x 132 SMs at the
# 1.98 GHz boost clock).
PEAK_FP32 = 67e12
PEAK_HALF = 989e12
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


def device_ms(fn, needle, reps=20, tries=5):
    """Device time per call of ``fn``'s kernels named ``*needle*``, from
    ``torch.profiler`` over ``reps`` back-to-back calls (the CUDA-event
    time of such a loop also holds the host's per-launch work): the sum,
    over the distinct kernel names, of each one's median span (each call
    launches each of its kernels once).  On the card the profiler has
    been seen to drop kernel records from a trace, which medians survive;
    a trace that holds fewer than ``reps // 2`` records of a name is
    taken again, up to ``tries`` times; then the run fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and needle in e.name:
                spans.setdefault(e.name, []).append(
                    e.time_range.end - e.time_range.start)
        if spans and min(map(len, spans.values())) >= reps // 2:
            return sum(float(np.median(v)) for v in spans.values()) * 1e-3
    raise AssertionError(f"device time of {needle}: {tries} profiler traces "
                         f"each held fewer than {reps // 2} of {reps} "
                         f"kernel records")


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


def gaussian(shape, seed, dtype=torch.float32):
    """Seeded normal values on the card, made in f32 and rounded to
    ``dtype`` (numpy has no bf16)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).to(dtype).cuda()


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def matmul_case(mm, *, name, m, k, n, seed, dtypes=(torch.float32,) * 2,
                positive=False, offset=False):
    """K8 against its twin: |kernel - twin| <= 1e-5 * (|a| @ |b|)
    elementwise (another summation order), plus one unit in the last place
    of an f16 or bf16 output (each side rounds its f32 sum once), equal
    from run to run, and one launch on the route that :func:`plan` picks.
    ``positive``: operands uniform in [0, 1), where a truncating
    accumulator's bias adds up along K; ``offset``: ``a`` is a contiguous
    view 2 or 4 bytes past a 16-byte boundary (no TMA base)."""
    from repro_torch.testing import ulp
    if positive:
        rng = np.random.default_rng(seed)
        a, b = (torch.from_numpy(rng.uniform(size=shape).astype(np.float32))
                .to(dt).cuda() for shape, dt in (((m, k), dtypes[0]),
                                                 ((k, n), dtypes[1])))
    else:
        a = gaussian((m, k), seed, dtypes[0])
        b = gaussian((k, n), seed + 1, dtypes[1])
    if offset:
        flat = torch.empty(m * k + 1, dtype=a.dtype, device="cuda")
        a = flat[1:].view(m, k).copy_(a)
        check(a.is_contiguous() and a.data_ptr() % 16 != 0,
              f"{name}: the view is aligned")
    route = mm.plan(m, n, k, a.dtype, b.dtype,
                    a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0,
                    torch.cuda.get_device_properties(0).multi_processor_count
                    ).route
    mm.reset_counts()
    ker = mm.matmul(a, b)
    check(mm.COUNTS[f"{route}_launches"] == mm.COUNTS["kernel_launches"]
          == 1, f"{name}: launches {mm.COUNTS} (route {route})")
    again = mm.matmul(a, b)
    torch.cuda.synchronize()
    twin = mm.matmul_torch(a, b)
    check(ker.dtype == twin.dtype == dtypes[0], f"{name}: output dtype")
    bound = MATMUL_RULE * (a.double().abs() @ b.double().abs())
    if dtypes[0] != torch.float32:
        bound = bound + ulp(torch.maximum(ker.abs(), twin.abs()), dtypes[0])
    err = (ker.double() - twin.double()).abs()
    ratio = float((err / bound.clamp_min(1e-300)).max()) \
        if err.numel() else 0.0
    check(ratio <= 1.0, f"{name}: matmul off its twin by {ratio} x the rule")
    check(torch.equal(ker, again), f"{name}: matmul differs run to run")
    rec = dict(case=name, mkn=[m, k, n],
               dtypes=[dtype_name(d) for d in dtypes], route=route,
               max_abs_err=float(err.max()) if err.numel() else 0.0,
               max_err_over_rule=ratio)
    if positive and route == "wgmma":
        rec["f32_sums_over_rule"] = wgmma_f32_sums(mm, a, b, name)
    emit({"kernel_vs_twin": rec})
    return rec


def wgmma_f32_sums(mm, a, b, name):
    """The wgmma route's own f32 sums, before the output's rounding hides
    them: a two-way split plan writes them to an f32 scratch, added here
    in f64, held to 1e-5 * (|a| @ |b|) of the twin's f32 sums."""
    (m, k), n = a.shape, b.shape[1]
    depth = -(-k // 2 // 64) * 64
    part = torch.empty((2, m, n), dtype=torch.float32, device="cuda")
    mm.run(a, b, mm.Plan("wgmma", 64, 2, depth), part=part)
    torch.cuda.synchronize()
    got = part.double().sum(0)
    twin = mm.matmul_torch(a.float(), b.float()).double()
    ratio = float(((got - twin).abs()
                   / (MATMUL_RULE * (a.double().abs() @ b.double().abs()))
                   ).max())
    check(ratio <= 1.0, f"{name}: the wgmma route's f32 sums off the twin's "
          f"by {ratio} x the rule")
    return ratio


def functional_kernel_cases(fmods):
    """K5-K8 against their twins at the functional path's shapes and at
    ragged ones; returns the records by kernel."""
    bn, sc, fe, mm = (fmods[name] for name in FUNC_KERNELS)
    cases = {"binning": [], "stencil_conv": [], "frame_event": [],
             "matmul": []}
    f32, f16, bf16 = torch.float32, torch.float16, torch.bfloat16
    for shape, f, dt in (((400, 640), 2, f32), ((720, 1280), 2, f32),
                         ((17, 33), 3, f32), ((17, 33), 4, f32),
                         ((17, 33), 2, f16), ((720, 1280), 2, f16),
                         ((17, 33), 3, bf16), ((720, 1280), 2, bf16)):
        x = gaussian(shape, sum(shape) + f, dt)
        cases["binning"].append(exact_case(
            f"binning_{shape[0]}x{shape[1]}_f{f}_{dtype_name(dt)}",
            lambda: bn.binning(x, f), lambda: bn.binning_torch(x, f)))
    # the kernel sums in f32: its twin is the f32 sum rounded once
    for shape, k, dt, taps_dt in (((360, 640), (3, 3), f32, f32),
                                  ((720, 1280), (3, 3), f32, f32),
                                  ((100, 140), (3, 5), f32, f32),
                                  ((77, 45), (5, 5), f32, f32),
                                  ((1000, 33), (2, 2), f32, f32),
                                  ((720, 1280), (3, 3), f16, f32),
                                  ((720, 1280), (3, 3), bf16, f32),
                                  ((720, 1280), (3, 3), f16, f16),
                                  ((720, 1280), (3, 3), bf16, bf16),
                                  ((77, 45), (5, 5), bf16, bf16)):
        x = gaussian(shape, shape[0], dt)
        taps = gaussian(k, 10 * k[0] + k[1], taps_dt)
        cases["stencil_conv"].append(exact_case(
            f"stencil_{shape[0]}x{shape[1]}_k{k[0]}x{k[1]}_"
            f"{dtype_name(dt)}_taps_{dtype_name(taps_dt)}",
            lambda: sc.stencil_conv(x, taps),
            lambda: sc.stencil_conv_torch(x, taps, acc_dtype=f32)))
    for shape, dt, t in (((200, 320), f32, EDGAZE_THRESHOLD),
                         ((33, 47), f32, 0.5), ((33, 47), f16, 0.5),
                         ((200, 320), f16, EDGAZE_THRESHOLD),
                         ((200, 320), bf16, EDGAZE_THRESHOLD),
                         ((33, 47), bf16, 0.5)):
        cur, prev = gaussian(shape, 1, dt), gaussian(shape, 2, dt)
        cases["frame_event"].append(exact_case(
            f"frame_event_{shape[0]}x{shape[1]}_{dtype_name(dt)}",
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
    # (m, k, n), dtypes, the route the plan must pick, and the options:
    # ragged M and N, K % 64 != 0 and split K on the wgmma route; positive
    # operands at K = 16384; an offset view, which must take the tile route
    for (m, k, n), dts, want, opts in (
            ((1, 64000, 900), (f32, f32), "skinny", {}),
            ((1, 900, 2), (f32, f32), "skinny", {}),
            ((130, 150, 70), (f32, f32), "tile", {}),
            ((1, 64, 1), (f32, f32), "skinny", {}),
            ((1024, 1024, 1024), (f32, f32), "tile", {}),
            ((7, 5000, 333), (f32, f32), "skinny", {}),
            ((1, 64000, 900), (bf16, bf16), "skinny", {}),
            ((1, 64000, 900), (f16, f16), "skinny", {}),
            ((1024, 1024, 1024), (bf16, bf16), "wgmma", {}),
            ((1024, 1024, 1024), (f16, f16), "wgmma", {}),
            ((4096, 4096, 4096), (bf16, bf16), "wgmma", {}),
            ((130, 150, 70), (bf16, f32), "tile", {}),
            ((7, 5000, 333), (f32, f16), "skinny", {}),
            ((130, 72, 1000), (f16, f16), "wgmma", {}),
            ((130, 72, 1000), (bf16, bf16), "wgmma", {}),
            ((9, 1024, 4096), (f16, f16), "wgmma", {}),
            ((9, 1024, 4096), (bf16, bf16), "wgmma", {}),
            ((1000, 200, 4104), (f16, f16), "wgmma", {}),
            ((1000, 200, 4104), (bf16, bf16), "wgmma", {}),
            ((256, 16384, 256), (f16, f16), "wgmma", dict(positive=True)),
            ((256, 16384, 256), (bf16, bf16), "wgmma", dict(positive=True)),
            ((1024, 1024, 1024), (f32, f32), "tile", dict(positive=True)),
            ((130, 64, 72), (bf16, bf16), "tile", dict(offset=True)),
            ((1000, 200, 4104), (f16, f16), "tile", dict(offset=True))):
        tag = "" if dts == (f32, f32) else \
            f"_{dtype_name(dts[0])}@{dtype_name(dts[1])}"
        tag += "".join(f"_{key}" for key in opts)
        rec = matmul_case(mm, name=f"matmul_{m}x{k}x{n}{tag}", m=m, k=k,
                          n=n, seed=m + k + n, dtypes=dts, **opts)
        check(rec["route"] == want, f"{rec['case']}: route {rec['route']}, "
              f"not {want}")
        cases["matmul"].append(rec)
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
        # the DNN's two products (M = 1) both run the skinny kernel
        routes = {r: counts["matmul"][f"{r}_launches"]
                  for r in ("wgmma", "tile", "skinny")}
        check(routes["skinny"] == launches["matmul"],
              f"functional {name}: matmul routes {routes}")
        rec[name] = {"frames": FUNC_FRAMES, "wall_s": wall,
                     "frames_per_s": FUNC_FRAMES / wall,
                     "kernel_launches": launches, "twin_calls": twins,
                     "matmul_route_launches": routes,
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
    functional path's shapes, in f32 and again in f16 and bf16; the first
    shape of each is its headline."""
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
    huge_a = gaussian((4096, 4096), 3, torch.bfloat16)
    huge_b = gaussian((4096, 4096), 4, torch.bfloat16)
    halves = (torch.float16, torch.bfloat16)

    def label(shape, x):
        return shape if x.dtype == torch.float32 else \
            f"{shape} {dtype_name(x.dtype)}"

    def binning_row(x, f):
        h, w = x.shape
        n_out = (h // f) * (w // f)
        return (label(f"{h}x{w} f{f}", x), lambda: bn.binning(x, f),
                lambda: bn.binning_torch(x, f),
                lambda: F.avg_pool2d(x[None, None], f),
                x.element_size() * n_out * (f * f + 1), n_out * (f * f + 1))

    def stencil_row(x, k):
        (h, w), (kh, kw) = x.shape, k.shape
        n_out = (h - kh + 1) * (w - kw + 1)
        k_lib = k.to(x.dtype)
        return (label(f"{h}x{w} k{kh}x{kw}", x), lambda: sc.stencil_conv(x, k),
                lambda: sc.stencil_conv_torch(x, k, acc_dtype=torch.float32),
                lambda: F.conv2d(x[None, None], k_lib[None, None]),
                x.element_size() * (h * w + n_out) + 4 * kh * kw,
                2 * kh * kw * n_out)

    def event_row(a, b):
        return (label(f"{a.shape[0]}x{a.shape[1]}", a),
                lambda: fe.frame_event(a, b, EDGAZE_THRESHOLD),
                lambda: fe.frame_event_torch(a, b, EDGAZE_THRESHOLD),
                None, 3 * a.element_size() * a.numel(), 3 * a.numel())

    def matmul_row(a, b, plain_reps=5):
        (m, k), n = a.shape, b.shape[1]
        ops = 2 * m * n * k
        halves_only = a.dtype == b.dtype and a.dtype in halves
        return (label(f"{m}x{k}x{n}", a), lambda: mm.matmul(a, b),
                lambda: mm.matmul_torch(a, b), lambda: torch.matmul(a, b),
                a.element_size() * (m * k + m * n) + b.element_size() * k * n,
                (0, ops) if halves_only else (ops, 0), plain_reps)

    rows = {
        "binning": ("binning_kernel",
                    [binning_row(rh, 2), binning_row(eg, 2)]
                    + [binning_row(rh.to(dt), 2) for dt in halves]),
        "stencil_conv": ("stencil_conv_kernel",
                         [stencil_row(rh, sobel),
                          stencil_row(binned, sobel)]
                         + [stencil_row(rh.to(dt), sobel)
                            for dt in halves]),
        "frame_event": ("frame_event", [event_row(ev_a, ev_b)]
                        + [event_row(ev_a.to(dt), ev_b.to(dt))
                           for dt in halves]),
        "matmul": ("matmul_", [matmul_row(events, inputs["w1"]),
                               matmul_row(hidden, inputs["w2"]),
                               matmul_row(big_a, big_b)]
                   + [matmul_row(x.to(dt), w.to(dt)) for dt in halves
                      for x, w in ((events, inputs["w1"]),
                                   (big_a, big_b))]
                   + [matmul_row(huge_a, huge_b, plain_reps=1)]),
    }
    out = {}
    for name, (needle, shape_rows) in rows.items():
        out[name] = [timing_row(label_, ker, plain, lib, nbytes, nops,
                                needle, plain_reps=rest[0] if rest else 5)
                     for label_, ker, plain, lib, nbytes, nops, *rest
                     in shape_rows]
    out["matmul_probe"] = matmul_probe(mm, events, inputs["w1"], hidden,
                                       inputs["w2"], big_a, big_b)
    return out


def host_us(fn, reps=50):
    """Host microseconds a call of ``fn`` takes to enqueue its work (no
    synchronise inside the window; the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def matmul_probe(mm, events, w1, hidden, w2, big_a, big_b):
    """What K8's design choices cost, measured here: the tile width (and a
    two-way K split) at 1024^3 on the wgmma and tile routes (device ms of
    each plan), the host time of encoding the wgmma route's two tensor
    maps, and the host time a wrapper call takes to enqueue, for the
    GEMV in f16 and bf16, the (1, 900, 2) layer and 1024^3 bf16."""
    lib = mm.load_kernel_library()
    big_h = big_a.to(torch.bfloat16), big_b.to(torch.bfloat16)
    plans = {}
    for route, (a, b) in (("wgmma", big_h), ("tile", (big_a, big_b))):
        unit = 64 if route == "wgmma" else 16
        for tile_n, splits in ((128, 1), (64, 1), (128, 2)):
            p = mm.Plan(route, tile_n, splits, -(-1024 // splits // unit)
                        * unit)
            plans[f"{route}_n{tile_n}_s{splits}"] = device_ms(
                lambda: mm.run(a, b, p), "matmul_")
    encode = lib.repro_matmul_encode_us(big_h[0].data_ptr(),
                                        big_h[1].data_ptr(), 2, 1024, 1024,
                                        1024, 2000)
    enqueue = {}
    for label_, a, b in (("gemv_f16", events.half(), w1.half()),
                         ("gemv_bf16", events.bfloat16(), w1.bfloat16()),
                         ("gemv_f32", events, w1),
                         ("1x900x2", hidden, w2),
                         ("1024^3_bf16", *big_h)):
        enqueue[label_] = host_us(lambda: mm.matmul(a, b))
    rec = {"device_ms_by_plan_1024^3": plans,
           "chosen_plan_1024^3": {r: mm.plan(1024, 1024, 1024, dt, dt, True,
                                             torch.cuda.get_device_properties(
                                                 0).multi_processor_count
                                             )._asdict()
                                  for r, dt in (("wgmma", torch.bfloat16),
                                                ("tile", torch.float32))},
           "tensor_map_encode_us": encode, "enqueue_us": enqueue}
    emit({"matmul_probe": rec})
    return rec


def split_ops(nops):
    """``(fp32, half)`` operations: a bare count is all FP32."""
    return nops if isinstance(nops, tuple) else (nops, 0)


def timing_row(shape, ker, plain, lib, nbytes, nops, needle, reps=20,
               plain_reps=5):
    """One kernel's times at one shape: CUDA-event ms of back-to-back
    wrapper calls, profiler device ms, the plain twin's and the library
    call's ms, and the bound from the bytes it must move and the
    operations it must do.  ``nops`` is an FP32 count or ``(fp32, half)``:
    the half operations (products of two f16/bf16 values) at the tensor
    cores' rate, added to the FP32 ones' time at the CUDA cores' rate."""
    fp32_ops, half_ops = split_ops(nops)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = fp32_ops / PEAK_FP32 + half_ops / PEAK_HALF
    return dict(shape=shape, ms=time_ms(ker, reps),
                device_ms=device_ms(ker, needle, reps),
                plain_ms=time_ms(plain, reps=plain_reps),
                library_ms=time_ms(lib, reps) if lib is not None else None,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, operations=fp32_ops + half_ops,
                half_operations=half_ops)


# ---------------------------------------------------------------------------
# K9 and the attention path
# ---------------------------------------------------------------------------
def attention_inputs(b, h, hkv, s, d, seed, dtype):
    return (gaussian((b, h, s, d), seed, dtype),
            gaussian((b, hkv, s, d), seed + 1, dtype),
            gaussian((b, hkv, s, d), seed + 2, dtype))


def attention_scores(b, h, s, causal):
    """Unmasked scores: one exp each, and ``D`` products in each of
    ``Q K^T`` and ``P V``."""
    return (s * (s + 1) // 2 if causal else s * s) * b * h


def attention_ops(b, h, s, d, causal, dtype, route):
    """``(fp32, half)`` operations of the route's arithmetic per unmasked
    score.  wgmma: ``2 D`` for q . k and ``4 D`` for the split p . v
    (``P_hi V + P_lo V``), all products of two f16/bf16 values (exact in
    f32), so half operations.  SIMT: ``2 D`` for q . k, half operations
    with f16/bf16 operands, and ``2 D`` FP32 for p . v (p in f32); all
    ``4 D`` FP32 in f32."""
    per_d = d * attention_scores(b, h, s, causal)
    if route == "wgmma":
        return 0, 6 * per_d
    if dtype == torch.float32:
        return 4 * per_d, 0
    return 2 * per_d, 2 * per_d


def half_rule(k, t):
    """Max over the elements of ``|k - t|`` over one unit in the last place
    of the half dtype at ``max(|k|, |t|)`` (each side rounds its f32 result
    once) plus the f32 tolerance ``1e-5 (1 + |t|)`` (another summation
    order); at most 1 when the two agree to one rounding."""
    from repro_torch.testing import ulp
    kf, tf = k.double(), t.double()
    rule = ulp(torch.maximum(kf.abs(), tf.abs()), k.dtype) \
        + FA_TOL[torch.float32] * (1.0 + tf.abs())
    return float(((kf - tf).abs() / rule).max())


def close_case(name, ker, twin, tol, **extra):
    """A kernel against its twin on the same inputs, compared in f32 at
    ``atol = rtol = tol``, and bit-equal from run to run; ``extra`` goes
    into the record."""
    k = ker()
    again = ker()
    torch.cuda.synchronize()
    t = twin()
    check(k.shape == t.shape and k.dtype == t.dtype,
          f"{name}: {tuple(k.shape)} {k.dtype} against the twin's "
          f"{tuple(t.shape)} {t.dtype}")
    err = (k.float() - t.float()).abs()
    over = float((err - tol * (1.0 + t.float().abs())).max())
    check(over <= 0.0, f"{name}: off its twin by {float(err.max())} "
          f"(tolerance {tol})")
    ratio = half_rule(k, t) if k.dtype != torch.float32 else None
    check(ratio is None or ratio <= 1.0,
          f"{name}: off its twin by {ratio} x one rounding")
    check(torch.equal(k, again), f"{name}: differs from run to run")
    rec = dict(case=name, shape=list(k.shape), dtype=dtype_name(k.dtype),
               max_abs_err=float(err.max()), tol=tol,
               max_err_over_one_rounding=ratio, **extra)
    emit({"kernel_vs_twin": rec})
    return rec


def attention_cases(fa):
    """K9 against its twin at each dtype, shape and mask, and in f32 at the
    attention path's shapes, each on the route the wrapper picks (f16/bf16
    on wgmma, f32 on SIMT), checked by the route's launch counter."""
    cases = [(dt, shape, causal) for dt in FA_TOL for shape in FA_SHAPES
             for causal in (True, False)]
    cases += [(torch.float32, shape[:5], shape[5])
              for shape in ATTENTION_MODELS.values()]
    # mixed operand dtypes and head dims past 128: the SIMT route
    f32, f16, bf16 = torch.float32, torch.float16, torch.bfloat16
    cases += [((bf16, f32, f16), (1, 4, 2, 200, 64), True),
              ((f32, bf16, bf16), (1, 4, 2, 200, 128), False),
              ((f16, f16, f32), (2, 8, 2, 127, 40), True),
              (f32, (1, 4, 2, 200, 160), True),
              (bf16, (1, 4, 2, 200, 256), False),
              (f16, (1, 4, 4, 130, 160), True)]
    recs = []
    for dt, (b, h, hkv, s, d), causal in cases:
        dts = dt if isinstance(dt, tuple) else (dt,) * 3
        q = gaussian((b, h, s, d), s + d, dts[0])
        k = gaussian((b, hkv, s, d), s + d + 1, dts[1])
        v = gaussian((b, hkv, s, d), s + d + 2, dts[2])
        dt = dts[0]
        route = fa.route(q, k, v)
        simt = dt == torch.float32 or len(set(dts)) > 1 or d > 128
        check(route == ("simt" if simt else "wgmma"),
              f"flash {dts} D = {d}: route {route}")
        fa.reset_counts()
        recs.append(close_case(
            f"flash_{b}x{h}x{hkv}x{s}x{d}_"
            f"{'causal' if causal else 'full'}_"
            f"{'_'.join(dict.fromkeys(dtype_name(x) for x in dts))}",
            lambda: fa.flash_attention(q, k, v, causal),
            lambda: fa.flash_attention_torch(q, k, v, causal), FA_TOL[dt],
            route=route))
        check(fa.COUNTS[f"{route}_launches"] == fa.COUNTS["kernel_launches"]
              == 2, f"flash {dt} {route}: launches {fa.COUNTS}")
        del q, k, v
    return recs


def attention_path(fa, kernel_mods):
    """The attention of qwen2_7b and whisper_medium's encoder at full
    width, bf16, through ``ops.flash_attention``, with the launch
    counters zeroed just before each and read just after: one launch, on
    the wgmma route; each output is finite, of the query's shape and
    dtype, and within one bf16 rounding of the twin.  Then the kernel's,
    twin's and SDPA's times, SDPA's distance from the twin (it rounds P to
    bf16 once) and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    rec = {}
    for seed, (name, (b, h, hkv, s, d, causal)) in enumerate(
            ATTENTION_MODELS.items()):
        q, k, v = attention_inputs(b, h, hkv, s, d, 100 * seed + 7,
                                   torch.bfloat16)
        ops.flash_attention(q, k, v, causal=causal)     # warm-up
        reset_all(kernel_mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fa.COUNTS["kernel_launches"]
        wgmma = fa.COUNTS["wgmma_launches"]
        twins = sum(m.COUNTS[c] for m in kernel_mods for c in m.COUNTS
                    if "twin" in c)
        check(launches == 1 and wgmma == 1 and twins == 0,
              f"attention {name}: {launches} kernel launches ({wgmma} "
              f"wgmma), {twins} twin calls")
        check(out.shape == q.shape and out.dtype == q.dtype
              and bool(torch.isfinite(out).all()),
              f"attention {name}: output not finite {tuple(q.shape)} bf16")
        twin = fa.flash_attention_torch(q, k, v, causal)
        err = (out.float() - twin.float()).abs()
        ratio = half_rule(out, twin)
        check(ratio <= 1.0, f"attention {name}: off its twin by "
              f"{float(err.max())}, {ratio} x one bf16 rounding")

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)
        lib_out = sdpa()
        lib_diff = float((lib_out.float() - out.float()).abs().max())
        lib_ratio = half_rule(lib_out, twin)
        del twin, lib_out
        nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
        times = timing_row(
            f"{b}x{h}x{hkv}x{s}x{d} {'causal' if causal else 'full'} bf16",
            lambda: fa.flash_attention(q, k, v, causal),
            lambda: fa.flash_attention_torch(q, k, v, causal), sdpa, nbytes,
            attention_ops(b, h, s, d, causal, q.dtype, "wgmma"),
            "flash_attention_wgmma_kernel",
            reps=10, plain_reps=3)
        exps = attention_scores(b, h, s, causal)
        rec[name] = dict(b_h_hkv_s_d=[b, h, hkv, s, d], causal=causal,
                         dtype="bfloat16", route="wgmma", wall_s=wall,
                         kernel_launches=launches, wgmma_launches=wgmma,
                         twin_calls=twins,
                         vs_twin_max_abs_err=float(err.max()),
                         vs_twin_over_one_rounding=ratio,
                         library_vs_kernel_max_abs_diff=lib_diff,
                         library_over_one_rounding=lib_ratio,
                         exps=exps, exp_ms=exps / PEAK_SFU * 1e3, **times)
    emit({"attention_path": rec})
    return rec


def attention_f32_timing(fa):
    """K9's SIMT route at the attention path's widths: f32 operands (the
    kernel's, twin's and SDPA's (f32, TF32 off) times and the bound), and
    mixed operands, a bf16 q over f32 k and v (the mixed-dtype kernel; no
    single library call takes mixed dtypes)."""
    import torch.nn.functional as F
    rec = {}
    for seed, (name, (b, h, hkv, s, d, causal)) in enumerate(
            ATTENTION_MODELS.items()):
        q, k, v = attention_inputs(b, h, hkv, s, d, 100 * seed + 7,
                                   torch.float32)
        check(fa.route(q, k, v) == "simt", f"f32 {name}: not on SIMT")
        mode = 'causal' if causal else 'full'
        rec[name] = timing_row(
            f"{b}x{h}x{hkv}x{s}x{d} {mode} f32",
            lambda: fa.flash_attention(q, k, v, causal),
            lambda: fa.flash_attention_torch(q, k, v, causal),
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True),
            q.element_size() * (2 * q.numel() + 2 * k.numel()),
            attention_ops(b, h, s, d, causal, q.dtype, "simt"),
            "flash_attention_kernel", reps=5, plain_reps=2)
        qm = q.to(torch.bfloat16)
        check(fa.route(qm, k, v) == "simt", f"mixed {name}: not on SIMT")
        rec[f"{name}_mixed"] = timing_row(
            f"{b}x{h}x{hkv}x{s}x{d} {mode} bf16 q, f32 k v",
            lambda: fa.flash_attention(qm, k, v, causal),
            lambda: fa.flash_attention_torch(qm, k, v, causal), None,
            qm.element_size() * 2 * qm.numel() + k.element_size() * 2
            * k.numel(),
            attention_ops(b, h, s, d, causal, torch.float32, "simt"),
            "flash_attention_kernel_any", reps=5, plain_reps=2)
    emit({"attention_f32": rec})
    return rec


def ptxas_by_entry(log: str) -> dict:
    """nvcc's ``-Xptxas -v`` report as ``{kernel: "registers, stack and
    spills"}``, the kernel names demangled by ``c++filt`` where it runs."""
    entries, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1]
            entries[cur] = []
        elif cur is not None and ("registers" in ln or "spill" in ln):
            entries[cur].append(ln.split(":", 1)[-1].strip())
    try:
        names = subprocess.run(["c++filt"], input="\n".join(entries),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) != len(entries):
        names = list(entries)
    return {name.replace("(anonymous namespace)::", "").split("(")[0]:
            "; ".join(v) for name, v in zip(names, entries.values())}


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
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    kernel_mods = (fs, gd, sr, cr, *fmods.values(), fa)

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
        "ptxas": {name: ptxas_by_entry(cuda_build.build_info(name)["log"])
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
    k4 = [reduce_case(cr, name="reduce_main_chunk", e=e_main, w=w_main)]
    # ragged B around a block's 256 rows, odd and even U, U past the 32
    # units staged at a time, each column capacity (8, 10, 16, 32)
    for b, u, c in ((100_003, 11, 10), (1, 11, 10), (255, 11, 10),
                    (257, 32, 32), (CHUNK + 3, 11, 10), (1000, 6, 8),
                    (4099, 33, 17), (513, 12, 16), (700, 64, 32)):
        e_c, w_c = reduce_inputs(b, u, c, b + u + c)
        k4.append(reduce_case(cr, name=f"reduce_{b}x{u}x{c}", e=e_c, w=w_c))
    e_off = torch.empty(1000 * 11 + 1, device="cuda")[1:].view(1000, 11)
    e_off.copy_(reduce_inputs(1000, 11, 10, 5)[0])
    k4.append(reduce_case(cr, name="reduce_unaligned_rows", e=e_off,
                          w=w_main))
    fcases = functional_kernel_cases(fmods)
    k9 = attention_cases(fa)

    # ----- 3. the main path at full width: fused ----------------------------
    space = DesignSpace(["edgaze", "rhythmic"], MEGA_GRIDS)
    explore(space, engine="fused", chunk_size=CHUNK, k=3)   # warm-up
    reset_all(kernel_mods)
    res = explore(space, engine="fused", chunk_size=CHUNK, k=3)
    launches = fs.COUNTS["kernel_launches"]
    twin_calls = fs.COUNTS["twin_calls"]
    # folding stays on the device, so only prep and finalize may
    # synchronise, never once per chunk.  The sync debug mode's first use
    # in a process counts one sync more (seen on the card), so a probe
    # runs first and the counts that follow are exact.
    def event_wait():
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
    count_syncs(event_wait)
    wait_counted = count_syncs(event_wait)
    check(wait_counted in (0, 1), f"an event wait counts {wait_counted}")
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
    # progress fires once per dispatch with the host-known points covered;
    # pipeline_depth = 1 makes the host wait on the oldest dispatch's event
    # dispatches - 1 times, a wait that copies no data.  Whether the sync
    # debug mode counts an event wait is probed above, so the count is
    # exact.
    calls = []
    paced = explore(space, engine="fused", chunk_size=CHUNK, k=3,
                    pipeline_depth=1,
                    progress=lambda done, span: calls.append((done, span)))
    check(len(calls) == paced.dispatches == res.dispatches
          and calls[-1] == (MEGA_POINTS, MEGA_POINTS)
          and all(a[0] < b[0] for a, b in zip(calls, calls[1:])),
          f"main path: progress calls {calls}")
    compare_results("paced_vs_main", paced, res)
    paced_syncs = count_syncs(lambda: explore(
        space, engine="fused", chunk_size=CHUNK, k=3, pipeline_depth=1))
    want_syncs = syncs + wait_counted * max(0, res.dispatches - 1)
    check(paced_syncs == want_syncs, f"main path at pipeline_depth=1: "
          f"{paced_syncs} host syncs, want {want_syncs}")
    emit({"main_path": {
        "points": res.n_points, "n_feasible": res.n_feasible,
        "points_per_s": res.points_per_sec, "eval_s": res.eval_s,
        "compile_s": res.compile_s, "wall_s": res.wall_s,
        "dispatches": res.dispatches, "superchunk": res.superchunk,
        "occupancy": res.occupancy, "kernel_launches": launches,
        "twin_calls": twin_calls, "host_syncs": syncs,
        "progress_calls": len(calls), "event_wait_counts_as_sync":
        bool(wait_counted), "host_syncs_at_pipeline_depth_1": paced_syncs,
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
    # the default pipeline_depth of 4 waits on an event after each of the
    # last n_chunks - 4 dispatches
    st_waits = wait_counted * max(0, n_chunks - 4)
    check(st_syncs - st_waits < st_counts["decode"], f"staged: {st_syncs} "
          f"host syncs ({st_waits} event waits) for {st_counts['decode']} "
          f"chunks")
    st_worst = compare_results("staged_vs_fused", st, res)
    emit({"staged_path": {
        "points": st.n_points, "eval_s": st.eval_s,
        "points_per_s": st.points_per_sec, "dispatches": st.dispatches,
        "grid_decode_launches": st_counts["decode"],
        "block_stats_launches": st_counts["stats"],
        "twin_calls": st_counts["twins"], "host_syncs": st_syncs,
        "event_waits_counted": st_waits,
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

    # ----- 8. the attention path: K9 (timed there) --------------------------
    attn = attention_path(fa, kernel_mods)
    attn_f32 = attention_f32_timing(fa)

    # ----- 9. timing at the main paths' shapes ------------------------------
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
    times = {name: timing_row(f"{CHUNK} points", ker, plain, lib, nbytes,
                              nops, f"{name}_kernel")
             for name, (ker, plain, lib, nbytes, nops) in timed.items()}

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
        extra = {}
        if name == "matmul":
            extra = {f"{r}_launches": func["edgaze"]["matmul_route_launches"][r]
                     for r in ("wgmma", "tile", "skinny")}
            extra["probe"] = ftimes["matmul_probe"]
        entries.append(dict(
            name=name, route="cuda", source=src + f"{name}.cu",
            replaces=f"src/repro/kernels/{name}.py:{line}",
            launches=launches_f,
            path="functional (edgaze + fig5 + rhythmic)",
            max_abs_err=max(r["max_abs_err"] for r in fcases[name]),
            power_limit=power, **head, **extra,
            by_shape=ftimes[name]))
    keys = ("shape", "ms", "device_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "bytes", "operations", "half_operations")
    by_shape = [{k: r[k] for k in keys} for r in attn.values()]
    entries.append(dict(
        name="flash_attention", route="cuda",
        source=src + "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:35",
        kernel="flash_attention_wgmma_kernel (f16/bf16: wgmma, TMA)",
        launches=sum(r["wgmma_launches"] for r in attn.values()),
        path="attention",
        max_abs_err=max(r["max_abs_err"] for r in k9
                        if r["route"] == "wgmma"),
        power_limit=power, **by_shape[0], by_shape=by_shape))
    f32_by_shape = [{k: r[k] for k in keys} for r in attn_f32.values()]
    entries.append(dict(
        name="flash_attention_simt", route="cuda",
        source=src + "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:35",
        kernel="flash_attention_kernel (f32: FP32 FMAs); "
               "flash_attention_kernel_any (mixed dtypes, D > 128)",
        launches=0, path="none (f32 operands; checked directly)",
        max_abs_err=max(r["max_abs_err"] for r in k9
                        if r["route"] == "simt"),
        power_limit=power, **f32_by_shape[0], by_shape=f32_by_shape))
    emit({"kernels": entries})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
