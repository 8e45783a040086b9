"""GPU smoke run of the PyTorch/CUDA port (``repro_torch``) on one card.

    python3 chip_smoke.py

Builds the fused-sweep CUDA kernel from ``src/repro_torch/csrc`` at first
use, holds it against its plain-torch twin on the card at the main path's
shapes, drives the port's main path — ``explore()`` over the full-width
``mega_sweep`` space (all 5 Ed-Gaze + 3 Rhythmic variants, 1.26e7 design
points, ``chunk_size=2**18``, ``k=3``) — through the kernel, checks the
result against the twin lane, the int64 index path and the scalar
``estimate_energy`` oracle, times the kernel, and prints its findings as
JSON lines.  The last line is the run's verdict::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Every check raises on failure, so the script exits nonzero and prints no
verdict; it also exits nonzero without a CUDA device or without the
repository's ``src/`` beside it.  It imports nothing of ``jax`` or of the
JAX package ``repro``.  A last ``torch.profiler`` pass over one
main-path sweep reports device time by kernel and the device's busy
share, and writes its chrome trace to ``build/traces/trace_main_path.json``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

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


def profile_main_path(explore, space) -> None:
    """torch.profiler over one main-path sweep: device time by kernel
    name and the device's busy share of the sweep's wall time; writes
    the chrome trace to build/traces/trace_main_path.json."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = Path(__file__).resolve().parent / "build" / "traces"
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = explore(space, engine="fused", chunk_size=CHUNK, k=3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(out / "trace_main_path.json"))
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    by_name, busy, reach = {}, 0.0, None
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        if reach is None or start >= reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({"profile_main_path": {
        "wall_s": wall, "eval_s": res.eval_s, "device_kernels": len(spans),
        "device_busy_s": busy * 1e-6,
        "device_busy_share_of_wall": busy * 1e-6 / wall,
        "device_s_by_kernel": {name[:80]: us * 1e-6 for name, us in top}}})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.batch import build_coeff_compute, interp_tables
    from repro_torch.core.shard_sweep import _prepare_stream
    from repro_torch.explore import DesignSpace, explore
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import fused_sweep as fs

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

    # ----- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    fs.load_kernel_library()
    info = cuda_build.build_info("fused_sweep")
    emit({"build": {"seconds": time.perf_counter() - t0,
                    "ptxas": [ln.strip() for ln in info["log"].splitlines()
                              if "registers" in ln or "spill" in ln]}})

    # ----- 2. kernel vs twin on the card ------------------------------------
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

    # ----- 3. the main path at full width -----------------------------------
    space = DesignSpace(["edgaze", "rhythmic"], MEGA_GRIDS)
    explore(space, engine="fused", chunk_size=CHUNK, k=3)   # warm-up
    fs.reset_counts()
    res = explore(space, engine="fused", chunk_size=CHUNK, k=3)
    launches = fs.COUNTS["kernel_launches"]
    twin_calls = fs.COUNTS["twin_calls"]
    # count the host syncs of an identical sweep (the debug mode slows
    # every op, so not in the timed one): folding stays on the device,
    # so only prep and finalize may synchronise, never once per chunk
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            explore(space, engine="fused", chunk_size=CHUNK, k=3)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
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

    # ----- 4. timing at the main-path shape ---------------------------------
    kw = dict(compute=compute, metric="total_j",
              axis_names=tuple(prep.vgrids[0].names),
              shape=prep.vgrids[0].shape, n_var=n_var, total=prep.total,
              chunk=CHUNK, lmax=prep.lmax, block_points=4096, kk=3)
    row = prep.bank.fused[2]
    start = 2 * n_var + CHUNK
    fs.reset_counts()
    kernel_ms = time_ms(lambda: fs.fused_sweep_block(
        prep.table2, row, start, 0, 3 * n_var, **kw))
    twin_ms = time_ms(lambda: fs.fused_sweep_block_torch(
        prep.table2, row, start, 0, 3 * n_var, **kw), reps=5)
    knots = tuple(len(xs) for xs, _ in interp_tables())
    n_blocks = CHUNK // 4096
    bytes_moved = 4 * (prep.table2.numel() + row.numel()) \
        + n_blocks * (3 * 8 + 8)
    b_ms, b_by, fp, sfu = bound_ms(CHUNK, prep.bank.dims, knots,
                                   bytes_moved)
    profile_main_path(explore, space)          # after the timed loops
    emit({"kernels": [{
        "name": "fused_sweep", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_sweep.cu",
        "replaces": "src/repro/kernels/fused_sweep.py:47",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "max_rel_err": max(r["max_rel_err"] for r in recs),
        "ms": kernel_ms, "plain_ms": twin_ms, "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None, "points": CHUNK, "fp32_ops_per_point": fp,
        "sfu_calls_per_point": sfu, "power_limit": smi[0] if smi else None,
    }]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
