"""Architectural exploration: the paper's core promise, as a script (the
port of ``examples/explore_design_space.py``).

Everything goes through ONE front door: declare a ``DesignSpace``
(registered algorithms + axis grids) and call ``explore()`` — it picks
the right engine from the grid size and always returns the same
``ExploreResult`` shape:

1. the paper's own tables (Sec. 6) — ``run_study`` rides the monolithic
   grid engine (K4 ``category_reduce`` on the card) underneath;
2. a full design-space sweep with the coefficient-hook axes:
   ``vdd_scale`` (dynamic energy x vdd^2, static x vdd) and ``adc_bits``
   (Walden-FoM terms re-price by 2^(bits - lowered)) sweep as PlanBank
   columns — no extra step build;
3. the pluggable algorithm registry: a toy pipeline is registered at
   runtime and swept NEXT TO Ed-Gaze in the same call, through one
   streaming step;
4. a streaming mega-sweep: each dispatch launches the fused
   decode->evaluate->reduce megakernel (K1, ``csrc/fused_sweep.cu``)
   once per chunk and folds its O(k) partials on the device: O(k)
   results at any grid size, one step build.  The default grid stays
   smoke-sized (27,648 points); ``MEGA_SWEEP=1`` densifies it to
   43,545,600;
5. fault-tolerant CAMPAIGNS: ``explore(space, checkpoint_dir=...)``
   shards the sweep into checkpointed index ranges, survives a
   mid-campaign kill (deterministic fault injection) and resumes
   dispatching ONLY the missing shards — the merged result is identical
   to the uninterrupted run;
6. PARALLEL campaigns: ``workers=2`` dispatches the same shard plan to
   persistent worker processes (one stream preparation and one step
   build each), checkpoint writes overlapped on a background thread; the
   merged top-k equals the serial path;
7. SERVING: an ``ExploreService`` turns ``explore()`` into a multi-tenant
   request/response surface — two concurrent tenants with distinct
   same-shape spaces coalesce onto ONE shared step, a repeated request
   replays from the TTL+LRU result cache with zero dispatches, and each
   result carries its serving metrics (``result.serve``).  The two
   tenants are released together through a ``threading.Barrier`` and
   the service gathers up to two requests a window, so the group of two
   does not hang on a short window under load; the replay is served as
   the service closes.

Also shows the energy model on the dry-run records, if present: a JSON
written by ``python -m repro_torch.launch.dryrun`` at
``benchmarks/results/dryrun.json`` (or ``--dryrun-json``).

Runs on the CUDA device unless ``--device cpu`` is given (the kernels'
plain-torch twins).

Run:  PYTHONPATH=src python -m repro_torch.examples.explore_design_space
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ..campaign import (CampaignOptions, FaultSchedule, KillCampaign,
                        TransientFault, resume)
from ..core.axes import AXES
from ..core.batch import OUT_KEYS
from ..core.shard_sweep import stream_cache_info
from ..core.usecases import run_study
from ..core.usecases.toy import TOY_VARIANTS, build_toy
from ..explore import DesignSpace, explore, register_algorithm
from ..kernels.runtime import resolve_device
from ..serve import ExploreService

TECH_NAMES = {-1: "decl", 0: "sram", 1: "sram_hp", 2: "stt"}

#: where the reference's script looks for the dry-run records
DRYRUN_JSON = (Path(__file__).resolve().parents[3] / "benchmarks"
               / "results" / "dryrun.json")


def sec6_tables(device) -> None:
    print("=== Ed-Gaze design space (Sec. 6) ===")
    print(f"{'node':>6} {'variant':<14} {'total uJ':>10} {'MEM-D uJ':>10} "
          f"{'mW/mm^2':>9}")
    for r in run_study("edgaze", device=device):
        print(f"{r['cis_node']:>5}n {r['variant']:<14} "
              f"{r['total_uj']:>10.1f} "
              f"{r['breakdown_uj'].get('MEM-D', 0):>10.1f} "
              f"{r['density_mw_mm2']:>9.3f}")

    print("\n=== Rhythmic Pixel Regions ===")
    for r in run_study("rhythmic", device=device):
        print(f"{r['cis_node']:>5}n {r['variant']:<14} "
              f"{r['total_uj']:>10.1f}")


def hook_axes(device):
    """The full sweep with the coefficient-hook knobs (vdd, ADC bits)."""
    space = DesignSpace(["edgaze"], {
        "cis_node": [130, 110, 90, 65, 45, 32, 28],
        "frame_rate": [15.0, 30.0, 60.0, 120.0],
        "sys_rows": [8.0, 16.0, 32.0],
        "mem_tech": ["sram_hp", "stt"],
        "active_fraction_scale": [0.25, 1.0],
        "vdd_scale": [0.8, 1.0],
        "adc_bits": [-1.0, 8.0]})
    res = explore(space, k=5, device=device)
    print(f"\n=== explore(): {res.n_points} Ed-Gaze points "
          f"({res.engine} engine) in {res.eval_s:.3f}s warm "
          f"(+{res.compile_s:.2f}s compile, {res.n_feasible} feasible) ===")
    print(f"{'variant':<12} {'node':>5} {'fps':>5} {'mem':>7} {'vdd':>5} "
          f"{'adc':>5} {'uJ/frame':>9} {'mW/mm^2':>8}")
    for row in res.best():
        adc = "decl" if row["adc_bits"] < 0 else f"{row['adc_bits']:.0f}b"
        print(f"{row['variant']:<12} {int(row['cis_node']):>4}n "
              f"{row['frame_rate']:>5.0f} "
              f"{TECH_NAMES[int(row['mem_tech'])]:>7} "
              f"{row['vdd_scale']:>5.2f} {adc:>5} "
              f"{row['total_j']*1e6:>9.2f} {row['density_mw_mm2']:>8.3f}")
    # the flat-index codec reproduces any scored point declaratively
    flat = space.encode(**{k: v for k, v in res.best(1)[0].items()
                           if k in ("algorithm", "variant")
                           or k in space.resolved_grid(0).names})
    print(f"best point = flat stream index {flat}; "
          f"decode round-trips: {space.decode(flat)['variant']}")
    return res


def registry_demo(device):
    """A NEW pipeline is one register call (``overwrite``: the script may
    run more than once in a process)."""
    register_algorithm("toy", build_toy, TOY_VARIANTS, overwrite=True)
    duo = explore(DesignSpace(["edgaze", "toy"],
                              {"cis_node": [130.0, 65.0, 28.0],
                               "frame_rate": [15.0, 30.0, 60.0],
                               "adc_bits": [-1.0, 6.0, 10.0]}),
                  engine="fused", chunk_size=32, k=4, device=device)
    print(f"\n=== Registry demo: Ed-Gaze + registered 'toy' pipeline in "
          f"ONE call ({duo.n_variants} variants, "
          f"{stream_cache_info()['step_builds']} step build) ===")
    for algo, rec in sorted(duo.best_by_algorithm().items()):
        s = rec["summary"]
        print(f"{algo:<9} best {rec['variant']:<8} "
              f"{s['metric_min']*1e6:>8.2f} uJ/frame "
              f"({rec['n_feasible']} feasible)")
    return duo


def mega_space(mega: bool) -> DesignSpace:
    """The mega-sweep's space: 27,648 points, or 43,545,600 with
    ``mega``."""
    return DesignSpace(["edgaze", "rhythmic"], {
        "cis_node": list(np.linspace(28, 130, 18 if mega else 6)),
        "soc_node": [14.0, 22.0, 28.0] if mega else [22.0],
        "frame_rate": list(np.linspace(15, 120, 8 if mega else 4)),
        "sys_rows": [4.0, 8.0, 16.0, 32.0, 64.0, 128.0]
        if mega else [8.0, 32.0],
        "sys_cols": [4.0, 8.0, 16.0, 32.0, 64.0] if mega else [8.0, 32.0],
        "mem_tech": ["sram", "sram_hp", "stt"],
        "active_fraction_scale": list(np.linspace(0.1, 1.0, 5))
        if mega else [0.25, 1.0],
        "pixel_pitch_um": list(np.linspace(2.0, 6.0, 7 if mega else 3)),
        "vdd_scale": [0.8, 0.9, 1.0, 1.1] if mega else [0.9, 1.0]})


def mega_chunk(mega: bool) -> int:
    return 1 << 17 if mega else 1 << 14


def mega_sweep(device, mega: bool):
    """One call, one step build, O(1) dispatches: all 8 Ed-Gaze +
    Rhythmic variants ride a shared PlanBank; each dispatch launches the
    fused megakernel once per chunk of its ``superchunk`` and folds the
    block partials on the device.  ``backend`` picks the megakernel lane:
    ``"cuda"`` (the CUDA kernel), ``"torch"`` (its plain-torch twin) or
    ``"auto"`` (``cuda`` on a CUDA device, ``torch`` on the CPU);
    ``REPRO_TORCH_SWEEP_BACKEND`` overrides ``auto``."""
    s = explore(mega_space(mega), engine="fused", backend="auto",
                chunk_size=mega_chunk(mega), k=6, device=device)
    print(f"\n=== Streaming mega-sweep: {s.n_points:,} points x "
          f"{s.n_variants} variants over {s.n_devices} device(s) ===")
    print(f"backend {s.backend} (kernel_mode="
          f"{s.stream_result.kernel_mode}), {s.dispatches} dispatch(es)")
    print(f"compile {s.compile_s:.1f}s ONCE "
          f"({s.cache['stream']['step_builds']} step builds cached) vs "
          f"eval {s.eval_s:.1f}s warm -> {s.points_per_sec:,.0f} points/s")
    # dispatch + memory audit: the staged pipeline dispatches once per
    # chunk and round-trips the decoded (n_axes, B) point matrix, the
    # variant ids and the B x n_out output table through device memory;
    # the fused megakernel only ever writes its O(k) block partials
    n_axes, n_out = len(AXES), len(OUT_KEYS)
    # staged chunks align to variant boundaries: ceil(n_var/chunk) each
    n_var = s.n_points // s.n_variants
    chunks = s.n_variants * -(-n_var // s.chunk_size)
    staged_bpp = 4 * (n_axes + 1 + n_out)
    fused_bpp = 4 * (2 * s.k + 4) * s.n_devices / s.chunk_size
    print(f"dispatches/sweep: {chunks} staged -> {s.dispatches} fused "
          f"(superchunk={s.superchunk}, occupancy {s.occupancy:.3f})")
    print(f"HBM traffic:      ~{staged_bpp} B/point staged -> "
          f"~{fused_bpp:.4f} B/point fused (candidates + scalars only)")
    for algo, rec in sorted(s.best_by_algorithm().items()):
        p = rec["summary"]["argmin_point"]
        if p is None:                      # no feasible point at all
            print(f"{algo:<9} no feasible design in this grid")
            continue
        print(f"{algo:<9} best {rec['variant']:<12} "
              f"{int(p['cis_node']):>4}n {p['frame_rate']:>5.0f}fps "
              f"{int(p['sys_rows'])}x{int(p['sys_cols'])} "
              f"vdd={p['vdd_scale']:.2f} -> "
              f"{rec['summary']['metric_min']*1e6:.2f} uJ/frame "
              f"({rec['n_feasible']:,} feasible)")
    return s


CAMP_GRIDS = {"cis_node": [130.0, 65.0, 28.0],
              "frame_rate": [15.0, 30.0, 60.0],
              "active_fraction_scale": [0.25, 1.0],
              "vdd_scale": [0.9, 1.0]}


def campaigns(device):
    """Checkpoint, kill, resume; then the same shard plan on two worker
    processes.  ``explore(checkpoint_dir=)`` plans index-range shards,
    checkpoints each completed shard's O(k+V) StreamResult (atomic +
    checksummed) and classifies failures: transient -> retry with
    backoff, OOM -> split the shard, deterministic -> quarantine +
    partial report.  A killed campaign resumes from its manifest,
    re-dispatching only what's missing; signatures refuse a changed
    space or bank layout.  Stale campaign directories are reclaimed with
    ``python -m repro_torch.campaign --gc ROOT --keep-days 30``."""
    camp_space = DesignSpace(["edgaze"], CAMP_GRIDS)
    straight = explore(camp_space, engine="fused", chunk_size=16, k=4,
                       device=device)
    camp_dir = tempfile.mkdtemp(prefix="campaign_demo_")
    # deterministic drill: one injected transient flake on the first
    # shard (retried), then a simulated SIGKILL after 2 completed shards
    faults = FaultSchedule({(0, 1): TransientFault("injected flake")},
                           kill_after=2)
    try:
        explore(camp_space, engine="fused", chunk_size=16, k=4,
                checkpoint_dir=camp_dir, device=device,
                campaign=CampaignOptions(shard_points=36, faults=faults,
                                         sleep=lambda _s: None))
        raise AssertionError("kill was scheduled but never fired")
    except KillCampaign:
        print(f"\n=== Campaign killed mid-run (2 shards checkpointed in "
              f"{camp_dir}) ===")
    resumed = resume(camp_dir, device=device)  # space from the manifest
    rep = resumed.campaign
    print(f"resume: {rep['n_loaded']} shards loaded from checkpoints, "
          f"{rep['n_executed']} dispatched, "
          f"{rep['n_retries']} retries, partial={rep['partial']}")
    match = [(r['variant'], r['index']) for r in resumed.topk] == \
            [(r['variant'], r['index']) for r in straight.topk]
    print(f"kill-and-resume top-{straight.k} identical to uninterrupted "
          f"run: {match}")
    assert match and not rep["partial"]
    shutil.rmtree(camp_dir, ignore_errors=True)

    # workers=N (or REPRO_CAMPAIGN_WORKERS=N) dispatches shard ranges to N
    # persistent spawn-context worker processes, each with its own stream
    # preparation and step; the parent folds StreamResults in arrival
    # order (the merge is associative) while a bounded background writer
    # thread checkpoints completed shards.  A worker death is a transient
    # failure of its in-flight shard: retried, never a campaign abort.
    par_dir = tempfile.mkdtemp(prefix="campaign_par_")
    par = explore(camp_space, engine="fused", chunk_size=16, k=4,
                  checkpoint_dir=par_dir, workers=2, device=device,
                  campaign=CampaignOptions(shard_points=36))
    rep = par.campaign
    builds = sorted(c["step_builds"]
                    for c in rep["worker_counters"].values())
    print(f"\n=== Parallel campaign: {rep['n_executed']} shards over "
          f"{rep['workers']} workers ===")
    print(f"per-worker stream preps {rep['worker_preps']} and step builds "
          f"{builds} (ONE each), checkpoint I/O "
          f"{rep['io_overlap_frac']:.0%} overlapped, worker spin-up "
          f"{rep['worker_startup_s']:.1f}s")
    match = [(r['variant'], r['index']) for r in par.topk] == \
            [(r['variant'], r['index']) for r in straight.topk]
    print(f"workers=2 top-{straight.k} identical to the serial sweep: "
          f"{match}")
    assert match and set(rep["worker_preps"]) == {1} and set(builds) == {1}
    shutil.rmtree(par_dir, ignore_errors=True)
    return straight, resumed, par


def tenant_space(vdd_lo):
    return DesignSpace(["edgaze"], {
        "cis_node": [130, 65, 28],
        "frame_rate": [30, 60, 120],
        "vdd_scale": [vdd_lo, 1.0]})


def serving(device):
    """Multi-tenant explore() through one service: ``explore(space,
    service=svc)`` is a drop-in routed call; concurrent tenants whose
    spaces resolve to the same dispatch shapes ride ONE shared step
    (different axis VALUES are fine: they are device inputs), and a
    repeat of an answered request never dispatches at all."""
    builds_before = stream_cache_info()["step_builds"]
    # the two tenants arrive together (a barrier releases them) and the
    # service takes up to two requests a window: one group of two
    # whatever the load; the replay, alone, is served as the service
    # closes (close drains the queue)
    with ExploreService(coalesce_window_s=60.0, max_batch=2,
                        device=device) as svc:
        served = {}
        barrier = threading.Barrier(2)

        def tenant(name, vdd_lo):
            barrier.wait(timeout=120)
            served[name] = explore(tenant_space(vdd_lo), k=3,
                                   engine="fused", chunk_size=8,
                                   service=svc)

        threads = [threading.Thread(target=tenant, args=("low", 0.80)),
                   threading.Thread(target=tenant, args=("high", 0.95))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        replay_handle = svc.submit(tenant_space(0.80), k=3, engine="fused",
                                   chunk_size=8)
    replay = replay_handle.result()
    metrics = svc.metrics()

    print("\n=== Exploration service: two coalesced tenants ===")
    for name in ("low", "high"):
        res = served[name]
        s = res.serve
        print(f"tenant {name:<5} best {res.metric}="
              f"{res.topk[0][res.metric]:.3e}  group="
              f"{s['coalesce_group']} dispatches={s['dispatches']} "
              f"share={s['dispatch_share']:.2f} "
              f"wait={s['queue_wait_s']*1e3:.0f}ms")
    new_builds = stream_cache_info()["step_builds"] - builds_before
    print(f"new step builds for both tenants: {new_builds}")
    print(f"replayed request: cache_hit={replay.serve['cache_hit']} "
          f"dispatches={replay.serve['dispatches']}")
    print(f"service counters: completed={metrics['completed']} "
          f"coalesced_groups={metrics['coalesced_groups']} "
          f"cache_hits={metrics['cache']['hits']}")
    assert served["low"].serve["coalesce_group"] == 2
    assert replay.serve["cache_hit"] \
        and replay.serve["dispatches"] == 0
    assert new_builds <= 1     # one shared build (0 if already built)
    return served, replay


def dryrun_bridge(path: Path) -> Optional[Dict]:
    """The energy model on the dry-run records of ``python -m
    repro_torch.launch.dryrun``, when they are present."""
    if not path.exists():
        return None
    print("\n=== Energy model: per-step energy of the traced "
          "training/serving steps (256 ranks) ===")
    with open(path) as f:
        results = json.load(f)
    print(f"{'cell':<42} {'E/step J':>9} {'dominant':>9}")
    for key, rec in sorted(results.items()):
        if rec.get("status") == "ok" and "energy" in rec:
            e = rec["energy"]
            print(f"{key:<42} {e['e_total_j']:>9.2f} "
                  f"{e['dominant']:>9}")
    return results


def run(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """The script's sections in order; returns their results by name."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.explore_design_space")
    ap.add_argument("--device", default="cuda",
                    help="where every sweep runs (default cuda; cpu runs "
                         "the kernels' plain-torch twins)")
    ap.add_argument("--dryrun-json", default=None,
                    help="dry-run records for the energy-model section "
                         f"(default: {DRYRUN_JSON} when present)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mega = bool(int(os.environ.get("MEGA_SWEEP", "0")))

    sec6_tables(device)
    out: Dict[str, object] = {"hook_axes": hook_axes(device)}
    out["registry"] = registry_demo(device)
    out["mega"] = mega_sweep(device, mega)
    out["campaigns"] = campaigns(device)
    out["serving"] = serving(device)
    out["dryrun"] = dryrun_bridge(Path(args.dryrun_json) if args.dryrun_json
                                  else DRYRUN_JSON)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
