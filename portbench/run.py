#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

One run is one cell: set-up (the cell's driver builds the program and
warms it up), the measured window of ``--seconds``, the comparison with
the plain reference, and one JSON line last on standard output with
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, last, ``checks``: each number compared with its limit,
also printed as the last lines of standard error.  Without as many CUDA
devices as the cell asks for, or with the JAX reference loaded, it
exits with a code other than 0 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "portbench_cache"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def prepare_process() -> None:
    """Kernel caches inside the checkout, at fixed paths; the checkout's
    ``src`` and the benchmark importable."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def run_cell(manifest, cell, seed: int, seconds: float, trace: bool,
             device, t_start: float):
    """Set-up, window, reference; returns (result, rows) where rows are
    the compared (name, value, limit)."""
    import torch

    from portbench.harness import compare, manifest as mf
    from portbench.harness.readers import Run
    drv = mf.driver(cell.kind)
    st = drv.setup(cell, seed, device, t_start)
    win = drv.window(st, seconds, trace)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    drv.release(st)
    t_judge = time.perf_counter()
    numbers = drv.judge(st)
    print(f"portbench: set-up {st.setup_s:.3f} s, window "
          f"{win.seconds:.3f} s ({win.units} units), reference "
          f"{time.perf_counter() - t_judge:.3f} s", file=sys.stderr,
          flush=True)
    if win.profile is not None:
        print("portbench: device s by kernel class "
              + json.dumps(win.profile["by_class_s"]), file=sys.stderr)
    ok, rows = compare.judge(numbers, cell.limits)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    metrics = {}
    run = Run(cell.arch, cell.traffic, win, kind)
    for m in mf.cell_metrics(manifest, cell.name, trace):
        value = (mf.reader(m["name"]).read(run) if trace
                 else win.e2e[m["name"]])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": bool(ok and win.failed == 0),
              "attempted": win.attempted, "failed": win.failed,
              "metrics": metrics, "device": dev}
    if trace and win.profile is not None:
        dev["busy_s"] = win.profile["busy_s"]
        dev["window_s"] = win.profile["window_s"]
        result["breakdown"] = {"device_ops": win.profile["device_ops"],
                               "idle_gaps": win.profile["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows


def main(argv=None) -> int:
    args = parse(argv)
    prepare_process()
    import torch

    import repro_torch  # noqa: F401  (the program: without it, no run)

    from portbench.harness import device as dv, isolation, manifest as mf
    print(f"portbench: imports {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)
    manifest = mf.load_manifest(ROOT)
    cell = mf.load_cell(manifest, args.workload)
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this process sees {seen}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, rows = run_cell(manifest, cell, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda", 0),
                            T_START)
    print(f"portbench: {args.workload} seed {args.seed} on {dv.card()}",
          file=sys.stderr, flush=True)
    found = isolation.forbidden_loaded()
    if found:
        print(f"portbench: the process holds {found}: no result",
              file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
