#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--window 1] \\
        [--out file.jsonl]

For each of ``--seeds``: the program's numbers (set-up, a short window,
the reference), the lower readings.  For each of ``--control-seeds``:
the numbers of the reference computed in float8 in the program's place
(the control), the upper readings.  For each of ``--fault-seeds``:
the numbers of each planted fault (:mod:`portbench.faults`; training's
are planted in the reference put in the program's place).  Prints one JSON
line a reading and writes them to ``--out``.  The benchmark's own runs
never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.run import ROOT, prepare_process  # noqa: E402


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--window", type=float, default=1.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    prepare_process()
    import torch

    from portbench.harness import manifest as mf
    cell = mf.load_cell(mf.load_manifest(ROOT), args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for rec in readings(cell, torch.device("cuda"), _seeds(args.seeds),
                            _seeds(args.control_seeds),
                            _seeds(args.fault_seeds), args.window):
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


def readings(cell, device, lower, upper, fault_seeds, window):
    """Yields one record a reading (``variant``: ``program``,
    ``control:fp8`` or ``fault:<name>``) with the cell's numbers."""
    from portbench import faults
    from portbench.harness import compare, manifest as mf
    from portbench.reference.lowp import fp8
    drv = mf.driver(cell.kind)

    def rec(seed, variant, numbers, t0):
        return {"cell": cell.name, "seed": seed, "variant": variant,
                "seconds": time.perf_counter() - t0, **numbers}

    def program(seed, fault=None):
        """Set-up and a short window of the program (``fault`` planted),
        its state released; returns the state to judge."""
        with faults.planted(cell.kind, fault) if fault else \
                contextlib.nullcontext():
            st = drv.setup(cell, seed, device)
            drv.window(st, window, False)
        drv.release(st)
        return st

    for seed in sorted(set(lower) | set(upper), key=(lower + upper).index):
        t0 = time.perf_counter()
        st = program(seed)
        if cell.kind == "train":
            ref = drv.reference(st)
            if seed in lower:
                yield rec(seed, "program", {
                    **compare.train_numbers(st.readings, ref),
                    **compare.worst_leaves(st.readings, ref),
                    "loss": st.readings["loss"], "ref_loss": ref["loss"]}, t0)
            if seed in upper:
                yield rec(seed, "control:fp8", compare.train_numbers(
                    drv.reference(st, cast=fp8), ref), t0)
        else:
            if seed in lower:
                yield rec(seed, "program", drv.judge(st), t0)
            if seed in upper:
                yield rec(seed, "control:fp8", drv.judge(st, cast=fp8), t0)
    for seed in fault_seeds:
        t0 = time.perf_counter()
        if cell.kind == "train":
            st = program(seed)
            ref = drv.reference(st)
            for fault in faults.FAULTS["train"]:
                yield rec(seed, f"fault:{fault}", compare.train_numbers(
                    drv.reference(st, fault=fault), ref), t0)
                t0 = time.perf_counter()
        else:
            for fault in faults.FAULTS["prefill"]:
                yield rec(seed, f"fault:{fault}",
                          drv.judge(program(seed, fault)), t0)
                t0 = time.perf_counter()


if __name__ == "__main__":
    sys.exit(main())
