#!/usr/bin/env python3
"""A traced run of one cell with its device time charged to the
program's spans (:mod:`portbench.harness.spans`).

    python3 portbench/span_report.py --workload <cell> --seed <n> \\
        --seconds <s> [--out FILE]

Runs ``run.py --trace 1`` in this process, unchanged (its stderr and
its result line come out as they do there), with the cell driver's
``summarize`` also charging the trace's device events to the
``repro_torch.`` spans.  Then prints one more JSON line: the window
(units, seconds, rate), device ms a unit by span and by span and kernel
class, the groups of ``harness/spans.py``'s ``GROUPS`` as
``<group>_ms.<kind>``, their sum against the busy time, and where the
unspanned time sits (by kernel and by the host operation that launched
it).  ``--out`` writes the same line to a file.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402


def _unspanned_detail(charged, events, top: int = 12) -> Dict:
    """Seconds of the unspanned device events by kernel name and by the
    host operations around their launch (the outermost ``portbench.``
    span and the innermost operation, as the idle gaps are labelled)."""
    from portbench.harness import device, spans
    by_kernel: Dict[str, float] = {}
    launches: Dict[int, list] = {}          # thread -> (start, seconds)
    for ev, span, launch in charged:
        if span != spans.UNSPANNED:
            continue
        sec = (ev.end_ns() - ev.start_ns()) * 1e-9
        name = ev.name()[:80]
        by_kernel[name] = by_kernel.get(name, 0.0) + sec
        if launch is not None:
            launches.setdefault(launch.start_thread_id(), []).append(
                (launch.start_ns(), sec))
    ops: Dict[int, list] = {}
    for ev in events:
        if ev.device_type() == spans.DeviceType.CPU and \
                not ev.name().startswith(spans.RUNTIME):
            ops.setdefault(ev.start_thread_id(), []).append(
                (ev.start_ns(), ev.end_ns(), ev.name()))
    by_op: Dict[str, float] = {}
    for tid, rows in launches.items():
        stacks = spans.sweep(ops.get(tid, []),
                             [(t, n) for n, (t, _) in enumerate(rows)])
        for n, stack in stacks.items():
            outer = next((name for name in stack
                          if name.startswith(device.SPAN_PREFIX)), None)
            parts = [p for p in (outer, stack[-1] if stack else None) if p]
            label = " > ".join(dict.fromkeys(parts)) or "no operation"
            by_op[label] = by_op.get(label, 0.0) + rows[n][1]

    def rows_of(d):
        return sorted(([k, v] for k, v in d.items()),
                      key=lambda r: -r[1])[:top]
    return {"by_kernel_s": rows_of(by_kernel), "by_host_op_s": rows_of(by_op)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.prepare_process()
    from portbench.harness import device, manifest as mf, spans
    cell = mf.load_cell(mf.load_manifest(run.ROOT), args.workload)
    drv = mf.driver(cell.kind)
    seen: Dict = {}

    def summarize(prof, window_s, *a, **kw):
        out = device.summarize(prof, window_s, *a, **kw)
        events = list(device._events(prof))
        charged = spans.charge(events)
        out.update(spans.tally(charged))
        seen["unspanned"] = _unspanned_detail(charged, events)
        seen["checks"] = {
            # annotation rows that summarize would count as device time
            "span_rows_as_activity": sum(
                1 for ev in events if ev.device_type() == spans.DeviceType.CUDA
                and ev.name().startswith(spans.PREFIX)
                and device._activity(ev) != "gpu_user_annotation"),
            "device_events_without_launch": sum(
                1 for _, _, launch in charged if launch is None),
            "program_spans": sum(1 for ev in events
                                 if ev.device_type() == spans.DeviceType.CPU
                                 and ev.name().startswith(spans.PREFIX)),
        }
        seen["summary"] = out
        return out

    def window(st, seconds, trace):
        win = original(st, seconds, trace)
        seen["window"] = win
        return win

    original = drv.window
    with mock.patch.object(drv, "summarize", summarize), \
            mock.patch.object(drv, "window", window):
        rc = run.main(["--workload", args.workload, "--seed",
                       str(args.seed), "--seconds", str(args.seconds),
                       "--trace", "1"])
    if rc != 0 or "summary" not in seen:
        return rc or 1
    win, prof = seen["window"], seen["summary"]
    n = win.units
    report = {
        "workload": args.workload, "seed": args.seed, "card": device.card(),
        "units": n, "window_s": win.seconds, "e2e": win.e2e,
        "busy_ms": 1e3 * prof["busy_s"] / n,
        "device_ms": 1e3 * prof["device_s"] / n,
        "by_span_ms": {k: 1e3 * v / n for k, v in
                       sorted(prof["by_span_s"].items(),
                              key=lambda kv: -kv[1])},
        "by_span_events": {k: v / n for k, v in
                           prof["by_span_events"].items()},
        "by_span_class_ms": {k: {c: 1e3 * s / n for c, s in row.items()}
                             for k, row in prof["by_span_class_s"].items()},
        "groups_ms": {f"{g}_ms.{cell.kind}": spans.device_ms(prof, n, names)
                      for g, names in spans.GROUPS[cell.kind].items()},
        "spans_ms": {k: sum(v) / len(v) for k, v in win.spans.items()},
        "unspanned": seen["unspanned"],
        "checks": seen["checks"],
    }
    report["groups_sum_ms"] = sum(v for v in report["groups_ms"].values()
                                  if v is not None)
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
