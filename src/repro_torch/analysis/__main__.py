# Port of src/repro/analysis/__main__.py: the same flags and exit codes;
# --list-rules also prints the reference's rules and their port.
"""CLI: ``python -m repro_torch.analysis [paths...]``.

Exits non-zero when any error-severity finding is not in the checked-in
baseline.  ``--write-baseline`` accepts the current findings as the new
baseline; ``--report`` writes a JSON findings report (uploaded as a CI
artifact).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from . import RULE_MAP
from .framework import (DEFAULT_PATHS, all_rules, analyze_paths,
                        load_baseline, norm_path, partition_findings,
                        save_baseline)


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static invariant checker: hot-path purity, "
                    "dispatch pacing, in-place reuse, axis/unit "
                    "consistency.")
    p.add_argument("paths", nargs="*",
                   help="files or directories to analyze (default: the "
                        "repro_torch core/, kernels/, explore/ and serve/ "
                        "packages)")
    p.add_argument("--baseline", default=None,
                   help="baseline file (default: the package's "
                        "baseline.json)")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept all current findings into the baseline "
                        "and exit 0")
    p.add_argument("--fail-on-new", action="store_true",
                   help="exit non-zero on findings not in the baseline "
                        "(this is the default; the flag exists so CI "
                        "invocations are self-documenting)")
    p.add_argument("--no-fail", action="store_true",
                   help="report findings but always exit 0")
    p.add_argument("--report", default=None, metavar="FILE",
                   help="write a JSON findings report to FILE")
    p.add_argument("--rules", default=None,
                   help="comma-separated subset of rules to run")
    p.add_argument("--list-rules", action="store_true",
                   help="list registered rules and the reference's rules "
                        "they port, and exit")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)

    if args.list_rules:
        for name, rule in sorted(all_rules().items()):
            print(f"{name:28s} [{rule.severity}] {rule.description}")
        print("\nreference rule -> port rule:")
        for name, (port, reason) in sorted(RULE_MAP.items()):
            print(f"{name:28s} -> " + (port if port is not None
                                       else f"not applicable: {reason}"))
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]

    paths = args.paths or list(DEFAULT_PATHS)
    findings = analyze_paths(paths, rules=rules)

    if args.write_baseline:
        path = save_baseline(findings, args.baseline)
        print(f"wrote {len(findings)} finding(s) to baseline {path}")
        return 0

    baseline = load_baseline(args.baseline)
    new, baselined = partition_findings(findings, baseline)

    for f in new:
        print(f.render())
    n_files = len({f.path for f in findings})
    print(f"repro_torch.analysis: {len(findings)} finding(s) "
          f"({len(new)} new, {len(baselined)} baselined)"
          + (f" across {n_files} file(s)" if findings else ""))

    if args.report:
        report = {
            "paths": [norm_path(p) for p in paths],
            "counts": {"total": len(findings), "new": len(new),
                       "baselined": len(baselined)},
            "findings": [{
                "rule": f.rule, "severity": f.severity,
                "path": norm_path(f.path), "line": f.line,
                "message": f.message, "fingerprint": f.fingerprint,
                "baselined": f.fingerprint in baseline,
            } for f in findings],
        }
        with open(args.report, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
            fh.write("\n")
        print(f"report written to {args.report}")

    if args.no_fail:
        return 0
    return 1 if any(f.severity == "error" for f in new) else 0


if __name__ == "__main__":
    sys.exit(main())
