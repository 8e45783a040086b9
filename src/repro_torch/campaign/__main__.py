# Port of src/repro/campaign/__main__.py under the port's module name.
"""CLI for campaign-directory maintenance.

Retention::

    python -m repro_torch.campaign --gc <root> --keep-days 14
    python -m repro_torch.campaign --gc <root> --keep-days 0 --dry-run
    python -m repro_torch.campaign --gc <root> --keep-days 7 --force

Completed campaign directories older than ``--keep-days`` are removed;
directories with missing index ranges (resumable work) or unreadable
manifests are refused unless ``--force``.  ``--dry-run`` reports what
would be pruned without deleting anything.
"""
from __future__ import annotations

import argparse
import sys

from .gc import gc_campaigns


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.campaign",
        description="Campaign directory maintenance (retention GC).")
    parser.add_argument(
        "--gc", metavar="ROOT", required=True,
        help="directory whose child campaign dirs should be swept "
             "(a campaign dir itself also works)")
    parser.add_argument(
        "--keep-days", type=float, required=True, metavar="N",
        help="retention window: completed campaign dirs older than N "
             "days are pruned")
    parser.add_argument(
        "--force", action="store_true",
        help="also prune stale INCOMPLETE/corrupt dirs (destroys "
             "resumable work)")
    parser.add_argument(
        "--dry-run", action="store_true",
        help="report what would be pruned without deleting")
    args = parser.parse_args(argv)

    report = gc_campaigns(args.gc, keep_days=args.keep_days,
                          force=args.force, dry_run=args.dry_run)
    verb = "would prune" if args.dry_run else "pruned"
    for st in report["pruned"]:
        print(f"{verb} {st['path']} ({st['state']}, "
              f"{st['age_days']:.1f}d old)")
    for st in report["kept"]:
        print(f"kept {st['path']} ({st['state']}, "
              f"{st['age_days']:.1f}d old, within retention)")
    for st in report["refused"]:
        detail = (f"{len(st['missing'])} missing range(s)"
                  if st["state"] == "incomplete"
                  else st.get("error", "unreadable manifest"))
        print(f"refused {st['path']} ({st['state']}: {detail}; "
              f"re-run with --force to delete resumable work)")
    print(f"{verb}: {len(report['pruned'])}  kept: "
          f"{len(report['kept'])}  refused: {len(report['refused'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
