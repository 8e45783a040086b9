# Verbatim copy of src/repro/campaign/gc.py (loads no jax).
"""Campaign directory retention: prune completed/stale campaign dirs.

``python -m repro.campaign --gc <root> --keep-days N`` scans the direct
children of ``<root>`` for campaign directories (anything holding a
``manifest.json``), classifies each one, and removes those older than
the retention window:

* **complete** — every planned index range has a checkpointed shard:
  pruned once older than ``keep_days`` (the merged result lives in the
  caller's hands / report.json; the directory is pure cache).
* **incomplete** — missing ranges remain (a killed or quarantine-heavy
  campaign): REFUSED by default, even when stale — deleting it destroys
  resumable work.  ``--force`` overrides.
* **corrupt** — unreadable manifest: refused unless ``--force`` (it may
  be a transient write race or a foreign directory).

Age is the newest mtime under the directory (a resumed campaign that
just checkpointed a shard is young, however old its manifest), so an
actively-running campaign is never swept mid-flight.
"""
from __future__ import annotations

import os
import shutil
import time
from typing import Dict, List, Optional

from .manifest import (MANIFEST_NAME, CampaignManifest, completed_shards,
                       missing_ranges)


def _newest_mtime(directory: str) -> float:
    newest = os.path.getmtime(directory)
    for root, _dirs, files in os.walk(directory):
        for name in files:
            try:
                newest = max(newest,
                             os.path.getmtime(os.path.join(root, name)))
            except OSError:
                continue
    return newest


def campaign_status(directory: str, *,
                    now: Optional[float] = None) -> Dict:
    """Classify one campaign directory for retention decisions.

    Returns ``{"path", "state", "age_days", "n_planned", "n_done",
    "missing"}`` where ``state`` is ``"complete"`` / ``"incomplete"`` /
    ``"corrupt"``.
    """
    now = time.time() if now is None else now
    age_days = max(0.0, (now - _newest_mtime(directory)) / 86400.0)
    try:
        manifest = CampaignManifest.load(directory)
    except Exception as exc:  # noqa: BLE001 - classified, not propagated
        return {"path": directory, "state": "corrupt",
                "age_days": age_days, "n_planned": None, "n_done": None,
                "missing": None, "error": f"{type(exc).__name__}: {exc}"}
    done = sorted(completed_shards(directory))
    missing = missing_ranges(manifest.shards, done)
    return {"path": directory,
            "state": "incomplete" if missing else "complete",
            "age_days": age_days, "n_planned": len(manifest.shards),
            "n_done": len(done),
            "missing": [[lo, hi] for lo, hi in missing]}


def find_campaign_dirs(root: str) -> List[str]:
    """Direct children of ``root`` holding a ``manifest.json`` (plus
    ``root`` itself, if it is a campaign directory)."""
    out = []
    if os.path.isfile(os.path.join(root, MANIFEST_NAME)):
        out.append(root)
    if os.path.isdir(root):
        for name in sorted(os.listdir(root)):
            d = os.path.join(root, name)
            if os.path.isdir(d) and os.path.isfile(
                    os.path.join(d, MANIFEST_NAME)):
                out.append(d)
    return out


def gc_campaigns(root: str, *, keep_days: float, force: bool = False,
                 dry_run: bool = False,
                 now: Optional[float] = None) -> Dict:
    """Prune stale campaign directories under ``root``.

    A directory is pruned when it is older than ``keep_days`` AND
    complete (or ``force`` is set — which also sweeps incomplete and
    corrupt directories).  Young directories are always kept.  Returns
    ``{"pruned": [...], "kept": [...], "refused": [...]}`` of status
    dicts; with ``dry_run`` nothing is deleted and ``pruned`` lists
    what WOULD go.
    """
    if keep_days < 0:
        raise ValueError(f"keep_days must be >= 0, got {keep_days}")
    pruned: List[Dict] = []
    kept: List[Dict] = []
    refused: List[Dict] = []
    for directory in find_campaign_dirs(root):
        status = campaign_status(directory, now=now)
        if status["age_days"] <= keep_days:
            kept.append(status)
            continue
        if status["state"] != "complete" and not force:
            refused.append(status)
            continue
        if not dry_run:
            shutil.rmtree(directory)
        pruned.append(status)
    return {"pruned": pruned, "kept": kept, "refused": refused}
