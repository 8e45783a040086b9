# Port of src/repro/campaign/manifest.py: a torch fingerprint in place of
# the jax one, the port's DesignSpace, the port's backend names.
"""Campaign manifests: provenance + the deterministic shard plan.

A campaign directory is a durable, resumable artifact::

    <checkpoint_dir>/
      manifest.json            # this module; written once, at start
      shards/
        shard_<lo>_<hi>.json   # one per COMPLETED index range (atomic,
                               # checksummed StreamResult payload)
      quarantine/
        shard_<lo>_<hi>.json   # shards given up on (error + attempts)
      report.json              # last runner invocation's summary

Manifest schema (``"schema": 1``)::

    {
      "schema": 1,
      "created_unix": <float>,          # provenance only
      "git_sha": <str|null>,            # repo HEAD at campaign start
      "torch": {"version", "cuda", "device", "n_devices"},  # the mesh's
                                        # first device, its size
      "space": {                        # enough to REBUILD the DesignSpace
        "algorithms": [...], "soc_node": <int>,
        "grids": {axis: [values...]}    # the user's grids, verbatim
      },
      "space_signature": <sha256>,      # canonical resolved-space hash
      "bank_signature": <sha256>,       # PlanBank dims + column layout
      "sweep": {"k", "metric", "engine", "chunk_size", "superchunk",
                "block_points",
                "backend"},             # per-shard sweep arguments; the
                                        # RESOLVED lane ("cuda" /
                                        # "torch") — resume refuses an
                                        # explicit cross-backend request
                                        # and a manifest of the
                                        # reference ("pallas" / "xla" /
                                        # none)
      "n_points": <int>,                # variant-major flat-space size
      "shards": [{"id", "lo", "hi"}, ...]   # the deterministic plan
    }

``space_signature`` hashes the RESOLVED space — algorithms, soc_node,
ordered variant slots, grid shape and the exact per-axis value lists —
so any change that would re-map flat indices to different design points
refuses to resume.  ``bank_signature`` hashes the PlanBank dims +
``bank_layout`` column map: a code change that re-packs coefficients
(new axis column, different padding) invalidates checkpointed shard
results even when the space looks identical, and must also refuse.

Shard checkpoint files carry ``{"schema", "shard": {id, lo, hi},
"result": <StreamResult payload>, "checksum"}`` where ``checksum`` is
sha256 over the canonical JSON of ``{"shard", "result"}`` — verified on
every resume before a shard is trusted as complete.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import time
from typing import Dict, List, Optional, Tuple

from ..ckpt import (atomic_write_json, payload_checksum, read_json)
# the signature functions live in repro_torch.signatures; re-exported
# here as the reference does
from ..signatures import bank_signature, space_signature  # noqa: F401

MANIFEST_SCHEMA = 1
MANIFEST_NAME = "manifest.json"
SHARD_DIR = "shards"
QUARANTINE_DIR = "quarantine"
REPORT_NAME = "report.json"


class CampaignMismatchError(RuntimeError):
    """Resume refused: the on-disk manifest does not describe the same
    campaign (DesignSpace signature or PlanBank layout changed)."""


class CampaignIntegrityError(RuntimeError):
    """A checkpointed shard failed its checksum verification."""


def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(["git", "rev-parse", "--short=12", "HEAD"],
                             capture_output=True, text=True, timeout=10,
                             cwd=os.path.dirname(__file__))
        return out.stdout.strip() or None
    except Exception:  # noqa: BLE001 - provenance degrades gracefully
        return None


def _torch_fingerprint(mesh) -> Dict:
    """torch and CUDA versions, the name of the campaign mesh's first
    device (``"cpu"`` on the CPU) and the mesh's size, the count of the
    devices the reference's mesh spans."""
    import torch
    device = mesh.devices[0]
    on_cuda = device.type == "cuda"
    return {"version": torch.__version__, "cuda": torch.version.cuda,
            "device": (torch.cuda.get_device_name(device.index)
                       if on_cuda else "cpu"),
            "n_devices": mesh.size}


def _grids_payload(grids: Optional[Dict]) -> Dict:
    """The user's grids dict in JSON form (values -> plain lists)."""
    out = {}
    for ax, vals in (grids or {}).items():
        out[ax] = [v if isinstance(v, str) else float(v)
                   for v in list(vals)]
    return out


def plan_shards(total: int, shard_points: int) -> List[Tuple[int, int]]:
    """Deterministically split ``[0, total)`` into ``index_range`` shards.

    Equal-width leading shards of ``shard_points`` plus one tail; the
    plan is a pure function of ``(total, shard_points)`` so a resumed
    campaign always re-derives the identical shard boundaries.
    """
    total = int(total)
    shard_points = int(shard_points)
    if total < 0:
        raise ValueError(f"total must be >= 0, got {total}")
    if shard_points < 1:
        raise ValueError(f"shard_points must be >= 1, got {shard_points}")
    return [(lo, min(lo + shard_points, total))
            for lo in range(0, total, shard_points)]


@dataclasses.dataclass
class CampaignManifest:
    """The durable identity + plan of one campaign (see module doc)."""
    space_payload: Dict                 # {"algorithms","soc_node","grids"}
    space_sig: str
    bank_sig: str
    sweep: Dict                         # per-shard explore() arguments
    n_points: int
    shards: List[Tuple[int, int]]
    git_sha: Optional[str] = None
    torch: Optional[Dict] = None
    created_unix: float = 0.0

    # ----- construction ---------------------------------------------------
    @classmethod
    def create(cls, space, *, sweep: Dict, shard_points: int,
               mesh) -> "CampaignManifest":
        return cls(
            space_payload={"algorithms": list(space.algorithms),
                           "soc_node": int(space.soc_node),
                           "grids": _grids_payload(space.grids)},
            space_sig=space_signature(space),
            bank_sig=bank_signature(space),
            sweep=dict(sweep), n_points=int(space.n_points),
            shards=plan_shards(space.n_points, shard_points),
            git_sha=_git_sha(), torch=_torch_fingerprint(mesh),
            created_unix=round(time.time(), 2))

    def rebuild_space(self):
        """The DesignSpace this manifest describes (from its payload)."""
        from ..explore import DesignSpace
        sp = self.space_payload
        return DesignSpace(list(sp["algorithms"]),
                           dict(sp["grids"]) or None,
                           soc_node=int(sp["soc_node"]))

    # ----- persistence ----------------------------------------------------
    def to_payload(self) -> Dict:
        return {"schema": MANIFEST_SCHEMA,
                "created_unix": self.created_unix,
                "git_sha": self.git_sha, "torch": self.torch,
                "space": self.space_payload,
                "space_signature": self.space_sig,
                "bank_signature": self.bank_sig,
                "sweep": self.sweep, "n_points": self.n_points,
                "shards": [{"id": i, "lo": lo, "hi": hi}
                           for i, (lo, hi) in enumerate(self.shards)]}

    @classmethod
    def from_payload(cls, payload: Dict) -> "CampaignManifest":
        if payload.get("schema") != MANIFEST_SCHEMA:
            raise CampaignMismatchError(
                f"unsupported manifest schema {payload.get('schema')!r} "
                f"(this build reads schema {MANIFEST_SCHEMA}); the "
                f"campaign was created by an incompatible version — "
                f"re-run it from scratch in a fresh directory")
        return cls(space_payload=dict(payload["space"]),
                   space_sig=payload["space_signature"],
                   bank_sig=payload["bank_signature"],
                   sweep=dict(payload["sweep"]),
                   n_points=int(payload["n_points"]),
                   shards=[(int(s["lo"]), int(s["hi"]))
                           for s in payload["shards"]],
                   git_sha=payload.get("git_sha"),
                   torch=payload.get("torch"),
                   created_unix=payload.get("created_unix", 0.0))

    def save(self, directory: str) -> str:
        return atomic_write_json(os.path.join(directory, MANIFEST_NAME),
                                 self.to_payload())

    @classmethod
    def load(cls, directory_or_path: str) -> "CampaignManifest":
        path = directory_or_path
        if os.path.isdir(path):
            path = os.path.join(path, MANIFEST_NAME)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no campaign manifest at {path}; start one with "
                f"run_campaign(space, checkpoint_dir=...) or "
                f"explore(space, checkpoint_dir=...)")
        return cls.from_payload(read_json(path))

    # ----- verification ---------------------------------------------------
    def verify_space(self, space) -> None:
        """Refuse a space whose resolved signature differs (actionable)."""
        sig = space_signature(space)
        if sig != self.space_sig:
            raise CampaignMismatchError(
                f"DesignSpace signature mismatch: the manifest was "
                f"created for {self.space_sig[:12]}… but the provided "
                f"space resolves to {sig[:12]}… — the flat-index -> "
                f"design-point mapping changed (different algorithms, "
                f"variants, soc_node or axis values), so checkpointed "
                f"shards cannot be reused.  Resume with the original "
                f"space, or start a NEW campaign in a fresh "
                f"checkpoint_dir")

    def verify_bank(self, space) -> None:
        sig = bank_signature(space)
        if sig != self.bank_sig:
            raise CampaignMismatchError(
                f"PlanBank layout mismatch: the manifest records bank "
                f"signature {self.bank_sig[:12]}… but the current code "
                f"packs {sig[:12]}… — coefficient columns moved (new "
                f"axis hook, padding or dims change), so checkpointed "
                f"shard results are not comparable.  Re-run the "
                f"campaign from scratch in a fresh checkpoint_dir")


# ---------------------------------------------------------------------------
# Shard checkpoint files
# ---------------------------------------------------------------------------
def shard_path(directory: str, lo: int, hi: int,
               quarantined: bool = False) -> str:
    sub = QUARANTINE_DIR if quarantined else SHARD_DIR
    return os.path.join(directory, sub, f"shard_{lo:012d}_{hi:012d}.json")


def write_shard(directory: str, lo: int, hi: int, result_payload: Dict,
                *, attempts: int = 1, splits: int = 0) -> str:
    """Atomically checkpoint one completed shard (checksummed).

    Written compact (``indent=None``): both the checksum's canonical
    form and the file body then take json's C-accelerated encoder, and
    the key ORDER of the payload survives the write -> read round trip
    (merge compares variant-label order across shards, so a sorted-key
    on-disk form would make loaded and fresh shards disagree).
    """
    body = {"shard": {"lo": int(lo), "hi": int(hi),
                      "attempts": int(attempts), "splits": int(splits)},
            "result": result_payload}
    payload = {"schema": MANIFEST_SCHEMA,
               "checksum": payload_checksum(body), **body}
    return atomic_write_json(shard_path(directory, lo, hi), payload,
                             indent=None)


def read_shard(path: str) -> Dict:
    """Load + checksum-verify one shard checkpoint file."""
    payload = read_json(path)
    body = {"shard": payload.get("shard"), "result": payload.get("result")}
    expect = payload.get("checksum")
    actual = payload_checksum(body)
    if expect != actual:
        raise CampaignIntegrityError(
            f"shard checkpoint {path} failed checksum verification "
            f"(recorded {str(expect)[:12]}…, recomputed {actual[:12]}…) "
            f"— the file is corrupt or was edited.  Delete it (or "
            f"resume with on_corrupt='redispatch') to re-run that "
            f"index range")
    return payload


def completed_shards(directory: str) -> Dict[Tuple[int, int], str]:
    """``{(lo, hi): path}`` of checkpointed shard files (unverified)."""
    d = os.path.join(directory, SHARD_DIR)
    out: Dict[Tuple[int, int], str] = {}
    if not os.path.isdir(d):
        return out
    for name in sorted(os.listdir(d)):
        if not (name.startswith("shard_") and name.endswith(".json")):
            continue
        stem = name[len("shard_"):-len(".json")]
        try:
            lo_s, hi_s = stem.split("_")
            out[(int(lo_s), int(hi_s))] = os.path.join(d, name)
        except ValueError:
            continue
    return out


def missing_ranges(planned: List[Tuple[int, int]],
                   done: List[Tuple[int, int]]
                   ) -> List[Tuple[int, int]]:
    """Planned index ranges minus the union of completed ranges.

    Completed shards need not match planned boundaries (OOM splits
    checkpoint half-shards), so coverage is interval arithmetic: each
    planned shard is clipped against the sorted union of done ranges
    and the uncovered sub-ranges come back as the re-dispatch queue.
    """
    merged: List[List[int]] = []
    for lo, hi in sorted((int(a), int(b)) for a, b in done):
        if hi <= lo:
            continue
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    out: List[Tuple[int, int]] = []
    for lo, hi in planned:
        cur = int(lo)
        for dlo, dhi in merged:
            if dhi <= cur or dlo >= hi:
                continue
            if dlo > cur:
                out.append((cur, dlo))
            cur = max(cur, dhi)
            if cur >= hi:
                break
        if cur < hi:
            out.append((cur, int(hi)))
    return out
