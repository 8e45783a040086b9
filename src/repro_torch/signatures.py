# Copy of src/repro/signatures.py on the port's lowering and plan bank.
"""Canonical content signatures shared by campaigns and the serve layer.

A sweep's identity has two independent halves:

* :func:`space_signature` — WHAT is being swept: the resolved
  :class:`~repro_torch.explore.space.DesignSpace` (ordered ``(algorithm,
  variant)`` slots, ``soc_node``, grid shape, exact per-axis value
  lists).  Two spaces with equal signatures map every flat stream index
  to the same design point.
* :func:`bank_signature` — HOW coefficients are packed: the
  :class:`~repro_torch.core.plan_bank.PlanBank` dims + fused column layout.
  Results are only mergeable/cacheable across runs that agree on it.

Campaign manifests (:mod:`repro_torch.campaign.manifest`) persist both
to refuse resuming a checkpoint against a drifted space or bank.  The
payloads are the reference's, so for the same space both signatures equal
the reference's character for character and a manifest names the same
campaign in both packages.  :func:`canonical_json` /
:func:`payload_checksum` (re-exported from :mod:`repro_torch.ckpt`) are the canonical-JSON helpers the
signatures are built on — use them for any new content-addressed key.
"""
from __future__ import annotations

from .ckpt import canonical_json, payload_checksum

__all__ = ["bank_signature", "canonical_json", "payload_checksum",
           "space_signature"]


def space_signature(space) -> str:
    """sha256 over the RESOLVED design space.

    Covers the ordered ``(algorithm, variant)`` slots, ``soc_node``, the
    grid shape and every resolved axis value list (mem_tech names already
    coded) — everything that determines which design point a flat stream
    index decodes to.
    """
    payload = {
        "algorithms": list(space.algorithms),
        "soc_node": int(space.soc_node),
        "variants": [list(lv) for lv in space.variant_labels],
        "shape": list(space.shape),
        "axes": {ax: [float(v) for v in vals]
                 for ax, vals in sorted(space._ngrids.items())},
    }
    return payload_checksum(payload)


def bank_signature(space) -> str:
    """sha256 over the PlanBank dims + fused column layout.

    Shard results are only mergeable with a bank that packs coefficients
    into the same ``(V, W)`` columns; any layout drift (new axis column,
    different unit padding) must refuse to resume even when the design
    space itself is unchanged.
    """
    from .core.grid import lower_variant
    from .core.plan_bank import bank_layout, build_plan_bank
    plans = [lower_variant(algo, variant, soc_node=space.soc_node)
             for algo, variant in space.variant_labels]
    bank = build_plan_bank(plans, device="cpu")    # host arithmetic only
    layout = bank_layout(bank.dims)
    payload = {
        "dims": {f: int(getattr(bank.dims, f))
                 for f in bank.dims._fields},
        "layout": {name: [int(off), [int(s) for s in shape]]
                   for name, (off, shape) in sorted(layout.items())},
    }
    return payload_checksum(payload)
