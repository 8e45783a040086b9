"""Request coalescing: compatible tenants share ONE step.

The port's streaming engine builds its per-sweep step state on SHAPES
only (``repro_torch.core.shard_sweep._step``: the coefficient compute,
K1's plan and fixed launch parameters), keyed on bank dims, grid shape,
chunk geometry, scan length, reduction params, lane and mesh, while
coefficients and axis values are inputs.  Two requests whose shapes
agree therefore share a step no matter how different their design-point
VALUES are.  This module exploits that, as the reference's
``repro.serve.coalesce`` does with its step executable:

* :func:`prepare_request` resolves a request exactly the way
  ``_stream_impl`` would (same chunk rounding and clamping, same
  superchunk default, one hoisted ``_StreamPrep`` on the service's mesh)
  into a
  :class:`PreparedRequest`;
* :func:`compat_key` IS the fused step key of that request, so equal
  compat keys share one step build by construction;
* :func:`run_group` round-robins superchunk-aligned ``index_range``
  segments across a group's members — N tenants interleaved through one
  warm step, each folding its own segments back together with the
  campaign merge algebra (associative, parity-exact) and streaming
  best-so-far snapshots as its segments land;
* :func:`run_solo` is the fallback for a group of one: a single
  full-range dispatch, streaming partials through the ``on_partial``
  hook instead.  Incompatible requests always land here — coalescing is
  an optimization, never an error.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, List, Optional, Tuple

from ..campaign.merge import merge_stream_results
from ..core.shard_sweep import (_DEFAULT_SUPERCHUNK, StreamResult,
                                _chunk_geometry, _fused_key, _prepare_stream,
                                _StreamPrep, _stream_impl)
from ..explore.api import _DEFAULT_CHUNK
from ..launch.mesh import BatchMesh
from .errors import RequestTimeout
from .stream import PartialEmitter

__all__ = ["GroupMember", "PreparedRequest", "compat_key",
           "plan_segments", "prepare_request", "run_group", "run_solo"]


@dataclasses.dataclass
class PreparedRequest:
    """One request resolved to dispatch geometry (see module doc)."""
    space: object                #: the DesignSpace
    k: int
    metric: str
    backend: str                 #: RESOLVED lane ("cuda" / "torch")
    block_points: int
    chunk: int                   #: span-clamped
    s_len: int                   #: chunk ordinals per dispatch
    cpv: int                     #: chunk ordinals per variant
    wide: bool                   #: int64 index lane
    prep: _StreamPrep            #: hoisted lowering/bank/tables

    @property
    def total(self) -> int:
        return self.prep.total


def prepare_request(space, *, k: int, metric: str, backend: str,
                    chunk_size: Optional[int], block_points: int,
                    superchunk: Optional[int],
                    mesh: BatchMesh) -> PreparedRequest:
    """Resolve a request the way ``_stream_impl`` would.

    The chunk rounding to the mesh's size, its clamping and the
    superchunk default MIRROR the streaming driver exactly
    (``repro/serve/coalesce.py:66-87``), so a solo ``explore()`` of the
    same space with the same arguments resolves to the same step key —
    serve traffic and library calls share warm steps both ways.
    ``backend`` must already be resolved ("cuda"/"torch"); the prep is
    built for ``mesh``.
    """
    prep = _prepare_stream(list(space.algorithms), space.grids,
                           soc_node=space.soc_node, mesh=mesh)
    chunk = _chunk_geometry(chunk_size or _DEFAULT_CHUNK, prep.n_var,
                            mesh.size)
    cpv = -(-prep.n_var // chunk)
    n_ord = cpv * prep.n_variants
    s_len = (max(1, int(superchunk)) if superchunk
             else min(max(n_ord, 1), _DEFAULT_SUPERCHUNK))
    return PreparedRequest(
        space=space, k=int(k), metric=metric, backend=backend,
        block_points=int(block_points), chunk=chunk, s_len=s_len,
        cpv=cpv, wide=prep.total + chunk >= 2 ** 31, prep=prep)


def compat_key(pr: PreparedRequest, mesh: BatchMesh) -> tuple:
    """Dispatch-compatibility key: the fused step key of the request on
    ``mesh``.  Equal keys => the group shares ONE step build."""
    return _fused_key(pr.backend, mesh, pr.chunk, pr.metric, pr.k,
                      pr.block_points, pr.prep.bank.dims,
                      pr.prep.vgrids[0].shape, pr.prep.n_var,
                      pr.prep.lmax, pr.s_len, pr.cpv, pr.wide)


def _ordinal_span(o0: int, o1: int, *, cpv: int, n_var: int,
                  chunk: int) -> Tuple[int, int]:
    """Flat index range covered by chunk ordinals ``[o0, o1)`` (the
    ordinal order is contiguous in the variant-major flat space)."""
    vi, r = divmod(o0, cpv)
    lo = vi * n_var + r * chunk
    vi, r = divmod(o1 - 1, cpv)
    hi = vi * n_var + min((r + 1) * chunk, n_var)
    return lo, hi


def plan_segments(pr: PreparedRequest) -> List[Tuple[int, int]]:
    """Superchunk-aligned ``index_range`` segments covering the space.

    Each segment spans exactly one superchunk's worth of chunk ordinals,
    so every segment is ONE dispatch of the shared step — the
    round-robin scheduler's unit of fairness.
    """
    n_ord = pr.cpv * pr.prep.n_variants
    return [_ordinal_span(o0, min(o0 + pr.s_len, n_ord), cpv=pr.cpv,
                          n_var=pr.prep.n_var, chunk=pr.chunk)
            for o0 in range(0, n_ord, pr.s_len)]


@dataclasses.dataclass
class GroupMember:
    """A request's slot in a dispatch group (inputs + outcome)."""
    pr: PreparedRequest
    emitter: Optional[PartialEmitter] = None
    #: absolute ``time.perf_counter()`` deadline, or None
    deadline: Optional[float] = None
    # ----- outcome --------------------------------------------------------
    result: Optional[StreamResult] = None
    error: Optional[BaseException] = None
    segments: int = 0
    dispatches: int = 0

    def _expired(self) -> bool:
        return (self.deadline is not None
                and time.perf_counter() > self.deadline)


def _dispatch_segment(member: GroupMember, lo: int, hi: int,
                      mesh: BatchMesh) -> StreamResult:
    pr = member.pr
    st = _stream_impl(
        list(pr.space.algorithms), pr.space.grids,
        soc_node=pr.space.soc_node, chunk_size=pr.chunk,
        metric=pr.metric, k=pr.k, block_points=pr.block_points,
        index_range=(lo, hi), engine="fused", superchunk=pr.s_len,
        backend=pr.backend, mesh=mesh, _prepared=pr.prep)
    member.segments += 1
    member.dispatches += st.dispatches
    return st


def run_group(members: List[GroupMember], *, mesh: BatchMesh) -> None:
    """Round-robin a compatible group through the shared step.

    Each turn dispatches ONE superchunk segment for the next member with
    work remaining — tenants in a group make proportional progress
    instead of queueing behind each other.  A member whose deadline
    expires between segments fails with :class:`RequestTimeout` (its
    remaining segments are dropped; the others keep going); any other
    per-member failure is likewise contained.  On return every member
    carries either ``result`` (the parity-exact merge of its segments)
    or ``error``.
    """
    work = deque((m, deque(plan_segments(m.pr)), []) for m in members)
    while work:
        member, segments, partials = work.popleft()
        if member._expired():
            member.error = RequestTimeout(
                f"deadline expired after {member.segments} of "
                f"{member.segments + len(segments)} segments")
            continue
        lo, hi = segments.popleft()
        try:
            partials.append(_dispatch_segment(member, lo, hi, mesh))
        except Exception as exc:  # noqa: BLE001 - contained per member
            member.error = exc
            continue
        if segments:
            if member.emitter is not None and member.emitter.want():
                merged = merge_stream_results(partials, k=member.pr.k)
                member.emitter.emit_stream_result(
                    merged, merged.n_points, member.pr.total)
            work.append((member, segments, partials))
        else:
            try:
                member.result = merge_stream_results(partials,
                                                     k=member.pr.k)
            except Exception as exc:  # noqa: BLE001
                member.error = exc


def run_solo(member: GroupMember, *, mesh: BatchMesh) -> None:
    """Dispatch one member standalone (full range, one ``_stream_impl``
    call), streaming partials through the driver's ``on_partial``
    hook."""
    if member._expired():
        member.error = RequestTimeout("deadline expired before dispatch")
        return
    pr = member.pr
    emitter = member.emitter

    def hook(done: int, span: int,
             snapshot: Callable[[], StreamResult]) -> None:
        # last-dispatch snapshots are redundant with the final result
        if emitter is not None and done < span and emitter.want():
            emitter.emit_stream_result(snapshot(), done, span)

    try:
        st = _stream_impl(
            list(pr.space.algorithms), pr.space.grids,
            soc_node=pr.space.soc_node, chunk_size=pr.chunk,
            metric=pr.metric, k=pr.k, block_points=pr.block_points,
            engine="fused", superchunk=pr.s_len, backend=pr.backend,
            mesh=mesh,
            on_partial=hook if emitter is not None else None,
            _prepared=pr.prep)
    except Exception as exc:  # noqa: BLE001 - contained per member
        member.error = exc
        return
    member.segments += 1
    member.dispatches += st.dispatches
    member.result = st
