"""Device time by program span: each device event of a ``torch.profiler``
trace charged to the ``repro_torch.`` span (``repro_torch/spans.py``)
that launched it.

A kernel, memcpy or memset is matched to the host runtime call that
launched it by ``correlation_id`` (the device's and the runtime's
numbering; a host operation's own ``correlation_id`` is another).  The
call goes to the innermost of three kinds of range that encloses it on
its thread (``start_thread_id``): a program span takes it; a forward
operation (one that records a ``sequence_nr`` and no ``fwd_thread_id``)
passes it to the innermost span around that operation, or to no span;
a backward node (``autograd::engine::evaluate_function: ...``) passes
it to the span of the forward operation that made the node, the one on
the node's ``fwd_thread_id`` with its ``sequence_nr`` (the last to
start, where several carry it: an operation that makes no node carries
the number the next node will take).  So a backward kernel is charged
to its forward's span, a recomputed forward (``torch.utils.checkpoint``,
inside a backward node) to the span it runs in again, and a recomputed
operation outside every span to none.  What no span takes is
``unspanned``.

The events read are those :func:`portbench.harness.device.summarize`
counts as device activity; their summed seconds by span add up to the
summed seconds of all of them.
"""
from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Optional, Tuple

from torch.autograd import DeviceType

from . import device

PREFIX = "repro_torch."
BACKWARD = "autograd::engine::evaluate_function:"
UNSPANNED = "unspanned"
# the CUDA runtime's and driver's calls (``cudaLaunchKernel``,
# ``cudaMemsetAsync``, ``cuLaunchKernel``, ...): named, since a trace
# need not say an event's activity type
RUNTIME = "cu"

# Per-layer groups of spans, as the metrics ``<group>_ms.<kind>`` would
# read them: device ms a step (train) or call (prefill) of the group.
_LAYER = {"attention": ("attention",), "rope": ("rope",),
          "norm": ("norm",), "attn_proj": ("attn_proj",), "mlp": ("mlp",)}
GROUPS = {
    "train": {**_LAYER, "vocab": ("embed", "logits", "loss"),
              "optimizer": ("schedule", "adamw"),
              "unspanned": (UNSPANNED,)},
    "prefill": {**_LAYER, "vocab": ("embed", "logits"),
                "kv_cache": ("kv_cache",), "unspanned": (UNSPANNED,)},
}


def is_device_event(ev) -> bool:
    """Device activity as ``summarize`` counts it."""
    return (ev.device_type() == DeviceType.CUDA
            and device._activity(ev) != "gpu_user_annotation"
            and not ev.name().startswith(device.SPAN_PREFIX))


def sweep(ranges: List[Tuple[int, int, object]],
          points: List[Tuple[int, Hashable]]) -> Dict[Hashable, Tuple]:
    """One thread's ranges ``(start, end, payload)``, nested as a
    thread's host ranges are, and points ``(time, key)``: ``{key: the
    payloads of the ranges open at that time, outermost first}``.  A
    range that starts or ends at a point's time is open there."""
    rows = sorted([(s, 0, -e, n) for n, (s, e, _) in enumerate(ranges)]
                  + [(t, 1, 0, n) for n, (t, _) in enumerate(points)])
    out: Dict[Hashable, Tuple] = {}
    stack: List[Tuple[int, object]] = []        # (end, payload)
    for t, is_point, neg_end, n in rows:
        while stack and stack[-1][0] < t:
            stack.pop()
        if is_point:
            out[points[n][1]] = tuple(p for _, p in stack)
        else:
            stack.append((-neg_end, ranges[n][2]))
    return out


def _verdict(stack: Tuple) -> Tuple:
    """What the innermost of a stack of ranges says of a moment:
    ``("span", name)`` (``name`` ``None`` for a forward operation under
    no span), ``("backward", (fwd_thread_id, sequence_nr))``, or
    ``(None, None)``."""
    forward = False
    for kind, key in reversed(stack):
        if kind == "span":
            return kind, key
        if kind == "backward":
            return ("span", None) if forward else (kind, key)
        forward = True
    return ("span", None) if forward else (None, None)


def charge(events: Iterable) -> List[Tuple[object, str, object]]:
    """(device event, span, the runtime call that launched it or
    ``None``) for every device event that ``summarize`` counts."""
    evs = list(events)
    dev, runtime = [], {}
    ranges: Dict[int, List] = {}
    points: Dict[int, List] = {}
    made: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for i, ev in enumerate(evs):
        if ev.device_type() == DeviceType.CUDA:
            if is_device_event(ev):
                dev.append(ev)
            continue
        if ev.device_type() != DeviceType.CPU:
            continue
        name, s, e = ev.name(), ev.start_ns(), ev.end_ns()
        tid, seq = ev.start_thread_id(), ev.sequence_nr()
        if name.startswith(RUNTIME):
            runtime[ev.correlation_id()] = i
            points.setdefault(tid, []).append((s, i))
        elif name.startswith(PREFIX):
            ranges.setdefault(tid, []).append(
                (s, e, ("span", name[len(PREFIX):])))
        elif name.startswith(BACKWARD):
            ranges.setdefault(tid, []).append(
                (s, e, ("backward", (ev.fwd_thread_id(), seq))))
        elif seq >= 0 and ev.fwd_thread_id() == 0:
            # a forward operation: its span is the one open at its start
            ranges.setdefault(tid, []).append((s, e, ("forward", None)))
            points.setdefault(tid, []).append((s, i))
            if made.get((tid, seq), (-1, i))[0] <= s:
                made[(tid, seq)] = (s, i)
    at: Dict[int, Tuple] = {}
    for tid in set(ranges) | set(points):
        for i, stack in sweep(ranges.get(tid, []),
                              points.get(tid, [])).items():
            at[i] = _verdict(stack)

    def span_of(launch: Optional[int]) -> str:
        kind, key = at.get(launch, (None, None))
        if kind == "backward":
            fwd = made.get(key)
            kind, key = at[fwd[1]] if fwd else (None, None)
        return key if kind == "span" and key is not None else UNSPANNED

    out = []
    for ev in dev:
        launch = runtime.get(ev.correlation_id())
        out.append((ev, span_of(launch),
                    None if launch is None else evs[launch]))
    return out


def tally(charged: List[Tuple[object, str, object]]) -> Dict:
    """Device seconds and event counts by span, and seconds by span and
    kernel class (``device.KERNEL_CLASSES``), of :func:`charge`'s rows:
    ``by_span_s``, ``by_span_events``, ``by_span_class_s``, and
    ``device_s``, their total."""
    by_s: Dict[str, float] = {}
    by_n: Dict[str, int] = {}
    by_class: Dict[str, Dict[str, float]] = {}
    total = 0.0
    for ev, span, _ in charged:
        sec = (ev.end_ns() - ev.start_ns()) * 1e-9
        total += sec
        by_s[span] = by_s.get(span, 0.0) + sec
        by_n[span] = by_n.get(span, 0) + 1
        row = by_class.setdefault(span, {})
        c = device.kernel_class(ev.name())
        row[c] = row.get(c, 0.0) + sec
    return {"by_span_s": by_s, "by_span_events": by_n,
            "by_span_class_s": by_class, "device_s": total}


def device_ms(profile: Optional[Dict], units: int,
              names: Tuple[str, ...]) -> Optional[float]:
    """Device ms a unit (step or call) of the named spans, from a
    profile that holds :func:`tally`'s ``by_span_s``; ``None`` without
    one."""
    if not profile or "by_span_s" not in profile or not units:
        return None
    by = profile["by_span_s"]
    if not any(n in by for n in names):
        return None
    return 1e3 * sum(by.get(n, 0.0) for n in names) / units
