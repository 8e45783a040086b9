"""The device side of a run: the table of peaks, the card's name and
power limit, and the reading of a ``torch.profiler`` trace (busy time,
device time by kernel class, the top operations, the idle gaps by what
the host was doing, and a check that no launch lost its kernel)."""
from __future__ import annotations

import bisect
import contextlib
import subprocess
from typing import Dict, List, Optional, Tuple

import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at the
# 700 W limit): bf16/fp16 and TF32 on the tensor cores, FP32 outside
# them, HBM3 bandwidth.  Keyed by a part of the name the driver reports.
PEAKS = {"H100": {"bf16_flops": 989e12, "tf32_flops": 495e12,
                  "fp32_flops": 67e12, "hbm_bytes": 3.35e12}}

# Device time by kernel name: the first class whose keys the name holds
# (fused attention, cuBLAS's GEMMs, torch's softmax, reduction and
# elementwise kernels).
KERNEL_CLASSES = (("attention", ("flash", "fmha", "attention")),
                  ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
                  ("softmax", ("softmax",)),
                  ("reduce", ("reduce_kernel",)),
                  ("elementwise", ("elementwise_kernel",)),
                  ("copy_cat_index", ("copy", "Cat", "index", "scatter",
                                      "gather")))

SPAN_PREFIX = "portbench."
LAUNCH_KEYS = ("LaunchKernel", "LaunchCooperativeKernel")


def peaks(kind: str) -> Optional[Dict[str, float]]:
    return next((v for k, v in PEAKS.items() if k in kind), None)


def kernel_class(name: str) -> str:
    return next((c for c, keys in KERNEL_CLASSES
                 if any(k in name for k in keys)), "other")


def card() -> str:
    """``nvidia-smi``'s name and power limit of the cards, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return "; ".join(out.stdout.strip().splitlines()) or "nvidia-smi: none"


@contextlib.contextmanager
def traced(enabled: bool):
    """A ``torch.profiler`` over the block (CPU and CUDA activity) when
    ``enabled``; yields the profiler or ``None``."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def span(name: str):
    """A host span in the trace, ``portbench.<name>``."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _events(prof):
    return prof.profiler.kineto_results.events()


def _activity(ev) -> str:
    fn = getattr(ev, "activity_type", None)
    return str(fn()) if fn is not None else ""


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class HostOps:
    """The host's operations of a trace, to say what the host was doing
    at a moment: the innermost operation then, under the outermost
    ``portbench.`` span (none of which lasts longer than the horizon)."""

    HORIZON_NS = 20e9

    def __init__(self, ops: List[Tuple[int, int, str]]):
        self.ops = sorted(ops)
        self.starts = [s for s, _, _ in self.ops]

    def at(self, t: int) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        inner, outer = None, None
        while i >= 0 and t - self.starts[i] < self.HORIZON_NS:
            s, e, name = self.ops[i]
            if e > t:
                if inner is None:
                    inner = name
                if name.startswith(SPAN_PREFIX):
                    outer = name
            i -= 1
        parts = [p for p in (outer, inner) if p]
        if len(parts) == 2 and parts[0] == parts[1]:
            parts = parts[:1]
        return " > ".join(parts) if parts else "no operation"


def summarize(prof, window_s: float, top: int = 10) -> Dict:
    """What the run's readers and its ``breakdown`` take from a trace.

    Raises where the profiler dropped records: a kernel launch whose
    kernel is missing, or device activity that stops short of the
    window's end."""
    from torch.autograd import DeviceType
    dev: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    launches, kernel_ids = set(), set()
    for ev in _events(prof):
        name, s, e = ev.name(), ev.start_ns(), ev.end_ns()
        if ev.device_type() == DeviceType.CUDA:
            if _activity(ev) == "gpu_user_annotation" or \
                    name.startswith(SPAN_PREFIX):
                continue
            dev.append((s, e, name))
            kernel_ids.add(ev.correlation_id())
        elif ev.device_type() == DeviceType.CPU:
            if any(k in name for k in LAUNCH_KEYS):
                launches.add(ev.correlation_id())
            else:
                host.append((s, e, name))
    if not dev:
        raise RuntimeError("trace: no device activity recorded")
    lost = launches - kernel_ids
    if lost:
        raise RuntimeError(f"trace: the profiler dropped {len(lost)} of "
                           f"{len(launches)} kernel records")
    busy = _merge([(s, e) for s, e, _ in dev])
    busy_ns = sum(e - s for s, e in busy)
    reach_s = (busy[-1][1] - busy[0][0]) * 1e-9
    if reach_s < 0.9 * window_s or busy_ns * 1e-9 > window_s * 1.01:
        raise RuntimeError(f"trace: device activity over {reach_s:.3f} s "
                           f"(busy {busy_ns * 1e-9:.3f} s) of a "
                           f"{window_s:.3f} s window: records dropped")
    by_name: Dict[str, float] = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
    by_class: Dict[str, float] = {}
    for name, sec in by_name.items():
        c = kernel_class(name)
        by_class[c] = by_class.get(c, 0.0) + sec
    ops = HostOps(host)
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:top]
    gap_rows: Dict[str, float] = {}
    for ns, t in gaps:
        label = ops.at(t)
        gap_rows[label] = gap_rows.get(label, 0.0) + ns * 1e-9
    return {
        "busy_s": busy_ns * 1e-9, "window_s": window_s,
        "kernels": len(dev), "launches": len(launches),
        "by_class_s": by_class,
        "device_ops": sorted(([n[:160], s] for n, s in by_name.items()),
                             key=lambda r: -r[1])[:top],
        "idle_gaps": sorted(([n[:160], s] for n, s in gap_rows.items()),
                            key=lambda r: -r[1])[:top],
    }
