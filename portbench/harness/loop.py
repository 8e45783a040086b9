"""The measured window: a closed loop that issues one unit of work (a
step, a call) after another, with at most ``depth`` in flight on the
device, until ``seconds`` have passed on the host's clock, then waits
for all of them.  The window is the host time from the first issue to
the end of the last unit, so a rate over it counts all the work and all
the time."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from .device import span


@dataclasses.dataclass
class Window:
    units: int                      # steps or calls completed
    seconds: float                  # host clock, first issue to last end
    attempted: int
    failed: int
    spans: Dict[str, List[float]]   # CUDA-event ms by span name
    profile: Optional[Dict] = None  # device.summarize() of a traced run
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seconds_since(t_start: Optional[float], device: torch.device
                  ) -> Optional[float]:
    """Host seconds from ``t_start`` to the end of the work issued so
    far (``setup_s`` where ``t_start`` is the process's start), or
    ``None`` without a start."""
    sync(device)
    return None if t_start is None else time.perf_counter() - t_start


def closed_loop(issue: Callable[[int], None], seconds: float, depth: int,
                device: torch.device):
    """Runs ``issue(0)``, ``issue(1)``, ... as above; returns (units,
    window seconds)."""
    cuda = device.type == "cuda"
    sync(device)
    ends = []
    t0 = time.perf_counter()
    n = 0
    while True:
        issue(n)
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            ends.append(ev)
        n += 1
        if cuda and n > depth:
            with span("wait"):
                ends[n - 1 - depth].synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return n, time.perf_counter() - t0


class Spans:
    """CUDA-event spans around calls, read after the window."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.pairs: Dict[str, List] = {}

    def begin(self):
        if not self.enabled:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def end(self, name: str, start) -> None:
        if start is None:
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.pairs.setdefault(name, []).append((start, ev))

    def ms(self) -> Dict[str, List[float]]:
        return {k: [a.elapsed_time(b) for a, b in v]
                for k, v in self.pairs.items()}
