"""The 1-D ``("batch",)`` device mesh the sweep engines split over.

Counterpart of the reference's ``make_batch_mesh``
(``repro/launch/mesh.py:40-58``).  The sweep batch axis is
embarrassingly parallel, so a mesh is an ordered strip of devices and
shard *i* of every batch or chunk runs on ``devices[i]``.  One process
drives every shard (a single controller, as one ``shard_map`` over a
mesh is): the shards' O(k) partials move to ``devices[0]`` and merge
there.

* On CUDA, :func:`make_batch_mesh` takes the first *n* visible GPUs.
* On the CPU a mesh is *n* logical shards on the one CPU device, the
  counterpart of the reference's
  ``--xla_force_host_platform_device_count``, whose forced "devices"
  are one CPU too.
* A :class:`BatchMesh` built directly may repeat a device
  (``BatchMesh([torch.device("cuda", 0)] * 4)``: four shards on one
  card).

The entry points take ``mesh=`` beside ``device=``: a bare ``device``
is a one-entry mesh on that device (:func:`resolve_mesh`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..kernels.runtime import resolve_device

__all__ = ["BatchMesh", "device_key", "make_batch_mesh", "resolve_mesh"]


def device_key(device: torch.device) -> str:
    """A device as a cache key names it: a bare ``cuda`` is the current
    CUDA device."""
    if device.type == "cuda" and device.index is None:
        return f"cuda:{torch.cuda.current_device()}"
    return str(device)


def _normalize(device) -> torch.device:
    """``device`` resolved (a CUDA request without a GPU raises), with
    the current index on a bare ``cuda``."""
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device.index >= torch.cuda.device_count():
            raise ValueError(f"device={str(device)!r}: this host has "
                             f"{torch.cuda.device_count()} CUDA "
                             f"device(s)")
    return device


@dataclasses.dataclass(frozen=True)
class BatchMesh:
    """An ordered strip of devices; shard *i* runs on ``devices[i]``.

    Every entry is of one type (``cuda`` with its index, or ``cpu``); an
    entry may repeat.  ``distinct`` lists each device once, in order:
    what needs one copy a device (the sweep's tables, K1's plan) is made
    once for each of them."""
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if isinstance(self.devices, (str, torch.device)):
            raise TypeError("BatchMesh takes a sequence of devices, got "
                            f"{self.devices!r}")
        devices = tuple(_normalize(d) for d in self.devices)
        if not devices:
            raise ValueError("a BatchMesh needs at least one device")
        if len({d.type for d in devices}) > 1:
            raise ValueError(f"a BatchMesh holds devices of one type, got "
                             f"{[str(d) for d in devices]}")
        object.__setattr__(self, "devices", devices)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("batch",)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        return tuple(dict.fromkeys(self.devices))


def make_batch_mesh(num_devices: Optional[int] = None,
                    device="cuda") -> BatchMesh:
    """1-D ``("batch",)`` mesh over the first ``num_devices`` visible
    GPUs (default: every one), or over ``num_devices`` logical shards of
    the CPU with ``device="cpu"`` (default: one).  Asking for more GPUs
    than are visible raises ``RuntimeError``, as the reference does; so
    does a CUDA mesh without a GPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        n = 1 if num_devices is None else int(num_devices)
        if n < 1:
            raise RuntimeError(f"batch mesh wants {n} shards; a mesh has "
                               f"at least one")
        return BatchMesh((dev,) * n)
    visible = torch.cuda.device_count()
    n = visible if num_devices is None else int(num_devices)
    if n < 1 or n > visible:
        raise RuntimeError(
            f"batch mesh wants {n} devices but {visible} are visible; "
            f"BatchMesh([torch.device('cuda', 0)] * {n}) runs {n} shards "
            f"on one card")
    return BatchMesh(tuple(torch.device("cuda", i) for i in range(n)))


def resolve_mesh(mesh: Optional[BatchMesh] = None,
                 device=None) -> BatchMesh:
    """The mesh an entry point runs on: ``mesh`` if given, else a
    one-entry mesh on ``device`` (default ``"cuda"``).  An explicit
    ``device`` must name the mesh's first device (where the merged state
    lives), or ``ValueError`` is raised."""
    if mesh is None:
        return BatchMesh((resolve_device("cuda" if device is None
                                         else device),))
    if not isinstance(mesh, BatchMesh):
        raise TypeError(f"mesh= takes a repro_torch.launch.BatchMesh "
                        f"(see make_batch_mesh), got "
                        f"{type(mesh).__name__}")
    if device is not None and (
            torch.device(device).type != mesh.devices[0].type
            or device_key(torch.device(device))
            != device_key(mesh.devices[0])):
        raise ValueError(f"device={str(device)!r} conflicts with mesh= "
                         f"(its first device is {mesh.devices[0]}); pass "
                         f"one or the other")
    return mesh
