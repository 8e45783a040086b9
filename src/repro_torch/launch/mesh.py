"""Device meshes: the 1-D ``("batch",)`` mesh the sweep engines split
over, and the LM stack's ``data`` x ``model`` (x ``pod``) mesh.

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

The LM mesh (:class:`LMMesh`, counterpart of the reference's
``make_host_mesh`` and ``make_production_mesh``, ``repro/launch/
mesh.py:25,61``) is SPMD instead: one process a rank in a
``torch.distributed`` process group (gloo on the CPU, NCCL with one GPU
a rank), and a ``DeviceMesh`` with the reference's axis names, over
which parameters, batches and caches are DTensors.  Its names and sizes
alone (no process group) are what the sharding rules read.
:func:`spawn` runs a function on N ranks joined over a ``file://``
store; :func:`join_from_env` joins the group ``torchrun`` describes.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import os
import shutil
import tempfile
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ..kernels.runtime import resolve_device

__all__ = ["BatchMesh", "LMMesh", "device_key", "join_from_env",
           "make_batch_mesh", "make_host_mesh", "make_mesh",
           "make_production_mesh", "resolve_mesh", "spawn", "world_size"]


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


# ===========================================================================
# The LM mesh
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class LMMesh:
    """Axis names and sizes, and the ``DeviceMesh`` over the process
    group's ranks once there is one (``None``: a shape-only mesh, which
    the sharding rules take at any size, or one device without a
    group)."""
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device_mesh: Any = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "sizes", tuple(int(s) for s in self.sizes))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"sizes {self.sizes} for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        """``{name: size}`` in mesh order (the reference's
        ``Mesh.shape``)."""
        return collections.OrderedDict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: Sequence[int], names: Sequence[str]) -> LMMesh:
    """An :class:`LMMesh` of any axes over the first ``prod(shape)``
    ranks (every rank of the group calls it: the ``DeviceMesh``'s groups
    are made collectively); with no process group it has no
    ``DeviceMesh``."""
    shape, names = tuple(shape), tuple(names)
    import torch.distributed as dist
    if not dist.is_initialized():
        return LMMesh(shape, names)
    from torch.distributed.device_mesh import DeviceMesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return LMMesh(shape, names, DeviceMesh(device_type, ranks,
                                           mesh_dim_names=names))


def make_production_mesh(*, multi_pod: bool = False) -> LMMesh:
    """16 x 16 ``data`` x ``model``, or 2 x 16 x 16 with ``pod``; raises
    ``RuntimeError`` below 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = world_size()
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} devices but only {have} visible "
            f"(ranks of the process group) — launch {need} ranks "
            f"(torchrun --nproc-per-node, or --devices {need})")
    return make_mesh(shape, axes)


def make_host_mesh(data: Optional[int] = None, model: int = 1) -> LMMesh:
    """``(data, model)`` over the process group's ranks (every rank by
    default); one device without a process group."""
    n = world_size()
    if data is None:
        data = max(n // model, 1)
    if data * model > n:
        raise RuntimeError(f"host mesh ({data}, {model}) needs "
                           f"{data * model} ranks but {n} are running")
    return make_mesh((data, model), ("data", "model"))


# ---------------------------------------------------------------------------
# Process groups
# ---------------------------------------------------------------------------
def _backend(device: str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def join_from_env(device: str = "cuda") -> bool:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); False when the
    environment names none.  On CUDA each rank takes GPU ``LOCAL_RANK``."""
    import torch.distributed as dist
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(_backend(device), init_method="env://")
    return True


def _rank_main(rank, fn, n, store, device, args):
    import torch.distributed as dist
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(_backend(device), init_method=f"file://{store}",
                            rank=rank, world_size=n)
    try:
        fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, args: Sequence = (), device: str = "cuda",
          store_dir: Optional[str] = None) -> None:
    """Run ``fn(rank, *args)`` on ``n`` spawned ranks joined in one
    process group over a ``file://`` store in ``store_dir`` (default: a
    new temporary directory, removed after): gloo on the CPU, NCCL on
    CUDA with GPU ``rank`` for rank ``rank`` (NCCL takes one rank a
    GPU, so ``n`` may not pass the visible count).  ``fn`` must be
    importable (it is pickled by name).  A rank's exception is raised
    here once every rank has stopped."""
    import torch.multiprocessing as mp
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch.cuda.is_available() "
                               "is False; pass device='cpu'")
        if n > torch.cuda.device_count():
            raise RuntimeError(f"{n} NCCL ranks need {n} GPUs, "
                               f"{torch.cuda.device_count()} are visible")
    own = store_dir is None
    root = os.path.abspath(tempfile.mkdtemp(prefix="lm_mesh_") if own
                           else store_dir)
    os.makedirs(root, exist_ok=True)
    store = os.path.join(root, "store")
    if os.path.exists(store):       # a crashed run's store never rendezvous
        os.remove(store)
    try:
        mp.start_processes(_rank_main, args=(fn, n, store, device,
                                             tuple(args)),
                           nprocs=n, join=True, start_method="spawn")
    finally:
        if own:
            shutil.rmtree(root, ignore_errors=True)
