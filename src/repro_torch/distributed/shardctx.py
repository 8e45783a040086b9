"""Mesh context: lets model code state sharding intent without importing
a mesh (torch counterpart of ``src/repro/distributed/shardctx.py``).
Outside a mesh context, and on a plain tensor, every constraint is the
identity, so the same model runs on one device and on a mesh unchanged.

Axis-name convention: ``data`` (batch / fsdp), ``model`` (tensor),
``pod`` (cross-pod data parallel).  ``constrain(x, 'data', None,
'model')`` redistributes a DTensor ``x`` to those axes of the active
mesh; axes absent from the mesh are dropped from the spec.

Inside :func:`use_mesh` plain tensors that meet DTensors (positions,
masks, RoPE tables, MoE buffers, the schedule's 0-d ``lr``) count as
replicated (``torch.distributed.tensor.experimental.
implicit_replication``): everything a step makes without reading a
sharded input is the same on every rank.  The batch, the parameters and
the optimizer state must enter as DTensors.  The flag and the active
mesh are the process's (the autograd engine's device threads, which
recompute rematerialised layers, must see them), so one thread at a time
runs on a mesh.
"""
from __future__ import annotations

import contextlib

import torch

from .sharding import NamedSharding, P, to_placements


class _State:
    """The active mesh and profile (the process's: see above)."""
    mesh = None
    profile = "tp"


_state = _State()


def current_mesh():
    return _state.mesh


def current_profile() -> str:
    return _state.profile


@contextlib.contextmanager
def use_mesh(mesh, profile: str = "tp"):
    """profile: 'tp' (2-D FSDP x TP, baseline) or 'fsdp' (both mesh axes
    carry data parallelism; params ZeRO-3-shard over the flattened axes
    and no tensor dimension is model-sharded)."""
    prev = current_mesh()
    prev_prof = current_profile()
    _state.mesh = mesh
    _state.profile = profile
    try:
        if prev is None:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield mesh
        else:
            yield mesh
    finally:
        _state.mesh = prev
        _state.profile = prev_prof


def _filter_spec(mesh, axes, profile: str = "tp") -> P:
    names = set(mesh.axis_names)

    def remap(a):
        if profile != "fsdp":
            return a
        # fsdp profile: no tensor-parallel sharding; batch-ish axes span both
        if a == "model":
            return None
        if a == "data" or (isinstance(a, (tuple, list)) and "data" in a):
            return tuple(x for x in ("pod", "data", "model") if x in names)
        return a

    def keep(a):
        a = remap(a)
        if a is None:
            return None
        if isinstance(a, (tuple, list)):
            kept = tuple(x for x in a if x in names)
            return kept if kept else None
        return a if a in names else None

    return P(*(keep(a) for a in axes))


def axis_size(name: str) -> int:
    """Size of a mesh axis in the active context (1 if absent/no mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    return mesh.shape.get(name, 1)


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """``x`` redistributed to ``axes`` iff a mesh is active and ``x`` is
    a DTensor (the reference's ``with_sharding_constraint``); the
    identity otherwise.  Differentiable: the backward redistributes the
    gradient back."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = _filter_spec(mesh, axes, current_profile())
    return x.redistribute(x.device_mesh, to_placements(spec, mesh))


def named_sharding(mesh, *axes) -> NamedSharding:
    return NamedSharding(mesh, _filter_spec(mesh, axes))
