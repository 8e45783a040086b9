"""Sharding rules: parameter, optimizer, batch and cache partition specs
(torch counterpart of ``src/repro/distributed/sharding.py``, rule for
rule).

Scheme: 2-D FSDP x TP (``data`` x ``model``) with an optional ``pod``
axis that carries pure data parallelism (the gradient all-reduce is the
only cross-pod collective; ``distributed/compression.py`` compresses
it).

Rules are name-based with divisibility-checked fallbacks: a named mesh
axis that does not evenly divide its dimension is dropped (replicated),
e.g. mixtral's 8 experts on a 16-way model axis fall back to TP inside
the expert matrices.

The rules read only a mesh's axis names and sizes (``mesh.axis_names``
and the ``mesh.shape`` mapping of :class:`repro_torch.launch.mesh.LMMesh`),
so they run without a process group, at any world size.  A
:class:`PartitionSpec` is a tuple, equal as one to the reference's
``jax.sharding.PartitionSpec``; :func:`to_placements` turns it into
DTensor placements on a mesh that has a ``DeviceMesh``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from ..tree import paths, unflatten

DATA = ("pod", "data")   # batch axes (pod folded into data parallelism)


def _canonical(ax):
    """An entry as ``jax.sharding.PartitionSpec`` keeps it: a list as a
    tuple, a tuple of one name as the name, an empty one as ``None``."""
    if isinstance(ax, (tuple, list)):
        ax = tuple(ax)
        if not ax:
            return None
        if len(ax) == 1:
            return ax[0]
    return ax


class PartitionSpec(tuple):
    """One entry a tensor dimension: ``None`` (replicated), an axis name,
    or a tuple of axis names (the dimension split over each in turn),
    normalised as the reference's (no trailing ``None`` is dropped)."""

    def __new__(cls, *axes):
        return super().__new__(cls, tuple(_canonical(a) for a in axes))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``): an axis
    names one dimension at most, or ``ValueError`` is raised."""
    mesh: Any
    spec: PartitionSpec

    def __post_init__(self):
        seen = [a for ax in self.spec if ax is not None
                for a in (ax if isinstance(ax, tuple) else (ax,))]
        if len(seen) != len(set(seen)):
            raise ValueError(f"spec {tuple(self.spec)} names a mesh axis "
                             f"on more than one dimension")

    @property
    def placements(self):
        return to_placements(self.spec, self.mesh)


def _fits(mesh, axes, shape) -> bool:
    for dim, ax in zip(shape, axes):
        if ax is None:
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        size = 1
        for n in names:
            if n in mesh.shape:
                size *= mesh.shape[n]
        if size and dim % size != 0:
            return False
    return True


def _choose(mesh, shape, *candidates) -> PartitionSpec:
    """First candidate whose every axis divides; else per-axis fallback."""
    for axes in candidates:
        if _fits(mesh, axes, shape):
            return P(*_strip(mesh, axes))
    axes = list(candidates[0])
    for i, ax in enumerate(axes):
        if ax is not None and not _fits(mesh, [ax], [shape[i]]):
            axes[i] = None
    return P(*_strip(mesh, axes))


def _strip(mesh, axes):
    """Drop axis names not present in the mesh (e.g. 'pod' on single-pod)."""
    out = []
    for ax in axes:
        if ax is None:
            out.append(None)
        elif isinstance(ax, tuple):
            kept = tuple(a for a in ax if a in mesh.shape)
            out.append(kept if kept else None)
        else:
            out.append(ax if ax in mesh.shape else None)
    return out


# ---------------------------------------------------------------------------
# Parameter rules (matched on the trailing path name)
# ---------------------------------------------------------------------------
def spec_for_param(path: str, shape: Tuple[int, ...], mesh) -> PartitionSpec:
    name = path.split("/")[-1]
    nd = len(shape)
    stacked = path.startswith("layers/") or "_layers/" in path
    lead = (None,) if (stacked and nd >= 2) else ()
    body = shape[1:] if lead else shape

    def ch(*cands):
        return _choose(mesh, shape, *[lead + c for c in cands])

    if name == "embed":
        return _choose(mesh, shape, ("model", "data"), (None, "data"))
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj", "bc_proj",
                "dt_proj2", "cross_wk", "cross_wv", "cross_wq"):
        return ch(("data", "model"))
    if name in ("wo", "w_down", "out_proj", "x_proj", "cross_wo"):
        return ch(("model", "data"))
    if name in ("bq", "bk", "bv", "dt_bias", "conv_b", "d_skip"):
        return ch(("model",))
    if name == "router":
        return ch(("data", None))
    if name in ("we_gate", "we_up"):            # (E, D, Fe)
        return ch(("model", "data", None), (None, "data", "model"))
    if name == "we_down":                       # (E, Fe, D)
        return ch(("model", None, "data"), (None, "model", "data"))
    if name == "conv_w":                        # (dI, K)
        return ch(("model", None))
    if name == "a_log":                         # (dI, N) or (nh,)
        if len(body) == 2:
            return ch(("model", None))
        return ch(("model",))
    if name == "dt_proj":                       # (R, dI) or (D, nh)
        return ch(("data", "model"))
    # norms, scalars, positional tables: replicate
    return P(*([None] * nd))


def param_shardings(params: Any, mesh, profile: str = "tp") -> Any:
    """:class:`NamedSharding` tree matching ``params`` (works on ``meta``
    tensors: only shapes are read).

    profile='fsdp': ZeRO-3 — every matrix shards its largest dimension
    over the flattened ('pod', 'data', 'model') axes (no tensor
    parallelism); weights are all-gathered per layer instead of
    activations.
    """
    both = tuple(a for a in ("pod", "data", "model") if a in mesh.shape)
    n_both = 1
    for a in both:
        n_both *= mesh.shape[a]
    specs = {}
    for pstr, leaf in paths(params):
        shape = tuple(leaf.shape)
        if profile == "fsdp":
            axes = [None] * len(shape)
            dims = sorted(range(len(shape)), key=lambda i: -shape[i])
            for i in dims:
                if shape[i] % n_both == 0:
                    axes[i] = both
                    break
            specs[pstr] = NamedSharding(mesh, P(*axes))
        else:
            specs[pstr] = NamedSharding(mesh,
                                        spec_for_param(pstr, shape, mesh))
    return unflatten(specs)


# ---------------------------------------------------------------------------
# Inputs / caches
# ---------------------------------------------------------------------------
def batch_spec(mesh, batch: int, extra_dims: int = 1,
               profile: str = "tp") -> PartitionSpec:
    """Shard the batch over (pod, data) when divisible, else replicate.
    fsdp profile spreads the batch over every mesh axis."""
    axes_b = (("pod", "data", "model") if profile == "fsdp" else DATA)
    axes: Tuple = (axes_b,) + (None,) * extra_dims
    return _choose(mesh, (batch,) + (1 << 30,) * extra_dims, axes)


def cache_shardings(mesh, cache: Any, batch: int) -> Any:
    """:class:`NamedSharding` tree for a decode/prefill cache.

    When the batch shards over (pod, data) the sequence axis stays local;
    for batch=1 long-context cells the kv-cache *sequence* axis shards
    over 'data' instead (context parallelism): the softmax over the
    sharded key axis becomes partial reductions and an all-reduce.
    """
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    batched = batch % dp == 0 and dp > 1

    def spec(path: str, leaf) -> PartitionSpec:
        nd = len(leaf.shape)
        name = path.split("/")[-1]
        if name == "pos":
            return P()
        if name in ("kv_k", "kv_v"):            # (L, B, S, KV*hd)
            axes = ((None, DATA, None, "model") if batched
                    else (None, None, "data", "model"))
            return _choose(mesh, leaf.shape, axes)
        if name == "conv":                       # (L, B, dI, K-1)
            axes = ((None, DATA, "model", None) if batched
                    else (None, None, "model", None))
            return _choose(mesh, leaf.shape, axes)
        if name == "ssm":                        # (L,B,dI,N) or (L,B,nh,p,N)
            axes = ((None, DATA, "model") + (None,) * (nd - 3) if batched
                    else (None, None, "model") + (None,) * (nd - 3))
            return _choose(mesh, leaf.shape, axes)
        if name == "enc_out":                    # (B, Senc, D)
            axes = ((DATA, None, "model") if batched
                    else (None, None, "model"))
            return _choose(mesh, leaf.shape, axes)
        return P(*([None] * nd))

    return unflatten({path: NamedSharding(mesh, spec(path, leaf))
                      for path, leaf in paths(cache)})


def input_shardings(mesh, batch: int) -> Dict[str, NamedSharding]:
    tok = NamedSharding(mesh, batch_spec(mesh, batch, extra_dims=1))
    emb = NamedSharding(mesh, _choose(
        mesh, (batch, 1 << 30, 1 << 30), (DATA, None, "model")))
    return {"tokens": tok, "embeds": emb}


def logical_to_sharding(mesh, *axes) -> NamedSharding:
    return NamedSharding(mesh, P(*_strip(mesh, axes)))


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------
def to_placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: one a mesh axis,
    ``Shard(d)`` where tensor dimension ``d`` names the axis, else
    ``Replicate()``.  A dimension split over several axes must list them
    in mesh order (DTensor nests the shards in mesh order, as jax does);
    an axis named twice raises.  An axis of size 1 replicates: a shard
    over it is the whole dimension, and DTensor's view rules refuse some
    flattens of a dimension marked sharded even over one rank (torch
    2.11's, in einsum's batched products)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.axis_names)
    sizes = mesh.shape
    out = [Replicate()] * len(names)
    taken = set()
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec {tuple(spec)}: dimension {dim} lists "
                             f"{axes}, not in mesh order {names}")
        for a, i in zip(axes, pos):
            if a in taken:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r} "
                                 f"twice")
            taken.add(a)
            if sizes[a] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def distribute(t, sharding: NamedSharding, src_data_rank=0):
    """``t`` as a DTensor under ``sharding`` (the reference's
    ``jax.device_put(t, sharding)``); a DTensor is redistributed.
    ``src_data_rank=0`` takes rank 0's values; ``None`` slices each
    rank's own copy, which must then be the same on every rank."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    mesh = sharding.mesh.device_mesh
    if mesh is None:
        raise ValueError("the mesh has no DeviceMesh: make it with "
                         "make_host_mesh / make_production_mesh inside a "
                         "process group")
    placements = sharding.placements
    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements)
    return distribute_tensor(t, mesh, placements, src_data_rank=src_data_rank)


def distribute_tree(tree: Any, shardings: Any, src_data_rank=0) -> Any:
    """Each leaf of ``tree`` distributed under the matching leaf of
    ``shardings`` (a tree like it, as :func:`param_shardings` gives)."""
    sh = dict(paths(shardings))
    return unflatten({k: distribute(t, sh[k], src_data_rank)
                      for k, t in paths(tree)})
