"""Gradient compression for the cross-pod reduction: int8 with error
feedback (torch counterpart of ``src/repro/distributed/compression.py``).

The ``pod`` mesh axis is the expensive one (the links between pods, not
those inside one).  :func:`compressed_psum_mean` quantizes each rank's
tensor to int8 with one f32 scale and all-reduces the int8 payload,
summed in int32 so that it cannot overflow (the wire format of a ring
all-reduce would be the int8 payload and one scale a rank), then
dequantizes with the mean scale.  The residual of the quantization is
returned, to be added to the next step's gradient (error feedback), so
the compression's bias vanishes over steps.

As in the reference, no train step calls it: it is a library held to
its tests.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..tree import paths, unflatten


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale f32 0-d)``: ``scale = max|x| / 127 + 1e-12``,
    ``q = clip(round(x / scale), -127, 127)`` (round half to even, as
    ``jnp.round``)."""
    x32 = x.float()
    scale = torch.amax(torch.abs(x32)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_mean(x: torch.Tensor, group,
                         error: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-reduce ``x`` over the ranks of the process group ``group``
    in int8 with error feedback.  Returns ``(reduced in x's dtype,
    new_error f32)``.  Every rank of ``group`` calls it, in the same
    order."""
    import torch.distributed as dist
    x32 = x.float() + error
    q, scale = quantize_int8(x32)
    sent = dequantize_int8(q, scale)
    new_error = x32 - sent                       # residual kept locally
    # int8 payload summed in int32 (wire format: int8 + per-rank scale);
    # a collective takes a contiguous buffer (a gradient may be a view)
    summed = q.to(torch.int32, memory_format=torch.contiguous_format)
    dist.all_reduce(summed, group=group)
    scale_sum = scale.clone()
    dist.all_reduce(scale_sum, group=group)
    n = float(dist.get_world_size(group))
    # per-rank scales are close (gradients similar across pods); use the
    # mean scale: the residual goes into error feedback either way
    mean_scale = scale_sum / n
    reduced = summed.float() * mean_scale / n
    return reduced.to(x.dtype), new_error


def cross_pod_grad_reduce(grads: Any, mesh, errors: Any) -> Tuple[Any, Any]:
    """Compressed mean-reduction over the ``pod`` axis of a gradient tree.

    ``grads`` enter pod-local (each pod computed its own mean over its
    batch slice) and leave pod-averaged; ``errors`` is a matching f32
    tree.  As in the reference (whose ``shard_map`` takes each leaf
    whole, ``P(None, ...)``), every rank quantizes its whole leaf with
    one scale: a DTensor leaf is first gathered over every mesh axis
    that shards it, the pod axis included, so a leaf sharded over pods
    (``fsdp``) reduces the same whole leaf on every pod.  The outputs
    take the leaf's placements again.  Without a ``pod`` axis this is
    the identity."""
    if "pod" not in mesh.shape:
        return grads, errors
    from torch.distributed.tensor import DTensor, Replicate
    group = mesh.device_mesh.get_group("pod")
    err = dict(paths(errors))
    red, new_err = {}, {}
    for key, g in paths(grads):
        e = err[key]
        if not isinstance(g, DTensor):
            red[key], new_err[key] = compressed_psum_mean(g, group, e)
            continue
        dm = g.device_mesh
        whole = [Replicate()] * dm.ndim

        def gather(t):
            return (t.redistribute(dm, whole).to_local()
                    if isinstance(t, DTensor) else t)

        def place(t):
            return DTensor.from_local(t, dm, whole, run_check=False
                                      ).redistribute(dm, g.placements)
        r, ne = compressed_psum_mean(gather(g), group, gather(e))
        red[key], new_err[key] = place(r), place(ne)
    return unflatten(red), unflatten(new_err)
