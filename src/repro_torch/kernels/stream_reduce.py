"""Per-block masked min / argmin / sum / count for the streaming reducer,
and their torch twins.

Port of the reference's K3a (``repro/kernels/stream_reduce.py::
_stats_kernel``) and K3b (``_stats_banked_kernel``).  A chunk's ``[B]``
metric vector is cut into blocks of ``block_points``; each block emits
its masked min, block-relative argmin (first occurrence), masked sum and
valid count.  Masked points and the padding of a ragged last block count
as +inf for the min and nothing for the sum and count, so an all-masked
block gives min +inf, argmin 0 and count 0 (``jnp.argmin``'s answer).
K3b does the same per (block, variant id), ``[G, V]``; padding rows
carry variant -1 and match no id.

* :func:`block_stats` / :func:`block_stats_banked` — wrappers around the
  hand-written CUDA kernels of ``repro_torch/csrc/stream_reduce.cu``.  For
  a CUDA tensor they launch the kernel or raise; for a CPU tensor they
  run the twin.
* :func:`block_stats_torch` / :func:`block_stats_banked_torch` — the
  plain-torch twins.  Min and argmin agree with the kernel exactly; the
  sums add in another order (rel 1e-5 over a 4096-point block).
* :func:`masked_stats` — the global fold of :func:`block_stats`.

:data:`COUNTS` counts launches and twin calls of each kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .cuda_build import check_operands, launch, load_library

#: launches of the CUDA kernels / calls of the torch twins since the
#: last :func:`reset_counts`
COUNTS: Dict[str, int] = {"kernel_launches": 0, "twin_calls": 0,
                          "banked_kernel_launches": 0,
                          "banked_twin_calls": 0}

_LIB = {}


def reset_counts() -> None:
    """Zero the launch / twin-call counters."""
    for key in COUNTS:
        COUNTS[key] = 0


def _check(values: torch.Tensor, *others: torch.Tensor) -> int:
    if values.dim() != 1 or any(o.shape != values.shape for o in others):
        raise ValueError(f"block stats take [B] vectors of one length, got "
                         f"{[tuple(t.shape) for t in (values,) + others]}")
    return int(values.shape[0])


def _blocked(values, mask, bp: int, variant=None):
    """``(G, bp)`` views of the masked metric (+inf where masked) and the
    validity mask, the ragged tail padded as masked."""
    b = values.shape[0]
    pad = (-b) % bp
    ok = mask.to(torch.bool)
    v = values.to(torch.float32)
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
        ok = torch.nn.functional.pad(ok, (0, pad))
        if variant is not None:
            variant = torch.nn.functional.pad(variant, (0, pad), value=-1)
    g = (b + pad) // bp
    return v.reshape(g, bp), ok.reshape(g, bp), (
        None if variant is None else variant.reshape(g, bp))


def _stats(v, ok):
    masked = torch.where(ok, v, torch.inf)
    # argmin returns the first minimal position (block-relative)
    amins = torch.argmin(masked, dim=-1).to(torch.int32)
    mins = torch.amin(masked, dim=-1)
    sums = torch.where(ok, v, 0.0).sum(dim=-1)
    counts = ok.to(torch.float32).sum(dim=-1)
    return mins, amins, sums, counts


def block_stats_torch(values: torch.Tensor, mask: torch.Tensor,
                      block_points: int = 4096):
    """Per-block masked stats over a ``[B]`` metric vector: ``(mins,
    argmins, sums, counts)``, each ``[G]`` with ``G = ceil(B / bp)``;
    argmins are block-relative int32."""
    COUNTS["twin_calls"] += 1
    b = _check(values, mask)
    bp = max(min(int(block_points), b), 1)
    v, ok, _ = _blocked(values, mask, bp)
    return _stats(v, ok)


def block_stats_banked_torch(values: torch.Tensor, mask: torch.Tensor,
                             variant: torch.Tensor, n_variants: int,
                             block_points: int = 4096):
    """Per-(block, variant) masked stats: ``(mins, argmins, sums,
    counts)``, each ``[G, V]``."""
    COUNTS["banked_twin_calls"] += 1
    b = _check(values, mask, variant)
    bp = max(min(int(block_points), b), 1)
    v, ok, gid = _blocked(values, mask, bp, variant.to(torch.int32))
    ids = torch.arange(n_variants, dtype=torch.int32, device=v.device)
    okw = ok[:, None, :] & (gid[:, None, :] == ids[None, :, None])
    return _stats(v[:, None, :].expand(-1, n_variants, -1), okw)


def load_kernel_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = _LIB.get("lib")
    if lib is not None:
        return lib
    lib = load_library("stream_reduce")
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.repro_block_stats.argtypes = [ptr, ptr, ll, i, ptr, ptr, ptr, ptr,
                                      ptr]
    lib.repro_block_stats.restype = ctypes.c_int
    lib.repro_block_stats_banked.argtypes = [ptr, ptr, ptr, ll, i, i, ptr,
                                             ptr, ptr, ptr, ptr]
    lib.repro_block_stats_banked.restype = ctypes.c_int
    _LIB["lib"] = lib
    return lib


def _cuda_inputs(values, mask, variant=None):
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"block stats run on CUDA or CPU tensors, got "
                         f"{dev}")
    check_operands("block stats", dev, (torch.float32,), values=values)
    check_operands("block stats", dev, (torch.bool,), mask=mask)
    if variant is not None:
        check_operands("block stats", dev, (torch.int32,), variant=variant)
    return dev


def _outputs(shape, dev):
    return (torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev),
            torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.float32, device=dev))


def block_stats(values: torch.Tensor, mask: torch.Tensor,
                block_points: int = 4096):
    """Same contract as :func:`block_stats_torch`.

    On a CUDA tensor it launches the hand-written kernel on the current
    stream (no synchronisation) or raises; on a CPU tensor it runs the
    twin.  The kernel takes f32 ``values`` and a bool ``mask``.
    """
    if values.device.type == "cpu":
        return block_stats_torch(values, mask, block_points)
    dev = _cuda_inputs(values, mask)
    b = _check(values, mask)
    if b == 0:
        raise ValueError("block_stats needs at least one point")
    bp = max(min(int(block_points), b), 1)
    outs = _outputs((-(-b // bp),), dev)
    lib = load_kernel_library()
    launch("block_stats", lib.repro_block_stats, dev, values.data_ptr(),
           mask.data_ptr(), b, bp, *(o.data_ptr() for o in outs))
    COUNTS["kernel_launches"] += 1
    return outs


def block_stats_banked(values: torch.Tensor, mask: torch.Tensor,
                       variant: torch.Tensor, n_variants: int,
                       block_points: int = 4096):
    """Same contract as :func:`block_stats_banked_torch`; on a CUDA tensor
    it launches the kernel (int32 ``variant``) or raises."""
    if values.device.type == "cpu":
        return block_stats_banked_torch(values, mask, variant, n_variants,
                                        block_points)
    dev = _cuda_inputs(values, mask, variant)
    b = _check(values, mask, variant)
    if b == 0 or n_variants < 1:
        raise ValueError(f"block_stats_banked needs points and variants, "
                         f"got B={b}, n_variants={n_variants}")
    bp = max(min(int(block_points), b), 1)
    outs = _outputs((-(-b // bp), int(n_variants)), dev)
    lib = load_kernel_library()
    launch("block_stats_banked", lib.repro_block_stats_banked, dev,
           values.data_ptr(), mask.data_ptr(), variant.data_ptr(), b, bp,
           int(n_variants), *(o.data_ptr() for o in outs))
    COUNTS["banked_kernel_launches"] += 1
    return outs


def masked_stats(values: torch.Tensor, mask: torch.Tensor,
                 block_points: int = 4096) -> Dict[str, torch.Tensor]:
    """Global ``{min, argmin, sum, count}`` of the masked ``[B]`` vector.

    The wide reduction rides :func:`block_stats`; only the ``[G]``
    partials are folded here, on the device.  ``argmin`` is a global
    index into ``values`` (undefined when ``count == 0``).
    """
    bp = max(min(int(block_points), values.shape[0]), 1)
    mins, amins, sums, counts = block_stats(values, mask, block_points=bp)
    g = torch.argmin(mins)
    return dict(min=mins[g], argmin=(g * bp + amins[g]).to(torch.int32),
                sum=torch.sum(sums), count=torch.sum(counts))
