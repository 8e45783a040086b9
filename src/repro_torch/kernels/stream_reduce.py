"""Per-block masked min / argmin / sum / count for the streaming reducer,
and their torch twins.

Port of the reference's K3a (``repro/kernels/stream_reduce.py::
_stats_kernel``) and K3b (``_stats_banked_kernel``).  A chunk's ``[B]``
metric vector is cut into blocks of ``block_points``; each block emits
its masked min, block-relative argmin (first occurrence), masked sum and
valid count.  Masked points and the padding of a ragged last block count
as +inf for the min and nothing for the sum and count, so an all-masked
block gives min +inf, argmin 0 and count 0 (``jnp.argmin``'s answer).
A NaN is below every number: it is the min, and the first NaN the
argmin, as ``jnp.argmin`` and ``torch.argmin`` have it.  K3b does the
same per (block, variant id), ``[G, V]``; padding rows carry variant -1,
and -1 and ids past ``V`` match no id.  Both take what the reference
takes: values of any real dtype (cast to f32), any mask (``!= 0`` after
the reference's cast to int32) and any integer ids (cast to int32).

* :func:`block_stats` / :func:`block_stats_banked` — wrappers around the
  hand-written CUDA kernels of ``repro_torch/csrc/stream_reduce.cu``.  For
  a CUDA tensor they launch the kernel or raise; for a CPU tensor they
  run the twin.  :func:`plan` spreads each of K3a's blocks over a cluster
  of 1-8 CTAs and picks its route, ``"vec4"`` (16-byte value and 4-byte
  mask loads, where bases and blocks are aligned) or ``"scalar"``;
  :func:`run` launches a forced :class:`Plan`.  :func:`plan_banked` does
  the same for K3b (16-byte ids too) and cuts ``V`` into tiles of at most
  :data:`MAX_TILE` variants; :func:`run_banked` launches a forced
  :class:`BankedPlan`.
* :func:`block_stats_torch` / :func:`block_stats_banked_torch` — the
  plain-torch twins.  Min and argmin agree with the kernel exactly; the
  sums add in another order (rel 1e-5 over a 4096-point block).
* :func:`masked_stats` — the global fold of :func:`block_stats`.

:data:`COUNTS` counts launches (each kernel's also by route) and twin
calls of each kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import torch

from .cuda_build import check_operands, launch, load_library, sm_count

#: K3a's cluster sizes (CTAs a block)
CLUSTER_CHOICES = (1, 2, 4, 8)
#: launches of the CUDA kernels (K3a's also by route) / calls of the torch
#: twins since the last :func:`reset_counts`
COUNTS: Dict[str, int] = {"kernel_launches": 0, "vec4_launches": 0,
                          "scalar_launches": 0, "twin_calls": 0,
                          "banked_kernel_launches": 0,
                          "banked_vec4_launches": 0,
                          "banked_scalar_launches": 0,
                          "banked_twin_calls": 0}
#: threads of a K3a or K3b CTA (the .cu source's kStatsThreads)
STATS_THREADS = 128
#: variants a K3b CTA keeps slots for (the .cu source's kMaxTile): ``V``
#: past it takes ``ceil(V / MAX_TILE)`` tiles, one pass over a block each
MAX_TILE = 16
#: ids K3b takes (the grid's y dimension holds the tiles)
MAX_VARIANTS = 65535
#: a plan takes the smallest cluster whose CTAs number at least this many
#: an SM, as long as each CTA keeps a 4-point vector for every thread.
#: On an H100 (chip_smoke.py's fused_probe line, vec4 at 2^18 points in
#: blocks of 4096; PERF.md) clusters of 1, 2 and 4 are within 5% of each
#: other.
_CTAS_PER_SM = 1
#: K3b's count: it folds 8-16 variants' slots a CTA after its scan, so
#: more, shorter CTAs hide more of that chain.  On an H100 (the
#: fused_probe line, vec4 at 2^18 points x 8 interleaved ids in blocks of
#: 4096; PERF.md) clusters of 8 (512 CTAs) beat 4 by 6% and 1 by 1.8x.
_BANKED_CTAS_PER_SM = 4

_LIB = {}


class Plan(NamedTuple):
    """How one K3a launch runs: its route, ``cluster`` CTAs a block,
    ``rank_points`` points of a block a CTA, ``ctas`` in all."""
    route: str
    cluster: int
    rank_points: int
    ctas: int


def make_plan(b: int, bp: int, cluster: int, aligned: bool) -> Plan:
    """The :class:`Plan` of ``[b]`` points in blocks of ``bp`` on
    clusters of ``cluster`` CTAs: ``"vec4"`` where ``aligned`` (values
    16-byte, mask 4-byte) and ``bp`` and each CTA's slice are whole
    4-point vectors, else ``"scalar"``; raises ``ValueError`` on a cluster
    size the kernel does not take."""
    if cluster not in CLUSTER_CHOICES:
        raise ValueError(f"cluster must be one of {CLUSTER_CHOICES}, got "
                         f"{cluster}")
    if b < 1 or bp < 1:
        raise ValueError(f"b and bp must be >= 1, got b={b}, bp={bp}")
    rank_points = -(-bp // cluster)
    vec = aligned and bp % 4 == 0
    if vec:
        rank_points = -(-rank_points // 4) * 4
    return Plan("vec4" if vec else "scalar", cluster, rank_points,
                -(-b // bp) * cluster)


def _cluster(units: int, bp: int, n_sm: int,
             per_sm: int = _CTAS_PER_SM) -> int:
    """The smallest cluster (1, 2, 4, 8) that gives ``units`` clusters'
    CTAs at least ``per_sm`` an SM, as long as each CTA keeps a 4-point
    vector for each of its threads (the largest such when none reaches
    that count)."""
    cluster = 1
    for c in CLUSTER_CHOICES[1:]:
        if units * cluster >= per_sm * n_sm \
                or -(-bp // c) < 4 * STATS_THREADS:
            break
        cluster = c
    return cluster


@functools.lru_cache(maxsize=None)
def plan(b: int, bp: int, aligned: bool, n_sm: int) -> Plan:
    """The plan for ``[b]`` points in blocks of ``bp`` on a card with
    ``n_sm`` SMs, on the cluster of :func:`_cluster`."""
    return make_plan(b, bp, _cluster(-(-b // max(bp, 1)), bp, n_sm),
                     aligned)


class BankedPlan(NamedTuple):
    """How one K3b launch runs: its route, ``cluster`` CTAs a block,
    ``rank_points`` points of a block a CTA, ``tile`` variants a CTA in
    ``tiles`` tiles, ``ctas`` in all."""
    route: str
    cluster: int
    rank_points: int
    tile: int
    tiles: int
    ctas: int


def make_banked_plan(b: int, bp: int, n_variants: int, cluster: int,
                     aligned: bool, tile: int = None) -> BankedPlan:
    """The :class:`BankedPlan` of ``[b]`` points in blocks of ``bp`` and
    ``n_variants`` ids on clusters of ``cluster`` CTAs: the route and
    slices of :func:`make_plan` (``aligned``: values and ids 16-byte, mask
    4-byte), and tiles of ``tile`` variants (by default the fewest tiles
    of at most :data:`MAX_TILE`, balanced); raises ``ValueError`` past
    the kernel's caps."""
    if not 1 <= n_variants <= MAX_VARIANTS:
        raise ValueError(f"n_variants must be in [1, {MAX_VARIANTS}], got "
                         f"{n_variants}")
    if tile is None:
        tile = -(-n_variants // -(-n_variants // MAX_TILE))
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"tile must be in [1, {MAX_TILE}], got {tile}")
    p = make_plan(b, bp, cluster, aligned)
    tiles = -(-n_variants // tile)
    return BankedPlan(p.route, cluster, p.rank_points, tile, tiles,
                      p.ctas * tiles)


@functools.lru_cache(maxsize=None)
def plan_banked(b: int, bp: int, n_variants: int, aligned: bool,
                n_sm: int) -> BankedPlan:
    """K3b's plan for ``[b]`` points in blocks of ``bp`` and
    ``n_variants`` ids on a card with ``n_sm`` SMs: balanced tiles of at
    most :data:`MAX_TILE` variants, and the cluster of :func:`_cluster`
    counting every tile's CTAs, ``_BANKED_CTAS_PER_SM`` an SM."""
    tiles = -(-n_variants // MAX_TILE)
    return make_banked_plan(
        b, bp, n_variants,
        _cluster(-(-b // max(bp, 1)) * tiles, bp, n_sm,
                 _BANKED_CTAS_PER_SM), aligned)


def reset_counts() -> None:
    """Zero the launch / twin-call counters."""
    for key in COUNTS:
        COUNTS[key] = 0


def _operands(values, mask, variant=None):
    """The reference's casts (``astype``): values to f32, the mask to
    int32 and then ``!= 0``, ids to int32; each copied only where its dtype
    differs."""
    if values.dtype != torch.float32:
        values = values.to(torch.float32)
    if mask.dtype != torch.bool:
        mask = mask.to(torch.int32) != 0
    if variant is not None and variant.dtype != torch.int32:
        variant = variant.to(torch.int32)
    return values, mask, variant


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
    v, ok, variant = _operands(values, mask, variant)
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
    v, ok, gid = _blocked(values, mask, bp, variant)
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
    lib.repro_block_stats.argtypes = [ptr, ptr, ll, i, i, i, i, ptr, ptr,
                                      ptr, ptr, ptr]
    lib.repro_block_stats.restype = ctypes.c_int
    lib.repro_block_stats_banked.argtypes = [ptr, ptr, ptr, ll, i, i, i, i,
                                             i, i, ptr, ptr, ptr, ptr, ptr]
    lib.repro_block_stats_banked.restype = ctypes.c_int
    _LIB["lib"] = lib
    return lib


def _cuda_inputs(values, mask, variant=None):
    """``(values, mask, variant)`` cast as the reference casts them, on the
    card; raises on anything else."""
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"block stats run on CUDA or CPU tensors, got "
                         f"{dev}")
    values, mask, variant = _operands(values, mask, variant)
    check_operands("block stats", dev, (torch.float32,), values=values)
    check_operands("block stats", dev, (torch.bool,), mask=mask)
    if variant is not None:
        check_operands("block stats", dev, (torch.int32,), variant=variant)
    return dev, values, mask, variant


def aligned(values, mask, variant=None) -> bool:
    """Whether the ``vec4`` routes may read these bases: values (and ids)
    16-byte aligned, the mask 4-byte."""
    return values.data_ptr() % 16 == 0 and mask.data_ptr() % 4 == 0 and (
        variant is None or variant.data_ptr() % 16 == 0)


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
    twin.  Values and mask are cast on the device as the reference casts
    them.
    """
    if values.device.type == "cpu":
        return block_stats_torch(values, mask, block_points)
    dev, values, mask, _ = _cuda_inputs(values, mask)
    b = _check(values, mask)
    if b == 0:
        raise ValueError("block_stats needs at least one point")
    bp = max(min(int(block_points), b), 1)
    return _launch(values, mask, plan(b, bp, aligned(values, mask),
                                      sm_count(dev)), b, bp, dev)


def run(values: torch.Tensor, mask: torch.Tensor, p: Plan,
        block_points: int = 4096):
    """Launch K3a under plan ``p`` (from :func:`plan` or
    :func:`make_plan`) on CUDA operands; the contract of
    :func:`block_stats`."""
    dev, values, mask, _ = _cuda_inputs(values, mask)
    b = _check(values, mask)
    bp = max(min(int(block_points), b), 1)
    if p.ctas != -(-b // bp) * p.cluster or p.cluster * p.rank_points < bp:
        raise ValueError(f"{p} is not a plan for {b} points in blocks of "
                         f"{bp}")
    return _launch(values, mask, p, b, bp, dev)


def _launch(values, mask, p: Plan, b: int, bp: int, dev):
    outs = _outputs((-(-b // bp),), dev)
    lib = load_kernel_library()
    launch("block_stats", lib.repro_block_stats, dev, values.data_ptr(),
           mask.data_ptr(), b, bp, p.cluster, p.rank_points,
           int(p.route == "vec4"), *(o.data_ptr() for o in outs))
    COUNTS[f"{p.route}_launches"] += 1
    COUNTS["kernel_launches"] += 1
    return outs


def block_stats_banked(values: torch.Tensor, mask: torch.Tensor,
                       variant: torch.Tensor, n_variants: int,
                       block_points: int = 4096):
    """Same contract as :func:`block_stats_banked_torch`; on a CUDA tensor
    it launches the kernel of :func:`plan_banked` or raises."""
    if values.device.type == "cpu":
        return block_stats_banked_torch(values, mask, variant, n_variants,
                                        block_points)
    dev, values, mask, variant = _cuda_inputs(values, mask, variant)
    b = _check(values, mask, variant)
    if b == 0:
        raise ValueError("block_stats_banked needs at least one point")
    bp = max(min(int(block_points), b), 1)
    p = plan_banked(b, bp, int(n_variants), aligned(values, mask, variant),
                    sm_count(dev))
    return _launch_banked(values, mask, variant, int(n_variants), p, b, bp,
                          dev)


def run_banked(values: torch.Tensor, mask: torch.Tensor,
               variant: torch.Tensor, n_variants: int, p: BankedPlan,
               block_points: int = 4096):
    """Launch K3b under plan ``p`` (from :func:`plan_banked` or
    :func:`make_banked_plan`) on CUDA operands; the contract of
    :func:`block_stats_banked`."""
    dev, values, mask, variant = _cuda_inputs(values, mask, variant)
    b = _check(values, mask, variant)
    bp = max(min(int(block_points), b), 1)
    nb = -(-b // bp)
    if p.ctas != nb * p.cluster * p.tiles \
            or p.cluster * p.rank_points < bp \
            or p.tiles != -(-int(n_variants) // p.tile):
        raise ValueError(f"{p} is not a plan for {b} points in blocks of "
                         f"{bp} and {n_variants} variants")
    return _launch_banked(values, mask, variant, int(n_variants), p, b, bp,
                          dev)


def _launch_banked(values, mask, variant, n_variants: int, p: BankedPlan,
                   b: int, bp: int, dev):
    outs = _outputs((-(-b // bp), n_variants), dev)
    lib = load_kernel_library()
    launch("block_stats_banked", lib.repro_block_stats_banked, dev,
           values.data_ptr(), mask.data_ptr(), variant.data_ptr(), b, bp,
           n_variants, p.cluster, p.rank_points, p.tile,
           int(p.route == "vec4"), *(o.data_ptr() for o in outs))
    COUNTS[f"banked_{p.route}_launches"] += 1
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
