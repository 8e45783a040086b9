"""K2's kernel arithmetic on the CPU: the per-thread work of
``csrc/grid_decode.cu`` emulated in torch and held to the twin.

The kernel cannot run here, so :func:`_emulate` repeats what each of its
threads does, on int64 tensors with one lane a thread.  A thread owns
``POINTS`` consecutive positions (one on the scalar route) of one output
row: an axis, or the variant ids.  It decodes its first flat index,
clamped to ``total - 1``, once by the exact magic multipliers
(``repro_torch.testing.fdiv``, at the width ``index_bits`` gives): the
variant, the offset in it, its axis's digit (by ``decode_strides``) and
the positions left in the digit's run and in the variant.  Then it steps
those counts down, only while a position is at most ``total - 1``: the
end of the variant resets the digit and moves to the next variant, the
end of a run increments the digit (wrapping at the axis size), and the
value is re-read only there.  Both routes and both index widths must
equal ``grid_decode_torch`` exactly: at the int32 ceiling, across
variant boundaries, on int64 past 2^31, 2^32 and the end of the space,
at chunks of 1, 3, 4 and 4,099, from every start residue mod 4, with
axes of size 1 innermost, and with 1 and 16 axes.  :func:`plan`'s route
and grid choices are checked too.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.grid_decode import (POINTS, THREADS, Plan,
                                             decode_strides,
                                             grid_decode_torch, index_bits,
                                             plan)
from repro_torch.testing import fdiv

CAP = 1 << 30        # the kernel's cap on the counts it resets to


def _emulate(table2, start, *, shape, n_var, total, chunk, lmax, idx_dtype,
             route):
    """The kernel's ``(vals, vid)`` on ``route``, thread by thread."""
    bits = index_bits(n_var, idx_dtype)
    per = POINTS if route == "vec4" else 1
    assert chunk % per == 0
    last = total - 1
    first = torch.arange(0, chunk, per, dtype=torch.int64) + start
    live = torch.where(first > last, 1,
                       torch.clamp(last - first + 1, max=POINTS))
    oc = torch.clamp_max(first, last)
    v0 = fdiv(oc, n_var, bits)
    local = oc - v0 * n_var
    vals = torch.empty((len(shape), chunk), dtype=torch.float32)
    vids = torch.empty(chunk, dtype=torch.int32)
    strides = decode_strides(shape, n_var)
    for a in range(len(shape) + 1):
        v = v0.clone()
        to_var = torch.clamp(n_var - local, max=POINTS)
        if a < len(shape):
            size, stride, row = shape[a], strides[a], table2[a]
            q = fdiv(local, stride, bits)
            d = q - fdiv(q, size, bits) * size
            to_digit = torch.clamp(stride - (local - q * stride), max=POINTS)
            out = row[v * lmax + d]
        for j in range(per):
            if j > 0:
                step = j < live
                to_var = torch.where(step, to_var - 1, to_var)
                cross = step & (to_var == 0)
                to_var = torch.where(cross, min(n_var, CAP), to_var)
                v = v + cross.long()
            if a == len(shape):
                vids[j::per] = v.to(torch.int32)
                continue
            if j > 0:
                to_digit = torch.where(step & ~cross, to_digit - 1,
                                       to_digit)
                turn = step & ~cross & (to_digit == 0)
                to_digit = torch.where(cross | turn, min(stride, CAP),
                                       to_digit)
                d = torch.where(cross, 0, torch.where(
                    turn, torch.where(d + 1 == size, 0, d + 1), d))
                out = torch.where(cross | turn, row[v * lmax + d], out)
            vals[a, j::per] = out
    return vals, vids


def _table(shape, n_variants):
    """An axis table whose every entry names its own (axis, column):
    equal values mean equal indices."""
    lmax = max(shape)
    cols = n_variants * lmax
    return torch.arange(len(shape) * cols,
                        dtype=torch.float32).reshape(len(shape), cols), lmax


def _check_routes(shape, n_variants, start, chunk, idx_dtype):
    n_var = int(np.prod(shape))
    total = n_var * n_variants
    start = start % total
    if idx_dtype == torch.int32:
        assert total + chunk < 2 ** 31
    table2, lmax = _table(shape, n_variants)
    kw = dict(shape=shape, n_var=n_var, total=total, chunk=chunk, lmax=lmax,
              idx_dtype=idx_dtype)
    want = grid_decode_torch(table2, start, **kw)
    routes = ("vec4", "scalar") if chunk % POINTS == 0 else ("scalar",)
    for route in routes:
        got = _emulate(table2, start, route=route, **kw)
        assert torch.equal(got[1], want[1]), route
        assert torch.equal(got[0], want[0]), route


@pytest.mark.parametrize("shape,n_variants,start,chunk,idx_dtype", [
    # the int32 ceiling: one variant of 2,146,435,200 points, the chunk's
    # tail past total (clamped, inside a thread's run too) and total +
    # chunk just below 2^31
    ((13, 3, 3, 8, 6, 8, 5, 7, 1365, 1), 1, -3001, 5000, torch.int32),
    # runs across variant boundaries (the registry's size-1 innermost axis)
    ((13, 3, 3, 8, 6, 8, 5, 7, 2, 2), 8, 3 * 6_289_920 - 777, 5000,
     torch.int32),
    ((3, 2, 1), 5, 5, 24, torch.int32),
    # int64: variants of 6.75e9 points, offsets across 2^31, 2^32 and the
    # end of the space
    ((1500, 1500, 3, 1, 1, 1, 1, 1, 1000, 1), 3, 2 ** 32 - 3001, 5000,
     torch.int64),
    ((1500, 1500, 3, 1, 1, 1, 1, 1, 1000, 1), 3, 2 ** 31 - 102, 5000,
     torch.int64),
    ((1500, 1500, 3, 1, 1, 1, 1, 1, 1000, 1), 3, -3001, 5000, torch.int64),
    # int64 indices on a small grid, across its variants and past its end
    ((5, 3, 2), 4, 100, 40, torch.int64),
    # axes of size 1 innermost, between moving axes, and only
    ((3, 4, 1, 1), 3, 7, 36, torch.int32),
    ((5, 1, 2, 1), 2, 3, 24, torch.int32),
    ((1, 1), 3, 1, 8, torch.int32),
    # one axis; sixteen (the kernel's cap), two of them of size 1
    ((7,), 3, 4, 24, torch.int32),
    ((2, 3, 2, 1, 2, 2, 3, 2, 2, 1, 2, 2, 2, 3, 2, 2), 2, 1_000_001, 4099,
     torch.int32),
    ((2, 3, 2, 1, 2, 2, 3, 2, 2, 1, 2, 2, 2, 3, 2, 2), 2, -77, 4096,
     torch.int64),
])
def test_emulated_kernel_matches_twin(shape, n_variants, start, chunk,
                                      idx_dtype):
    _check_routes(shape, n_variants, start, chunk, idx_dtype)


@pytest.mark.parametrize("residue", [0, 1, 2, 3])
@pytest.mark.parametrize("chunk", [1, 3, 4, 4099])
def test_every_chunk_and_start_residue(chunk, residue):
    """Chunks of 1, 3, 4 and 4,099 from a start at each residue mod 4,
    across a variant boundary and past the end of the space."""
    shape = (4, 3, 1, 5)                        # n_var = 60
    for base in (56, 172, 240 - 4):
        _check_routes(shape, 4, base + residue, chunk, torch.int32)


def test_decode_strides_and_index_bits():
    assert decode_strides((13, 1, 3, 1), 39) == (3, 39, 1, 39)
    assert decode_strides((1, 1), 1) == (1, 1)
    assert decode_strides((7,), 7) == (1,)
    assert index_bits(100, torch.int32) == 32
    assert index_bits(100, torch.int64) == 64
    assert index_bits(2 ** 31, torch.int32) == 64   # no 32-bit multiplier


@pytest.mark.parametrize("chunk,aligned,want", [
    (2 ** 18, True, Plan("vec4", 256)),     # the main path
    (2 ** 18, False, Plan("scalar", 1024)),
    (4099, True, Plan("scalar", 17)),
    (4096, True, Plan("vec4", 4)),
    (4, True, Plan("vec4", 1)),
    (3, True, Plan("scalar", 1)),
    (100_000, True, Plan("vec4", 98)),
])
def test_plan_routes_and_grid(chunk, aligned, want):
    """vec4 where the chunk is whole 4-position vectors and the outputs
    aligned; blocks of THREADS threads that just cover the chunk."""
    p = plan(chunk, aligned)
    assert p == want
    per = POINTS if p.route == "vec4" else 1
    assert p.blocks * THREADS * per >= chunk > (p.blocks - 1) * THREADS * per
