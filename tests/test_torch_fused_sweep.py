"""The port's fused-sweep twin matches the reference's XLA twin.

``repro_torch.kernels.fused_sweep.fused_sweep_block_torch`` against
``repro.kernels.fused_sweep_xla.fused_sweep_block_xla`` on the same axis
table and bank row, covering a chunk not divisible by the block, ``kk``
above the block size, a ``low`` cut inside the chunk, a ``limit`` before
the chunk end, and exact metric ties (``pixel_pitch_um`` does not enter
``total_j``, so points that differ only in pitch tie exactly).

Pass criteria (the reference's parity tolerance, rel 1e-6): ``cand_v``
at rel 1e-6; ``cand_l`` equal wherever ``cand_v`` is finite, except that
two candidates whose reference values lie within the tolerance of each
other may come in either order; ``counts`` exact; ``sums`` at rel 1e-6.
The CUDA kernel itself is held against this twin on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.testing import fdiv

REL = 1e-6

GRIDS = {"variant": ["2d_in", "3d_in"],
         "cis_node": [130.0, 65.0, 28.0],
         "frame_rate": [15.0, 60.0, 2000.0],
         "sys_rows": [8.0, 32.0],
         "pixel_pitch_um": [3.0, 5.0]}


def assert_blocks_equal(ours, ref, rel=REL):
    """(cand_v, cand_l, sums, counts) parity; near-ties may swap."""
    cv, cl, sums, counts = (np.asarray(t) for t in ours)
    rv, rl, rs, rc = (np.asarray(t) for t in ref)
    assert cv.shape == rv.shape and cl.shape == rl.shape
    np.testing.assert_array_equal(counts, rc)
    np.testing.assert_allclose(sums, rs, rtol=rel, atol=0)
    np.testing.assert_allclose(cv, rv, rtol=rel, atol=0)
    for g in range(rv.shape[0]):
        for j in np.flatnonzero(np.isfinite(rv[g])):
            if cl[g, j] == rl[g, j]:
                continue
            # accepted only as a near-tie: ours names a candidate the
            # reference also ranks, at a value within the tolerance
            other = np.flatnonzero(rl[g] == cl[g, j])
            assert other.size and np.isclose(rv[g, other[0]], rv[g, j],
                                             rtol=rel, atol=0), (g, j)


@pytest.fixture(scope="module")
def prepared():
    from repro.core.batch import build_coeff_compute as ref_compute
    from repro_torch.core.batch import build_coeff_compute
    from repro_torch.core.shard_sweep import _prepare_stream
    prep = _prepare_stream("edgaze", GRIDS, device="cpu")
    from repro.core.plan_bank import BankDims
    return dict(prep=prep, compute=build_coeff_compute(prep.bank.dims),
                ref_compute=ref_compute(BankDims(*prep.bank.dims),
                                        exact=True))


def _run_both(p, *, start, low, limit, chunk, bp, kk, variant=0,
              metric="total_j"):
    import jax.numpy as jnp
    from repro.kernels.fused_sweep_xla import fused_sweep_block_xla
    from repro_torch.kernels.fused_sweep import fused_sweep_block_torch
    prep = p["prep"]
    kw = dict(metric=metric, axis_names=tuple(prep.vgrids[0].names),
              shape=prep.vgrids[0].shape, n_var=prep.n_var,
              total=prep.total, chunk=chunk, lmax=prep.lmax,
              block_points=bp, kk=kk)
    row = prep.bank.fused[variant]
    ours = fused_sweep_block_torch(prep.table2, row, start, low, limit,
                                   compute=p["compute"], **kw)
    ref = fused_sweep_block_xla(jnp.asarray(prep.table2.numpy()),
                                jnp.asarray(row.numpy()), start, low, limit,
                                compute=p["ref_compute"], **kw)
    return ours, ref


def test_twin_matches_reference_ragged_masked_chunk(prepared):
    """chunk 50 over blocks of 16 (ragged last block), low inside the
    chunk, limit before its end, in the second variant; the pitch axis
    makes exact ties."""
    n_var = prepared["prep"].n_var
    start = n_var + 7
    ours, ref = _run_both(prepared, start=start, low=start + 5,
                          limit=start + 41, chunk=50, bp=16, kk=5,
                          variant=1)
    assert_blocks_equal(ours, ref)
    counts = ours[3].numpy()
    assert 0 < counts.sum() <= 36            # masked by low and limit
    cv = ours[0].numpy()
    assert np.any(cv[:, 1:] == cv[:, :-1])   # exact ties occurred


def test_twin_matches_reference_kk_above_block(prepared):
    ours, ref = _run_both(prepared, start=0, low=0,
                          limit=prepared["prep"].n_var, chunk=10, bp=4,
                          kk=6)
    assert_blocks_equal(ours, ref)
    assert np.isinf(ours[0].numpy()[:, 4:]).all()     # padding contract


def test_twin_matches_reference_other_metric_and_tail(prepared):
    """A metric that keeps infeasible-sensitive values (density) on the
    last chunk of the space, whose tail clamps to total - 1."""
    prep = prepared["prep"]
    start = prep.total - 20
    ours, ref = _run_both(prepared, start=start, low=0, limit=prep.total,
                          chunk=32, bp=8, kk=3, variant=1,
                          metric="density_mw_mm2")
    assert_blocks_equal(ours, ref)
    assert ours[3].numpy().sum() <= 20


def test_twin_matches_reference_synthetic_row():
    """The synthetic L=2 / D=3 row through both twins."""
    import jax.numpy as jnp
    from repro.core.batch import build_coeff_compute as ref_compute
    from repro.core.plan_bank import BankDims
    from repro.kernels.fused_sweep_xla import fused_sweep_block_xla
    from repro_torch.core.batch import build_coeff_compute
    from repro_torch.core.grid import axis_tables, fused_table2
    from repro_torch.core.grid import ChunkedGrid
    from repro_torch.core.plan_bank import bank_from_reference
    from repro_torch.kernels.fused_sweep import fused_sweep_block_torch
    from repro_torch.testing import synthetic_bank
    dims, fused = synthetic_bank(0)
    grid = ChunkedGrid({"cis_node": [130.0, 45.0], "soc_node": [22.0],
                        "mem_tech": [-1.0, 2.0], "sys_rows": [8.0, 64.0],
                        "sys_cols": [16.0], "frame_rate": [30.0, 500.0],
                        "active_fraction_scale": [1.0],
                        "pixel_pitch_um": [3.0], "vdd_scale": [0.9, 1.1],
                        "adc_bits": [-1.0, 12.0]})
    table2 = fused_table2(axis_tables([grid]))
    bank = bank_from_reference({"fused": fused}, dims, device="cpu")
    kw = dict(metric="total_j", axis_names=tuple(grid.names),
              shape=grid.shape, n_var=len(grid), total=len(grid),
              chunk=len(grid), lmax=2, block_points=16, kk=4)
    ours = fused_sweep_block_torch(torch.from_numpy(table2), bank.fused[0],
                                   0, 0, len(grid),
                                   compute=build_coeff_compute(dims), **kw)
    ref = fused_sweep_block_xla(jnp.asarray(table2), jnp.asarray(fused[0]),
                                0, 0, len(grid),
                                compute=ref_compute(BankDims(*dims),
                                                    exact=True), **kw)
    assert_blocks_equal(ours, ref)


def test_twin_matches_reference_wide_synthetic_row():
    """The wide synthetic row (every dim past four slots: the kernel's
    16-slot instantiation) through both twins."""
    import jax.numpy as jnp
    from repro.core.batch import build_coeff_compute as ref_compute
    from repro.core.plan_bank import BankDims
    from repro.kernels.fused_sweep_xla import fused_sweep_block_xla
    from repro_torch.core.batch import build_coeff_compute
    from repro_torch.core.grid import ChunkedGrid, axis_tables, fused_table2
    from repro_torch.core.plan_bank import bank_from_reference
    from repro_torch.kernels.fused_sweep import fused_sweep_block_torch
    from repro_torch.testing import synthetic_wide_bank
    dims, fused = synthetic_wide_bank(0)
    grid = ChunkedGrid(WIDE_GRID)
    table2 = fused_table2(axis_tables([grid]))
    bank = bank_from_reference({"fused": fused}, dims, device="cpu")
    kw = dict(metric="total_j", axis_names=tuple(grid.names),
              shape=grid.shape, n_var=len(grid), total=len(grid),
              chunk=len(grid), lmax=max(grid.shape), block_points=32, kk=4)
    ours = fused_sweep_block_torch(torch.from_numpy(table2), bank.fused[0],
                                   0, 0, len(grid),
                                   compute=build_coeff_compute(dims), **kw)
    ref = fused_sweep_block_xla(jnp.asarray(table2), jnp.asarray(fused[0]),
                                0, 0, len(grid),
                                compute=ref_compute(BankDims(*dims),
                                                    exact=True), **kw)
    assert_blocks_equal(ours, ref)
    assert ours[3].numpy().sum() > 0


#: the axes of the wide synthetic row's grid: every role's node moves
WIDE_GRID = {"cis_node": [130.0, 45.0], "soc_node": [22.0, 14.0],
             "mem_tech": [-1.0, 1.0, 2.0], "sys_rows": [8.0, 64.0],
             "sys_cols": [16.0], "frame_rate": [30.0, 3000.0],
             "active_fraction_scale": [1.0], "pixel_pitch_um": [3.0],
             "vdd_scale": [0.9, 1.1], "adc_bits": [-1.0, 6.0, 12.0]}


# ---------------------------------------------------------------------------
# the CUDA kernel's plan, its division-free decode and its cluster merge,
# emulated here in plain torch (the kernel itself runs on the card only)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bp", [8, 32, 64, 256, 1024, 4096, 8200, 16384,
                                2 ** 18])
@pytest.mark.parametrize("kk", [1, 3, 16, 32])
@pytest.mark.parametrize("chunk", [2 ** 22, 2 ** 18, 100_003, 50])
def test_plan_covers_every_block(bp, kk, chunk):
    from repro_torch.kernels.fused_sweep import MAX_TILE, THREADS, plan
    bp = min(bp, chunk)
    p = plan(bp, kk, chunk, 132)
    assert p.cluster in (1, 2, 4, 8)
    assert p.cluster * p.rank_points >= bp
    assert (p.cluster - 1) * p.rank_points < bp      # no empty CTA
    assert p.tile == min(p.rank_points, MAX_TILE)
    assert p.ppt * THREADS >= p.tile
    # one pass a CTA wherever a cluster can give it one
    assert p.rank_points <= MAX_TILE or p.cluster == 8
    assert (p.kw, p.kc, p.kout) == (min(kk, 32 * p.ppt),
                                    min(kk, p.rank_points), min(kk, bp))
    assert p.ctas == -(-chunk // bp) * p.cluster
    if bp <= 256:                       # the tests' blocks: one CTA each
        assert p.cluster == 1
    if p.cluster > 1:                   # a point for every thread
        assert p.rank_points >= THREADS


#: the mega sweep's axis sizes (benchmarks/run.py's grid, AXES order)
MEGA_SHAPE = (13, 3, 3, 8, 6, 8, 5, 7, 1, 1)


def test_plan_fills_the_card_at_the_main_path_shape():
    from repro_torch.core.plan_bank import BankDims
    from repro_torch.kernels.fused_sweep import _MAX_SMEM, plan, staging
    p = plan(4096, 3, 2 ** 18, 132)
    assert (p.cluster, p.rank_points, p.tile, p.ppt, p.ctas) \
        == (4, 1024, 1024, 4, 256)
    assert p.ctas >= 132
    assert plan(4096, 16, 2 ** 18, 132).cluster == 4
    # a chunk that is one block still spreads it over 8 CTAs
    assert plan(4096, 3, 4096, 132).cluster == 8
    # blocks of 1024 keep at least a point a thread: clusters of 4 at most
    assert plan(1024, 3, 2 ** 22, 132).rank_points >= 256
    # the mega sweep's row (W = 239), F = 1, variants of 1.57e6 points:
    # one pass of the tile, the timing tabled, two CTAs an SM
    st = staging(239, BankDims(8, 2, 0, 1, 4, 3), MEGA_SHAPE,
                 int(np.prod(MEGA_SHAPE)), 8, p)
    assert (st.span, st.nv, st.tim) == (1024, 2, True)
    assert 2 * 4 * st.smem < _MAX_SMEM


@pytest.mark.parametrize("bp,chunk,cluster,passes", [
    (16384, 2 ** 22, 2, 1),          # 256 blocks: clusters of 2, 8192 a CTA
    (8200, 8200 * 132, 2, 1),
    (2 ** 18, 2 ** 18, 8, 4),        # one block a chunk: 32768 a CTA
    (2 ** 20, 2 ** 22, 8, 16),
])
def test_plan_takes_blocks_past_one_tile(bp, chunk, cluster, passes):
    """Blocks whose CTAs hold more than a tile run in passes, on the
    cluster the plan picks and on a forced cluster of 1."""
    from repro_torch.core.plan_bank import BankDims
    from repro_torch.kernels.fused_sweep import (MAX_TILE, make_plan, plan,
                                                 staging)
    dims = BankDims(8, 2, 0, 1, 4, 3)
    for p in (plan(bp, 16, chunk, 132), make_plan(bp, 16, chunk, 1)):
        st = staging(239, dims, MEGA_SHAPE, int(np.prod(MEGA_SHAPE)), 8, p)
        assert st.span == p.tile == min(p.rank_points, MAX_TILE)
        assert -(-p.rank_points // st.span) \
            == (passes if p.cluster > 1 else -(-bp // MAX_TILE))
    assert plan(bp, 16, chunk, 132).cluster == cluster


@pytest.mark.parametrize("args", [
    dict(bp=4096, kk=3, chunk=4096, cluster=3),
    dict(bp=4096, kk=3, chunk=4096, cluster=16),
    dict(bp=0, kk=3, chunk=4096, cluster=1),
    dict(bp=4096, kk=3, chunk=0, cluster=8),
    dict(bp=4096, kk=0, chunk=4096, cluster=8),
])
def test_make_plan_refuses_past_the_caps(args):
    from repro_torch.kernels.fused_sweep import make_plan
    with pytest.raises(ValueError):
        make_plan(**args)


def _shape(**sizes):
    """Registry-order axis sizes, 1 but for ``sizes``."""
    from repro_torch.core.axes import AXES
    return tuple(sizes.get(a, 1) for a in AXES)


def test_params_refuse_what_shared_memory_cannot_hold():
    """Two variants whose cis_node and soc_node axes hold 3,000 values
    each: a pass that straddles them needs their node tables (4 kinds of
    each value) beside their axis values, past one block's 227 KiB."""
    from repro_torch.core.plan_bank import BankDims
    from repro_torch.kernels.fused_sweep import _static_params, make_plan
    dims = BankDims(1, 2, 0, 1, 4, 3)
    p = make_plan(4096, 3, 4096, 8)
    _static_params(dims, "total_j", _shape(cis_node=300, soc_node=300),
                   90_000, 180_000, 4096, 300, 600, 4096, 3, p)
    with pytest.raises(ValueError, match="shared"):
        _static_params(dims, "total_j", _shape(cis_node=3000,
                                               soc_node=3000),
                       9_000_000, 18_000_000, 4096, 3000, 6000, 4096, 3, p)


@pytest.mark.parametrize("sizes,n_variants,shrunk", [
    # tables the whole-table layout took (10 V lmax + W words fit):
    (dict(cis_node=10), 570, False),         # 5,700 columns
    (dict(cis_node=1000), 5, False),
    (dict(cis_node=5000), 1, False),
    (dict(frame_rate=2800, pixel_pitch_um=2), 2, False),
    # and past it: passes shorter than the tile, each reaching 9 variants
    (dict(cis_node=1000), 20, True),
    (dict(frame_rate=1000, sys_rows=32, sys_cols=32), 400, False),
])
def test_staging_takes_wide_tables(sizes, n_variants, shrunk):
    """Passes reach few variants, so the tables a CTA stages scale with
    the axis sizes and not with the number of variants; a pass is cut
    short only when the variants a whole tile may reach do not fit."""
    from repro_torch.core.plan_bank import BankDims
    from repro_torch.kernels.fused_sweep import (_MAX_SMEM, make_plan,
                                                 staging)
    dims = BankDims(1, 2, 0, 1, 4, 3)
    shape = _shape(**sizes)
    n_var = int(np.prod(shape))
    p = make_plan(8192, 16, 8192 * 40, 1)
    st = staging(239, dims, shape, n_var, n_variants, p)
    assert 4 * st.smem <= _MAX_SMEM
    assert (st.span < p.tile) == shrunk
    assert st.nv == min(n_variants, (st.span - 1) // n_var + 2)
    if shrunk:
        assert st.span % n_var == 0 and st.nv == st.span // n_var + 1


def _divfree_decode(table2, start, *, shape, n_var, total, chunk, lmax,
                    idx_dtype):
    """The kernel's decode in torch: the flat index clamped to total - 1,
    the variant by n_var's magic multiplier, then the digits innermost
    first by each axis size's; ``(vals, vid)`` as ``grid_decode_torch``."""
    bits = 32 if idx_dtype == torch.int32 else 64
    off = torch.arange(chunk, dtype=torch.int64) + start
    off = torch.clamp_max(off, total - 1)
    vid = fdiv(off, n_var, bits)
    local = off - vid * n_var
    cols = [None] * len(shape)
    for a in range(len(shape) - 1, 0, -1):
        q = fdiv(local, shape[a], bits)
        cols[a] = local - q * shape[a]
        local = q
    cols[0] = local
    vals = torch.stack([table2[a].index_select(0, vid * lmax + cols[a])
                        for a in range(len(shape))])
    return vals, vid.to(torch.int32)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 10, 13, 1000, 4096, 65_537,
                               1_572_480, 2 ** 31 - 1])
def test_magic_division_is_exact_at_the_edges(d):
    """Quotients of the magic multipliers equal floor division at every
    multiple's edge near 0, near d and near each dividend ceiling."""
    bits_max = {32: 2 ** 31 - 1, 64: 2 ** 63 - 1}
    for bits, top in bits_max.items():
        ns = {0, 1, d - 1, d, d + 1, 2 * d - 1, 2 * d, top, top - 1,
              top - d, (top // d) * d, (top // d) * d - 1}
        ns |= {k * d + e for k in (3, 1000, 123_457) for e in (-1, 0, 1)}
        ns = sorted(n for n in ns if 0 <= n <= top)
        n = torch.tensor(ns, dtype=torch.int64)
        assert fdiv(n, d, bits).tolist() == [x // d for x in ns], (bits, d)


@pytest.mark.parametrize("shape,n_variants,start,idx_dtype", [
    # the int32 ceiling: one variant of 2,146,435,200 points, the chunk's
    # tail past total (clamped) and total + chunk just below 2^31
    ((13, 3, 3, 8, 6, 8, 5, 7, 1365, 1), 1, -3000, torch.int32),
    # across a variant boundary
    ((13, 3, 3, 8, 6, 8, 5, 7, 2, 2), 8, 3 * 6_289_920 - 777, torch.int32),
    # int64: variants of 6.75e9 points, offsets across 2^31, 2^32 and the
    # end of the space
    ((1500, 1500, 3, 1, 1, 1, 1, 1, 1000, 1), 3, 2 ** 32 - 3000,
     torch.int64),
    ((1500, 1500, 3, 1, 1, 1, 1, 1, 1000, 1), 3, 2 ** 31 - 100,
     torch.int64),
    ((1500, 1500, 3, 1, 1, 1, 1, 1, 1000, 1), 3, -3000, torch.int64),
])
def test_divfree_decode_matches_grid_decode_torch(shape, n_variants, start,
                                                  idx_dtype):
    from repro_torch.kernels.grid_decode import grid_decode_torch
    n_var = int(np.prod(shape))
    total = n_var * n_variants
    start = start % total
    if idx_dtype == torch.int32:
        assert total + 5000 < 2 ** 31
    lmax = max(shape)
    # each table entry names its own (axis, column): equal values mean
    # equal indices
    cols = n_variants * lmax
    table2 = torch.arange(len(shape) * cols,
                          dtype=torch.float32).reshape(len(shape), cols)
    kw = dict(shape=shape, n_var=n_var, total=total, chunk=5000, lmax=lmax,
              idx_dtype=idx_dtype)
    want = grid_decode_torch(table2, start, **kw)
    got = _divfree_decode(table2, start, **kw)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


def _lex_least(v: np.ndarray, q: np.ndarray, n: int):
    """The n least (value, position) pairs, padded with the kernel's
    sentinel (+inf, INT32_MAX)."""
    order = np.lexsort((q, v))[:n]
    out_v = np.full(n, np.inf, np.float32)
    out_q = np.full(n, np.iinfo(np.int32).max, np.int64)
    out_v[:order.size], out_q[:order.size] = v[order], q[order]
    return out_v, out_q


def _cluster_merge(masked: np.ndarray, p, kk: int, span=None):
    """The kernel's reduction of one ``(bp,)`` block under plan ``p``:
    each rank's points taken in passes of ``span`` (the plan's tile by
    default), each pass's points split over its warps (thread t holds
    pass positions i * 256 + t), each warp's kw least, the CTA's kc least
    of its warps' lists and its running list, the block's kout least of
    its CTAs' lists, the sentinel written as (+inf, 0) and padded to
    kk."""
    from repro_torch.kernels.fused_sweep import THREADS
    bp = masked.shape[0]
    span = span or p.tile
    empty = np.zeros(0, np.float32), np.zeros(0, np.int64)
    cta_v, cta_q = [], []
    for r in range(p.cluster):
        q0 = r * p.rank_points
        n_here = max(0, min(bp - q0, p.rank_points))
        run_v, run_q = _lex_least(*empty, p.kc)
        for p0 in range(0, n_here, span):
            n_pass = min(span, n_here - p0)
            wv, wq = [run_v], [run_q]
            for w in range(THREADS // 32):
                qr = (np.arange(p.ppt)[:, None] * THREADS + w * 32
                      + np.arange(32)[None, :]).ravel()
                qr = q0 + p0 + qr[qr < n_pass]
                lv, lq = _lex_least(masked[qr], qr, p.kw)
                wv.append(lv)
                wq.append(lq)
            run_v, run_q = _lex_least(np.concatenate(wv),
                                      np.concatenate(wq), p.kc)
        cta_v.append(run_v)
        cta_q.append(run_q)
    v, q = _lex_least(np.concatenate(cta_v), np.concatenate(cta_q), p.kout)
    q = np.where(q == np.iinfo(np.int32).max, 0, q)
    pad = kk - p.kout
    return (np.concatenate([v, np.full(pad, np.inf, np.float32)]),
            np.concatenate([q, np.zeros(pad, np.int64)]).astype(np.int32))


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("bp,kk,span", [
    (4096, 3, None), (4096, 16, None), (1024, 32, None), (1000, 16, None),
    (256, 1, None), (8, 16, None), (40, 64, None), (3000, 8, None),
    # passes: blocks past a tile, and passes cut short of it
    (20_000, 16, None), (20_000, 32, 3000), (9000, 3, 1000)])
def test_cluster_merge_emulation_equals_the_twins_stable_sort(cluster, bp,
                                                              kk, span):
    """Tie-heavy blocks (three values and +inf, equal runs straddling the
    slice and pass edges), one all-masked slice, ``kk`` above ``bp``: the
    kernel's lexicographic merges (warps, a CTA's passes, the cluster)
    give the twin's stable sort, padding positions included."""
    from repro_torch.kernels.fused_sweep import make_plan
    p = make_plan(bp, kk, bp, cluster)
    span = min(span or p.tile, p.tile)
    rng = np.random.default_rng(bp * 64 + kk + cluster)
    masked = rng.choice(np.float32([0.5, 1.25, 2.0, np.inf]), bp)
    masked[: p.rank_points] = np.inf                  # an all-masked slice
    for edge in (p.rank_points, p.rank_points + span):  # ties across edges
        masked[max(edge - 3, 0): edge + 3] = 0.25
    got_v, got_q = _cluster_merge(masked, p, kk, span)
    want_v, want_q = torch.sort(torch.from_numpy(masked), stable=True)
    want_v, want_q = want_v[:kk].numpy(), want_q[:kk].numpy()
    if kk > bp:
        want_v = np.concatenate([want_v, np.full(kk - bp, np.inf)])
        want_q = np.concatenate([want_q, np.zeros(kk - bp, np.int64)])
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_q, want_q)
