"""The port's ``block_stats`` (K3a) / ``block_stats_banked`` (K3b) twins
and ``masked_stats`` against the reference kernels.

The twins of ``repro_torch.kernels.stream_reduce`` against
``repro.kernels.stream_reduce`` (Pallas, interpret mode on the CPU, as
``tests/test_shard_sweep.py:67-106`` and ``tests/test_grid_decode.py``
run them) on the same seeded vectors: a ragged last block, an all-masked
block, exact ties (the first position wins), NaN (below every number:
the first NaN wins) and +-inf, and K3b on the run, interleaved and
single-variant id layouts with ids -1 and past ``V``.  Min and argmin
exact, counts exact, sums at rel 1e-5 (block sums add in another order).
The kernels run on the card only: their plans, and plain emulations of
their threads', CTAs' and tiles' work in the kernels' combine order, are
held here against the twins.
"""
import numpy as np
import pytest
import torch

from repro_torch.testing import STATS_LAYOUTS, stats_case


def _case(b, seed, n_variants=None, ties=False):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=b).astype(np.float32)
    if ties:                               # a few values, many repeats
        vals = rng.choice(np.float32([0.5, -1.25, 2.0]), size=b)
    mask = rng.uniform(size=b) > 0.3
    mask[128:256] = False                  # one all-masked block at bp=128
    vid = (rng.integers(0, n_variants, size=b).astype(np.int32)
           if n_variants else None)
    return vals, mask, vid


def _check(ours, ref):
    mins, amins, sums, counts = (np.asarray(t) for t in ours)
    rmins, ramins, rsums, rcounts = (np.asarray(t) for t in ref)
    assert mins.shape == rmins.shape and amins.dtype == np.int32
    np.testing.assert_array_equal(mins, rmins)
    np.testing.assert_array_equal(amins, ramins)
    np.testing.assert_array_equal(counts, rcounts)
    np.testing.assert_allclose(sums, rsums, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,bp,ties", [(1000, 128, False), (1000, 128, True),
                                       (4096, 4096, False), (77, 128, True)])
def test_block_stats_twin_matches_reference(b, bp, ties):
    import jax.numpy as jnp
    from repro.kernels import block_stats as ref_stats
    from repro_torch.kernels.stream_reduce import block_stats_torch
    vals, mask, _ = _case(b, seed=b + bp, ties=ties)
    ref = ref_stats(jnp.asarray(vals), jnp.asarray(mask), block_points=bp)
    ours = block_stats_torch(torch.from_numpy(vals), torch.from_numpy(mask),
                             block_points=bp)
    _check(ours, ref)
    if b > 256 and bp == 128:              # the all-masked block
        mins, amins, _sums, counts = (t.numpy() for t in ours)
        assert np.isinf(mins[1]) and amins[1] == 0 and counts[1] == 0


#: K3b's cases: V (1 to past one tile of 16) and the id layouts
BANKED_VARIANTS = (1, 3, 8, 17, 40)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n_variants", BANKED_VARIANTS)
@pytest.mark.parametrize("layout", STATS_LAYOUTS)
def test_block_stats_banked_twin_matches_reference(n_variants, layout, ties):
    """The twin against the reference's K3b (interpret mode) on every
    case of the kernel's emulation: NaN and +-inf, ties (``ties``: three
    values only), ids -1 and past V, an all-masked block and a ragged last
    one."""
    import jax.numpy as jnp
    from repro.kernels import block_stats_banked as ref_banked
    from repro_torch.kernels.stream_reduce import block_stats_banked_torch
    b, bp = 1000, 128
    vals, mask, vid = stats_case(b, bp, n_variants, layout, n_variants,
                                 ties=ties)
    ref = ref_banked(jnp.asarray(vals), jnp.asarray(mask), jnp.asarray(vid),
                     n_variants, block_points=bp)
    ours = block_stats_banked_torch(torch.from_numpy(vals),
                                    torch.from_numpy(mask),
                                    torch.from_numpy(vid), n_variants,
                                    block_points=bp)
    _check(ours, ref)
    assert tuple(ours[0].shape) == (8, n_variants)
    mins, amins, _sums, counts = (t.numpy() for t in ours)
    assert (counts[1] == 0).all() and np.isinf(mins[1]).all() \
        and (amins[1] == 0).all()
    assert np.isnan(mins).any()


def test_nan_and_inf_twins_match_reference():
    """F4's rule pinned on the case of its report: NaN is the min and the
    first NaN the argmin; a block of +inf and masked points gives min
    +inf, argmin 0; a NaN sum stays NaN."""
    import jax.numpy as jnp
    from repro.kernels import block_stats as ref_stats
    from repro.kernels import block_stats_banked as ref_banked
    from repro_torch.kernels.stream_reduce import (block_stats_banked_torch,
                                                   block_stats_torch)
    vals = np.float32([1, np.nan, 0.5, 2, np.inf, 3, np.nan, np.nan, -np.inf])
    mask = np.array([1, 1, 1, 1, 1, 0, 1, 1, 0], bool)
    vid = np.int32([0, 0, 1, 1, 5, -1, 1, 0, 1])
    ours = block_stats_torch(torch.from_numpy(vals), torch.from_numpy(mask),
                             3)
    _check(ours, ref_stats(jnp.asarray(vals), jnp.asarray(mask),
                           block_points=3))
    mins, amins, sums, _ = (t.numpy() for t in ours)
    assert np.isnan(mins[0]) and amins[0] == 1 and np.isnan(sums[0])
    assert mins[1] == 2 and amins[1] == 0
    assert np.isnan(mins[2]) and amins[2] == 0
    ours = block_stats_banked_torch(torch.from_numpy(vals),
                                    torch.from_numpy(mask),
                                    torch.from_numpy(vid), 2, 3)
    _check(ours, ref_banked(jnp.asarray(vals), jnp.asarray(mask),
                            jnp.asarray(vid), 2, block_points=3))
    mins, amins, _, counts = (t.numpy() for t in ours)
    np.testing.assert_array_equal(mins[0], [np.nan, 0.5])
    np.testing.assert_array_equal(amins[0], [1, 2])
    assert mins[1, 0] == np.inf and amins[1, 0] == 0 and counts[1, 0] == 0
    assert np.isnan(mins[2, 0]) and amins[2, 0] == 1
    assert np.isnan(mins[2, 1]) and amins[2, 1] == 0


def test_wrappers_cast_as_the_reference():
    """Values of another float dtype, an int8 or float mask and int64 ids
    are cast as the reference's ``astype`` casts them (a mask of 0.5 is 0
    after the cast to int32), on the CPU by the twins the wrappers run;
    the ``vec4`` routes' alignment is read from the cast operands."""
    import jax.numpy as jnp
    from repro.kernels import block_stats as ref_stats
    from repro.kernels import block_stats_banked as ref_banked
    from repro_torch.kernels import block_stats, block_stats_banked
    from repro_torch.kernels.stream_reduce import _operands, aligned
    vals, mask, vid = stats_case(777, 64, 5, "interleaved", 9)
    fmask = np.where(mask, np.float32(1.5), np.float32(0.5))
    fmask[::5] = -2.0
    for m in (mask.astype(np.int8), fmask):
        v64, vid64 = vals.astype(np.float64), vid.astype(np.int64)
        ours = block_stats_banked(torch.from_numpy(v64), torch.from_numpy(m),
                                  torch.from_numpy(vid64), 5, 64)
        _check(ours, ref_banked(jnp.asarray(vals), jnp.asarray(m),
                                jnp.asarray(vid), 5, block_points=64))
        _check(block_stats(torch.from_numpy(v64), torch.from_numpy(m), 64),
               ref_stats(jnp.asarray(vals), jnp.asarray(m),
                         block_points=64))
    v, ok, ids = _operands(torch.from_numpy(vals.astype(np.float64)),
                           torch.from_numpy(fmask),
                           torch.from_numpy(vid.astype(np.int64)))
    assert (v.dtype, ok.dtype, ids.dtype) == (torch.float32, torch.bool,
                                              torch.int32)
    np.testing.assert_array_equal(ok.numpy(), fmask.astype(np.int32) != 0)
    same = torch.from_numpy(vals), torch.from_numpy(mask), torch.from_numpy(
        vid)
    assert all(a is b for a, b in zip(_operands(*same), same))
    buf_v, buf_i = torch.zeros(65), torch.zeros(65, dtype=torch.int32)
    buf_m = torch.zeros(68, dtype=torch.bool)
    for off, want in ((0, True), (1, False)):
        assert aligned(buf_v[4 * off:][:64], buf_m[4 * off:][:64],
                       buf_i[:64]) is (buf_v.data_ptr() % 16 == 0
                                       and buf_i.data_ptr() % 16 == 0
                                       and buf_m.data_ptr() % 4 == 0)
        assert aligned(buf_v[off:][:64], buf_m[:64], buf_i[off:][:64]) \
            is (want and buf_v.data_ptr() % 16 == 0
                and buf_i.data_ptr() % 16 == 0
                and buf_m.data_ptr() % 4 == 0)


def test_masked_stats_matches_reference():
    import jax.numpy as jnp
    from repro.kernels import masked_stats as ref_masked
    from repro_torch.kernels import masked_stats
    vals, mask, _ = _case(777, seed=1)
    ref = {k: np.asarray(v) for k, v in ref_masked(
        jnp.asarray(vals), jnp.asarray(mask), block_points=64).items()}
    ours = {k: v.numpy() for k, v in masked_stats(
        torch.from_numpy(vals), torch.from_numpy(mask),
        block_points=64).items()}
    assert ours["min"] == ref["min"] and ours["argmin"] == ref["argmin"]
    assert ours["count"] == ref["count"]
    np.testing.assert_allclose(ours["sum"], ref["sum"], rtol=1e-5)


def test_wrappers_on_cpu_run_the_twins():
    from repro_torch.kernels import block_stats, block_stats_banked
    from repro_torch.kernels.stream_reduce import COUNTS, reset_counts
    vals, mask, vid = _case(300, seed=2, n_variants=2)
    reset_counts()
    block_stats(torch.from_numpy(vals), torch.from_numpy(mask), 64)
    block_stats_banked(torch.from_numpy(vals), torch.from_numpy(mask),
                       torch.from_numpy(vid), 2, 64)
    assert COUNTS == {"kernel_launches": 0, "vec4_launches": 0,
                      "scalar_launches": 0, "twin_calls": 1,
                      "banked_kernel_launches": 0,
                      "banked_vec4_launches": 0,
                      "banked_scalar_launches": 0, "banked_twin_calls": 1}


# ---------------------------------------------------------------------------
# K3a's plan and its cluster merge, emulated in plain torch (the kernel
# runs on the card only)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bp", [8, 32, 64, 256, 1024, 4096, 4099])
@pytest.mark.parametrize("b", [2 ** 18, 100_003, 50])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_covers_every_block(bp, b, aligned):
    from repro_torch.kernels.stream_reduce import STATS_THREADS, plan
    bp = min(bp, b)
    p = plan(b, bp, aligned, 132)
    assert p.cluster in (1, 2, 4, 8)
    assert p.cluster * p.rank_points >= bp
    assert (p.cluster - 1) * p.rank_points < bp       # no empty CTA
    assert p.ctas == -(-b // bp) * p.cluster
    assert p.route == ("vec4" if aligned and bp % 4 == 0 else "scalar")
    if p.route == "vec4":
        assert p.rank_points % 4 == 0
    if p.cluster > 1:                   # a vector for every thread
        assert p.rank_points >= 4 * STATS_THREADS


def test_plan_fills_the_card_at_the_main_path_shape():
    from repro_torch.kernels.stream_reduce import plan
    p = plan(2 ** 18, 4096, True, 132)
    assert p == ("vec4", 4, 1024, 256)
    assert plan(2 ** 18, 4096, False, 132).route == "scalar"


@pytest.mark.parametrize("cluster", [0, 3, 16])
def test_make_plan_refuses_past_the_caps(cluster):
    from repro_torch.kernels.stream_reduce import make_plan
    with pytest.raises(ValueError):
        make_plan(4096, 4096, cluster, True)


def _cluster_stats(vals, mask, bp, p):
    """K3a's reduction under plan ``p``: each rank's slice of a block
    reduced to (min, first argmin, sum, count), the slices combined
    lexicographically in rank order."""
    b = vals.shape[0]
    out = []
    for g in range(-(-b // bp)):
        best = (np.inf, None)
        s = c = 0.0
        for r in range(p.cluster):
            lo = g * bp + r * p.rank_points
            hi = min(g * bp + bp, lo + p.rank_points, b)
            first = r * p.rank_points
            if first >= bp:
                continue
            v = np.where(mask[lo:hi], vals[lo:hi], np.inf)
            if v.size and v.min() < np.inf:
                cand = (v.min(), first + int(np.argmin(v)))
            else:
                cand = (np.inf, first)
            if best[1] is None or cand[0] < best[0] or (
                    cand[0] == best[0] and cand[1] < best[1]):
                best = cand
            s += float(np.where(mask[lo:hi], vals[lo:hi], 0).sum())
            c += float(mask[lo:hi].sum())
        out.append((best[0], best[1], s, c))
    return [np.array(col) for col in zip(*out)]


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("b,bp", [(4096 * 3 + 17, 4096), (5003, 1024),
                                  (77, 128)])
def test_cluster_merge_emulation_equals_the_twin(cluster, b, bp):
    """Tie-heavy values (three of them), an all-masked block and ranks,
    a ragged tail: the slices' partials combined in rank order give the
    twin's min, first argmin and count exactly."""
    from repro_torch.kernels.stream_reduce import (block_stats_torch,
                                                   make_plan)
    vals, mask, _ = _case(b, seed=b + cluster, ties=True)
    bp = min(bp, b)
    mask[:bp] = False                           # an all-masked block
    p = make_plan(b, bp, cluster, True)
    mins, amins, sums, counts = _cluster_stats(vals, mask, bp, p)
    tm, ta, ts, tc = block_stats_torch(torch.from_numpy(vals),
                                       torch.from_numpy(mask), bp)
    np.testing.assert_array_equal(mins, tm.numpy())
    np.testing.assert_array_equal(amins, ta.numpy())
    np.testing.assert_array_equal(counts, tc.numpy())
    np.testing.assert_allclose(sums, ts.numpy(), rtol=1e-5, atol=1e-6)
    assert counts[0] == 0 and mins[0] == np.inf and amins[0] == 0


# ---------------------------------------------------------------------------
# K3b's plan and its work, emulated in plain numpy (the kernel runs on the
# card only)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bp", [8, 64, 512, 4096, 4099])
@pytest.mark.parametrize("b", [2 ** 18, 2 ** 24, 100_003, 50])
@pytest.mark.parametrize("n_variants", [1, 8, 16, 17, 40, 65535])
@pytest.mark.parametrize("aligned", [True, False])
def test_banked_plan_covers_every_block_and_variant(bp, b, n_variants,
                                                    aligned):
    from repro_torch.kernels.stream_reduce import (MAX_TILE, STATS_THREADS,
                                                   plan_banked)
    bp = min(bp, b)
    p = plan_banked(b, bp, n_variants, aligned, 132)
    assert p.cluster in (1, 2, 4, 8)
    assert p.cluster * p.rank_points >= bp
    assert (p.cluster - 1) * p.rank_points < bp       # no empty CTA
    assert 1 <= p.tile <= MAX_TILE
    assert (p.tiles - 1) * p.tile < n_variants <= p.tiles * p.tile
    assert p.tiles == -(-n_variants // MAX_TILE)      # the fewest tiles
    assert p.ctas == -(-b // bp) * p.cluster * p.tiles
    assert p.route == ("vec4" if aligned and bp % 4 == 0 else "scalar")
    if p.route == "vec4":
        assert p.rank_points % 4 == 0
    if p.cluster > 1:                   # a vector for every thread
        assert p.rank_points >= 4 * STATS_THREADS
        # the smallest cluster that gives 4 CTAs an SM
        assert p.ctas // 2 < 4 * 132


def test_banked_plan_at_the_measured_shapes():
    from repro_torch.kernels.stream_reduce import plan_banked
    assert plan_banked(2 ** 18, 4096, 8, True, 132) == (
        "vec4", 8, 512, 8, 1, 512)
    assert plan_banked(2 ** 18, 4096, 8, False, 132).route == "scalar"
    assert plan_banked(2 ** 24, 4096, 8, True, 132) == (
        "vec4", 1, 4096, 8, 1, 4096)
    assert plan_banked(512, 512, 8, True, 132) == ("vec4", 1, 512, 8, 1, 1)
    assert plan_banked(2 ** 18, 4096, 40, True, 132)[3:5] == (14, 3)


@pytest.mark.parametrize("kw", [dict(cluster=0), dict(cluster=3),
                                dict(cluster=16), dict(n_variants=0),
                                dict(n_variants=65536), dict(tile=0),
                                dict(tile=17)])
def test_make_banked_plan_refuses_past_the_caps(kw):
    from repro_torch.kernels.stream_reduce import make_banked_plan
    args = dict(b=4096, bp=4096, n_variants=8, cluster=1, aligned=True)
    args.update(kw)
    with pytest.raises(ValueError):
        make_banked_plan(**args)


def _key_less(v, p, ov, op):
    """The kernels' order, elementwise: by value with NaN first, then by
    position."""
    n, on = np.isnan(v), np.isnan(ov)
    return np.where(n | on, n & (~on | (p < op)),
                    (v < ov) | ((v == ov) & (p < op)))


def _nan_first_less(y, t):
    return (not np.isnan(t)) if np.isnan(y) else bool(y < t)


def _banked_emulation(vals, mask, vid, n_variants, bp, p):
    """K3b's work under plan ``p``, in the kernel's order and f32
    arithmetic: each thread walks its points (``vec4``: the vectors j =
    tid, tid + 128, ...; ``scalar``: the points) keeping a run of one id
    and merging it into its slot when the id changes (the first merge
    writes the slot whole; a slot never written folds as the identity);
    L lanes fold a
    variant's 128 slots (L = 32, 16 or 8 for up to 4, 8 or 16 variants a
    tile: 128 / L a lane in order, then shuffles down L / 2, ..., 1);
    rank 0 merges the ranks' partials in rank order; min +inf gives
    argmin 0.  The kernel's plain-order fold of a warp without NaN gives
    the same as this order."""
    threads = 128
    big = np.int64(2 ** 31 - 1)
    with np.errstate(invalid="ignore"):      # +inf + -inf is NaN, as there
        return _banked_work(vals, mask, vid, n_variants, bp, p, threads,
                            big)


def _banked_work(vals, mask, vid, n_variants, bp, p, threads, big):
    b = vals.shape[0]
    nb = -(-b // bp)
    out_m = np.zeros((nb, n_variants), np.float32)
    out_a = np.zeros((nb, n_variants), np.int32)
    out_s = np.zeros((nb, n_variants), np.float32)
    out_c = np.zeros((nb, n_variants), np.float32)
    for g in range(nb):
        for t in range(p.tiles):
            tile0 = t * p.tile
            nt = min(p.tile, n_variants - tile0)
            parts = []
            for rank in range(p.cluster):
                q0 = rank * p.rank_points
                base = g * bp + q0
                n_here = max(0, min(bp - q0, p.rank_points))
                n_live = max(0, min(n_here, b - base))
                s_m = np.full((nt, threads), np.inf, np.float32)
                s_a = np.full((nt, threads), big)
                s_s = np.zeros((nt, threads), np.float32)
                s_c = np.zeros((nt, threads), np.int64)

                written = set()

                def flush(r, tid):
                    if r is None:
                        return
                    w, mn, arg, sm, c = r
                    if (w, tid) not in written:     # the slot's first flush
                        written.add((w, tid))
                        s_m[w, tid], s_a[w, tid] = mn, arg
                        s_s[w, tid], s_c[w, tid] = sm, c
                        return
                    if _nan_first_less(mn, s_m[w, tid]):
                        s_m[w, tid], s_a[w, tid] = mn, arg
                    s_s[w, tid] = np.float32(s_s[w, tid] + sm)
                    s_c[w, tid] += c

                for tid in range(threads):
                    if p.route == "vec4":
                        qs = [q for j in range(tid, -(-n_live // 4), threads)
                              for q in range(4 * j, min(4 * j + 4, n_live))]
                    else:
                        qs = range(tid, n_live, threads)
                    r = None
                    for q in qs:
                        i = base + q
                        w = int(vid[i]) - tile0
                        if not mask[i] or not 0 <= w < nt:
                            continue
                        x = vals[i]
                        if r is not None and r[0] == w:
                            if _nan_first_less(x, r[1]):
                                r[1], r[2] = x, q0 + q
                            r[3] = np.float32(r[3] + x)
                            r[4] += 1
                        else:
                            flush(r, tid)
                            r = [w, x, q0 + q, x, 1]
                    flush(r, tid)
                # the fold: L = 32, 16 or 8 lanes a variant (nt up to 4,
                # 8, 16); lane l folds slots l, l + L, ... in order
                lanes = 8 if nt > 8 else 16 if nt > 4 else 32
                lm = np.full((nt, lanes), np.inf, np.float32)
                la = np.full((nt, lanes), big)
                ls = np.zeros((nt, lanes), np.float32)
                lc = np.zeros((nt, lanes), np.int64)
                for k in range(threads // lanes):
                    sl = slice(lanes * k, lanes * k + lanes)
                    take = _key_less(s_m[:, sl], s_a[:, sl], lm, la)
                    lm = np.where(take, s_m[:, sl], lm)
                    la = np.where(take, s_a[:, sl], la)
                    ls = ls + s_s[:, sl]
                    lc = lc + s_c[:, sl]
                o = lanes // 2
                while o:
                    om, oa = lm[:, o:2 * o], la[:, o:2 * o]
                    take = _key_less(om, oa, lm[:, :o], la[:, :o])
                    lm = np.where(take, om, lm[:, :o])
                    la = np.where(take, oa, la[:, :o])
                    ls = ls[:, :o] + ls[:, o:2 * o]
                    lc = lc[:, :o] + lc[:, o:2 * o]
                    o //= 2
                parts.append((lm[:, 0], la[:, 0], ls[:, 0], lc[:, 0]))
            bm, ba, bs, bc = parts[0]
            for om, oa, os_, oc in parts[1:]:
                take = _key_less(om, oa, bm, ba)
                bm, ba = np.where(take, om, bm), np.where(take, oa, ba)
                bs, bc = bs + os_, bc + oc
            cols = slice(tile0, tile0 + nt)
            out_m[g, cols] = bm
            out_a[g, cols] = np.where(bm == np.inf, 0, ba)
            out_s[g, cols] = bs
            out_c[g, cols] = bc
    return out_m, out_a, out_s, out_c


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("n_variants", BANKED_VARIANTS)
@pytest.mark.parametrize("layout", STATS_LAYOUTS)
def test_banked_emulation_equals_the_twin(cluster, n_variants, layout):
    """K3b's threads, CTAs and tiles, emulated, give the twin's min, first
    argmin and count exactly (sums rel 1e-5) on both routes: ties, NaN
    ties, +-inf, ids -1 and past V, an all-masked block, empty (block,
    variant) pairs and a ragged last block, on graded values and on three
    values only; a V past one tile also on tiles of 5."""
    from repro_torch.kernels.stream_reduce import (block_stats_banked_torch,
                                                   make_banked_plan)
    b, bp = 3 * 1024 + 77, 1024
    tiles = [None] + ([5] if n_variants > 16 else [])
    for ties in (False, True):
        vals, mask, vid = stats_case(b, bp, n_variants, layout,
                                       cluster + n_variants, ties)
        twin = [t.numpy() for t in block_stats_banked_torch(
            torch.from_numpy(vals), torch.from_numpy(mask),
            torch.from_numpy(vid), n_variants, bp)]
        assert np.isnan(twin[0]).any() and (twin[3] == 0).any()
        for route_aligned in (True, False):
            for tile in tiles:
                p = make_banked_plan(b, bp, n_variants, cluster,
                                     route_aligned, tile)
                ours = _banked_emulation(vals, mask, vid, n_variants, bp, p)
                _check(ours, twin)
