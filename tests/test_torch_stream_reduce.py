"""The port's ``block_stats`` (K3a) / ``block_stats_banked`` (K3b) twins
and ``masked_stats`` against the reference kernels.

The twins of ``repro_torch.kernels.stream_reduce`` against
``repro.kernels.stream_reduce`` (Pallas, interpret mode on the CPU, as
``tests/test_shard_sweep.py:67-106`` and ``tests/test_grid_decode.py``
run them) on the same seeded vectors: a ragged last block, an all-masked
block, and exact ties (the first position wins).  Min and argmin exact,
counts exact, sums at rel 1e-5 (block sums add in another order).
"""
import numpy as np
import pytest
import torch


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


@pytest.mark.parametrize("ties", [False, True])
def test_block_stats_banked_twin_matches_reference(ties):
    import jax.numpy as jnp
    from repro.kernels import block_stats_banked as ref_banked
    from repro_torch.kernels.stream_reduce import block_stats_banked_torch
    vals, mask, vid = _case(1000, seed=3, n_variants=3, ties=ties)
    ref = ref_banked(jnp.asarray(vals), jnp.asarray(mask), jnp.asarray(vid),
                     3, block_points=128)
    ours = block_stats_banked_torch(torch.from_numpy(vals),
                                    torch.from_numpy(mask),
                                    torch.from_numpy(vid), 3,
                                    block_points=128)
    _check(ours, ref)
    assert tuple(ours[0].shape) == (8, 3)


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
                      "banked_kernel_launches": 0, "banked_twin_calls": 1}


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
