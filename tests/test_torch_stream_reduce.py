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
    assert COUNTS == {"kernel_launches": 0, "twin_calls": 1,
                      "banked_kernel_launches": 0, "banked_twin_calls": 1}
