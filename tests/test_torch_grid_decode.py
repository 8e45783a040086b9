"""The port's ``grid_decode`` (K2) twin against the reference kernel.

``repro_torch.kernels.grid_decode.grid_decode_torch`` against
``repro.kernels.grid_decode.grid_decode`` (Pallas, interpret mode on the
CPU, as ``tests/test_grid_decode.py`` runs it) on the same seeded axis
tables: single-value axes, several variants, starts on non-divisible
tails and chunks running past ``total`` (clamped).  int32 decodes are
bit-equal to the reference's.  The reference's int64 path is broken on
the installed jax (ROADMAP R1), so the int64 decode past 2**31 is held
against the host oracle ``ChunkedGrid.point`` instead.
"""
import numpy as np
import pytest
import torch


def _grids(lengths, n_variants, value_seed):
    from repro_torch.core.grid import ChunkedGrid
    rng = np.random.default_rng(value_seed)
    return [ChunkedGrid({f"a{i}": rng.normal(size=n)
                         for i, n in enumerate(lengths)})
            for _ in range(n_variants)]


def _ours(grids, start, chunk, idx_dtype=torch.int32):
    from repro_torch.core.grid import axis_tables, fused_table2
    from repro_torch.kernels.grid_decode import grid_decode_torch
    tables = axis_tables(grids)
    n_var = len(grids[0])
    vals, vid = grid_decode_torch(
        torch.from_numpy(fused_table2(tables)), start,
        shape=grids[0].shape, n_var=n_var, total=len(grids) * n_var,
        chunk=chunk, lmax=tables.shape[2], idx_dtype=idx_dtype)
    return vals.numpy(), vid.numpy()


@pytest.mark.parametrize("lengths,n_variants,start_seed,count,seed", [
    ([3, 1, 2], 2, 4, 13, 0),              # tail past total, 1-axes
    ([1, 1], 3, 1, 7, 1),                  # all-singleton grid
    ([4, 3, 2, 2], 1, 17, 31, 2),          # non-divisible blocks
    ([5, 2, 3], 3, 88, 40, 3),             # crosses a variant boundary
])
def test_twin_matches_reference_kernel(lengths, n_variants, start_seed,
                                       count, seed):
    import jax.numpy as jnp
    from repro.core.sweep import ChunkedGrid as RefGrid
    from repro.core.sweep import axis_tables as ref_tables
    from repro.kernels.grid_decode import grid_decode as ref_decode
    grids = _grids(lengths, n_variants, seed)
    ref_grids = [RefGrid(dict(zip(g.names, g.values))) for g in grids]
    n_var = len(grids[0])
    total = n_variants * n_var
    start = start_seed % total
    rv, rvid = ref_decode(jnp.asarray(ref_tables(ref_grids)), start,
                          shape=grids[0].shape, n_var=n_var, total=total,
                          chunk=count, block_points=3)
    vals, vid = _ours(grids, start, count)
    assert vals.shape == (len(lengths), count) and vid.dtype == np.int32
    np.testing.assert_array_equal(vals, np.asarray(rv))
    np.testing.assert_array_equal(vid, np.asarray(rvid))


def test_twin_property_vs_reference_kernel():
    """Hypothesis over shapes, variant counts, starts and chunk lengths."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=10, deadline=None, derandomize=True)
    @hyp.given(st.tuples(st.lists(st.integers(1, 4), min_size=2,
                                  max_size=4),
                         st.integers(1, 3), st.integers(0, 200),
                         st.integers(1, 37), st.integers(0, 1000)))
    def run(params):
        test_twin_matches_reference_kernel(*params)

    run()


def test_int64_decode_beyond_int32_matches_host_oracle():
    """A chunk whose flat indices pass 2**31 (and clamp at the end)."""
    grids = _grids([1500, 1500, 1000], 1, 5)
    total = len(grids[0])
    assert total >= 2 ** 31
    start, chunk = total - 70, 100
    vals, vid = _ours(grids, start, chunk, idx_dtype=torch.int64)
    np.testing.assert_array_equal(vid, 0)
    for j in (0, 1, 37, 69, 70, 99):
        point = grids[0].point(min(start + j, total - 1))
        for a, name in enumerate(grids[0].names):
            assert vals[a, j] == np.float32(point[name]), (j, name)


def test_strides_and_wrapper_on_cpu():
    from repro_torch.kernels import grid_decode, grid_strides
    from repro_torch.kernels.grid_decode import COUNTS, reset_counts
    for shape in [(3,), (2, 5), (4, 1, 3), (2, 3, 4, 5)]:
        idx = np.arange(int(np.prod(shape)))
        multi = np.unravel_index(idx, shape)
        for a, stride in enumerate(grid_strides(shape)):
            np.testing.assert_array_equal((idx // stride) % shape[a],
                                          multi[a])
    reset_counts()
    vals, vid = grid_decode(torch.zeros(2, 6), 0, shape=(2, 3), n_var=6,
                            total=12, chunk=5, lmax=3)
    assert COUNTS == {"kernel_launches": 0, "vec4_launches": 0,
                      "scalar_launches": 0, "twin_calls": 1}
    assert tuple(vals.shape) == (2, 5) and tuple(vid.shape) == (5,)
