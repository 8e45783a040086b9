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
