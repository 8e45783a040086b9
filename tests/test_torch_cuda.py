"""The CUDA megakernel against its torch twin, on the card.

Marked ``cuda``: without a CUDA device every test here skips (decided in
a fixture, never at import).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: ``cand_v`` rel 1e-6 and ``cand_l`` equal where finite (the
kernel keeps the twin's operation order, built with ``--fmad=false``);
``counts`` exact; ``sums`` rel 1e-5 (block sums add up to 4096 f32 terms
in another order).
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

GRIDS = {"variant": ["2d_in", "3d_in"],
         "cis_node": [130.0, 65.0, 28.0],
         "frame_rate": [15.0, 60.0, 2000.0],
         "sys_rows": [8.0, 32.0],
         "mem_tech": ["sram", "stt", "declared"],
         "vdd_scale": [0.9, 1.0],
         "adc_bits": [-1.0, 10.0],
         "pixel_pitch_um": [3.0, 5.0]}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused-sweep kernel is CUDA "
                    "C++ and has no CPU mode")
    return torch.device("cuda")


def _assert_close(ker, twin):
    kv, kl, ks, kc = (t.cpu().numpy() for t in ker)
    tv, tl, ts, tc = (t.cpu().numpy() for t in twin)
    np.testing.assert_array_equal(kc, tc)
    np.testing.assert_allclose(ks, ts, rtol=1e-5, atol=0)
    np.testing.assert_allclose(kv, tv, rtol=1e-6, atol=0)
    fin = np.isfinite(tv)
    np.testing.assert_array_equal(kl[fin], tl[fin])


@pytest.mark.parametrize("case", [
    dict(start=0, low=0, limit=None, chunk=None, bp=256, kk=4),
    dict(start=5, low=9, limit=200, chunk=250, bp=64, kk=5),
    dict(start=0, low=0, limit=None, chunk=40, bp=8, kk=12),
])
def test_kernel_matches_twin(cuda, case):
    from repro_torch.core.batch import build_coeff_compute
    from repro_torch.core.shard_sweep import _prepare_stream
    from repro_torch.kernels import fused_sweep as fs
    prep = _prepare_stream("edgaze", GRIDS, device=cuda)
    chunk = case["chunk"] or prep.n_var
    kw = dict(compute=build_coeff_compute(prep.bank.dims),
              metric="total_j", axis_names=tuple(prep.vgrids[0].names),
              shape=prep.vgrids[0].shape, n_var=prep.n_var,
              total=prep.total, chunk=chunk, lmax=prep.lmax,
              block_points=case["bp"], kk=case["kk"])
    limit = case["limit"] or prep.n_var
    args = (prep.table2, prep.bank.fused[0], case["start"], case["low"],
            limit)
    fs.reset_counts()
    ker = fs.fused_sweep_block(*args, **kw)
    torch.cuda.synchronize()
    assert fs.COUNTS == {"kernel_launches": 1, "twin_calls": 0}
    _assert_close(ker, fs.fused_sweep_block_torch(*args, **kw))


def test_kernel_matches_twin_synthetic_int64(cuda):
    from repro_torch.core.batch import build_coeff_compute
    from repro_torch.core.grid import ChunkedGrid, axis_tables, fused_table2
    from repro_torch.core.plan_bank import bank_from_reference
    from repro_torch.kernels import fused_sweep as fs
    from repro_torch.testing import synthetic_bank
    dims, fused = synthetic_bank(0)
    grid = ChunkedGrid({"cis_node": [130.0, 45.0], "soc_node": [22.0],
                        "mem_tech": [-1.0, 1.0, 2.0],
                        "sys_rows": [8.0, 64.0], "sys_cols": [16.0],
                        "frame_rate": [30.0, 3000.0],
                        "active_fraction_scale": [1.0],
                        "pixel_pitch_um": [3.0], "vdd_scale": [0.9, 1.1],
                        "adc_bits": [-1.0, 12.0]})
    table2 = torch.from_numpy(fused_table2(axis_tables([grid]))).to(cuda)
    row = bank_from_reference({"fused": fused}, dims, device=cuda).fused[0]
    n = len(grid)
    for idx_dtype, start in ((torch.int32, 0), (torch.int64, 0)):
        kw = dict(compute=build_coeff_compute(dims), metric="total_j",
                  axis_names=tuple(grid.names), shape=grid.shape, n_var=n,
                  total=n, chunk=n, lmax=3, block_points=32, kk=4,
                  idx_dtype=idx_dtype)
        ker = fs.fused_sweep_block(table2, row, start, 0, n, **kw)
        _assert_close(ker, fs.fused_sweep_block_torch(table2, row, start,
                                                      0, n, **kw))


def test_explore_on_cuda_matches_cpu(cuda):
    from repro_torch.explore import DesignSpace, explore
    space = DesignSpace(["edgaze", "rhythmic"], {
        k: v for k, v in GRIDS.items() if k != "variant"})
    gpu = explore(space, chunk_size=512, k=5)
    cpu = explore(space, chunk_size=512, k=5, device="cpu")
    assert gpu.backend == "cuda" and cpu.backend == "torch"
    assert (gpu.n_points, gpu.n_feasible) == (cpu.n_points, cpu.n_feasible)
    assert [(r["algorithm"], r["variant"], r["index"]) for r in gpu.topk] \
        == [(r["algorithm"], r["variant"], r["index"]) for r in cpu.topk]
    np.testing.assert_allclose([r["total_j"] for r in gpu.topk],
                               [r["total_j"] for r in cpu.topk], rtol=1e-6)
    assert gpu.cache["stream"]["kernel_launches"] > 0
