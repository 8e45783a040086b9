"""K2, K3a/K3b and K4 against their torch twins, and the staged and grid
engines on the card against the CPU.

Marked ``cuda``: without a CUDA device every test here skips (decided in
a fixture, never at import).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: ``grid_decode`` and ``category_reduce`` bit-equal (same
index arithmetic; same summation order, built with ``--fmad=false``);
block stats min / argmin / counts exact and sums rel 1e-5 (another
summation order); engines rel 1e-6 on the top-k metric.
"""
import importlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ and "
                    "have no CPU mode")
    return torch.device("cuda")


def _mod(name):
    return importlib.import_module(f"repro_torch.kernels.{name}")


@pytest.mark.parametrize("start,chunk,idx_dtype", [
    (0, 1000, torch.int32), (37, 4099, torch.int32),
    (130, 777, torch.int64)])
def test_grid_decode_matches_twin(cuda, start, chunk, idx_dtype):
    from repro_torch.core.shard_sweep import _prepare_stream
    gd = _mod("grid_decode")
    prep = _prepare_stream(["edgaze", "rhythmic"],
                           {"cis_node": [130.0, 65.0, 28.0],
                            "frame_rate": [15.0, 60.0],
                            "mem_tech": ["sram", "stt"]}, device=cuda)
    kw = dict(shape=prep.vgrids[0].shape, n_var=prep.n_var,
              total=prep.total, chunk=chunk, lmax=prep.lmax,
              idx_dtype=idx_dtype)
    gd.reset_counts()
    kv, kid = gd.grid_decode(prep.table2, start, **kw)
    torch.cuda.synchronize()
    assert gd.COUNTS == {"kernel_launches": 1, "twin_calls": 0}
    tv, tid = gd.grid_decode_torch(prep.table2, start, **kw)
    assert torch.equal(kv, tv) and torch.equal(kid, tid)


@pytest.mark.parametrize("n,bp", [(5000, 1024), (4096, 4096), (77, 128)])
def test_block_stats_match_twins(cuda, n, bp):
    sr = _mod("stream_reduce")
    rng = np.random.default_rng(n)
    vals = torch.from_numpy(rng.choice(np.float32([0.5, 1.25, 2.0]),
                                       n)).to(cuda)
    mask = torch.from_numpy(rng.uniform(size=n) > 0.3).to(cuda)
    mask[: min(bp, n)] = False                # an all-masked block
    vid = torch.from_numpy(rng.integers(-1, 3, n).astype(np.int32)).to(cuda)
    for ker, twin in (
            (sr.block_stats(vals, mask, bp),
             sr.block_stats_torch(vals, mask, bp)),
            (sr.block_stats_banked(vals, mask, vid, 3, bp),
             sr.block_stats_banked_torch(vals, mask, vid, 3, bp))):
        km, ka, ks, kc = (t.cpu().numpy() for t in ker)
        tm, ta, ts, tc = (t.cpu().numpy() for t in twin)
        np.testing.assert_array_equal(km, tm)
        np.testing.assert_array_equal(ka, ta)
        np.testing.assert_array_equal(kc, tc)
        np.testing.assert_allclose(ks, ts, rtol=1e-5, atol=0)


@pytest.mark.parametrize("b,u", [(1, 1), (1000, 6), (100_003, 11)])
def test_category_reduce_matches_twin(cuda, b, u):
    cr = _mod("category_reduce")
    rng = np.random.default_rng(b + u)
    e = torch.from_numpy(rng.uniform(1e-12, 1e-6, (b, u)).astype(
        np.float32)).to(cuda)
    w = torch.from_numpy((rng.uniform(size=(u, 10)) > 0.5).astype(
        np.float32)).to(cuda)
    cr.reset_counts()
    ker = cr.category_reduce(e, w)
    assert cr.COUNTS == {"kernel_launches": 1, "twin_calls": 0}
    assert torch.equal(ker, cr.category_reduce_torch(e, w))


@pytest.mark.parametrize("engine", ["staged", "monolithic", "chunked"])
def test_engines_on_cuda_match_cpu(cuda, engine):
    from repro_torch.explore import DesignSpace, explore
    space = DesignSpace(["edgaze", "rhythmic"],
                        {"cis_node": [130.0, 65.0, 28.0],
                         "frame_rate": [15.0, 60.0, 240.0],
                         "sys_rows": [8.0, 32.0],
                         "mem_tech": ["sram", "stt"]})
    kw = dict(engine=engine, k=5,
              chunk_size=None if engine == "monolithic" else 16)
    gpu = explore(space, **kw)
    cpu = explore(space, device="cpu", **kw)
    assert (gpu.engine, gpu.n_points, gpu.n_feasible, gpu.dispatches) \
        == (cpu.engine, cpu.n_points, cpu.n_feasible, cpu.dispatches)
    assert [(r["algorithm"], r["variant"], r["index"]) for r in gpu.topk] \
        == [(r["algorithm"], r["variant"], r["index"]) for r in cpu.topk]
    np.testing.assert_allclose([r["total_j"] for r in gpu.topk],
                               [r["total_j"] for r in cpu.topk], rtol=1e-6)
