"""K2, K3a/K3b, K4 and K5-K8 against their torch twins, and the staged
and grid engines and the functional pipelines on the card against the
CPU.

Marked ``cuda``: without a CUDA device every test here skips (decided in
a fixture, never at import).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: ``grid_decode`` and ``category_reduce`` bit-equal (same
index arithmetic; same summation order, built with ``--fmad=false``);
block stats min / argmin / counts exact and sums rel 1e-5 (another
summation order); engines rel 1e-6 on the top-k metric.  ``binning``,
``stencil_conv`` and ``frame_event`` bit-equal (same order); ``matmul``
within ``1e-5 * (|a| @ |b|)`` elementwise (another summation order) and
the same from run to run; the pipelines bit-equal to the CPU's, the DNN
output by the matmul rule through both layers.
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


# ---------------------------------------------------------------------------
# K5-K8, the functional simulator's kernels
# ---------------------------------------------------------------------------
def _rand(cuda, shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(dtype)).to(cuda)


@pytest.mark.parametrize("shape,factor,dtype", [
    ((400, 640), 2, np.float32), ((720, 1280), 2, np.float32),
    ((17, 33), 3, np.float32), ((17, 33), 4, np.float32),
    ((64, 96), 2, np.float16), ((33, 47), 3, np.float16)])
def test_binning_matches_twin(cuda, shape, factor, dtype):
    bn = _mod("binning")
    x = _rand(cuda, shape, sum(shape) + factor, dtype)
    bn.reset_counts()
    ker = bn.binning(x, factor)
    torch.cuda.synchronize()
    assert bn.COUNTS == {"kernel_launches": 1, "twin_calls": 0}
    assert torch.equal(ker, bn.binning_torch(x, factor))


@pytest.mark.parametrize("shape,k", [
    ((360, 640), (3, 3)), ((720, 1280), (3, 3)), ((100, 140), (3, 5)),
    ((77, 45), (5, 5)), ((40, 40), (2, 2)), ((33, 70), (1, 1))])
def test_stencil_conv_matches_twin(cuda, shape, k):
    st = _mod("stencil_conv")
    x = _rand(cuda, shape, shape[0])
    taps = _rand(cuda, k, k[0] * 10 + k[1])
    st.reset_counts()
    ker = st.stencil_conv(x, taps)
    torch.cuda.synchronize()
    assert st.COUNTS == {"kernel_launches": 1, "twin_calls": 0}
    assert torch.equal(ker, st.stencil_conv_torch(x, taps))


@pytest.mark.parametrize("shape,dtype", [
    ((200, 320), np.float32), ((33, 47), np.float32),
    ((33, 47), np.float16)])
def test_frame_event_matches_twin(cuda, shape, dtype):
    fe = _mod("frame_event")
    cur, prev = _rand(cuda, shape, 1, dtype), _rand(cuda, shape, 2, dtype)
    fe.reset_counts()
    for t in (0.1, 0.5, 1.5):
        assert torch.equal(fe.frame_event(cur, prev, t),
                           fe.frame_event_torch(cur, prev, t))
    assert fe.COUNTS == {"kernel_launches": 3, "twin_calls": 3}
    one = torch.tensor([[0.7, float("nan")]], device=cuda)
    zero = torch.zeros(1, 2, device=cuda)
    assert fe.frame_event(one, zero, 0.7).tolist() == [[1.0, 0.0]]


@pytest.mark.parametrize("mkn", [(1, 64000, 900), (130, 150, 70), (1, 64, 1),
                                 (1024, 1024, 1024), (1, 900, 2),
                                 (5, 3000, 257), (64, 0, 3)])
def test_matmul_matches_twin(cuda, mkn):
    mm = _mod("matmul")
    m, k, n = mkn
    a, b = _rand(cuda, (m, k), m + k), _rand(cuda, (k, n), k + n)
    mm.reset_counts()
    ker = mm.matmul(a, b)
    torch.cuda.synchronize()
    assert mm.COUNTS == {"kernel_launches": 1, "twin_calls": 0}
    twin = mm.matmul_torch(a, b)
    scale = a.double().abs().cpu() @ b.double().abs().cpu()
    err = (ker.double() - twin.double()).abs().cpu()
    assert (err <= 1e-5 * scale).all(), float((err - 1e-5 * scale).max())
    assert torch.equal(ker, mm.matmul(a, b))          # run to run


def test_functional_pipelines_on_cuda_match_cpu(cuda):
    from repro_torch import functional as fn
    rng = np.random.default_rng(3)
    frame = rng.uniform(size=(96, 128)).astype(np.float32)
    prev = rng.uniform(size=(48, 64)).astype(np.float32)
    w1 = rng.normal(size=(48 * 64, 40)).astype(np.float32)
    w2 = rng.normal(size=(40, 2)).astype(np.float32)
    g, c = torch.from_numpy(frame).to(cuda), torch.from_numpy(frame)
    assert torch.equal(fn.fig5_pipeline(g).cpu(), fn.fig5_pipeline(c))
    assert torch.equal(fn.rhythmic_pixel_frontend(g).cpu(),
                       fn.rhythmic_pixel_frontend(c))
    ev_g, b_g = fn.edgaze_frontend(g, torch.from_numpy(prev).to(cuda))
    ev_c, b_c = fn.edgaze_frontend(c, torch.from_numpy(prev))
    assert torch.equal(ev_g.cpu(), ev_c) and torch.equal(b_g.cpu(), b_c)
    out_g = fn.simple_dnn(ev_g, *fn.params_from_reference(w1, w2, cuda))
    out_c = fn.simple_dnn(ev_c, *fn.params_from_reference(w1, w2, "cpu"))
    x = ev_c.reshape(1, -1).double().abs()
    h = (x @ torch.from_numpy(w1).double()).abs()
    w2a = torch.from_numpy(w2).double().abs()
    bound = 1e-5 * ((x @ torch.from_numpy(w1).double().abs()) @ w2a
                    + h @ w2a)
    assert ((out_g.cpu().double() - out_c.double()).abs() <= bound).all()
