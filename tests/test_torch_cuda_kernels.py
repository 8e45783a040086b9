"""K2, K3a/K3b, K4, K5-K8 and K9 against their torch twins, and the
staged and grid engines and the functional pipelines on the card against
the CPU.

Marked ``cuda``: without a CUDA device every test here skips (decided in
a fixture, never at import).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: ``grid_decode`` and ``category_reduce`` bit-equal (same
index arithmetic; same summation order, built with ``--fmad=false``);
block stats min / argmin / counts exact and sums rel 1e-5 (another
summation order); engines rel 1e-6 on the top-k metric.  ``binning``,
``stencil_conv`` and ``frame_event`` bit-equal (same order) at f32, f16
and bf16; ``matmul`` within ``1e-5 * (|a| @ |b|)`` elementwise (another
summation order; one unit in the last place more for an f16 or bf16
output) and the same from run to run; ``flash_attention`` within
``atol = rtol`` 1e-5 (f32), 1e-2 (bf16), 2e-3 (f16), compared in f32
(another summation order and an online softmax), its tensor-core route
also within one rounding of the half output plus ``1e-5 (1 + |twin|)``
(``repro_torch.testing.half_rule``), and the same from run to run, each
launch counted on the route that ran; the pipelines bit-equal to the
CPU's, the DNN output by the matmul rule through both layers.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.testing import half_rule

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


@pytest.mark.parametrize("b,u,c", [
    (1, 1, 10), (1000, 6, 10), (100_003, 11, 10), (255, 11, 10),
    (257, 32, 32), (2 ** 18 + 3, 11, 10), (300, 12, 1), (700, 33, 17),
    (513, 7, 8), (1025, 64, 16)])
def test_category_reduce_matches_twin(cuda, b, u, c):
    """Bit-equal at odd and even U (the staged rows' two layouts), U past
    32 (staged 32 units at a time), every column capacity and ragged B."""
    cr = _mod("category_reduce")
    rng = np.random.default_rng(b + u + c)
    e = torch.from_numpy(rng.uniform(1e-12, 1e-6, (b, u)).astype(
        np.float32)).to(cuda)
    w = torch.from_numpy((rng.uniform(size=(u, c)) > 0.5).astype(
        np.float32)).to(cuda)
    cr.reset_counts()
    ker = cr.category_reduce(e, w)
    assert cr.COUNTS == {"kernel_launches": 1, "twin_calls": 0}
    assert torch.equal(ker, cr.category_reduce_torch(e, w))


def test_category_reduce_unaligned_rows_match_twin(cuda):
    """A view whose rows start 4 bytes past a 16-byte boundary: the
    staged span's unaligned head and tail."""
    cr = _mod("category_reduce")
    rng = np.random.default_rng(9)
    flat = torch.from_numpy(rng.uniform(1e-12, 1e-6, 1000 * 11 + 1).astype(
        np.float32)).to(cuda)
    e = flat[1:].view(1000, 11)
    w = torch.from_numpy((rng.uniform(size=(11, 10)) > 0.5).astype(
        np.float32)).to(cuda)
    assert e.is_contiguous() and e.data_ptr() % 16 == 4
    assert torch.equal(cr.category_reduce(e, w),
                       cr.category_reduce_torch(e, w))


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
    """Seeded normal values of a numpy dtype, or of a torch dtype (made
    in f32 and rounded: numpy has no bf16)."""
    rng = np.random.default_rng(seed)
    if isinstance(dtype, torch.dtype):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return x.to(dtype).to(cuda)
    return torch.from_numpy(rng.normal(size=shape).astype(dtype)).to(cuda)


@pytest.mark.parametrize("shape,factor,dtype", [
    ((400, 640), 2, np.float32), ((720, 1280), 2, np.float32),
    ((17, 33), 3, np.float32), ((17, 33), 4, np.float32),
    ((64, 96), 2, np.float16), ((33, 47), 3, np.float16),
    ((720, 1280), 2, torch.bfloat16), ((33, 47), 3, torch.bfloat16)])
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


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape,k", [((720, 1280), (3, 3)),
                                     ((77, 45), (5, 5))])
def test_stencil_conv_half_matches_twin(cuda, shape, k, dtype):
    """f16/bf16 frames against f32 and same-dtype taps: the kernel sums
    in f32, as its twin does at ``acc_dtype=float32``."""
    st = _mod("stencil_conv")
    x = _rand(cuda, shape, shape[1], dtype)
    for taps in (_rand(cuda, k, 5), _rand(cuda, k, 5, dtype)):
        st.reset_counts()
        ker = st.stencil_conv(x, taps)
        torch.cuda.synchronize()
        assert st.COUNTS == {"kernel_launches": 1, "twin_calls": 0}
        assert ker.dtype == dtype
        assert torch.equal(ker, st.stencil_conv_torch(
            x, taps, acc_dtype=torch.float32))


@pytest.mark.parametrize("shape,dtype", [
    ((200, 320), np.float32), ((33, 47), np.float32),
    ((33, 47), np.float16), ((200, 320), torch.bfloat16),
    ((33, 47), torch.bfloat16)])
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


def _matmul_case(cuda, a, b, want_route):
    """One product against the twin: the K8 rule, one launch on the
    planned route, and the same from run to run."""
    from repro_torch.testing import ulp
    mm = _mod("matmul")
    mm.reset_counts()
    ker = mm.matmul(a, b)
    torch.cuda.synchronize()
    assert mm.COUNTS["kernel_launches"] == 1 and mm.COUNTS["twin_calls"] == 0
    assert mm.COUNTS[f"{want_route}_launches"] == 1, mm.COUNTS
    twin = mm.matmul_torch(a, b)
    assert ker.dtype == twin.dtype == a.dtype
    bound = 1e-5 * (a.double().abs() @ b.double().abs())
    if a.dtype != torch.float32:
        bound = bound + ulp(torch.maximum(ker.abs(), twin.abs()), a.dtype)
    err = (ker.double() - twin.double()).abs()
    assert (err <= bound).all(), float((err / bound).max())
    assert torch.equal(ker, mm.matmul(a, b))          # run to run


@pytest.mark.parametrize("mkn", [(1, 64000, 900), (130, 150, 70), (1, 64, 1),
                                 (1024, 1024, 1024), (1, 900, 2),
                                 (5, 3000, 257), (64, 0, 3)])
def test_matmul_matches_twin(cuda, mkn):
    m, k, n = mkn
    a, b = _rand(cuda, (m, k), m + k), _rand(cuda, (k, n), k + n)
    _matmul_case(cuda, a, b, "skinny" if m <= 8 else "tile")


@pytest.mark.parametrize("dtypes", [
    (torch.float16, torch.float16), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.float16)],
    ids=lambda d: f"{d[0]}@{d[1]}"[6:])
@pytest.mark.parametrize("mkn", [(1, 64000, 900), (1024, 1024, 1024),
                                 (130, 150, 70), (5, 3000, 257)])
def test_matmul_half_matches_twin(cuda, mkn, dtypes):
    from repro_torch.kernels.matmul import route
    m, k, n = mkn
    a = _rand(cuda, (m, k), m + k, dtypes[0])
    b = _rand(cuda, (k, n), k + n, dtypes[1])
    _matmul_case(cuda, a, b, route(m, n, k, a.dtype, b.dtype, True))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("mkn", [(130, 72, 1000), (9, 1024, 4096),
                                 (1000, 200, 4104), (1024, 1024, 1024),
                                 (256, 64, 136)])
def test_matmul_wgmma_matches_twin(cuda, mkn, dtype):
    """The tensor-core route at ragged M and N, K % 64 != 0 and split K."""
    m, k, n = mkn
    a = _rand(cuda, (m, k), m + k + 1, dtype)
    b = _rand(cuda, (k, n), k + n + 1, dtype)
    _matmul_case(cuda, a, b, "wgmma")


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16],
                         ids=str)
def test_matmul_wgmma_positive_long_k(cuda, dtype):
    """Positive operands at K = 16384, where a truncating accumulator's
    bias adds up: the output within the K8 rule, and the route's own f32
    sums (a split plan's partials, added on the host) within the f32 rule
    of the twin's f32 sums."""
    mm = _mod("matmul")
    rng = np.random.default_rng(16)
    a = torch.from_numpy(rng.uniform(size=(256, 16384)).astype(
        np.float32)).to(dtype).to(cuda)
    b = torch.from_numpy(rng.uniform(size=(16384, 256)).astype(
        np.float32)).to(dtype).to(cuda)
    _matmul_case(cuda, a, b, "wgmma")
    p = mm.Plan("wgmma", 64, 2, 8192)
    part = torch.empty((2, 256, 256), dtype=torch.float32, device=cuda)
    mm.run(a, b, p, part=part)
    got = part.double().sum(0)
    twin = mm.matmul_torch(a.float(), b.float()).double()
    rule = 1e-5 * (a.double() @ b.double())
    assert ((got - twin).abs() <= rule).all(), \
        float(((got - twin).abs() / rule).max())


def test_matmul_offset_view_takes_the_tile_route(cuda):
    """A contiguous operand 2 bytes past a 16-byte boundary is no TMA
    base: it runs on the tile route, never on a tensor map that faults."""
    from repro_torch.kernels.matmul import route
    flat = torch.empty(130 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    a = flat[1:].view(130, 64)
    a.copy_(_rand(cuda, (130, 64), 3, torch.bfloat16))
    b = _rand(cuda, (64, 72), 4, torch.bfloat16)
    assert a.is_contiguous() and a.data_ptr() % 16 == 2
    assert route(130, 72, 64, a.dtype, b.dtype, False) == "tile"
    _matmul_case(cuda, a, b, "tile")


def test_matmul_tiny_product_is_one_launch(cuda):
    """The DNN's second layer, (1, 900, 2): one device kernel, no
    scratch."""
    from torch.profiler import ProfilerActivity, profile
    mm = _mod("matmul")
    a, b = _rand(cuda, (1, 900), 1), _rand(cuda, (900, 2), 2)
    mm.matmul(a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mm.matmul(a, b)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type.name == "CUDA" and "matmul" in e.name]
    assert len(names) == 1 and "skinny" in names[0], names


# ---------------------------------------------------------------------------
# K9, flash attention
# ---------------------------------------------------------------------------
FA_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}


@pytest.mark.parametrize("dtype", list(FA_TOL), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [
    (2, 4, 4, 256, 64),       # MHA
    (2, 8, 2, 200, 32),       # GQA, ragged S
    (1, 8, 1, 128, 64),       # MQA
    (1, 4, 2, 1, 16),         # S = 1
    (1, 4, 2, 127, 128),      # S = 127, the largest head dim
    (1, 28, 4, 320, 128)])    # qwen2-7b's heads, ragged S
def test_flash_attention_matches_twin(cuda, shape, causal, dtype):
    fa = _mod("flash_attention")
    b, h, hkv, s, d = shape
    q = _rand(cuda, (b, h, s, d), 1, dtype)
    k = _rand(cuda, (b, hkv, s, d), 2, dtype)
    v = _rand(cuda, (b, hkv, s, d), 3, dtype)
    fa.reset_counts()
    ker = fa.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.COUNTS["kernel_launches"] == 1
    assert fa.COUNTS[f"{fa.route(q, k, v)}_launches"] == 1
    assert fa.COUNTS["twin_calls"] == 0
    twin = fa.flash_attention_torch(q, k, v, causal)
    assert ker.dtype == twin.dtype == dtype and ker.shape == q.shape
    tol = FA_TOL[dtype]
    torch.testing.assert_close(ker.float(), twin.float(), rtol=tol, atol=tol)
    assert torch.equal(ker, fa.flash_attention(q, k, v, causal))


def _wgmma_case(cuda, shape, causal, dtype):
    """The tensor-core route against the twin: one launch on that route,
    within FA_TOL and one rounding, bit-equal from run to run."""
    fa = _mod("flash_attention")
    b, h, hkv, s, d = shape
    q = _rand(cuda, (b, h, s, d), s + d, dtype)
    k = _rand(cuda, (b, hkv, s, d), s + d + 1, dtype)
    v = _rand(cuda, (b, hkv, s, d), s + d + 2, dtype)
    assert fa.route(q, k, v) == "wgmma"
    fa.reset_counts()
    ker = fa.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.COUNTS == {"kernel_launches": 1, "wgmma_launches": 1,
                         "simt_launches": 0, "twin_calls": 0}
    twin = fa.flash_attention_torch(q, k, v, causal)
    assert ker.dtype == dtype and ker.shape == q.shape
    tol = FA_TOL[dtype]
    torch.testing.assert_close(ker.float(), twin.float(), rtol=tol, atol=tol)
    assert half_rule(ker, twin) <= 1.0
    assert torch.equal(ker, fa.flash_attention(q, k, v, causal))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(2, 4, 4), (1, 8, 2), (1, 8, 1)],
                         ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("s", [1, 127, 200, 1500])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_wgmma_matches_twin(cuda, d, s, heads, causal,
                                            dtype):
    _wgmma_case(cuda, (*heads, s, d), causal, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_flash_attention_wgmma_every_head_dim(cuda, d, causal, dtype):
    _wgmma_case(cuda, (1, 4, 2, 200, d), causal, dtype)


def test_flash_attention_simt_route(cuda):
    """f32, a head dim TMA does not move and a misaligned base go through
    the SIMT kernel, within FA_TOL of the twin."""
    fa = _mod("flash_attention")
    cases = []
    for dtype, d in ((torch.float32, 64), (torch.float32, 128),
                     (torch.bfloat16, 12)):
        cases.append(tuple(_rand(cuda, (1, heads, 130, d), heads + d, dtype)
                           for heads in (4, 2, 2)))
    flat = torch.empty(1 * 4 * 130 * 64 + 1, dtype=torch.float16,
                       device=cuda)
    q = flat[1:].view(1, 4, 130, 64)
    q.copy_(_rand(cuda, (1, 4, 130, 64), 7, torch.float16))
    cases.append((q, *(_rand(cuda, (1, 2, 130, 64), 8 + i, torch.float16)
                       for i in range(2))))
    for q, k, v in cases:
        assert fa.route(q, k, v) == "simt"
        fa.reset_counts()
        ker = fa.flash_attention(q, k, v, True)
        torch.cuda.synchronize()
        assert fa.COUNTS == {"kernel_launches": 1, "wgmma_launches": 0,
                             "simt_launches": 1, "twin_calls": 0}
        tol = FA_TOL[q.dtype]
        torch.testing.assert_close(
            ker.float(), fa.flash_attention_torch(q, k, v, True).float(),
            rtol=tol, atol=tol)


def test_flash_attention_refuses_what_it_does_not_stage(cuda):
    fa = _mod("flash_attention")
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros(1, 2, 16, 8, device=cuda).transpose(2, 3)
        fa.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="float32, float16 or bfloat16"):
        x = torch.zeros(1, 2, 16, 8, device=cuda, dtype=torch.float64)
        fa.flash_attention(x, x, x)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtypes,d", [
    ((torch.bfloat16, torch.float32, torch.float16), 64),
    ((torch.float32, torch.bfloat16, torch.bfloat16), 128),
    ((torch.float16, torch.float16, torch.float32), 40),
    ((torch.float32,) * 3, 160), ((torch.bfloat16,) * 3, 256),
    ((torch.float16,) * 3, 160), ((torch.float32, torch.float16,
                                   torch.float16), 256)],
    ids=lambda x: str(x).replace("torch.", ""))
def test_flash_attention_mixed_and_wide_on_simt(cuda, dtypes, d, causal):
    """Mixed operand dtypes and head dims past 128 run the SIMT route,
    within the output dtype's FA_TOL (and one rounding of a half output)
    of the twin, the same from run to run."""
    fa = _mod("flash_attention")
    q = _rand(cuda, (1, 4, 200, d), d, dtypes[0])
    k = _rand(cuda, (1, 2, 200, d), d + 1, dtypes[1])
    v = _rand(cuda, (1, 2, 200, d), d + 2, dtypes[2])
    assert fa.route(q, k, v) == "simt"
    fa.reset_counts()
    ker = fa.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.COUNTS == {"kernel_launches": 1, "wgmma_launches": 0,
                         "simt_launches": 1, "twin_calls": 0}
    twin = fa.flash_attention_torch(q, k, v, causal)
    assert ker.dtype == twin.dtype == dtypes[0] and ker.shape == q.shape
    tol = FA_TOL[dtypes[0]]
    torch.testing.assert_close(ker.float(), twin.float(), rtol=tol, atol=tol)
    if dtypes[0] != torch.float32:
        assert half_rule(ker, twin) <= 1.0
    assert torch.equal(ker, fa.flash_attention(q, k, v, causal))


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
