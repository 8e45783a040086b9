"""K2, K3a/K3b, K4, K5-K8 and K9 against their torch twins, and the
staged and grid engines and the functional pipelines on the card against
the CPU.

Marked ``cuda``: without a CUDA device every test here skips (decided in
a fixture, never at import).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: ``grid_decode`` and ``category_reduce`` bit-equal (same
index arithmetic, ``grid_decode`` on both routes and index widths, past
2^32, on 1 and 16 axes; same summation order, built with
``--fmad=false``);
block stats min / argmin / counts exact, NaN where the twin's is, and
sums rel 1e-5 (another summation order), K3b on every plan (cluster x
route x variant tile) and bit-equal from launch to launch; engines rel
1e-6 on the top-k metric.  ``binning``,
``stencil_conv`` and ``frame_event`` bit-equal (same order) at f32, f16
and bf16, ``binning``, ``stencil_conv`` and ``frame_event`` on every
route (each launch counted on the route that ran); ``matmul`` within ``1e-5 * (|a| @ |b|)``
elementwise (another summation order; one unit in the last place more
for an f16 or bf16 output) and the same from run to run; ``flash_attention`` within
``atol = rtol`` 1e-5 (f32), 1e-2 (bf16), 2e-3 (f16), compared in f32
(another summation order and an online softmax), its tensor-core routes
also within one rounding of the half output plus ``1e-5 (1 + |twin|)``
(``repro_torch.testing.half_rule``), and the same from run to run, each
launch counted on the route that ran; at inputs scaled by 8 (scores of
hundreds, where no other summation order of the f32 function stays
within 1e-5 of the twin) the 3xTF32 route's f32 result within twice the
twin's distance from the f64 function (``repro_torch.testing.
attention_f64``); the pipelines bit-equal to the CPU's, the DNN output by
the matmul rule through both layers.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.testing import (attention_f64, f64_error, half_rule,
                                 rounded_f64_error)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ and "
                    "have no CPU mode")
    return torch.device("cuda")


def _mod(name):
    return importlib.import_module(f"repro_torch.kernels.{name}")


@pytest.mark.parametrize("start,chunk,idx_dtype,route", [
    (0, 1000, torch.int32, "vec4"), (37, 4099, torch.int32, "scalar"),
    (130, 777, torch.int64, "scalar"), (5, 4096, torch.int32, "vec4"),
    (130, 4096, torch.int64, "vec4"), (3, 3, torch.int32, "scalar"),
    # the tail past total, clamped inside a thread's run (start < 0: that
    # far before the end); every chunk here crosses variants (12 points)
    (-10, 4096, torch.int32, "vec4"), (-9, 4099, torch.int64, "scalar"),
    (-7, 8, torch.int64, "vec4")])
def test_grid_decode_matches_twin(cuda, start, chunk, idx_dtype, route):
    from repro_torch.core.shard_sweep import _prepare_stream
    gd = _mod("grid_decode")
    prep = _prepare_stream(["edgaze", "rhythmic"],
                           {"cis_node": [130.0, 65.0, 28.0],
                            "frame_rate": [15.0, 60.0],
                            "mem_tech": ["sram", "stt"]}, device=cuda)
    if start < 0:
        start += prep.total
    kw = dict(shape=prep.vgrids[0].shape, n_var=prep.n_var,
              total=prep.total, chunk=chunk, lmax=prep.lmax,
              idx_dtype=idx_dtype)
    gd.reset_counts()
    kv, kid = gd.grid_decode(prep.table2, start, **kw)
    torch.cuda.synchronize()
    assert gd.COUNTS["kernel_launches"] == gd.COUNTS[f"{route}_launches"] \
        == 1 and gd.COUNTS["twin_calls"] == 0, gd.COUNTS
    tv, tid = gd.grid_decode_torch(prep.table2, start, **kw)
    assert torch.equal(kv, tv) and torch.equal(kid, tid)


@pytest.mark.parametrize("shape,n_variants,start,chunk,idx_dtype", [
    # int64 past 2^31 and 2^32 and at the end of the space, both routes
    ((1500, 1500, 3, 1, 1, 1, 1, 1, 1000, 1), 3, 2 ** 31 - 102, 4096,
     torch.int64),
    ((1500, 1500, 3, 1, 1, 1, 1, 1, 1000, 1), 3, 2 ** 32 - 3001, 5001,
     torch.int64),
    ((1500, 1500, 3, 1, 1, 1, 1, 1, 1000, 1), 3, -3001, 2 ** 18,
     torch.int64),
    # one axis; sixteen (the kernel's cap), two of them of size 1
    ((7,), 3, 4, 24, torch.int32),
    ((2, 3, 2, 1, 2, 2, 3, 2, 2, 1, 2, 2, 2, 3, 2, 2), 2, 1_000_001, 4099,
     torch.int32),
    ((2, 3, 2, 1, 2, 2, 3, 2, 2, 1, 2, 2, 2, 3, 2, 2), 2, -77, 4096,
     torch.int64)])
def test_grid_decode_wide_grids_match_twin(cuda, shape, n_variants, start,
                                           chunk, idx_dtype):
    """Synthetic tables whose every entry names its own (axis, column)."""
    gd = _mod("grid_decode")
    n_var = int(np.prod(shape))
    total = n_var * n_variants
    lmax = max(shape)
    table2 = torch.arange(len(shape) * n_variants * lmax,
                          dtype=torch.float32, device=cuda).reshape(
                              len(shape), -1)
    kw = dict(shape=shape, n_var=n_var, total=total, chunk=chunk, lmax=lmax,
              idx_dtype=idx_dtype)
    start %= total
    gd.reset_counts()
    kv, kid = gd.grid_decode(table2, start, **kw)
    torch.cuda.synchronize()
    route = "vec4" if chunk % 4 == 0 else "scalar"
    assert gd.COUNTS[f"{route}_launches"] == 1, gd.COUNTS
    tv, tid = gd.grid_decode_torch(table2, start, **kw)
    assert torch.equal(kv, tv) and torch.equal(kid, tid)


def _stats_equal(ker, twin):
    """Block stats against the twin's: min (NaN where the twin's is NaN),
    argmin and counts exact, sums rel 1e-5."""
    km, ka, ks, kc = (t.cpu().numpy() for t in ker)
    tm, ta, ts, tc = (t.cpu().numpy() for t in twin)
    np.testing.assert_array_equal(km, tm)
    np.testing.assert_array_equal(ka, ta)
    np.testing.assert_array_equal(kc, tc)
    np.testing.assert_allclose(ks, ts, rtol=1e-5, atol=0)


def _stats_inputs(cuda, n, bp, n_variants, layout, seed, offset=0,
                  ties=False):
    """:func:`repro_torch.testing.stats_case` on the card, ``offset``
    elements into each buffer."""
    from repro_torch.testing import stats_case
    vals, mask, vid = stats_case(n, bp, n_variants, layout, seed, ties)
    outs = []
    for a in (vals, mask, vid):
        buf = torch.empty(n + offset, dtype=torch.from_numpy(a).dtype,
                          device=cuda)[offset:]
        buf.copy_(torch.from_numpy(a))
        outs.append(buf)
    return outs


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
        _stats_equal(ker, twin)
    # F4: NaN, +-inf, an all-masked block, on every layout of ids
    for layout in ("run", "interleaved", "single"):
        v, m, ids = _stats_inputs(cuda, n, min(bp, n), 3, layout, n + 1)
        _stats_equal(sr.block_stats(v, m, bp), sr.block_stats_torch(v, m, bp))
        _stats_equal(sr.block_stats_banked(v, m, ids, 3, bp),
                     sr.block_stats_banked_torch(v, m, ids, 3, bp))


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n,bp", [(2 ** 18, 4096), (5003, 1024), (77, 128),
                                  (4099, 4099)])
def test_block_stats_every_plan_matches_twin(cuda, cluster, offset, n, bp):
    """K3a on every cluster size, on the vec4 route (aligned) and on the
    scalar route (an offset view: values and mask one element in; or a
    block of 77 or 4099 points, not whole vectors), with a ragged tail,
    exact ties and an all-masked block."""
    sr = _mod("stream_reduce")
    rng = np.random.default_rng(n + offset)
    vals_all = torch.from_numpy(rng.choice(np.float32([0.5, 1.25, 2.0]),
                                           n + offset)).to(cuda)
    mask_all = torch.from_numpy(rng.uniform(size=n + offset) > 0.3).to(cuda)
    vals, mask = vals_all[offset:], mask_all[offset:]
    mask[: min(bp, n)] = False                # an all-masked block
    aligned = vals.data_ptr() % 16 == 0 and mask.data_ptr() % 4 == 0
    assert aligned == (offset == 0)
    p = sr.make_plan(n, min(bp, n), cluster, aligned)
    assert p.route == ("vec4" if aligned and min(bp, n) % 4 == 0
                       else "scalar")
    sr.reset_counts()
    ker = sr.run(vals, mask, p, bp)
    torch.cuda.synchronize()
    assert sr.COUNTS["kernel_launches"] == 1
    assert sr.COUNTS[f"{p.route}_launches"] == 1
    twin = sr.block_stats_torch(vals, mask, bp)
    km, ka, ks, kc = (t.cpu().numpy() for t in ker)
    tm, ta, ts, tc = (t.cpu().numpy() for t in twin)
    np.testing.assert_array_equal(km, tm)
    np.testing.assert_array_equal(ka, ta)
    np.testing.assert_array_equal(kc, tc)
    np.testing.assert_allclose(ks, ts, rtol=1e-5, atol=0)
    assert tc[0] == 0 and km[0] == np.inf and ka[0] == 0


def test_block_stats_plan_fills_the_card(cuda):
    sr = _mod("stream_reduce")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    vals = torch.ones(2 ** 18, device=cuda)
    mask = torch.ones(2 ** 18, dtype=torch.bool, device=cuda)
    sr.reset_counts()
    sr.block_stats(vals, mask, 4096)
    torch.cuda.synchronize()
    assert sr.COUNTS["vec4_launches"] == 1
    assert sr.plan(2 ** 18, 4096, True, n_sm).ctas >= n_sm


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("offset", [0, 1])
def test_block_stats_nan_every_plan_matches_twin(cuda, cluster, offset):
    """F4 on K3a's every plan: NaN (ties of it in one thread), +-inf, an
    all-masked block and a ragged tail equal the twin, NaN where its min
    is NaN."""
    sr = _mod("stream_reduce")
    n, bp = 4 * 4096 + 77, 4096
    for ties in (False, True):
        vals, mask, _ = _stats_inputs(cuda, n, bp, 1, "single", cluster,
                                      offset, ties)
        p = sr.make_plan(n, bp, cluster, sr.aligned(vals, mask))
        assert p.route == ("vec4" if offset == 0 else "scalar")
        sr.reset_counts()
        ker = sr.run(vals, mask, p, bp)
        torch.cuda.synchronize()
        assert sr.COUNTS[f"{p.route}_launches"] == 1
        twin = sr.block_stats_torch(vals, mask, bp)
        _stats_equal(ker, twin)
        assert np.isnan(ker[0][0].item())
        assert ker[3][1].item() == 0 and ker[0][1].item() == np.inf


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("tile", [None, 3])
@pytest.mark.parametrize("layout", ["run", "interleaved", "single"])
@pytest.mark.parametrize("n,bp,n_variants", [
    (4 * 4096 + 77, 4096, 8), (5003, 1024, 40), (777, 128, 1),
    (4099, 4099, 17)])
def test_block_stats_banked_every_plan_matches_twin(cuda, cluster, offset,
                                                    tile, layout, n, bp,
                                                    n_variants):
    """K3b on every plan: cluster size x route (aligned, or one element
    into its buffers: ``scalar``; a block of 4099 points is not whole
    vectors) x variant tile (the plan's, or 3), on the run, interleaved
    and single-variant layouts, with NaN, +-inf, ids -1 and past V, an
    all-masked block and a ragged tail; each launch counted on its route,
    and a repeated launch bit-equal, sums too."""
    sr = _mod("stream_reduce")
    vals, mask, vid = _stats_inputs(cuda, n, bp, n_variants, layout,
                                    n + cluster, offset,
                                    ties=cluster % 2 == 0)
    al = sr.aligned(vals, mask, vid)
    assert al == (offset == 0)
    p = sr.make_banked_plan(n, bp, n_variants, cluster, al,
                            tile and min(tile, n_variants))
    assert p.route == ("vec4" if al and bp % 4 == 0 else "scalar")
    sr.reset_counts()
    ker = sr.run_banked(vals, mask, vid, n_variants, p, bp)
    again = sr.run_banked(vals, mask, vid, n_variants, p, bp)
    torch.cuda.synchronize()
    assert sr.COUNTS[f"banked_{p.route}_launches"] == 2
    assert sr.COUNTS["banked_kernel_launches"] == 2
    twin = sr.block_stats_banked_torch(vals, mask, vid, n_variants, bp)
    _stats_equal(ker, twin)
    for a, b in zip(ker, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if n > bp:                                # the all-masked block
        assert (ker[3][1] == 0).all() and (ker[1][1] == 0).all()


def test_block_stats_banked_plan_and_casts(cuda):
    """The wrapper's own plan on the card (vec4 at the main path's shape)
    and the reference's casts: f64 values, an int8 mask, int64 ids,
    each cast on the device, equal to the twin on the cast operands."""
    sr = _mod("stream_reduce")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    vals, mask, vid = _stats_inputs(cuda, 2 ** 18, 4096, 8, "interleaved", 5)
    sr.reset_counts()
    ker = sr.block_stats_banked(vals.double(), mask.to(torch.int8),
                                vid.long(), 8, 4096)
    k3a = sr.block_stats(vals.double(), mask.to(torch.int8), 4096)
    torch.cuda.synchronize()
    assert sr.COUNTS["banked_vec4_launches"] == 1
    assert sr.COUNTS["vec4_launches"] == 1
    assert sr.plan_banked(2 ** 18, 4096, 8, True, n_sm).ctas >= n_sm
    _stats_equal(ker, sr.block_stats_banked_torch(vals, mask, vid, 8, 4096))
    _stats_equal(k3a, sr.block_stats_torch(vals, mask, 4096))


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


def _offset(cuda, x):
    """``x`` as a contiguous view one element past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _launched_on(mod, route):
    """One launch, on ``route``, and no twin call."""
    others = {k: v for k, v in mod.COUNTS.items()
              if k not in ("kernel_launches", f"{route}_launches")}
    assert mod.COUNTS["kernel_launches"] == 1, mod.COUNTS
    assert mod.COUNTS[f"{route}_launches"] == 1, mod.COUNTS
    assert not any(others.values()), mod.COUNTS


@pytest.mark.parametrize("shape,factor,dtype", [
    ((400, 640), 2, np.float32), ((720, 1280), 2, np.float32),
    ((17, 33), 3, np.float32), ((17, 33), 4, np.float32),
    ((64, 96), 2, np.float16), ((33, 47), 3, np.float16),
    ((720, 1280), 2, torch.bfloat16), ((33, 47), 3, torch.bfloat16),
    ((63, 72), 2, np.float32), ((41, 1288), 2, np.float32),
    ((40, 1284), 2, np.float32), ((9, 8), 2, np.float32),
    ((31, 1296), 2, torch.bfloat16), ((31, 1300), 2, np.float16),
    ((40, 1282), 2, np.float32), ((9, 8), 2, np.float16),
    ((16, 16), 2, np.float16), ((16, 32), 2, torch.bfloat16)])
def test_binning_matches_twin(cuda, shape, factor, dtype):
    """On the route the plan picks (vec2 where the rows are whole 16-byte
    vectors, else scalar), bit-equal to the twin."""
    bn = _mod("binning")
    x = _rand(cuda, shape, sum(shape) + factor, dtype)
    route = bn.plan(shape[1], factor, x.dtype, True)
    bn.reset_counts()
    ker = bn.binning(x, factor)
    torch.cuda.synchronize()
    _launched_on(bn, route)
    assert torch.equal(ker, bn.binning_torch(x, factor))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_binning_offset_view_takes_the_scalar_route(cuda, dtype):
    bn = _mod("binning")
    x = _offset(cuda, _rand(cuda, (720, 1280), 3, dtype))
    bn.reset_counts()
    ker = bn.binning(x, 2)
    torch.cuda.synchronize()
    _launched_on(bn, "scalar")
    assert torch.equal(ker, bn.binning_torch(x, 2))


@pytest.mark.parametrize("shape,k", [
    ((360, 640), (3, 3)), ((720, 1280), (3, 3)), ((100, 140), (3, 5)),
    ((77, 45), (5, 5)), ((40, 40), (2, 2)), ((33, 70), (1, 1)),
    ((77, 48), (5, 5)), ((1000, 36), (2, 2)), ((33, 72), (1, 1)),
    ((65, 8388), (3, 3)), ((66, 8388), (3, 3)), ((67, 8388), (3, 3)),
    ((9, 64), (3, 3)), ((10, 68), (3, 3)), ((11, 132), (3, 3))])
def test_stencil_conv_matches_twin(cuda, shape, k):
    """On the route the plan picks (k3x3 for 3 x 3, generic for the rest,
    scalar where the rows are no whole 16-byte vectors), bit-equal to the
    twin; the 3 x 3 frames put output rows one either side of a multiple
    of the planned tile's (16 or 32 rows at 8388 columns, 8 at small
    frames)."""
    st = _mod("stencil_conv")
    x = _rand(cuda, shape, shape[0])
    taps = _rand(cuda, k, k[0] * 10 + k[1])
    p = st.plan(*shape, *k, x.dtype, True,
                torch.cuda.get_device_properties(0).multi_processor_count)
    st.reset_counts()
    ker = st.stencil_conv(x, taps)
    torch.cuda.synchronize()
    _launched_on(st, p.route)
    assert torch.equal(ker, st.stencil_conv_torch(x, taps))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [(3, 3), (5, 5)])
def test_stencil_conv_offset_view_takes_the_scalar_route(cuda, k, dtype):
    st = _mod("stencil_conv")
    x = _offset(cuda, _rand(cuda, (360, 640), 4, dtype))
    taps = _rand(cuda, k, 6, dtype)
    st.reset_counts()
    ker = st.stencil_conv(x, taps)
    torch.cuda.synchronize()
    _launched_on(st, "scalar")
    assert torch.equal(ker, st.stencil_conv_torch(x, taps,
                                                  acc_dtype=torch.float32))


def test_binning_and_stencil_conv_refuse_what_they_do_not_take(cuda):
    """A strided frame, or a stencil on another device, raises before any
    launch: the wrappers check only what a call can change, and these
    are such."""
    bn, st = _mod("binning"), _mod("stencil_conv")
    x = _rand(cuda, (64, 96), 1)
    taps = _rand(cuda, (3, 3), 2)
    bn.reset_counts()
    st.reset_counts()
    with pytest.raises(ValueError, match="contiguous"):
        bn.binning(x.t(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        st.stencil_conv(x[:, ::2], taps)
    with pytest.raises(ValueError, match="contiguous"):
        st.stencil_conv(x, taps.t())
    with pytest.raises(ValueError, match="tensor on cuda"):
        st.stencil_conv(x, taps.cpu())
    assert bn.COUNTS["kernel_launches"] == st.COUNTS["kernel_launches"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [8, 4, 2, 1])
@pytest.mark.parametrize("route,k", [("k3x3", (3, 3)), ("generic", (3, 5)),
                                     ("scalar", (3, 3))])
def test_stencil_conv_every_tile_matches_twin(cuda, route, k, rows, dtype):
    """Each route at each rows-a-thread, forced through ``run``, with
    output rows of tile - 1, tile and tile + 1 and columns past the
    tile's: bit-equal to the twin."""
    st = _mod("stencil_conv")
    size = torch.empty((), dtype=dtype).element_size()
    threads_y = 8 if route == "k3x3" else 4
    tile_h, tile_w = threads_y * rows, 256 // size
    taps = _rand(cuda, k, 9)
    for oh in (tile_h - 1, tile_h, tile_h + 1):
        if oh < 1:
            continue
        h, w = oh + k[0] - 1, 2 * tile_w + 8
        x = _rand(cuda, (h, w), oh, dtype)
        if route == "scalar":
            x = _offset(cuda, x)
        p = st.Plan(route, rows, tile_h, tile_w if route == "k3x3" else 32
                    * (8 // size), 0)
        st.reset_counts()
        ker = st.run(x, taps, p)
        torch.cuda.synchronize()
        _launched_on(st, route)
        assert torch.equal(ker, st.stencil_conv_torch(
            x, taps, acc_dtype=torch.float32)), (route, rows, oh)


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
        _launched_on(st, "k3x3" if k == (3, 3) else "scalar")
        assert ker.dtype == dtype
        assert torch.equal(ker, st.stencil_conv_torch(
            x, taps, acc_dtype=torch.float32))


@pytest.mark.parametrize("shape,dtype,route", [
    ((200, 320), np.float32, "vec4"), ((33, 47), np.float32, "scalar"),
    ((33, 47), np.float16, "scalar"), ((200, 320), np.float16, "vec8"),
    ((200, 320), torch.bfloat16, "vec8"), ((33, 47), torch.bfloat16, "scalar"),
    ((1, 3), np.float32, "scalar"), ((1, 3), torch.bfloat16, "scalar"),
    ((1, 4), np.float32, "vec4"), ((1, 8), torch.bfloat16, "vec8"),
    ((720, 1280), np.float32, "vec4")])
def test_frame_event_matches_twin(cuda, shape, dtype, route):
    fe = _mod("frame_event")
    cur, prev = _rand(cuda, shape, 1, dtype), _rand(cuda, shape, 2, dtype)
    fe.reset_counts()
    for t in (0.1, 0.5, 1.5):
        assert torch.equal(fe.frame_event(cur, prev, t),
                           fe.frame_event_torch(cur, prev, t))
    assert fe.COUNTS["kernel_launches"] == fe.COUNTS[f"{route}_launches"] \
        == 3 and fe.COUNTS["twin_calls"] == 3, fe.COUNTS
    one = torch.tensor([[0.7, float("nan")]], device=cuda)
    zero = torch.zeros(1, 2, device=cuda)
    assert fe.frame_event(one, zero, 0.7).tolist() == [[1.0, 0.0]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_frame_event_threshold_nan_and_unaligned_views(cuda, dtype):
    """The 0.7 rounding case and NaN on each 16-byte route; frames one
    element past a 16-byte boundary take the scalar route."""
    fe = _mod("frame_event")
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    cur = torch.zeros(2, vec, device=cuda, dtype=dtype)
    cur[0, :3] = torch.tensor([0.7, float("nan"), 0.69999])
    prev = torch.zeros_like(cur)
    fe.reset_counts()
    got = fe.frame_event(cur, prev, 0.7)
    assert fe.COUNTS[f"vec{vec}_launches"] == 1, fe.COUNTS
    assert torch.equal(got, fe.frame_event_torch(cur, prev, 0.7))
    if dtype == torch.float32:
        assert got[0, :3].tolist() == [1.0, 0.0, 0.0]
    for shape in ((200, 320), (33, 48)):
        va, vb = (_offset(cuda, _rand(cuda, shape, s, dtype))
                  for s in (3, 4))
        fe.reset_counts()
        assert torch.equal(fe.frame_event(va, vb, 0.5),
                           fe.frame_event_torch(va, vb, 0.5))
        assert fe.COUNTS["scalar_launches"] == 1, fe.COUNTS


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
                         "tf32x3_launches": 0, "tf32x3_any_launches": 0,
                         "tf32x3_wide_launches": 0, "twin_calls": 0}
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


def _tf32x3_case(cuda, shape, causal, dtypes, scale=1.0, route="tf32x3",
                 offset=False):
    """A 3xTF32 route (``tf32x3``, or ``tf32x3_any``) against the twin: one
    launch on that route, within FA_TOL (and one rounding of a half
    output), bit-equal from run to run.  At ``scale = 8`` (scores of
    hundreds) the f32 result before its one rounding (a half q taken at
    its f32 values) is held to the f64 function within twice the twin's
    distance instead, and a half q's output, from the half q itself, to
    one rounding of the f64 function to q's dtype.  ``offset``: q's base
    one element past a 16-byte boundary."""
    fa = _mod("flash_attention")
    b, h, hkv, s, d = shape
    q = scale * _rand(cuda, (b, h, s, d), s + d, torch.float32)
    k = scale * _rand(cuda, (b, hkv, s, d), s + d + 1, torch.float32)
    v = scale * _rand(cuda, (b, hkv, s, d), s + d + 2, torch.float32)
    q, k, v = q.to(dtypes[0]), k.to(dtypes[1]), v.to(dtypes[2])
    if offset:
        q = _offset(cuda, q)
    assert fa.route(q, k, v) == route
    fa.reset_counts()
    ker = fa.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    want = {"kernel_launches": 1, "wgmma_launches": 0, "tf32x3_launches": 0,
            "tf32x3_any_launches": 0, "tf32x3_wide_launches": 0,
            "twin_calls": 0}
    want[f"{route}_launches"] = 1
    assert fa.COUNTS == want
    assert ker.dtype == dtypes[0] and ker.shape == q.shape
    assert torch.equal(ker, fa.flash_attention(q, k, v, causal))
    if scale == 1.0:
        twin = fa.flash_attention_torch(q, k, v, causal)
        tol = FA_TOL[dtypes[0]]
        torch.testing.assert_close(ker.float(), twin.float(), rtol=tol,
                                   atol=tol)
        if dtypes[0] != torch.float32:
            assert half_rule(ker, twin) <= 1.0
        return
    qf = q.float()
    got = fa.flash_attention(qf, k, v, causal)
    exact = attention_f64(q, k, v, causal)
    twin = fa.flash_attention_torch(qf, k, v, causal)
    theirs = f64_error(twin, exact)
    assert f64_error(got, exact) <= 2 * theirs
    if dtypes[0] != torch.float32:
        assert rounded_f64_error(ker, exact) <= 2 * theirs


F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
#: operand dtypes (q, k, v) that take the 3xTF32 route
TF32X3_MIXES = [(F32,) * 3, (BF16, F32, F32), (F32, BF16, BF16),
                (F16, F16, F32), (BF16, F32, F16), (F32, F16, BF16)]


def _dt_id(dts):
    return "_".join(str(t)[6:] for t in dts)


@pytest.mark.parametrize("dtypes", TF32X3_MIXES, ids=_dt_id)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(2, 4, 4), (1, 8, 2), (1, 8, 1)],
                         ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("s", [1, 127, 200, 1500])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_tf32x3_matches_twin(cuda, d, s, heads, causal,
                                             dtypes):
    _tf32x3_case(cuda, (*heads, s, d), causal, dtypes)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", list(range(4, 129, 4)))
def test_flash_attention_tf32x3_every_head_dim_f32(cuda, d, causal):
    _tf32x3_case(cuda, (1, 4, 2, 200, d), causal, (F32,) * 3)


@pytest.mark.parametrize("dtypes", TF32X3_MIXES[1:], ids=_dt_id)
@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_flash_attention_tf32x3_every_head_dim_mixed(cuda, d, dtypes):
    _tf32x3_case(cuda, (1, 4, 2, 130, d), True, dtypes)


@pytest.mark.parametrize("dtypes", TF32X3_MIXES[:4], ids=_dt_id)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 4, 2, 1500, 128), (2, 8, 2, 200, 64),
                                   (1, 2, 1, 127, 16)])
def test_flash_attention_tf32x3_scores_of_hundreds(cuda, shape, causal,
                                                   dtypes):
    _tf32x3_case(cuda, shape, causal, dtypes, scale=8.0)


# the 3xTF32 route through registers: every call up to D = 256 that the
# TMA routes do not take
ANY_MIXES = [(F32,) * 3, (BF16,) * 3, (F16,) * 3, (BF16, F32, F16),
             (F32, BF16, BF16), (F16, F16, F32)]


@pytest.mark.parametrize("dtypes", ANY_MIXES, ids=_dt_id)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(2, 4, 4), (1, 8, 2), (1, 8, 1)],
                         ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("s", [1, 127, 200, 1500])
@pytest.mark.parametrize("d", [136, 160, 200, 256])
def test_flash_attention_tf32x3_any_matches_twin(cuda, d, s, heads, causal,
                                                 dtypes):
    _tf32x3_case(cuda, (*heads, s, d), causal, dtypes, route="tf32x3_any")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtypes,d", [
    ((F32,) * 3, 18), ((F32,) * 3, 98), ((F32,) * 3, 2), ((F32,) * 3, 129),
    ((F16,) * 3, 100), ((BF16,) * 3, 12), ((BF16,) * 3, 1), ((F16,) * 3, 60),
    ((BF16, F32, F16), 12), ((F32, BF16, BF16), 20), ((F16, F16, F32), 36),
    ((F32, F16, BF16), 250)],
    ids=lambda x: str(x).replace("torch.", ""))
def test_flash_attention_tf32x3_any_rows_tma_does_not_move(cuda, dtypes, d,
                                                           causal):
    """Head dims whose rows are no 16-byte multiple (odd, or D % 8 != 0
    beside a half operand) run the route through registers."""
    _tf32x3_case(cuda, (1, 4, 2, 200, d), causal, dtypes, route="tf32x3_any")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtypes,d", [
    ((F32,) * 3, 64), ((F32,) * 3, 128), ((F16,) * 3, 64), ((BF16,) * 3, 128),
    ((BF16, F32, F32), 64), ((F32,) * 3, 160), ((F16,) * 3, 256)],
    ids=lambda x: str(x).replace("torch.", ""))
def test_flash_attention_tf32x3_any_misaligned_base(cuda, dtypes, d, causal):
    """q's base one element past a 16-byte boundary (2 bytes for a half
    q: no 16-byte or 4-byte load of a row is aligned there)."""
    _tf32x3_case(cuda, (1, 4, 2, 130, d), causal, dtypes, route="tf32x3_any",
                 offset=True)


@pytest.mark.parametrize("dtypes", ANY_MIXES[:4], ids=_dt_id)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 4, 2, 1500, 256), (2, 8, 2, 200, 160),
                                   (1, 2, 1, 127, 200), (1, 4, 2, 200, 18)])
def test_flash_attention_tf32x3_any_scores_of_hundreds(cuda, shape, causal,
                                                       dtypes):
    _tf32x3_case(cuda, shape, causal, dtypes, scale=8.0, route="tf32x3_any")


def _wide_case(cuda, q, k, v, causal):
    """One call on the wide route against the twin: one launch counted on
    that route, within the output dtype's FA_TOL (and one rounding of a
    half output), bit-equal from run to run."""
    fa = _mod("flash_attention")
    assert fa.route(q, k, v) == "tf32x3_wide"
    fa.reset_counts()
    ker = fa.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.COUNTS == {"kernel_launches": 1, "wgmma_launches": 0,
                         "tf32x3_launches": 0, "tf32x3_any_launches": 0,
                         "tf32x3_wide_launches": 1, "twin_calls": 0}
    assert torch.equal(ker, fa.flash_attention(q, k, v, causal))
    twin = fa.flash_attention_torch(q, k, v, causal)
    assert ker.dtype == twin.dtype == q.dtype and ker.shape == q.shape
    tol = FA_TOL[q.dtype]
    torch.testing.assert_close(ker.float(), twin.float(), rtol=tol, atol=tol)
    if q.dtype != torch.float32:
        assert half_rule(ker, twin) <= 1.0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 7, 33, 130])
@pytest.mark.parametrize("dtype,d", [
    (torch.float32, 264), (torch.float32, 320), (torch.float16, 300),
    (torch.bfloat16, 264), (torch.float16, 264), (torch.float32, 512),
    (torch.bfloat16, 520), (torch.float32, 1024)],
    ids=lambda x: str(x).replace("torch.", ""))
def test_flash_attention_simt_route(cuda, dtype, d, s, causal):
    """Head dims past 256 go through the wide 3xTF32 route, aligned or not
    (q's base 2 or 4 bytes off a 16-byte boundary), GQA, ragged S, causal
    and full, within FA_TOL of the twin."""
    q, k, v = (_rand(cuda, (1, n, s, d), d + s + i, dtype)
               for i, n in enumerate((4, 2, 2)))
    _wide_case(cuda, q, k, v, causal)
    _wide_case(cuda, _offset(cuda, q), k, v, causal)


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
    ((torch.bfloat16, torch.float32, torch.float16), 264),
    ((torch.float32, torch.bfloat16, torch.bfloat16), 300),
    ((torch.float32,) * 3, 320), ((torch.bfloat16,) * 3, 264),
    ((torch.float16,) * 3, 320), ((torch.float32, torch.float16,
                                   torch.float16), 288),
    ((torch.float32,) * 3, 384), ((torch.bfloat16, torch.float32,
                                   torch.float32), 512),
    ((torch.float16, torch.float16, torch.float32), 520),
    ((torch.float32, torch.bfloat16, torch.float16), 1024)],
    ids=lambda x: str(x).replace("torch.", ""))
def test_flash_attention_mixed_and_wide_on_simt(cuda, dtypes, d, causal):
    """Head dims past 256, each operand in its own dtype, run the wide
    3xTF32 route (GQA, 200 rows), within the output dtype's FA_TOL (and
    one rounding of a half output) of the twin, the same from run to run."""
    q = _rand(cuda, (1, 4, 200, d), d, dtypes[0])
    k = _rand(cuda, (1, 2, 200, d), d + 1, dtypes[1])
    v = _rand(cuda, (1, 2, 200, d), d + 2, dtypes[2])
    _wide_case(cuda, q, k, v, causal)


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
