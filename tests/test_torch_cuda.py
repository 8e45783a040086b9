"""The CUDA megakernel against its torch twin, serving, and the LM
stack's serving (P12a) and training (P12b) paths, on the card.

Marked ``cuda``: without a CUDA device every test here skips (decided in
a fixture, never at import).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: ``cand_v`` rel 1e-6 and ``cand_l`` equal where finite (the
kernel keeps the twin's operation order, built with ``--fmad=false``);
``counts`` exact; ``sums`` rel 1e-5 (block sums add up to 4096 f32 terms
in another order).  Every cluster size of the kernel's plans is forced
through ``fused_sweep.run`` and counted on its route; there the
candidates' positions are also held equal at the +inf padding, which the
kernel's lexicographic merge gives exactly as the twin's stable sort.
A served tenant is held to its solo call: top-k values and indices
bit-equal, full rows rel 1e-6.  Four shards on one card
(``BatchMesh([cuda:0] * 4)``) are held to the port's 4-shard CPU mesh
(top-k indices exact, values rel 1e-6) and to the card's one-device
run (top-k bit for bit), with K1 and K4 launched once a shard.  The LM
stack's ten reduced configs (f32, TF32 off) are held to the same weights
on the CPU (every call's logits and the final cache within 1e-4
max|cpu|, greedy tokens equal), and their prefill and decode steps run
under the sync debug mode "error"; so does a train step (bf16, remat
``full`` and ``dots``), and one f32 train step is held to the CPU's
(loss rel 1e-5, grad_norm rel 1e-4, moments 1e-4 max|cpu|, parameters
within ``2 lr + 1e-6 |p|``, ``1e-3 lr`` where the gradient is not near
zero).
"""
import json

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
    # blocks of 256 points or fewer take one CTA a block
    assert fs.COUNTS == {"kernel_launches": 1, "twin_calls": 0,
                         "cluster1_launches": 1, "cluster2_launches": 0,
                         "cluster4_launches": 0, "cluster8_launches": 0}
    _assert_close(ker, fs.fused_sweep_block_torch(*args, **kw))


@pytest.fixture(scope="module")
def wide_prep(cuda):
    """Two Ed-Gaze variants of 1,728 points each, so blocks of up to
    4096 straddle the variants."""
    from repro_torch.core.shard_sweep import _prepare_stream
    grids = dict(GRIDS, sys_cols=[16.0, 32.0], active_fraction_scale=[
        0.5, 1.0])
    return _prepare_stream("edgaze", grids, device=cuda)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("kk", [1, 3, 16, 32])
@pytest.mark.parametrize("case", [
    # a chunk that straddles the two variants, low and limit inside it
    dict(metric="total_j", start=1000, low=1003, limit=2900, chunk=2500,
         bp=1024, idx_dtype=torch.int32),
    # tie-heavy: the area depends on the pitch and the nodes alone
    dict(metric="area_mm2", start=0, low=0, limit=None, chunk=None,
         bp=4096, idx_dtype=torch.int32),
    # int64 indices, a ragged last block
    dict(metric="total_j", start=77, low=0, limit=None, chunk=3000,
         bp=512, idx_dtype=torch.int64),
])
def test_kernel_every_cluster_matches_twin(cuda, wide_prep, cluster, kk,
                                           case):
    from repro_torch.core.batch import build_coeff_compute
    from repro_torch.kernels import fused_sweep as fs
    prep = wide_prep
    chunk = case["chunk"] or prep.total
    kw = dict(compute=build_coeff_compute(prep.bank.dims),
              metric=case["metric"], axis_names=tuple(prep.vgrids[0].names),
              shape=prep.vgrids[0].shape, n_var=prep.n_var,
              total=prep.total, chunk=chunk, lmax=prep.lmax,
              block_points=case["bp"], kk=kk, idx_dtype=case["idx_dtype"])
    variant = case["start"] // prep.n_var
    args = (prep.table2, prep.bank.fused[variant], case["start"],
            case["low"], case["limit"] or prep.total)
    p = fs.make_plan(min(case["bp"], chunk), kk, chunk, cluster)
    fs.reset_counts()
    ker = fs.run(*args, p, **kw)
    torch.cuda.synchronize()
    assert fs.COUNTS["kernel_launches"] == 1
    assert fs.COUNTS[f"cluster{cluster}_launches"] == 1
    twin = fs.fused_sweep_block_torch(*args, **kw)
    _assert_close(ker, twin)
    np.testing.assert_array_equal(ker[1].cpu().numpy(),
                                  twin[1].cpu().numpy())
    if case["metric"] == "area_mm2":          # ties did occur
        cv = twin[0].cpu().numpy()
        assert np.any(cv[:, 1:] == cv[:, :-1]) or kk == 1


def _staging(fs, prep, p):
    from repro_torch.core.plan_bank import BankDims, bank_layout
    dims = BankDims(*prep.bank.dims)
    return fs.staging(bank_layout(dims)["__width__"][0], dims,
                      prep.vgrids[0].shape, prep.n_var,
                      prep.table2.shape[1] // prep.lmax, p)


def test_kernel_per_point_timing_matches_twin(cuda):
    """96 x 96 (sys_rows, sys_cols) pairs of (D + 1 + M) = 8 words pass
    the shared memory a block has, so each point times its own digital
    stages: the path every other case tables."""
    from repro_torch.core.batch import build_coeff_compute
    from repro_torch.core.shard_sweep import _prepare_stream
    from repro_torch.kernels import fused_sweep as fs
    grid = list(np.linspace(4.0, 128.0, 96))
    prep = _prepare_stream("edgaze", {"variant": ["2d_in"],
                                      "sys_rows": grid, "sys_cols": grid,
                                      "frame_rate": [30.0, 2000.0]},
                           device=cuda)
    dims = prep.bank.dims
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    assert not _staging(fs, prep, fs.plan(1024, 8, prep.total, n_sm)).tim
    kw = dict(compute=build_coeff_compute(dims), metric="total_j",
              axis_names=tuple(prep.vgrids[0].names),
              shape=prep.vgrids[0].shape, n_var=prep.n_var,
              total=prep.total, chunk=prep.total, lmax=prep.lmax,
              block_points=1024, kk=8)
    args = (prep.table2, prep.bank.fused[0], 0, 0, prep.total)
    ker = fs.fused_sweep_block(*args, **kw)
    torch.cuda.synchronize()
    twin = fs.fused_sweep_block_torch(*args, **kw)
    _assert_close(ker, twin)
    np.testing.assert_array_equal(ker[1].cpu().numpy(),
                                  twin[1].cpu().numpy())


def _synthetic_prep(cuda, sizes, n_variants):
    """The synthetic row on a grid of registry axes (``sizes`` values
    each, 1 elsewhere), repeated over ``n_variants`` variants."""
    from types import SimpleNamespace
    from repro_torch.core.grid import ChunkedGrid, axis_tables, fused_table2
    from repro_torch.core.plan_bank import bank_from_reference
    from repro_torch.testing import synthetic_bank
    dims, fused = synthetic_bank(0)
    grid = ChunkedGrid({
        "cis_node": [130.0], "soc_node": [22.0], "mem_tech": [1.0],
        "sys_rows": [16.0], "sys_cols": [32.0], "frame_rate": [60.0],
        "active_fraction_scale": [1.0], "pixel_pitch_um": [3.0],
        "vdd_scale": [1.0], "adc_bits": [10.0], **sizes})
    bank = bank_from_reference({"fused": fused}, dims, device=cuda)
    table2 = torch.from_numpy(fused_table2(axis_tables(
        [grid] * n_variants))).to(cuda)
    return SimpleNamespace(bank=bank, vgrids=[grid], n_var=len(grid),
                           total=len(grid) * n_variants,
                           lmax=max(grid.shape), table2=table2)


@pytest.mark.parametrize("cluster", [1, 2, None])
@pytest.mark.parametrize("case", [
    # 20 variants of 1,000 cis_node values: a tile's variants do not fit,
    # so passes of 8,000 points restage their variants' tables
    dict(sizes={"cis_node": list(np.linspace(14.0, 130.0, 1000))},
         n_variants=20, bp=16384, start=0, chunk=20_000,
         passes={1: (3, True), 2: (2, True), None: (1, False)}),
    # one block a chunk, 300,000 points: 32,768 a CTA of 8, in passes of
    # 8,192; the second, ragged block's last ranks are padding
    dict(sizes={"cis_node": list(np.linspace(14.0, 130.0, 1000)),
                "frame_rate": list(np.geomspace(15.0, 3000.0, 300))},
         n_variants=1, bp=2 ** 18, start=1000, chunk=299_000,
         passes={1: (32, False), 2: (16, False), None: (4, False)}),
])
def test_kernel_multi_pass_matches_twin(cuda, cluster, case):
    """Blocks whose CTAs take their points in passes (forced clusters of
    1 and 2, and the plan the wrapper picks: one pass on the first grid)
    against the twin, every candidate position equal."""
    from repro_torch.core.batch import build_coeff_compute
    from repro_torch.kernels import fused_sweep as fs
    prep = _synthetic_prep(cuda, case["sizes"], case["n_variants"])
    bp, chunk = case["bp"], case["chunk"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    p = fs.plan(bp, 16, chunk, n_sm) if cluster is None \
        else fs.make_plan(bp, 16, chunk, cluster)
    st = _staging(fs, prep, p)
    # (passes a CTA, passes cut short of the tile)
    assert (-(-p.rank_points // st.span), st.span < p.tile) \
        == case["passes"][cluster]
    kw = dict(compute=build_coeff_compute(prep.bank.dims), metric="total_j",
              axis_names=tuple(prep.vgrids[0].names),
              shape=prep.vgrids[0].shape, n_var=prep.n_var,
              total=prep.total, chunk=chunk, lmax=prep.lmax,
              block_points=bp, kk=16)
    args = (prep.table2, prep.bank.fused[0], case["start"], 0, prep.total)
    fs.reset_counts()
    ker = fs.run(*args, p, **kw)
    torch.cuda.synchronize()
    assert fs.COUNTS[f"cluster{p.cluster}_launches"] == 1
    twin = fs.fused_sweep_block_torch(*args, **kw)
    _assert_close(ker, twin)
    np.testing.assert_array_equal(ker[1].cpu().numpy(),
                                  twin[1].cpu().numpy())


def test_plan_fills_the_card_at_the_main_path_shape(cuda):
    from repro_torch.kernels import fused_sweep as fs
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    p = fs.plan(4096, 3, 2 ** 18, n_sm)
    assert p.ctas >= n_sm and p.cluster > 1


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
    gpu = explore(space, engine="fused", chunk_size=512, k=5)
    cpu = explore(space, engine="fused", chunk_size=512, k=5, device="cpu")
    assert gpu.backend == "cuda" and cpu.backend == "torch"
    assert (gpu.n_points, gpu.n_feasible) == (cpu.n_points, cpu.n_feasible)
    assert [(r["algorithm"], r["variant"], r["index"]) for r in gpu.topk] \
        == [(r["algorithm"], r["variant"], r["index"]) for r in cpu.topk]
    np.testing.assert_allclose([r["total_j"] for r in gpu.topk],
                               [r["total_j"] for r in cpu.topk], rtol=1e-6)
    assert gpu.cache["stream"]["kernel_launches"] > 0


@pytest.mark.parametrize("engine", ["fused", "staged", "chunked"])
def test_repeated_device_mesh_matches_the_cpu_mesh(cuda, engine):
    """Four shards on one card (``BatchMesh([cuda:0] * 4)``: K1, or K2
    and K3a, once a shard of every chunk; K4 once a shard of every batch)
    against the port's 4-shard CPU mesh: top-k indices exact and values
    rel 1e-6, counts exact; the card's mesh against its one-device run:
    top-k bit for bit."""
    from repro_torch.core.shard_sweep import stream_cache_info
    from repro_torch.explore import DesignSpace, explore
    from repro_torch.kernels.category_reduce import COUNTS as K4
    from repro_torch.launch import BatchMesh, make_batch_mesh
    space = DesignSpace(["edgaze", "rhythmic"], {
        k: v for k, v in GRIDS.items() if k != "variant"})
    four = BatchMesh([torch.device("cuda", 0)] * 4)
    kw = dict(engine=engine, chunk_size=130, k=5)
    before = (stream_cache_info()["kernel_launches"], K4["kernel_launches"])
    gpu = explore(space, mesh=four, **kw)
    launched = (stream_cache_info()["kernel_launches"] - before[0],
                K4["kernel_launches"] - before[1])
    cpu = explore(space, mesh=make_batch_mesh(4, device="cpu"), **kw)
    one = explore(space, **kw)
    assert gpu.n_devices == cpu.n_devices == 4
    # streaming chunks round up to a multiple of the mesh; a grid batch
    # keeps its size and pads its last shard
    assert gpu.chunk_size == (130 if engine == "chunked" else 132)
    assert (gpu.n_points, gpu.n_feasible) == (cpu.n_points, cpu.n_feasible)
    assert [(r["algorithm"], r["variant"], r["index"]) for r in gpu.topk] \
        == [(r["algorithm"], r["variant"], r["index"]) for r in cpu.topk]
    np.testing.assert_allclose([r["total_j"] for r in gpu.topk],
                               [r["total_j"] for r in cpu.topk], rtol=1e-6)
    assert gpu.topk == one.topk and gpu.n_feasible == one.n_feasible
    if engine == "fused":
        n_var = gpu.n_points // gpu.n_variants
        assert launched[0] == 4 * gpu.n_variants * -(-n_var // 132)
    elif engine == "chunked":
        assert launched[1] == 4 * gpu.dispatches


# ---------------------------------------------------------------------------
# serving on the card (repro_torch.serve)
# ---------------------------------------------------------------------------
SERVE_GRIDS = {"variant": ["2d_in", "3d_in"],
               "cis_node": [130.0, 65.0, 28.0],
               "frame_rate": [15.0, 30.0, 60.0, 120.0],
               "sys_rows": [8.0, 32.0]}


def _serve_space(i):
    from repro_torch.explore import DesignSpace
    return DesignSpace(["edgaze"], dict(SERVE_GRIDS,
                                        vdd_scale=[0.80 + 0.01 * i, 1.0]))


def _run_threads(fn, n):
    import threading
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)


def test_service_on_cuda_coalesces_onto_one_step(cuda, monkeypatch):
    """8 client threads at a small grid: one coalesce group, one step
    build, every K1 launch on the service's worker thread, each tenant
    equal to its solo call (top-k values and indices bit-equal, rows rel
    1e-6); then a repeat wave replays from the cache with no launch."""
    import threading
    from repro_torch.core import shard_sweep
    from repro_torch.explore import explore
    from repro_torch.kernels import fused_sweep as fs
    from repro_torch.serve import ExploreService
    threads = []
    real_run = shard_sweep.k1_run

    def recording_run(*args, **kw):
        threads.append(threading.current_thread().name)
        return real_run(*args, **kw)

    monkeypatch.setattr(shard_sweep, "k1_run", recording_run)
    shard_sweep.stream_cache_clear()        # the step binds k1_run at build
    kw = dict(k=5, engine="fused", chunk_size=16, superchunk=2)
    out = {}
    with ExploreService(coalesce_window_s=0.2) as svc:
        def client(i):
            out[i] = explore(_serve_space(i), service=svc, **kw)
        _run_threads(client, 8)
        info = shard_sweep.stream_cache_info()
        assert info["step_builds"] == 1 and info["twin_calls"] == 0
        assert info["kernel_launches"] == len(threads) > 0
        assert set(threads) == {"repro-torch-serve-worker"}
        for i, res in out.items():
            assert res.serve["coalesce_group"] == 8
            assert res.backend == "cuda" and res.device == "cuda:0"
            solo = explore(_serve_space(i), **kw)
            assert [(r["total_j"], r["variant"], r["index"])
                    for r in res.topk] \
                == [(r["total_j"], r["variant"], r["index"])
                    for r in solo.topk]
            for a, b in zip(res.topk, solo.topk):
                for key, val in b.items():
                    if isinstance(val, float):
                        np.testing.assert_allclose(a[key], val, rtol=1e-6)
        assert shard_sweep.stream_cache_info()["step_builds"] == 1

        fs.reset_counts()
        wave2 = {}

        def replay(i):
            wave2[i] = svc.explore(_serve_space(i), **kw)
        _run_threads(replay, 8)
        assert fs.COUNTS["kernel_launches"] == 0
        assert all(r.serve["cache_hit"] and r.serve["dispatches"] == 0
                   and r.topk == out[i].topk for i, r in wave2.items())
    monkeypatch.undo()
    shard_sweep.stream_cache_clear()        # drop the recording step


def test_service_on_cuda0_from_a_fresh_thread(cuda):
    """A service on ``cuda:0`` driven from a thread whose current device
    was never set: its worker makes the device current, a streamed
    request equals the straight fused run bit for bit."""
    import threading
    from repro_torch.explore import explore
    from repro_torch.serve import ExploreService
    kw = dict(k=4, engine="fused", chunk_size=8, superchunk=1)
    straight = explore(_serve_space(3), **kw)
    got = {}

    def tenant():
        with ExploreService(device="cuda:0", partial_interval_s=0) as svc:
            h = svc.submit(_serve_space(3), stream=True, **kw)
            got["updates"] = list(h.partials())
            got["res"] = h.result(timeout=300)
            got["staged"] = svc.explore(_serve_space(3), k=3,
                                        engine="staged", chunk_size=8)

    t = threading.Thread(target=tenant)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive()
    res, updates = got["res"], got["updates"]
    assert res.backend == "cuda" and res.device == "cuda:0"
    assert res.topk == straight.topk
    assert json.dumps(res.summaries) == json.dumps(straight.summaries)
    assert len(updates) == res.dispatches and updates[-1].final
    assert [u.seq for u in updates] == list(range(len(updates)))
    assert [u.done for u in updates] == sorted(u.done for u in updates)
    assert got["staged"].engine == "staged"


# ---------------------------------------------------------------------------
# the LM serving path (P12a) on the card: plain torch ops, no port kernel
# ---------------------------------------------------------------------------
LM_ARCHS = ["llava_next_34b", "whisper_medium", "olmo_1b", "qwen2_5_32b",
            "qwen2_7b", "qwen3_4b", "falcon_mamba_7b", "granite_moe_1b_a400m",
            "mixtral_8x7b", "zamba2_1p2b"]


@pytest.fixture
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _lm_batch(cfg, n, device):
    rng = np.random.default_rng(0)
    out = {}
    if cfg.family == "vlm":
        out["embeds"] = rng.standard_normal((2, n, cfg.d_model),
                                            dtype=np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (2, n))
    if cfg.family == "encdec":
        out["audio_embeds"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def _lm_serve(cfg, params, device, s=48, steps=3):
    """prefill(s) and ``steps`` greedy decode steps on ``device``: every
    call's logits, the greedy tokens and the final cache."""
    from repro_torch.models import model as M
    p = {k: ({kk: vv.to(device) for kk, vv in v.items()}
             if isinstance(v, dict) else v.to(device))
         for k, v in params.items()}
    with torch.inference_mode():
        logits, cache = M.prefill(p, _lm_batch(cfg, s, device),
                                  M.init_cache(cfg, 2, s + steps,
                                               device=device), cfg)
        outs, toks = [logits], []
        for _ in range(steps):
            toks.append(torch.argmax(logits[:, -1], -1)[:, None])
            logits, cache = M.decode_step(p, toks[-1], cache, cfg)
            outs.append(logits)
    return outs, torch.cat(toks, 1), cache


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_reduced_arch_on_cuda_matches_cpu(cuda, no_tf32, arch):
    """The reduced config in f32 (TF32 off), the same weights on both:
    every call's logits and the final cache within 1e-4 max|cpu|, the
    greedy tokens equal (S = 48 rolls mixtral's and zamba2's ring)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, 0, device="cpu")
    c_out, c_tok, c_cache = _lm_serve(cfg, params, "cpu")
    g_out, g_tok, g_cache = _lm_serve(cfg, params, cuda)
    assert torch.equal(g_tok.cpu(), c_tok)
    assert int(g_cache["pos"]) == int(c_cache["pos"]) == 51
    pairs = list(zip(c_out, g_out)) + [(c_cache[k], g_cache[k])
                                       for k in c_cache if k != "pos"]
    for c, g in pairs:
        assert g.device.type == "cuda" and g.dtype == c.dtype
        c, g = c.double(), g.cpu().double()
        assert float((g - c).abs().max()) <= 1e-4 * float(c.abs().max())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_and_decode_make_no_host_sync(cuda, arch):
    """After a warm-up (cuBLAS handles), prefill and two decode steps run
    under the sync debug mode "error": a host sync would raise."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="bfloat16")
    params = M.init_params(cfg, 0, device=cuda)
    batch = _lm_batch(cfg, 40, cuda)
    nxt = (batch.get("embeds", batch.get("tokens")))[:, :1]
    with torch.inference_mode():
        _, cache = M.prefill(params, batch, M.init_cache(cfg, 2, 48), cfg)
        M.decode_step(params, nxt, cache, cfg)
        cache = M.init_cache(cfg, 2, 48)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, cache = M.prefill(params, batch, cache, cfg)
            for _ in range(2):
                logits, cache = M.decode_step(params, nxt, cache, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(logits).all()) and int(cache["pos"]) == 42


def _train_batch(cfg, n, device):
    rng = np.random.default_rng(1)
    out = {"tokens": rng.integers(0, cfg.vocab, (2, n))}
    if cfg.family == "vlm":
        out = {"embeds": rng.standard_normal((2, n, cfg.d_model),
                                             dtype=np.float32),
               "labels": out["tokens"]}
    elif cfg.family == "encdec":
        out["audio_embeds"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step_on_cuda_matches_cpu(cuda, no_tf32, arch):
    """One f32 train step (reduced config, TF32 off) on the same weights
    and batch: loss within rel 1e-5, grad_norm within rel 1e-4, the
    moments within 1e-4 max|cpu leaf|, the parameters within ``2 lr +
    1e-6 |p|`` (``1e-3 lr`` where the first moment is above 1e-3 of its
    leaf's largest)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.tree import leaves as tree_leaves
    from repro_torch.tree import tree_map
    from repro_torch.train import build_train_step
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, 0, device="cpu")
    step = build_train_step(cfg, warmup_steps=2, total_steps=8)
    runs = {}
    for dev in ("cpu", cuda):
        # a copy on each device: the step writes its params in place
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        runs[str(dev)] = step(p, adamw_init(p), _train_batch(cfg, 40, dev),
                              1)
    (cp, co, cm), (gp, go, gm) = runs["cpu"], runs[str(cuda)]
    assert all(t.device.type == "cuda" for t in gm.values())
    for key, rel in (("loss", 1e-5), ("grad_norm", 1e-4)):
        assert abs(float(gm[key]) - float(cm[key])) <= rel * abs(
            float(cm[key])), key
    lr = float(cm["lr"])
    for key in ("m", "v"):
        for c, g in zip(tree_leaves(co[key]), tree_leaves(go[key])):
            c, g = c.double(), g.cpu().double()
            assert float((g - c).abs().max()) <= 1e-4 * float(
                c.abs().max())
    for c, g, m in zip(tree_leaves(cp), tree_leaves(gp),
                       tree_leaves(co["m"])):
        c, g, m = c.double(), g.cpu().double(), m.double()
        strong = m.abs() > 1e-3 * m.abs().max()
        bound = torch.where(strong, 1e-3 * lr, 2 * lr) + 1e-6 * c.abs()
        assert bool(((g - c).abs() <= bound).all())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step_makes_no_host_sync(cuda, arch):
    """After a warm-up step, a bf16 train step under each remat policy
    runs under the sync debug mode "error": a host sync would raise."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    for policy in ("full", "dots"):
        cfg = dataclasses.replace(reduced(get_config(arch)),
                                  dtype="bfloat16", remat_policy=policy)
        params = M.init_params(cfg, 0, device=cuda)
        opt = adamw_init(params)
        batch = _train_batch(cfg, 40, cuda)
        step = build_train_step(cfg, warmup_steps=2, total_steps=8)
        params, opt, _ = step(params, opt, batch, 0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            params, opt, m = step(params, opt, batch, 1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert bool(torch.isfinite(m["loss"])) and int(opt["count"]) == 2
