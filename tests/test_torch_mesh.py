"""P8: the batch axis split across a mesh, on the CPU.

Mirrors ``tests/test_shard_sweep.py:331-414``.  The reference runs ONCE,
in a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
(its eight "devices" are one CPU), on ``make_batch_mesh()``:
``evaluate_batch_sharded`` on 1,001 points, the chunked grid engine with
``chunk_size=13`` (batches padded to 16, shards of 2), fused streams
(``backend="xla"``), the staged stream, ragged and ``index_range`` runs
(a chunk and ``n_var = 36`` not divisible by 8; ``k`` above the shard),
and fused and staged runs whose metric is NaN at some points
(``tests/test_torch_topk_nan.py``'s patched evaluators).  The port runs
in this process on ``make_batch_mesh(8, device="cpu")``: eight logical
shards of the CPU.

The reference's rules: ``evaluate_batch_sharded`` and the grid tables
at rel 1e-6, atol 0; top-k flat indices exact and values rel 1e-6;
``n_feasible`` exact; per-variant means rel 1e-5.  Beyond them: one
step build per shape key (1, then 2 for edgaze+rhythmic), fewer fused
dispatches than staged ones, the 8-shard result equal to the port's
one-device result (top-k bit for bit, counts exact), a one-entry mesh
the same as ``device=``, the merge of ``(ndev,)`` partials against the
reference's ``_merge_candidates`` (NaN shards included), and the int64
window on 8 shards against R1's oracle (``variant_grid(...).point(flat)``
plus a one-point ``evaluate_batch``).
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_topk_nan as tn
from repro_torch.core import shard_sweep as ss
from repro_torch.explore import DesignSpace, explore
from repro_torch.launch import BatchMesh, make_batch_mesh, resolve_mesh

SRC = Path(__file__).resolve().parents[1] / "src"
TESTS = Path(__file__).resolve().parent
REL = 1e-6
REL_MEAN = 1e-5
CPU = "cpu"

GRIDS = {"variant": ["2d_in", "3d_in"], "cis_node": [130.0, 65.0],
         "frame_rate": [15.0, 30.0, 60.0], "sys_rows": [8.0, 16.0, 32.0],
         "mem_tech": ["sram_hp", "stt"]}

#: name -> (algorithms, explore keywords): the runs held to the reference
RUNS = {
    "fused": (["edgaze"], dict(engine="fused", chunk_size=32, k=5)),
    "both": (["edgaze", "rhythmic"],
             dict(engine="fused", chunk_size=32, k=5)),
    "ragged": (["edgaze"], dict(engine="fused", chunk_size=13, k=7)),
    "ranged": (["edgaze"], dict(engine="fused", chunk_size=13, k=7,
                                index_range=(5, 61))),
    "staged": (["edgaze"], dict(engine="staged", chunk_size=32, k=5)),
    "staged_ranged": (["edgaze"], dict(engine="staged", chunk_size=13, k=7,
                                       index_range=(5, 61))),
}
#: the NaN runs: tests/test_torch_topk_nan.py's grids and "both_nans"
NAN_KW = dict(k=5, chunk_size=16, block_points=4)

SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax
from repro.core import shard_sweep as ref
from repro.core.batch import make_points
from repro.core.sweep import lower_variant
from repro.explore import DesignSpace, explore
from repro.launch.mesh import make_batch_mesh
import test_torch_mesh as tm
import test_torch_topk_nan as tn

assert len(jax.devices()) == 8
mesh = make_batch_mesh()
out = {}
plan = lower_variant("edgaze", "3d_in")
for name, points in (("sharded", tm.POINTS), ("sharded_lists",
                                             tm.points_from_lists())):
    out[name] = {k: np.asarray(v) for k, v in ref.evaluate_batch_sharded(
        plan, make_points(plan, 1001, **points), mesh=mesh).items()}


def payload(r):
    return dict(topk=r.topk, summaries=r.summaries, n_points=r.n_points,
                n_feasible=r.n_feasible, n_devices=r.n_devices,
                chunk_size=r.chunk_size, dispatches=r.dispatches)


ch = explore(DesignSpace(["edgaze"], tm.GRIDS), engine="chunked",
             chunk_size=13, k=5, mesh=mesh)
out["chunked"] = dict(payload(ch), outputs={
    k: np.asarray(v) for k, v in ch.sweep_results["edgaze"].outputs.items()})
ref.stream_cache_clear()
for name, (algos, kw) in tm.RUNS.items():
    if kw["engine"] == "fused":
        kw = dict(kw, backend="xla")
    out[name] = payload(explore(DesignSpace(algos, tm.GRIDS), mesh=mesh,
                                **kw))
    out[name + "_steps"] = ref.stream_cache_info()["step_compiles"]
cases = tn.CASES["both_nans"]
ref.build_coeff_compute = tn._patch_compute(ref.build_coeff_compute, cases)
ref.build_banked_eval = tn._patch_banked(ref.build_banked_eval, cases)
ref.evaluate_bank = tn._patch_eval_bank(ref.evaluate_bank, cases)
ref.stream_cache_clear()
space = DesignSpace(["edgaze"], tn.GRIDS)
out["nan_fused"] = payload(explore(space, engine="fused", backend="xla",
                                   mesh=mesh, **tm.NAN_KW))
out["nan_staged"] = payload(explore(space, engine="staged", mesh=mesh,
                                    **tm.NAN_KW))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""

#: the 1,001 design points of the reference's sharded-evaluator check
POINTS = dict(cis_node=np.linspace(28, 130, 1001),
              frame_rate=np.linspace(15, 120, 1001))


def points_from_lists(n=1001, seed=0):
    """``n`` design points drawn from value lists, as the repo's parity
    tests draw them (ROADMAP R2: on continuous frame rates the
    reference's own evaluators disagree past rel 1e-6)."""
    rng = np.random.default_rng(seed)
    return dict(cis_node=rng.choice([28.0, 65.0, 90.0, 130.0], n),
                frame_rate=rng.choice([15.0, 30.0, 60.0, 120.0, 240.0], n),
                sys_rows=rng.choice([8.0, 16.0, 32.0], n),
                mem_tech=rng.choice([-1, 0, 1, 2], n),
                active_fraction_scale=rng.choice([0.25, 0.5, 1.0], n))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's runs on its 8 forced devices (one subprocess,
    ~25 s on a CPU)."""
    path = tmp_path_factory.mktemp("mesh_reference") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), str(TESTS), os.environ.get("PYTHONPATH", "")]),
        JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(path)],
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def mesh():
    return make_batch_mesh(8, device=CPU)


def _rows(res):
    return [(r["algorithm"], r["variant"], r["index"]) for r in res.topk]


def _metric(res):
    return [r["total_j"] for r in res.topk]


def assert_matches_reference(got, want):
    """The reference's rules: top-k indices exact, values rel 1e-6,
    counts exact, per-variant minima rel 1e-6 and means rel 1e-5."""
    assert (got.n_points, got.n_feasible, got.n_devices, got.chunk_size,
            got.dispatches) == (want["n_points"], want["n_feasible"],
                                want["n_devices"], want["chunk_size"],
                                want["dispatches"])
    assert _rows(got) == [(r["algorithm"], r["variant"], r["index"])
                          for r in want["topk"]]
    for a, b in zip(got.topk, want["topk"]):
        assert sorted(a) == sorted(b)
        for key, val in b.items():
            if not isinstance(val, str):
                np.testing.assert_allclose(a[key], val, rtol=REL, atol=0,
                                           err_msg=key)
    assert list(got.summaries) == list(want["summaries"])
    for label, b in want["summaries"].items():
        a = got.summaries[label]
        for key in ("n", "n_feasible", "argmin_index", "argmin_point"):
            assert a[key] == b[key], (label, key)
        for key, rel in (("metric_min", REL), ("metric_mean", REL_MEAN)):
            if np.isnan(b[key]):
                assert np.isnan(a[key]), (label, key)
            else:
                np.testing.assert_allclose(a[key], b[key], rtol=rel,
                                           err_msg=f"{label}.{key}")


def assert_same_sweep(a, b):
    """Two sweeps of the port over the same points on different meshes:
    top-k bit for bit, counts exact, minima exact, means rel 1e-5."""
    assert (a.n_points, a.n_feasible) == (b.n_points, b.n_feasible)
    assert a.topk == b.topk
    for label, sa in a.summaries.items():
        sb = b.summaries[label]
        for key in ("n", "n_feasible", "argmin_index", "argmin_point",
                    "metric_min"):
            assert sa[key] == sb[key], (label, key)
        np.testing.assert_allclose(sa["metric_mean"], sb["metric_mean"],
                                   rtol=REL_MEAN)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
def test_batch_mesh_on_the_cpu():
    m = make_batch_mesh(8, device=CPU)
    assert m.size == 8 and m.axis_names == ("batch",)
    assert m.devices == (torch.device(CPU),) * 8
    assert m.distinct == (torch.device(CPU),)
    assert make_batch_mesh(device=CPU).size == 1
    assert BatchMesh([CPU, "cpu"]) == make_batch_mesh(2, device=CPU)
    with pytest.raises(RuntimeError, match="at least one"):
        make_batch_mesh(0, device=CPU)
    with pytest.raises(ValueError, match="at least one device"):
        BatchMesh([])
    with pytest.raises(TypeError, match="sequence of devices"):
        BatchMesh(CPU)


def test_batch_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (make_batch_mesh, lambda: BatchMesh(["cuda:0"] * 4),
                  lambda: resolve_mesh()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_resolve_mesh_and_conflicts(mesh):
    assert resolve_mesh(None, CPU).devices == (torch.device(CPU),)
    assert resolve_mesh(mesh) is mesh and resolve_mesh(mesh, CPU) is mesh
    with pytest.raises(ValueError, match="conflicts with mesh="):
        resolve_mesh(mesh, "cuda")
    with pytest.raises(TypeError, match="BatchMesh"):
        resolve_mesh(object())
    space = DesignSpace(["edgaze"], GRIDS)
    with pytest.raises(ValueError, match="conflicts with mesh="):
        explore(space, k=1, mesh=mesh, device="cuda:0")


def test_mesh_key_of_one_entry_is_the_device_key(mesh):
    """A one-entry mesh keys its steps as ``device=`` always has; an
    8-shard mesh keys them apart."""
    one = make_batch_mesh(1, device=CPU)
    assert ss._mesh_key(one) == ss._device_key(torch.device(CPU)) == CPU
    assert ss._mesh_key(mesh) == (CPU,) * 8
    assert ss._mesh_key(make_batch_mesh(4, device=CPU)) != ss._mesh_key(mesh)


def test_prep_keeps_one_replica_a_device(mesh):
    """A repeated device shares one replica of the tables and the bank."""
    prep = ss._prepare_stream("edgaze", GRIDS, mesh=mesh)
    assert list(prep.replicas) == [torch.device(CPU)]
    shards = prep.shards(mesh)
    assert len(shards) == 8
    assert all(t is prep.table2 and b is prep.bank for t, b in shards)


# ---------------------------------------------------------------------------
# the grid engines: evaluate_batch_sharded
# ---------------------------------------------------------------------------
def test_pad_points_repeats_the_last_point():
    from repro_torch.core.batch import make_points
    from repro_torch.core.grid import lower_variant
    plan = lower_variant("edgaze", "3d_in")
    pts = make_points(plan, 13, device=CPU, frame_rate=np.arange(13.0) + 1)
    padded, b = ss.pad_points(pts, 8)
    assert b == 13 and padded.batch == 16
    assert padded.frame_rate.tolist() == list(range(1, 14)) + [13.0] * 3
    same, b = ss.pad_points(padded, 8)
    assert same is padded and b == 16


def _port_sharded(points, mesh):
    from repro_torch.core.batch import evaluate_batch, make_points
    from repro_torch.core.grid import lower_variant
    plan = lower_variant("edgaze", "3d_in")
    pts = make_points(plan, 1001, device=CPU, **points)
    timings = {}
    got = ss.evaluate_batch_sharded(plan, pts, mesh=mesh, timings=timings)
    assert timings["eval_s"] > 0
    # a point's outputs do not depend on its shard
    one = evaluate_batch(plan, pts)
    assert sorted(got) == sorted(one)
    for key, val in one.items():
        assert got[key].shape == val.shape, key
        np.testing.assert_array_equal(got[key], val, err_msg=key)
    return got


def test_evaluate_batch_sharded_matches_reference(reference, mesh):
    """1,001 points drawn from value lists (padded to 1,008, shards of
    126): every output at rel 1e-6, atol 0, and bit-equal to the port's
    one-device ``evaluate_batch``."""
    got = _port_sharded(points_from_lists(), mesh)
    for key, val in reference["sharded_lists"].items():
        np.testing.assert_allclose(got[key], val, rtol=REL, atol=0,
                                   err_msg=key)


def test_evaluate_batch_sharded_on_continuous_points(reference, mesh):
    """The reference's own 1,001 points (continuous cis nodes and frame
    rates): bit-equal to the port's one-device ``evaluate_batch``, and
    against the reference within R2's band: the two packages' per-plan
    evaluators differ by at most 2.3e-6, and past rel 1e-6 only on
    ``cat_ADC_j`` at one point, as the reference's own evaluators differ
    on continuous frame rates (``ROADMAP.md`` R2; no mesh is involved:
    the reference's 8-shard and one-device outputs are bit-equal)."""
    got = _port_sharded(POINTS, mesh)
    for key, val in reference["sharded"].items():
        got_k, val = got[key].astype(np.float64), val.astype(np.float64)
        rel = np.abs(got_k - val) / np.maximum(np.abs(val), 1e-300)
        assert rel.max() <= 2.3e-6, (key, rel.max())
        assert np.count_nonzero(rel > REL) <= (1 if key == "cat_ADC_j"
                                               else 0), key


def test_chunked_grid_on_the_mesh_matches_reference(reference, mesh):
    want = reference["chunked"]
    got = explore(DesignSpace(["edgaze"], GRIDS), engine="chunked",
                  chunk_size=13, k=5, mesh=mesh)
    assert got.n_devices == 8 and got.device == CPU
    outputs = got.sweep_results["edgaze"].outputs
    for key, val in want["outputs"].items():
        np.testing.assert_allclose(outputs[key], val, rtol=REL, atol=0,
                                   err_msg=key)
    assert_matches_reference(got, want)
    one = explore(DesignSpace(["edgaze"], GRIDS), engine="chunked",
                  chunk_size=13, k=5, device=CPU)
    assert_same_sweep(got, one)


def test_run_study_on_the_mesh():
    """``run_study(mesh=)`` passes the mesh to the grid engine: the same
    rows as on one device."""
    from repro_torch.core.usecases import run_study
    one = run_study("edgaze", device=CPU)
    assert run_study("edgaze", mesh=make_batch_mesh(8, device=CPU)) == one
    assert run_study("edgaze", chunk_size=5,
                     mesh=make_batch_mesh(8, device=CPU)) == one


# ---------------------------------------------------------------------------
# the streaming engines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(RUNS))
def test_stream_on_the_mesh_matches_reference(reference, mesh, name):
    algos, kw = RUNS[name]
    got = explore(DesignSpace(algos, GRIDS), mesh=mesh, **kw)
    assert got.n_devices == 8 and got.device == CPU
    assert_matches_reference(got, reference[name])


#: the reference's staged engine fails on its 8-device mesh at an even
#: ``k`` (ROADMAP R5), so an even ``k`` is held to one device only
ONE_DEVICE_RUNS = dict(RUNS, staged_even_k=(
    ["edgaze", "rhythmic"], dict(engine="staged", chunk_size=16, k=6)))


@pytest.mark.parametrize("name", sorted(ONE_DEVICE_RUNS))
def test_stream_on_the_mesh_equals_one_device(mesh, name):
    """Each point's value does not depend on its shard: 8 shards give the
    one-device top-k bit for bit and its counts exactly."""
    algos, kw = ONE_DEVICE_RUNS[name]
    space = DesignSpace(algos, GRIDS)
    assert_same_sweep(explore(space, mesh=mesh, **kw),
                      explore(space, device=CPU, **kw))


def test_one_step_build_a_shape_key(reference, mesh):
    """One step for edgaze, a second for edgaze+rhythmic (other bank
    dims), as the reference compiles one executable each; every shard of
    a live chunk launches (the twin here: 8 a chunk ordinal)."""
    assert (reference["fused_steps"], reference["both_steps"]) == (1, 2)
    ss.stream_cache_clear()
    res = explore(DesignSpace(["edgaze"], GRIDS), mesh=mesh,
                  **RUNS["fused"][1])
    info = ss.stream_cache_info()
    assert info["step_builds"] == 1
    ordinals = 2 * -(-res.stream_result.n_var // res.chunk_size)
    assert info["twin_calls"] == 8 * ordinals
    explore(DesignSpace(["edgaze", "rhythmic"], GRIDS), mesh=mesh,
            **RUNS["both"][1])
    assert ss.stream_cache_info()["step_builds"] == 2


def test_fused_dispatches_fewer_than_staged(mesh):
    space = DesignSpace(["edgaze"], GRIDS)
    fused = explore(space, mesh=mesh, **RUNS["fused"][1])
    staged = explore(space, mesh=mesh, **RUNS["staged"][1])
    assert fused.dispatches < staged.dispatches
    assert _rows(fused) == _rows(staged)
    assert fused.n_feasible == staged.n_feasible


@pytest.mark.parametrize("engine", ["fused", "staged"])
def test_one_entry_mesh_is_device(engine):
    """``mesh=make_batch_mesh(1)`` is ``device=``: one step between
    them, the same launches (twin calls here) and the same result."""
    space = DesignSpace(["edgaze", "rhythmic"], GRIDS)
    kw = dict(engine=engine, chunk_size=13, k=7)
    ss.stream_cache_clear()
    by_device = explore(space, device=CPU, **kw)
    calls = ss.stream_cache_info()["twin_calls"]
    by_mesh = explore(space, mesh=make_batch_mesh(1, device=CPU), **kw)
    info = ss.stream_cache_info()
    assert info["step_builds"] == 1
    assert info["twin_calls"] == 2 * calls
    assert by_mesh.n_devices == by_device.n_devices == 1
    assert by_mesh.topk == by_device.topk
    assert by_mesh.summaries == by_device.summaries


@pytest.mark.parametrize("engine", ["fused", "staged"])
def test_nan_shard_matches_reference(reference, mesh, engine, monkeypatch):
    """NaN metrics at some points (``both_nans``: a positive NaN where
    the total order ranks it last, a sign-bit NaN where it ranks first):
    a shard whose minimum is NaN wins the variant's minimum, as
    ``jnp.argmin`` picks it."""
    cases = tn.CASES["both_nans"]
    ss.stream_cache_clear()
    monkeypatch.setattr(ss, "build_coeff_compute",
                        tn._patch_compute(ss.build_coeff_compute, cases))
    monkeypatch.setattr(ss, "build_banked_eval",
                        tn._patch_banked(ss.build_banked_eval, cases))
    try:
        got = explore(DesignSpace(["edgaze"], tn.GRIDS), engine=engine,
                      mesh=mesh, **NAN_KW)
    finally:
        ss.stream_cache_clear()
    want = reference[f"nan_{engine}"]
    assert (got.n_points, got.n_feasible, got.dispatches) == (
        want["n_points"], want["n_feasible"], want["dispatches"])
    assert _rows(got) == [(r["algorithm"], r["variant"], r["index"])
                          for r in want["topk"]]
    np.testing.assert_array_equal(tn._bits(_metric(got)),
                                  tn._bits([r["total_j"]
                                            for r in want["topk"]]))
    tn._summaries_equal(got.summaries, want["summaries"])
    assert any(np.isnan(s["metric_min"]) for s in got.summaries.values())


# ---------------------------------------------------------------------------
# the merge of (ndev,) partials
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("x", [
    [3.0, 1.0, 1.0, 2.0], [np.inf, np.inf], [2.0, np.nan, 1.0, np.nan],
    [tn.NEG_NAN, 1.0], [1.0, -np.inf, tn.POS_NAN], [0.0, -0.0], [5.0]])
def test_first_min_is_jnp_argmin(x):
    import jax.numpy as jnp
    x = np.asarray(x, np.float32)
    assert int(ss._first_min(torch.from_numpy(x))) == int(jnp.argmin(x))


@pytest.mark.parametrize("ndev,kk,seed", [(8, 2, 0), (4, 3, 1), (3, 5, 2),
                                          (2, 1, 3)])
def test_shard_partials_merge_as_reference(ndev, kk, seed):
    """``_combine_shards`` then ``_merge_candidates`` against the
    reference's ``_merge_candidates`` on ``(ndev,)`` partials, over
    several chunks: candidates in shard order, NaN and ``+-inf`` minima,
    ties; the running state bit for bit."""
    import jax.numpy as jnp
    from repro.core import shard_sweep as ref
    from repro_torch.core.batch import OUT_KEYS

    rng = np.random.default_rng(seed)
    k, n_variants = 6, 3
    ours = ss._init_banked_state(k, n_variants, torch.int32, CPU,
                                 with_out=True)
    want = {key: jnp.asarray(val.numpy()) for key, val in ours.items()}
    flat = 0
    for step in range(6):
        v = int(rng.integers(n_variants))
        parts = []
        for _ in range(ndev):
            cand_i = np.arange(flat, flat + kk, dtype=np.int32)
            flat += kk
            parts.append(dict(
                cand_v=tn._draw(rng, kk) if kk > 2 else rng.choice(
                    tn.POOL, kk).astype(np.float32),
                cand_i=cand_i,
                cand_out=rng.random((kk, len(OUT_KEYS))).astype(np.float32),
                mins=np.float32(rng.choice(tn.POOL)),
                amin_i=np.int32(rng.integers(flat)),
                sums=np.float32(rng.choice([1.5, -2.0, 0.25, np.inf])),
                counts=np.float32(rng.integers(0, 5))))
        cat = {key: np.concatenate([np.atleast_1d(p[key]) for p in parts])
               for key in parts[0]}
        want = ref._merge_candidates(
            {key: jnp.asarray(val) for key, val in cat.items()}, v, want, k,
            True)
        ss._merge_candidates(ss._combine_shards(
            [{key: torch.as_tensor(val) for key, val in p.items()}
             for p in parts], torch.device(CPU)), v, ours, k)
        tn._assert_state_equal(ours, want, f"step {step}")


# ---------------------------------------------------------------------------
# int64 flat indices on 8 shards (R1: the reference's own oracle)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["fused", "staged"])
def test_int64_window_on_the_mesh(mesh, engine):
    import test_torch_explore as tte
    grids = {"variant": ["3d_in"],
             "cis_node": list(np.linspace(28.0, 130.0, 1500)),
             "frame_rate": list(np.linspace(15.0, 120.0, 1500)),
             "active_fraction_scale": list(np.linspace(0.1, 1.0, 1000))}
    total, n = 1500 * 1500 * 1000, 150
    assert total >= 2 ** 31
    space = DesignSpace(["edgaze"], grids)
    kw = dict(engine=engine, chunk_size=60, k=4,
              index_range=(total - n, total))
    res = explore(space, mesh=mesh, **kw)
    assert res.chunk_size == 64 and res.n_devices == 8
    assert res.n_points == n and res.summaries["3d_in"]["n"] == n
    assert 0 < res.n_feasible <= n
    assert all(total - n <= r["index"] < total for r in res.topk)
    for row in res.topk:
        np.testing.assert_allclose(
            row["total_j"], tte._oracle_total(grids, row["index"]),
            rtol=REL)
    assert_same_sweep(res, explore(space, device=CPU, **dict(
        kw, chunk_size=64)))
