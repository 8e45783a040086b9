"""P9: campaigns on the port (manifest / retry / resume), on the CPU.

Mirrors ``tests/test_campaign.py`` test for test on the same small space
(``GRIDS``, ``CHUNK, K, SUPER = 4, 6, 16``, ``shard_points=7``
straddling variant boundaries), with ``device="cpu"`` in place of the
reference's one-device mesh and ``preps`` (one stream preparation a
campaign) in place of its one step executable.  The reference's
``test_stream_cache_limit_validation`` has no counterpart: the port keeps
no executable cache for ``set_stream_cache_limit`` to bound (ROADMAP,
differences kept on purpose).

Beyond the mirror, the port is held to the reference itself: a port
campaign equals the reference's ``run_campaign`` (xla backend) by the
``_assert_equal`` rule, the two manifests name the same campaign (space
and bank signatures, shard plan, sweep), and a manifest the reference
wrote is refused, as is a resume on the other lane.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.campaign import (CampaignIntegrityError,
                                  CampaignMismatchError, CampaignOptions,
                                  DeterministicFault, FaultSchedule,
                                  KillCampaign, OOMFault, ShardTimeout,
                                  TransientFault, classify_failure,
                                  merge_stream_results, missing_ranges,
                                  plan_shards, resume, run_campaign)
from repro_torch.campaign.manifest import read_shard, shard_path
from repro_torch.core.shard_sweep import (StreamResult, stream_cache_clear,
                                          stream_cache_info)
from repro_torch.explore import DesignSpace, explore
from repro_torch.launch import make_batch_mesh

REL = 1e-6

GRIDS = {"variant": ["2d_in", "3d_in"],
         "frame_rate": [15.0, 30.0, 60.0],
         "sys_rows": [8.0, 32.0],
         "vdd_scale": [0.9, 1.0, 1.1]}

#: shared sweep shape: every campaign in this module (and the straight
#: reference) rides the same (chunk, superchunk, k) dispatches
CHUNK, K, SUPER = 4, 6, 16
CPU = "cpu"


@pytest.fixture(scope="module")
def space():
    return DesignSpace(["edgaze"], GRIDS)


@pytest.fixture(scope="module")
def straight(space):
    return explore(space, engine="fused", chunk_size=CHUNK, k=K,
                   superchunk=SUPER, device=CPU)


def _opts(**kw):
    kw.setdefault("shard_points", 7)   # straddles variant boundaries
    kw.setdefault("sleep", lambda _s: None)
    return CampaignOptions(**kw)


def _campaign(space, d, **kw):
    return run_campaign(space, str(d), k=K, engine="fused",
                        chunk_size=CHUNK, device=CPU, options=_opts(**kw))


def _assert_equal(a, b, *, rtol=REL):
    """topk / summaries / count parity between two explore results."""
    assert a.n_points == b.n_points
    assert a.n_feasible == b.n_feasible
    assert ([(r["variant"], r["index"]) for r in a.topk]
            == [(r["variant"], r["index"]) for r in b.topk])
    np.testing.assert_allclose([r[a.metric] for r in a.topk],
                               [r[b.metric] for r in b.topk], rtol=rtol)
    assert list(a.summaries) == list(b.summaries)
    for label, sa in a.summaries.items():
        sb = b.summaries[label]
        assert sa["n"] == sb["n"] and sa["n_feasible"] == sb["n_feasible"]
        for key in ("metric_min", "metric_mean"):
            if np.isnan(sa[key]) or np.isnan(sb[key]):
                assert np.isnan(sa[key]) and np.isnan(sb[key])
            else:
                np.testing.assert_allclose(sa[key], sb[key], rtol=1e-5,
                                           err_msg=f"{label}.{key}")


# ---------------------------------------------------------------------------
# campaign == straight == monolithic, one preparation, durable artifacts
# ---------------------------------------------------------------------------
def test_campaign_matches_straight_and_monolithic(space, straight,
                                                  tmp_path):
    stream_cache_clear()
    res = _campaign(space, tmp_path)
    assert stream_cache_info()["preps"] == 1, \
        "all campaign shards must share ONE stream preparation"
    _assert_equal(res, straight)
    mono = explore(space, engine="monolithic", k=K, device=CPU)
    np.testing.assert_allclose([r[res.metric] for r in res.topk],
                               [r[mono.metric] for r in mono.topk],
                               rtol=REL)
    # durable artifacts: manifest + checksummed shard files + report
    assert (tmp_path / "manifest.json").exists()
    assert (tmp_path / "report.json").exists()
    man = json.loads((tmp_path / "manifest.json").read_text())
    assert man["schema"] == 1 and man["n_points"] == space.n_points
    assert [tuple((s["lo"], s["hi"])) for s in man["shards"]] \
        == plan_shards(space.n_points, 7)
    for s in man["shards"]:
        payload = read_shard(shard_path(str(tmp_path), s["lo"], s["hi"]))
        assert payload["shard"]["lo"] == s["lo"]
        assert payload["result"]["n_points"] == s["hi"] - s["lo"]
    assert res.campaign["n_executed"] == len(man["shards"])
    assert not res.campaign["partial"]
    assert res.device == CPU


def test_campaign_staged_engine(space, straight, tmp_path):
    res = run_campaign(space, str(tmp_path), k=K, engine="staged",
                       chunk_size=CHUNK, device=CPU, options=_opts())
    _assert_equal(res, straight)
    man = json.loads((tmp_path / "manifest.json").read_text())
    assert man["sweep"]["backend"] == "torch", "the device's lane"


def test_explore_checkpoint_dir_entry(space, straight, tmp_path):
    res = explore(space, engine="fused", chunk_size=CHUNK, k=K, device=CPU,
                  checkpoint_dir=str(tmp_path), campaign=_opts())
    _assert_equal(res, straight)
    # idempotent: a finished campaign re-verifies and merges, 0 dispatches
    again = explore(space, chunk_size=CHUNK, k=K, device=CPU,
                    checkpoint_dir=str(tmp_path))
    assert again.campaign["n_executed"] == 0
    assert again.campaign["resumed"] is True
    _assert_equal(again, straight)
    with pytest.raises(ValueError, match="require checkpoint_dir"):
        explore(space, campaign=_opts(), device=CPU)
    with pytest.raises(ValueError, match="incompatible with"):
        explore(space, checkpoint_dir=str(tmp_path), index_range=(0, 5),
                device=CPU)


# ---------------------------------------------------------------------------
# merge algebra: any disjoint partition == the unsharded sweep
# ---------------------------------------------------------------------------
def _shard_results(space, cuts):
    bounds = [0] + sorted(cuts) + [space.n_points]
    out = []
    for lo, hi in zip(bounds, bounds[1:]):
        res = explore(space, engine="fused", chunk_size=CHUNK, k=K,
                      superchunk=SUPER, device=CPU, index_range=(lo, hi))
        out.append(res.stream_result)
    return out


def test_merge_fixed_partitions(space, straight):
    n_var = space.n_var
    for cuts in ([], [1], [n_var], [n_var - 1, n_var + 1],
                 [1, 2, 3, n_var, space.n_points - 1]):
        shards = _shard_results(space, cuts)
        merged = merge_stream_results(shards, k=K)
        _assert_equal(merged, straight.stream_result)
        assert merged.n_var == n_var


def test_merge_partition_property(space, straight):
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=8, deadline=None)
    @hyp.given(st.lists(st.integers(1, space.n_points - 1),
                        unique=True, max_size=6))
    def prop(cuts):
        shards = _shard_results(space, cuts)
        np.random.default_rng(len(cuts)).shuffle(shards)  # order-free
        merged = merge_stream_results(shards, k=K)
        _assert_equal(merged, straight.stream_result)

    prop()


def test_merge_rejects_overlap_and_empty():
    with pytest.raises(ValueError, match="at least one shard"):
        merge_stream_results([])
    mk = lambda lo, hi: StreamResult(             # noqa: E731
        algorithm="a", metric="total_j", k=1, n_points=hi - lo,
        n_feasible=0, n_devices=1, chunk_size=1, topk=[], summaries={},
        index_lo=lo, index_hi=hi, n_var=10)
    with pytest.raises(ValueError, match="overlap"):
        merge_stream_results([mk(0, 5), mk(4, 8)])


def test_stream_result_payload_roundtrip(straight):
    st = straight.stream_result
    payload = json.loads(json.dumps(st.to_payload()))
    back = StreamResult.from_payload(payload)
    assert dataclasses.asdict(back) == dataclasses.asdict(st)


# ---------------------------------------------------------------------------
# failure paths (all deterministic)
# ---------------------------------------------------------------------------
def test_transient_retry_exponential_backoff(space, straight, tmp_path):
    sleeps = []
    faults = FaultSchedule({(0, 1): TransientFault("flake"),
                            (0, 2): TransientFault("flake")})
    res = _campaign(space, tmp_path, faults=faults, backoff_s=0.25,
                    sleep=sleeps.append)
    assert sleeps == [0.25, 0.5], "backoff must double per attempt"
    assert res.campaign["n_retries"] == 2
    assert not res.campaign["partial"]
    _assert_equal(res, straight)


def test_retries_exhausted_quarantines(space, tmp_path):
    faults = FaultSchedule({(0, a): TransientFault("still down")
                            for a in (1, 2, 3)})
    res = _campaign(space, tmp_path, faults=faults, max_retries=3)
    assert res.campaign["partial"]
    assert res.campaign["missing"] == [[0, 7]]
    (q,) = res.campaign["quarantined"]
    assert q["kind"] == "transient" and q["attempts"] == 3
    assert os.path.exists(shard_path(str(tmp_path), 0, 7,
                                     quarantined=True))
    assert res.n_points == space.n_points - 7


def test_oom_splits_shard_and_recovers(space, straight, tmp_path):
    # OOM only at full shard width; both halves then succeed
    faults = FaultSchedule(
        {(0, 1): lambda lo, hi, attempt:
         OOMFault("too big") if hi - lo >= 7 else None})
    stream_cache_clear()
    res = _campaign(space, tmp_path, faults=faults)
    assert stream_cache_info()["preps"] == 1, "half-shards reuse the prep"
    assert res.campaign["n_splits"] == 1
    assert not res.campaign["partial"]
    _assert_equal(res, straight)
    # the halves checkpointed their own ranges
    assert os.path.exists(shard_path(str(tmp_path), 0, 3))
    assert os.path.exists(shard_path(str(tmp_path), 3, 7))


def test_oom_recurses_to_quarantine_at_min_width(space, tmp_path):
    res = _campaign(space, tmp_path,
                    faults=FaultSchedule({(0, 1): OOMFault("always")}))
    # [0,7) halves until the 1-point shard at lo=0 cannot split further
    assert res.campaign["partial"]
    assert res.campaign["missing"] == [[0, 1]]
    (q,) = res.campaign["quarantined"]
    assert (q["lo"], q["hi"], q["kind"]) == (0, 1, "oom")
    assert res.n_points == space.n_points - 1


def test_deterministic_fault_quarantines_with_partial_report(
        space, straight, tmp_path):
    faults = FaultSchedule({(7, 1): DeterministicFault("bad shard")})
    res = _campaign(space, tmp_path, faults=faults)
    assert res.campaign["partial"]
    assert res.campaign["missing"] == [[7, 14]]
    assert res.campaign["quarantined"][0]["kind"] == "deterministic"
    # the surviving shards still merge into a well-formed result
    assert res.n_points == space.n_points - 7
    assert all(not (7 <= r["index"] < 14) or r["variant"] != "2d_in"
               for r in res.topk)
    # ... and a later run re-dispatches ONLY the quarantined range
    res2 = _campaign(space, tmp_path)
    assert [(e["lo"], e["hi"]) for e in res2.campaign["executed"]] \
        == [(7, 14)]
    assert not res2.campaign["partial"]
    _assert_equal(res2, straight)
    assert not os.path.exists(shard_path(str(tmp_path), 7, 14,
                                         quarantined=True))


def test_kill_and_resume_dispatches_only_missing(space, straight,
                                                 tmp_path):
    with pytest.raises(KillCampaign):
        _campaign(space, tmp_path, faults=FaultSchedule(kill_after=2))
    done = sorted((s["lo"], s["hi"]) for s in
                  (json.loads((tmp_path / "shards" / f).read_text())["shard"]
                   for f in os.listdir(tmp_path / "shards")))
    assert len(done) == 2, "kill must land after exactly 2 checkpoints"
    res = resume(str(tmp_path), device=CPU)
    assert res.campaign["resumed"] and res.campaign["n_loaded"] == 2
    ran = sorted((e["lo"], e["hi"]) for e in res.campaign["executed"])
    assert ran == missing_ranges(plan_shards(space.n_points, 7), done)
    assert not res.campaign["partial"]
    _assert_equal(res, straight)


def test_resume_refuses_signature_mismatch(space, tmp_path):
    _campaign(space, tmp_path)
    other = DesignSpace(["edgaze"], dict(GRIDS, frame_rate=[15.0, 30.0]))
    with pytest.raises(CampaignMismatchError, match="signature mismatch"):
        run_campaign(other, str(tmp_path), device=CPU)
    # tampered bank signature: same space, manifest claims another layout
    man_path = tmp_path / "manifest.json"
    man = json.loads(man_path.read_text())
    man["bank_signature"] = "0" * 64
    man_path.write_text(json.dumps(man))
    with pytest.raises(CampaignMismatchError, match="PlanBank layout"):
        run_campaign(space, str(tmp_path), device=CPU)


def test_manifest_records_resolved_backend(space, tmp_path, monkeypatch):
    """The manifest stores the RESOLVED lane (never "auto"), so resume
    is deterministic on any host; provenance names torch and the
    device."""
    from repro_torch.kernels.runtime import resolve_backend
    monkeypatch.delenv("REPRO_TORCH_SWEEP_BACKEND", raising=False)
    _campaign(space, tmp_path)
    man = json.loads((tmp_path / "manifest.json").read_text())
    assert man["sweep"]["backend"] == resolve_backend(None, CPU) == "torch"
    assert man["torch"] == {"version": torch.__version__,
                            "cuda": torch.version.cuda, "device": "cpu",
                            "n_devices": 1}
    assert "jax" not in man


def test_resume_refuses_cross_backend(space, tmp_path, monkeypatch):
    """Shards checkpointed by one lane must not merge with shards
    computed by the other: an EXPLICIT contradicting backend (argument
    or env) refuses; "auto" reuses the recorded lane."""
    monkeypatch.delenv("REPRO_TORCH_SWEEP_BACKEND", raising=False)
    _campaign(space, tmp_path)
    man = json.loads((tmp_path / "manifest.json").read_text())
    recorded = man["sweep"]["backend"]
    other = "cuda" if recorded == "torch" else "torch"
    with pytest.raises(CampaignMismatchError, match="backend"):
        run_campaign(space, str(tmp_path), device=CPU, backend=other)
    monkeypatch.setenv("REPRO_TORCH_SWEEP_BACKEND", other)  # env is explicit
    with pytest.raises(CampaignMismatchError, match="backend"):
        run_campaign(space, str(tmp_path), device=CPU)
    monkeypatch.delenv("REPRO_TORCH_SWEEP_BACKEND")
    # deferring ("auto") or naming the recorded lane both merge cleanly
    for again in ("auto", recorded):
        res = run_campaign(space, str(tmp_path), device=CPU, backend=again)
        assert res.campaign["n_executed"] == 0
        assert not res.campaign["partial"]


@pytest.mark.parametrize("written", ["pallas", "xla", None])
def test_reference_manifest_is_refused(space, tmp_path, monkeypatch,
                                       written):
    """A manifest with the reference's lanes ("pallas" / "xla", or none:
    the reference's pre-backend manifests) was computed by the other
    package: every resume refuses, "auto" included."""
    monkeypatch.delenv("REPRO_TORCH_SWEEP_BACKEND", raising=False)
    _campaign(space, tmp_path)
    man_path = tmp_path / "manifest.json"
    man = json.loads(man_path.read_text())
    if written is None:
        del man["sweep"]["backend"]
    else:
        man["sweep"]["backend"] = written
    man_path.write_text(json.dumps(man))
    for backend in ("auto", "torch"):
        with pytest.raises(CampaignMismatchError, match="another package"):
            run_campaign(space, str(tmp_path), device=CPU, backend=backend)


def test_staged_resume_refuses_the_other_lane(space, tmp_path):
    """A staged campaign records its device's lane; a resume on the other
    lane refuses instead of mixing kernels across shards."""
    run_campaign(space, str(tmp_path), k=K, engine="staged",
                 chunk_size=CHUNK, device=CPU, options=_opts())
    man_path = tmp_path / "manifest.json"
    man = json.loads(man_path.read_text())
    man["sweep"]["backend"] = "cuda"
    man_path.write_text(json.dumps(man))
    with pytest.raises(CampaignMismatchError, match="lane"):
        run_campaign(space, str(tmp_path), device=CPU)


def test_fused_cuda_lane_on_a_cpu_device_raises(space, tmp_path):
    """A fused campaign recorded on the ``cuda`` lane cannot run its
    missing shards on the CPU: the resume raises before dispatching."""
    _campaign(space, tmp_path)
    man_path = tmp_path / "manifest.json"
    man = json.loads(man_path.read_text())
    man["sweep"]["backend"] = "cuda"
    man_path.write_text(json.dumps(man))
    with pytest.raises(ValueError, match="CUDA device"):
        run_campaign(space, str(tmp_path), device=CPU)


def test_corrupt_shard_refused_then_redispatched(space, straight,
                                                 tmp_path):
    _campaign(space, tmp_path)
    path = shard_path(str(tmp_path), 0, 7)
    payload = json.loads(open(path).read())
    payload["result"]["n_feasible"] += 1       # bit-flip, checksum stale
    with open(path, "w") as f:
        json.dump(payload, f)
    with pytest.raises(CampaignIntegrityError, match="checksum"):
        run_campaign(space, str(tmp_path), device=CPU)
    res = run_campaign(space, str(tmp_path), device=CPU,
                       on_corrupt="redispatch")
    assert [(e["lo"], e["hi"]) for e in res.campaign["executed"]] \
        == [(0, 7)]
    _assert_equal(res, straight)


def test_campaign_all_quarantined_raises(space, tmp_path):
    faults = FaultSchedule(
        {(lo, 1): DeterministicFault("no")
         for lo, _hi in plan_shards(space.n_points, 7)})
    with pytest.raises(RuntimeError, match="no completed shards"):
        _campaign(space, tmp_path, faults=faults)


def test_budgeted_shards_run_on_the_timeout_thread(space, straight,
                                                   tmp_path):
    """``timeout_s`` runs every shard on the runner's pool thread (which
    sets its own device); the result is the unbudgeted one."""
    res = _campaign(space, tmp_path, timeout_s=120.0)
    assert not res.campaign["partial"]
    _assert_equal(res, straight)


def test_mesh_and_default_device_without_cuda_raise(space, tmp_path,
                                                    monkeypatch):
    """``mesh=`` takes a ``BatchMesh`` and a ``device`` beside it must
    name the mesh's first device; the default device is CUDA, and
    without a GPU the campaign raises before any write."""
    mesh = make_batch_mesh(8, device=CPU)
    with pytest.raises(TypeError, match="BatchMesh"):
        run_campaign(space, str(tmp_path / "a"), mesh=object())
    with pytest.raises(ValueError, match="conflicts with mesh="):
        run_campaign(space, str(tmp_path / "b"), mesh=mesh,
                     device="cuda:0")
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()
    res = run_campaign(space, str(tmp_path / "c"), k=K, engine="fused",
                       chunk_size=CHUNK, mesh=mesh, device=CPU,
                       options=_opts())
    assert res.n_devices == 8 and res.device == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_campaign(space, str(tmp_path / "d"))
    assert not (tmp_path / "d").exists(), "refused before any write"


@pytest.mark.parametrize("workers", [1, 2])
def test_campaign_on_a_mesh_equals_straight_on_it(space, tmp_path, workers):
    """A campaign on an 8-shard CPU mesh, serial and on two worker
    processes (each rebuilds the mesh from the devices it is sent),
    equals a straight sweep on the same mesh: top-k bit for bit, counts
    exact, means rel 1e-5.  The manifest and the merged result record
    the mesh's size."""
    mesh = make_batch_mesh(8, device=CPU)
    straight = explore(space, engine="fused", chunk_size=CHUNK, k=K,
                       superchunk=SUPER, mesh=mesh)
    res = run_campaign(space, str(tmp_path), k=K, engine="fused",
                       chunk_size=CHUNK, mesh=mesh, workers=workers,
                       options=_opts())
    assert not res.campaign["partial"]
    assert res.n_devices == straight.n_devices == 8
    assert res.chunk_size == straight.chunk_size == 8   # 4 rounded to 8
    assert res.topk == straight.topk
    _assert_equal(res, straight)
    man = json.loads((tmp_path / "manifest.json").read_text())
    assert man["torch"]["n_devices"] == 8
    if workers == 2:
        assert set(res.campaign["worker_preps"]) == {1}
        assert not any(res.campaign["worker_modules"].values())


# ---------------------------------------------------------------------------
# fault schedule + classifier units
# ---------------------------------------------------------------------------
def test_classify_failure_taxonomy():
    assert classify_failure(TransientFault("x")) == "transient"
    assert classify_failure(ShardTimeout("x")) == "transient"
    assert classify_failure(OOMFault("x")) == "oom"
    assert classify_failure(KillCampaign("x")) == "kill"
    assert classify_failure(MemoryError()) == "oom"
    assert classify_failure(TimeoutError()) == "transient"
    assert classify_failure(
        RuntimeError("RESOURCE_EXHAUSTED: out of memory")) == "oom"
    assert classify_failure(RuntimeError("UNAVAILABLE: try later")) \
        == "transient"
    assert classify_failure(ValueError("shape mismatch")) \
        == "deterministic"


def test_torch_cuda_oom_classifies_as_oom():
    """What the CUDA allocator raises splits the shard, as XLA's
    RESOURCE_EXHAUSTED does in the reference."""
    exc = torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.10 GiB "
        "total capacity)")
    assert classify_failure(exc) == "oom"


def test_fault_schedule_is_deterministic():
    mk = lambda: FaultSchedule(seed=7, rates={"transient": 0.5})  # noqa
    logs = []
    for _ in range(2):
        sched, log = mk(), []
        for lo in range(0, 70, 7):
            for attempt in (1, 2):
                try:
                    sched.check(lo, lo + 7, attempt)
                except TransientFault:
                    log.append((lo, attempt))
        logs.append(log)
    assert logs[0] == logs[1] and logs[0], "seeded schedule must replay"
    with pytest.raises(ValueError, match="needs a seed"):
        FaultSchedule(rates={"transient": 0.5})
    with pytest.raises(ValueError, match="unknown fault-rate"):
        FaultSchedule(seed=1, rates={"cosmic": 1.0})


def test_plan_shards_and_missing_ranges():
    assert plan_shards(10, 4) == [(0, 4), (4, 8), (8, 10)]
    assert plan_shards(0, 4) == []
    with pytest.raises(ValueError, match=">= 1"):
        plan_shards(10, 0)
    planned = [(0, 4), (4, 8), (8, 10)]
    assert missing_ranges(planned, []) == planned
    assert missing_ranges(planned, [(0, 4), (8, 10)]) == [(4, 8)]
    # OOM half-shards: coverage is interval union, not shard identity
    assert missing_ranges(planned, [(0, 2), (3, 9)]) == [(2, 3), (9, 10)]
    assert missing_ranges(planned, planned) == []


# ---------------------------------------------------------------------------
# satellites: index_range validation, empty ranges
# ---------------------------------------------------------------------------
def test_index_range_validation(space):
    total = space.n_points
    with pytest.raises(ValueError, match=rf"reversed.*\[0, {total}\)"):
        explore(space, engine="fused", chunk_size=CHUNK, device=CPU,
                index_range=(5, 2))
    with pytest.raises(ValueError, match=rf"\[0, {total}\)"):
        explore(space, engine="fused", chunk_size=CHUNK, device=CPU,
                index_range=(0, total + 1))
    with pytest.raises(ValueError, match=rf"\[0, {total}\)"):
        explore(space, engine="fused", chunk_size=CHUNK, device=CPU,
                index_range=(-1, 3))
    with pytest.raises(ValueError, match="must be integers"):
        explore(space, engine="fused", chunk_size=CHUNK, device=CPU,
                index_range=("a", 3))
    with pytest.raises(ValueError, match=r"\(lo, hi\) pair"):
        explore(space, engine="fused", chunk_size=CHUNK, device=CPU,
                index_range=(1, 2, 3))


@pytest.mark.parametrize("engine", ["fused", "staged"])
def test_empty_index_range_is_well_formed(space, engine):
    res = explore(space, engine=engine, chunk_size=CHUNK, k=K,
                  superchunk=SUPER if engine == "fused" else None,
                  device=CPU, index_range=(9, 9))
    st = res.stream_result
    assert (st.n_points, st.n_feasible, st.topk) == (0, 0, [])
    assert st.dispatches == 0 and st.occupancy == 1.0
    assert list(st.summaries) and all(
        sm["n"] == 0 and sm["n_feasible"] == 0 and sm["argmin_point"] is None
        for sm in st.summaries.values())
    # an empty shard folds into a merge as a no-op
    full = explore(space, engine="fused", chunk_size=CHUNK, k=K,
                   superchunk=SUPER, device=CPU, index_range=(0, 9))
    merged = merge_stream_results([st, full.stream_result])
    assert merged.n_points == 9


# ---------------------------------------------------------------------------
# the port against the reference's campaign layer
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's campaign of the same space on the CPU (xla
    backend, one device), and its directory."""
    from repro.campaign import CampaignOptions as RefOptions
    from repro.campaign import run_campaign as ref_run_campaign
    from repro.explore import DesignSpace as RefSpace
    from repro.launch.mesh import make_batch_mesh
    d = tmp_path_factory.mktemp("reference_campaign")
    res = ref_run_campaign(RefSpace(["edgaze"], GRIDS), str(d), k=K,
                           engine="fused", chunk_size=CHUNK,
                           mesh=make_batch_mesh(1), backend="xla",
                           options=RefOptions(shard_points=7,
                                              sleep=lambda _s: None))
    return res, d


def test_campaign_equals_reference_campaign(space, reference, tmp_path):
    want, _ = reference
    got = _campaign(space, tmp_path)
    _assert_equal(got, want)
    for a, b in zip(got.topk, want.topk):
        assert a.keys() == b.keys()
        for key, val in b.items():
            if isinstance(val, str):
                assert a[key] == val
            else:
                np.testing.assert_allclose(a[key], val, rtol=REL,
                                           err_msg=key)
    assert got.campaign["n_planned"] == want.campaign["n_planned"]
    assert got.campaign["coverage"] == want.campaign["coverage"]


def test_manifest_names_the_same_campaign_as_the_reference(space,
                                                           reference,
                                                           tmp_path):
    _, ref_dir = reference
    _campaign(space, tmp_path)
    ours = json.loads((tmp_path / "manifest.json").read_text())
    want = json.loads((ref_dir / "manifest.json").read_text())
    for key in ("schema", "space", "space_signature", "bank_signature",
                "n_points", "shards"):
        assert ours[key] == want[key], key
    assert ({k: v for k, v in ours["sweep"].items() if k != "backend"}
            == {k: v for k, v in want["sweep"].items() if k != "backend"})
    assert (ours["sweep"]["backend"], want["sweep"]["backend"]) \
        == ("torch", "xla")


def test_port_refuses_to_resume_the_reference_campaign(space, reference,
                                                       tmp_path):
    """A checkpoint directory the reference wrote verifies (same space
    and bank signatures) but is refused on its lane: the port never
    merges shards the other package computed."""
    import shutil
    _, ref_dir = reference
    d = tmp_path / "copy"
    shutil.copytree(ref_dir, d)
    with pytest.raises(CampaignMismatchError, match="'xla'"):
        resume(str(d), device=CPU)


@pytest.mark.parametrize("algos,grids", [
    (["edgaze"], GRIDS),
    (["edgaze", "rhythmic"], {"variant": ["2d_in", "3d_in"],
                              "cis_node": [130.0, 65.0],
                              "mem_tech": ["sram_hp", "stt"]}),
    (["rhythmic"], None)])
def test_signatures_equal_the_reference(algos, grids):
    from repro.explore import DesignSpace as RefSpace
    from repro.signatures import bank_signature as ref_bank
    from repro.signatures import space_signature as ref_space
    from repro_torch.signatures import bank_signature, space_signature
    ours, want = DesignSpace(algos, grids), RefSpace(algos, grids)
    assert space_signature(ours) == ref_space(want)
    assert bank_signature(ours) == ref_bank(want)
