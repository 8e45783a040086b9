"""P9: the port's parallel campaign executor (workers / overlap /
retention), on the CPU.

Mirrors ``tests/test_campaign_parallel.py`` test for test on the same
space, with ``device="cpu"`` in place of the reference's mesh and each
worker's ``preps`` counter (ONE stream preparation a worker) in place of
its one step executable.  Beyond the mirror:

* a ``workers=2`` campaign equals the serial one bit for bit (top-k
  values, indices and rows; summaries), and so does a parallel
  kill-and-resume;
* the workers report the ``jax*`` / ``repro*`` modules they loaded:
  none, though this test process has the reference loaded;
* ``python -m repro_torch.campaign --gc`` runs as a module.
"""
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch.campaign import (CampaignOptions, CheckpointWriter,
                                  FaultSchedule, KillCampaign, KillWorker,
                                  campaign_status, gc_campaigns,
                                  merge_stream_results, missing_ranges,
                                  plan_shards, resolve_workers, resume,
                                  run_campaign)
from repro_torch.campaign.executor import WORKERS_ENV, _TimeoutRunner
from repro_torch.campaign.faults import ShardTimeout
from repro_torch.campaign.manifest import read_shard, shard_path
from repro_torch.core.shard_sweep import StreamResult
from repro_torch.explore import DesignSpace, explore

REL = 1e-6

GRIDS = {"variant": ["2d_in", "3d_in"],
         "frame_rate": [15.0, 30.0, 60.0],
         "sys_rows": [8.0, 32.0],
         "vdd_scale": [0.9, 1.0, 1.1]}

CHUNK, K, SUPER = 4, 6, 16
CPU = "cpu"
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def space():
    return DesignSpace(["edgaze"], GRIDS)


@pytest.fixture(scope="module")
def straight(space):
    return explore(space, engine="fused", chunk_size=CHUNK, k=K,
                   superchunk=SUPER, device=CPU)


@pytest.fixture(scope="module")
def serial(space, tmp_path_factory):
    return _campaign(space, tmp_path_factory.mktemp("serial"))


def _opts(**kw):
    kw.setdefault("shard_points", 7)
    kw.setdefault("sleep", lambda _s: None)
    return CampaignOptions(**kw)


def _campaign(space, d, *, workers=None, **kw):
    return run_campaign(space, str(d), k=K, engine="fused",
                        chunk_size=CHUNK, device=CPU, workers=workers,
                        options=_opts(**kw))


def _assert_equal(a, b, *, rtol=REL):
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


def _assert_bit_equal(a, b):
    """Two campaigns of the same shards: identical rows and summaries."""
    assert a.topk == b.topk
    assert json.dumps(a.summaries) == json.dumps(b.summaries)
    assert (a.n_points, a.n_feasible) == (b.n_points, b.n_feasible)


# ---------------------------------------------------------------------------
# workers=2 parity + parallel report accounting
# ---------------------------------------------------------------------------
def test_parallel_campaign_matches_straight(space, straight, serial,
                                            tmp_path):
    res = _campaign(space, tmp_path, workers=2)
    _assert_equal(res, straight)
    _assert_bit_equal(res, serial)
    rep = res.campaign
    assert rep["workers"] == 2
    assert not rep["partial"] and not rep["quarantined"]
    # every worker that completed shards prepared the stream exactly ONCE
    assert rep["worker_preps"], "workers must report their counters"
    assert set(rep["worker_preps"]) == {1}
    assert 1 <= len(rep["worker_preps"]) <= 2
    assert sum(c["twin_calls"] for c in rep["worker_counters"].values()) \
        >= len(plan_shards(space.n_points, 7))
    # the spawned workers load no jax and no reference module
    assert rep["worker_modules"] and not any(rep["worker_modules"].values())
    assert rep["worker_startup_s"] > 0.0
    # overlap/idle accounting is present and sane
    assert rep["dispatch_wait_s"] >= 0.0
    assert rep["io_s"] >= 0.0
    assert 0.0 <= rep["io_overlap_frac"] <= 1.0
    # completions are attributed to worker pids
    assert all(e.get("worker") for e in rep["executed"]
               if e["status"] == "ok")
    # checkpoints on disk are the ordinary artifacts
    man = json.loads((tmp_path / "manifest.json").read_text())
    for s in man["shards"]:
        payload = read_shard(shard_path(str(tmp_path), s["lo"], s["hi"]))
        assert payload["result"]["n_points"] == s["hi"] - s["lo"]


def test_serial_report_keeps_parallel_fields(space, tmp_path):
    rep = _campaign(space, tmp_path).campaign
    assert rep["workers"] == 1
    assert rep["worker_preps"] == []               # in-process dispatch
    assert rep["dispatch_wait_s"] >= 0.0
    assert 0.0 <= rep["io_overlap_frac"] <= 1.0


# ---------------------------------------------------------------------------
# worker death: transient, retried, never an abort
# ---------------------------------------------------------------------------
def test_kill_worker_is_transient_not_abort(space, straight, serial,
                                            tmp_path):
    faults = FaultSchedule({(0, 1): KillWorker("injected worker death")})
    res = _campaign(space, tmp_path, workers=2, faults=faults)
    rep = res.campaign
    deaths = [e for e in rep["executed"] if e["status"] == "fault"]
    assert deaths, "the killed worker's shard must be logged as a fault"
    assert deaths[0]["kind"] == "transient"
    assert "died" in deaths[0]["error"] and deaths[0]["lo"] == 0
    assert "worker" in deaths[0]
    assert rep["n_retries"] >= 1
    assert not rep["partial"] and not rep["quarantined"]
    _assert_equal(res, straight)
    _assert_bit_equal(res, serial)


def test_kill_worker_serial_degrades_to_transient(space, straight,
                                                  tmp_path):
    # no pool to kill at workers=1: the drill is a plain transient fault
    faults = FaultSchedule({(0, 1): KillWorker("worker death drill")})
    res = _campaign(space, tmp_path, faults=faults)
    assert res.campaign["workers"] == 1
    assert res.campaign["n_retries"] == 1
    assert not res.campaign["partial"]
    _assert_equal(res, straight)


def test_parallel_kill_and_resume(space, straight, serial, tmp_path):
    with pytest.raises(KillCampaign):
        _campaign(space, tmp_path, workers=2,
                  faults=FaultSchedule(kill_after=2))
    done = sorted((s["lo"], s["hi"]) for s in
                  (json.loads((tmp_path / "shards" / f).read_text())["shard"]
                   for f in os.listdir(tmp_path / "shards")))
    assert len(done) == 2, "kill must land after exactly 2 checkpoints"
    res = resume(str(tmp_path), workers=2, device=CPU)
    assert res.campaign["resumed"] and res.campaign["n_loaded"] == 2
    assert res.campaign["workers"] == 2
    ran = sorted((e["lo"], e["hi"]) for e in res.campaign["executed"]
                 if e["status"] == "ok")
    assert ran == missing_ranges(plan_shards(space.n_points, 7), done)
    assert not res.campaign["partial"]
    _assert_equal(res, straight)
    _assert_bit_equal(res, serial)


# ---------------------------------------------------------------------------
# worker-count resolution + API validation
# ---------------------------------------------------------------------------
def test_resolve_workers_precedence(monkeypatch):
    assert WORKERS_ENV == "REPRO_TORCH_CAMPAIGN_WORKERS"
    monkeypatch.delenv(WORKERS_ENV, raising=False)
    assert resolve_workers() == 1
    monkeypatch.setenv(WORKERS_ENV, "3")
    assert resolve_workers() == 3
    assert resolve_workers(2) == 2, "the argument beats the environment"
    for bad in ("zero", 0, "0", -1, "1.5"):
        with pytest.raises(ValueError, match="workers"):
            resolve_workers(bad)
    monkeypatch.setenv(WORKERS_ENV, "junk")
    with pytest.raises(ValueError, match=WORKERS_ENV):
        resolve_workers()


def test_worker_count_conflict_and_explore_validation(space, tmp_path):
    with pytest.raises(ValueError, match="conflicting worker counts"):
        run_campaign(space, str(tmp_path), workers=2, device=CPU,
                     options=CampaignOptions(workers=3))
    with pytest.raises(ValueError, match="require checkpoint_dir"):
        explore(space, workers=2, device=CPU)


# ---------------------------------------------------------------------------
# merge algebra under arrival order + duplicate redelivery
# ---------------------------------------------------------------------------
def _shard_results(space, cuts):
    bounds = [0] + sorted(cuts) + [space.n_points]
    return [explore(space, engine="fused", chunk_size=CHUNK, k=K,
                    superchunk=SUPER, device=CPU,
                    index_range=(lo, hi)).stream_result
            for lo, hi in zip(bounds, bounds[1:])]


def test_merge_dedupes_exact_duplicate_ranges(space, straight):
    shards = _shard_results(space, [space.n_var])
    merged = merge_stream_results(shards + [shards[0], shards[-1]], k=K)
    _assert_equal(merged, straight.stream_result)
    # partially-overlapping ranges still double-count: hard error
    mk = lambda lo, hi: StreamResult(             # noqa: E731
        algorithm="a", metric="total_j", k=1, n_points=hi - lo,
        n_feasible=0, n_devices=1, chunk_size=1, topk=[], summaries={},
        index_lo=lo, index_hi=hi, n_var=10)
    with pytest.raises(ValueError, match="overlap"):
        merge_stream_results([mk(0, 5), mk(4, 8)])


def test_merge_random_arrival_order_with_redelivery(space, straight):
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=6, deadline=None)
    @hyp.given(st.data())
    def prop(data):
        cuts = data.draw(st.lists(st.integers(1, space.n_points - 1),
                                  unique=True, max_size=5))
        shards = _shard_results(space, cuts)
        dups = data.draw(st.lists(st.integers(0, len(shards) - 1),
                                  max_size=3))
        shards = shards + [shards[i] for i in dups]
        seed = data.draw(st.integers(0, 2 ** 32 - 1))
        np.random.default_rng(seed).shuffle(shards)   # arrival order
        merged = merge_stream_results(shards, k=K)
        _assert_equal(merged, straight.stream_result)

    prop()


# ---------------------------------------------------------------------------
# CheckpointWriter + _TimeoutRunner units
# ---------------------------------------------------------------------------
def test_checkpoint_writer_roundtrip_flush_and_errors(tmp_path, straight):
    st = straight.stream_result
    w = CheckpointWriter(str(tmp_path), capacity=2)
    w.submit(st.index_lo, st.index_hi, st.to_payload(),
             attempts=2, splits=1)
    w.flush()
    payload = read_shard(shard_path(str(tmp_path), st.index_lo,
                                    st.index_hi))
    assert payload["shard"]["attempts"] == 2
    assert payload["shard"]["splits"] == 1
    back = StreamResult.from_payload(payload["result"])
    assert back.n_points == st.n_points
    assert w.n_writes == 1 and w.io_s > 0.0
    assert 0.0 <= w.io_overlap_frac <= 1.0
    w.close()
    w.close()                                   # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(0, 1, st.to_payload())
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("x")
    w2 = CheckpointWriter(str(blocker))
    w2.submit(0, 1, st.to_payload())
    w2.close()
    with pytest.raises(OSError):
        w2.raise_if_failed()
    w2.raise_if_failed()                        # error is consumed once


def test_timeout_runner_reuses_one_pool():
    r = _TimeoutRunner()
    assert r.run(lambda: 42, None, 0, 1) == 42
    assert r._pool is None, "no pool without a budget"
    assert r.run(lambda: 1, 60.0, 0, 1) == 1
    pool = r._pool
    assert r.run(lambda: 2, 60.0, 1, 2) == 2
    assert r._pool is pool, "budgeted dispatches must share ONE pool"
    release = threading.Event()
    with pytest.raises(ShardTimeout, match=r"shard \[2, 3\) exceeded"):
        r.run(lambda: release.wait(10), 0.05, 2, 3)
    assert r._pool is None, "a timed-out pool is abandoned, not reused"
    release.set()
    assert r.run(lambda: 3, 60.0, 3, 4) == 3, "fresh pool after timeout"
    r.close()
    assert r._pool is None


# ---------------------------------------------------------------------------
# retention GC (+ CLI)
# ---------------------------------------------------------------------------
@pytest.fixture()
def gc_root(space, tmp_path):
    a = tmp_path / "a"                          # complete campaign
    _campaign(space, a)
    b = tmp_path / "b"                          # resumable: one shard gone
    shutil.copytree(a, b)
    os.remove(shard_path(str(b), 0, 7))
    c = tmp_path / "c"                          # corrupt manifest
    c.mkdir()
    (c / "manifest.json").write_text("{ not json")
    (tmp_path / "noise").mkdir()                # not a campaign dir
    return tmp_path


def test_campaign_status_classification(gc_root):
    sa = campaign_status(str(gc_root / "a"))
    assert sa["state"] == "complete" and sa["missing"] == []
    assert sa["n_done"] == sa["n_planned"]
    sb = campaign_status(str(gc_root / "b"))
    assert sb["state"] == "incomplete" and sb["missing"] == [[0, 7]]
    sc = campaign_status(str(gc_root / "c"))
    assert sc["state"] == "corrupt" and sc["error"]


def test_gc_retention_refusal_and_force(gc_root):
    now = time.time() + 10 * 86400              # everything ~10 days old
    with pytest.raises(ValueError, match=">= 0"):
        gc_campaigns(str(gc_root), keep_days=-1)
    rep = gc_campaigns(str(gc_root), keep_days=30, now=now)
    assert not rep["pruned"] and not rep["refused"]
    assert len(rep["kept"]) == 3, "young directories are always kept"
    rep = gc_campaigns(str(gc_root), keep_days=7, dry_run=True, now=now)
    assert [s["path"] for s in rep["pruned"]] == [str(gc_root / "a")]
    assert (gc_root / "a" / "manifest.json").exists(), "dry run deletes nothing"
    assert {s["state"] for s in rep["refused"]} == {"incomplete", "corrupt"}
    rep = gc_campaigns(str(gc_root), keep_days=7, now=now)
    assert not (gc_root / "a").exists()
    assert (gc_root / "b").exists() and (gc_root / "c").exists(), \
        "resumable/corrupt dirs are refused without --force"
    rep = gc_campaigns(str(gc_root), keep_days=7, force=True, now=now)
    assert len(rep["pruned"]) == 2 and not rep["refused"]
    assert not (gc_root / "b").exists() and not (gc_root / "c").exists()
    assert (gc_root / "noise").exists(), "non-campaign dirs are untouched"


def test_gc_cli_dry_run(gc_root, capsys):
    from repro_torch.campaign.__main__ import main
    rc = main(["--gc", str(gc_root), "--keep-days", "0", "--dry-run"])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"would prune {gc_root / 'a'}" in out
    assert "refused" in out and "--force" in out
    assert (gc_root / "a").exists(), "dry run deletes nothing"


def test_gc_cli_runs_as_a_module(gc_root):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.campaign", "--gc",
         str(gc_root), "--keep-days", "0", "--dry-run"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"would prune {gc_root / 'a'}" in proc.stdout
    assert (gc_root / "a").exists()
