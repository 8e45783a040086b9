"""The port's serving layer (``repro_torch.serve``) on the CPU lane.

Three parts:

* **the reference's contract**, test by test (``tests/test_serve.py``):
  the 8-client gauntlet (one coalesce group, ONE step build —
  ``stream_cache_info()["step_builds"]``, the port's ``step_compiles`` —
  parity with solo ``explore()`` and a repeat wave served from the
  result cache with zero dispatches), dedup, the solo fallback, keyword
  routing and conflicts, compat keys and segments, the result cache
  (key, LRU/TTL, bounds, geometry-free keys, TTL expiry), streamed
  partials, backpressure, deadlines, drain and the asyncio front end;
* **parity with the reference's served results**: the gauntlet's 8
  tenants and streamed partials (solo and coalesced) against
  ``repro.serve.ExploreService`` on the CPU (``backend="xla"``, the
  reference's CPU lane): top-k rows at rel 1e-6, flat indices, variants
  and counts exactly; ``compat_key`` partitions requests as the
  reference's does, and ``plan_segments`` equals the reference's;
* **the driver's hook and step cache**: ``_stream_impl(on_partial=)``
  fires once per dispatch on both engines with ``progress``'s ``done``,
  its snapshots equal the reference's at every dispatch (rel 1e-6), a
  hook changes no result, and ``step_builds`` counts one build per shape
  key across threads.
"""
import asyncio
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import shard_sweep
from repro_torch.core.shard_sweep import (_stream_impl, stream_cache_clear,
                                          stream_cache_info)
from repro_torch.explore import DesignSpace, explore
from repro_torch.launch import make_batch_mesh
from repro_torch.serve import (ExploreService, PartialUpdate, QueueFull,
                               RequestTimeout, ResultCache, ServiceClosed,
                               TenantStream, result_cache_key)
from repro_torch.serve.coalesce import (compat_key, plan_segments,
                                        prepare_request)

REL = 1e-6
CPU = torch.device("cpu")
ONE = make_batch_mesh(1, device="cpu")        # a one-entry CPU mesh

BASE = {"variant": ["2d_in", "3d_in"],
        "cis_node": [130.0, 65.0],
        "frame_rate": [15.0, 30.0, 60.0],
        "vdd_scale": [0.9, 1.0]}
#: two algorithms, one variant-major flat space: the hook and step tests
MULTI = {"variant": ["2d_in", "3d_in"],
         "cis_node": [130.0, 65.0, 28.0],
         "frame_rate": [15.0, 30.0, 60.0],
         "sys_rows": [8.0, 32.0]}
N_VAR = 3 * 3 * 2


def _grids(i=0):
    """Distinct-but-shape-compatible grids: same axes and lengths,
    different vdd values -> different signatures, same step."""
    return dict(BASE, vdd_scale=[0.80 + 0.01 * i, 1.0])


def _space(i=0):
    return DesignSpace("edgaze", _grids(i))


def _assert_parity(a, b, rtol=REL):
    assert a.n_points == b.n_points
    assert a.n_feasible == b.n_feasible
    assert len(a.topk) == len(b.topk)
    for ra, rb in zip(a.topk, b.topk):
        assert ra.keys() == rb.keys()
        for key in ra:
            if isinstance(ra[key], float):
                np.testing.assert_allclose(ra[key], rb[key], rtol=rtol)
            else:
                assert ra[key] == rb[key]


def _solo(i, **kw):
    return explore(_space(i), engine="fused", device="cpu", **kw)


#: the coalesce window of a service whose test needs all of ``n``
#: concurrent clients in one group: it is given ``max_batch=n``, so the
#: group closes the moment the n-th request arrives, and the window only
#: bounds how long a loaded host may take to enqueue them all
GATHER_S = 60.0


@pytest.fixture
def svc():
    service = ExploreService(coalesce_window_s=0.2, device="cpu")
    yield service
    service.close()


@pytest.fixture
def gather8():
    """A service that groups 8 concurrent clients whatever the host's
    load (``GATHER_S``)."""
    service = ExploreService(coalesce_window_s=GATHER_S, max_batch=8,
                             device="cpu")
    yield service
    service.close()


def _concurrently(fn, n):
    """``fn(i)`` for ``i < n`` on n threads released together by a
    barrier."""
    barrier = threading.Barrier(n)

    def run(i):
        barrier.wait(timeout=120)
        fn(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)


# ---------------------------------------------------------------------------
# the tentpole: coalesced one-step serving (tests/test_serve.py)
# ---------------------------------------------------------------------------

def test_eight_clients_one_step_parity_and_cache(gather8):
    """The acceptance gauntlet: 8 concurrent distinct clients -> one
    coalesce group, ONE step build, parity with solo, and a repeat wave
    served entirely from the result cache."""
    svc = gather8
    stream_cache_clear()
    results = {}

    def client(i):
        results[i] = explore(_space(i), k=5, engine="fused", chunk_size=8,
                             superchunk=2, service=svc)

    _concurrently(client, 8)
    assert stream_cache_info()["step_builds"] == 1
    assert len(results) == 8
    for i, res in results.items():
        assert res.serve["coalesce_group"] == 8
        assert not res.serve["cache_hit"] and not res.serve["deduped"]
        assert res.serve["dispatches"] >= 1
        assert res.serve["dispatch_share"] == pytest.approx(1 / 8)
        assert res.backend == "torch" and res.device == "cpu"

    # solo reruns: the SAME step (no new build); top-k values and flat
    # indices bit-equal, full rows rel 1e-6
    for i, res in results.items():
        solo = _solo(i, k=5, chunk_size=8, superchunk=2)
        _assert_parity(res, solo)
        assert [(r["total_j"], r["variant"], r["index"]) for r in res.topk] \
            == [(r["total_j"], r["variant"], r["index"]) for r in solo.topk]
    assert stream_cache_info()["step_builds"] == 1

    # repeat wave: every request replays from the result cache with
    # ZERO new dispatches
    before = svc.metrics()["dispatches"]
    launched = stream_cache_info()["dispatches"]
    wave2 = {}

    def replay(i):
        wave2[i] = svc.explore(_space(i), k=5, engine="fused",
                               chunk_size=8, superchunk=2)

    _concurrently(replay, 8)
    assert svc.metrics()["dispatches"] == before
    assert stream_cache_info()["dispatches"] == launched
    for i, res in wave2.items():
        assert res.serve["cache_hit"]
        assert res.serve["dispatches"] == 0
        _assert_parity(res, results[i])

    m = svc.metrics()
    assert m["coalesced_groups"] >= 1 and m["max_group"] == 8
    assert m["completed"] == 16 and m["failed"] == 0


def test_identical_inflight_requests_dedupe(svc):
    """N identical concurrent requests dispatch ONCE; the twins ride the
    leader's fresh result."""
    results = {}

    def client(i):
        results[i] = svc.explore(_space(0), k=4, engine="fused",
                                 chunk_size=8)

    _concurrently(client, 4)
    deduped = [r for r in results.values() if r.serve["deduped"]]
    leaders = [r for r in results.values() if not r.serve["deduped"]
               and not r.serve["cache_hit"]]
    # all in one batch -> 1 leader + 3 twins; a straggler batch can only
    # shrink the twin count via cache hits, never add dispatches
    assert len(leaders) >= 1
    assert all(r.serve["dispatches"] == 0 for r in deduped)
    for r in results.values():
        _assert_parity(r, results[0])


def test_incompatible_requests_fall_back_to_solo(svc):
    """Different k -> different compat keys -> separate (solo) runs in
    the same batch; both still correct."""
    out = {}

    def client(i):
        out[i] = svc.explore(_space(i), k=(3, 7)[i], engine="fused",
                             chunk_size=8)

    _concurrently(client, 2)
    assert out[0].k == 3 and out[1].k == 7
    for i, k in ((0, 3), (1, 7)):
        assert out[i].serve["coalesce_group"] == 1
        _assert_parity(out[i], _solo(i, k=k, chunk_size=8))


def test_explore_service_kwarg_routes_and_rejects_conflicts(svc):
    res = explore(_space(0), k=3, service=svc)
    assert res.serve is not None and res.k == 3
    with pytest.raises(ValueError, match="incompatible with service="):
        explore(_space(0), k=3, service=svc, checkpoint_dir="/tmp/x")
    with pytest.raises(ValueError, match="incompatible with service="):
        explore(_space(0), k=3, service=svc, index_range=(0, 4))


@pytest.mark.parametrize("kwargs", [
    dict(checkpoint_dir="unused"), dict(campaign=object()),
    dict(workers=2), dict(index_range=(0, 4)), dict(progress=print),
    dict(mesh=object()), dict(strict=True), dict(device="cuda"),
    dict(device="cuda:0")], ids=lambda kw: next(iter(kw)) + (
        f"={kw['device']}" if "device" in kw else ""))
def test_explore_service_rejects_each_conflict(svc, kwargs):
    """Every keyword the reference rejects beside ``service=``, with its
    message, and a ``device`` that is not the service's."""
    from repro.explore import DesignSpace as RefSpace
    from repro.explore import explore as ref_explore
    from repro.serve import ExploreService as RefService
    if "device" not in kwargs:
        with RefService(coalesce_window_s=0.0) as ref_svc:
            with pytest.raises(ValueError,
                               match="incompatible with service="):
                ref_explore(RefSpace("edgaze", _grids(0)), k=3,
                            service=ref_svc, **kwargs)
    with pytest.raises(ValueError, match="incompatible with service="):
        explore(_space(0), k=3, service=svc, **kwargs)
    assert svc.metrics()["submitted"] == 0


def test_explore_service_takes_its_own_device(svc):
    """``device`` left out or naming the service's device routes."""
    for device in (None, "cpu", CPU):
        res = explore(_space(0), k=3, service=svc, device=device)
        assert res.serve is not None and res.device == "cpu"
    with pytest.raises(TypeError, match="ExploreService"):
        explore(_space(0), k=3, service=object(), device="cpu")


def test_service_device_and_mesh(monkeypatch):
    """``mesh=`` takes a ``BatchMesh`` (its first device is the
    service's), a ``device`` beside it must name that device; the default
    device is CUDA, and without a GPU the service raises instead of
    falling back."""
    mesh = make_batch_mesh(8, device="cpu")
    with pytest.raises(TypeError, match="BatchMesh"):
        ExploreService(mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="conflicts with mesh="):
        ExploreService(mesh=mesh, device="cuda:0")
    with ExploreService(mesh=mesh, device="cpu") as svc:
        assert svc.mesh is mesh and svc.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExploreService()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExploreService(device="cuda:0")


# ---------------------------------------------------------------------------
# coalesce geometry
# ---------------------------------------------------------------------------

def _prepare(space, **kw):
    base = dict(k=5, metric="total_j", backend="torch", chunk_size=8,
                block_points=4096, superchunk=2)
    base.update(kw)
    return prepare_request(space, mesh=ONE, **base)


def test_compat_key_groups_shapes_not_values():
    pr0, pr1 = _prepare(_space(0)), _prepare(_space(7))
    assert compat_key(pr0, ONE) == compat_key(pr1, ONE)
    for kw in (dict(k=6), dict(metric="on_sensor_j"),
               dict(chunk_size=4), dict(superchunk=1)):
        pr2 = _prepare(_space(0), **kw)
        assert compat_key(pr2, ONE) != compat_key(pr0, ONE), kw


def test_compat_key_names_the_mesh():
    """A one-shard mesh keys a request as ``device=`` does (its step is
    the one a solo ``explore(device=)`` builds); an 8-shard mesh keys it
    apart, with the chunk rounded to the mesh's size."""
    one, eight = make_batch_mesh(1, device="cpu"), make_batch_mesh(
        8, device="cpu")
    pr = _prepare(_space(0), chunk_size=5)
    pr1 = prepare_request(_space(0), mesh=one, **dict(
        k=5, metric="total_j", backend="torch", chunk_size=5,
        block_points=4096, superchunk=2))
    pr8 = prepare_request(_space(0), mesh=eight, **dict(
        k=5, metric="total_j", backend="torch", chunk_size=5,
        block_points=4096, superchunk=2))
    assert (pr.chunk, pr1.chunk, pr8.chunk) == (5, 5, 8)
    assert compat_key(pr1, one) == compat_key(pr, ONE)
    assert compat_key(pr8, eight) != compat_key(pr1, one)
    stream_cache_clear()
    explore(_space(0), k=5, engine="fused", chunk_size=5, superchunk=2,
            device="cpu")
    assert list(shard_sweep._STEPS) == [compat_key(pr1, one)]
    stream_cache_clear()


def test_mesh_tenants_equal_their_solo_calls():
    """8 coalesced tenants of a service on an 8-shard CPU mesh: one
    group, one step, each tenant's top-k bit for bit its solo call on the
    same mesh, counts exact."""
    mesh = make_batch_mesh(8, device="cpu")
    kw = dict(k=5, engine="fused", chunk_size=8, superchunk=2)
    stream_cache_clear()
    results = {}
    with ExploreService(coalesce_window_s=GATHER_S, max_batch=8,
                        mesh=mesh) as svc:
        def client(i):
            results[i] = explore(_space(i), service=svc, **kw)
        _concurrently(client, 8)
    assert stream_cache_info()["step_builds"] == 1
    for i, res in results.items():
        assert res.serve["coalesce_group"] == 8 and res.n_devices == 8
        solo = explore(_space(i), mesh=mesh, **kw)
        assert res.topk == solo.topk
        assert (res.n_points, res.n_feasible) == (solo.n_points,
                                                  solo.n_feasible)
        assert [s["n_feasible"] for s in res.summaries.values()] \
            == [s["n_feasible"] for s in solo.summaries.values()]
    assert stream_cache_info()["step_builds"] == 1
    stream_cache_clear()


def test_plan_segments_tile_the_flat_space():
    pr = _prepare(_space(0))
    segs = plan_segments(pr)
    assert segs[0][0] == 0 and segs[-1][1] == pr.total
    for (_, hi), (lo, _) in zip(segs, segs[1:]):
        assert hi == lo  # contiguous, disjoint


# ---------------------------------------------------------------------------
# result cache
# ---------------------------------------------------------------------------

def test_result_cache_key_identity():
    k_a = result_cache_key(_space(0), k=5, metric="total_j",
                           backend="torch")
    assert k_a == result_cache_key(_space(0), k=5, metric="total_j",
                                   backend="torch")
    assert k_a != result_cache_key(_space(1), k=5, metric="total_j",
                                   backend="torch")
    assert k_a != result_cache_key(_space(0), k=6, metric="total_j",
                                   backend="torch")
    assert k_a != result_cache_key(_space(0), k=5,
                                   metric="on_sensor_j", backend="torch")
    assert k_a != result_cache_key(_space(0), k=5, metric="total_j",
                                   backend="cuda")


def test_result_cache_key_is_the_references_on_the_signature():
    """The signature half equals the reference's character for
    character; the lane half names the port's lanes."""
    from repro.explore import DesignSpace as RefSpace
    from repro.serve import result_cache_key as ref_key
    ours = result_cache_key(_space(3), k=5, metric="total_j",
                            backend="torch")
    ref = ref_key(RefSpace("edgaze", _grids(3)), k=5, metric="total_j",
                  backend="xla")
    assert ours[:3] == ref[:3] and ours[3] == "torch"


def test_result_cache_lru_ttl_and_counters():
    now = [0.0]
    cache = ResultCache(capacity=2, ttl_s=10.0, clock=lambda: now[0])
    cache.put(("a",), "ra")
    cache.put(("b",), "rb")
    assert cache.get(("a",)) == "ra"          # refreshes LRU rank
    cache.put(("c",), "rc")                   # evicts the stalest: b
    assert cache.get(("b",)) is None
    assert cache.get(("c",)) == "rc"
    now[0] = 11.0                              # a + c age out
    assert cache.get(("a",)) is None
    s = cache.stats()
    assert (s["hits"], s["misses"]) == (2, 2)
    assert s["evictions"] == 1 and s["expirations"] == 1
    assert s["inserts"] == 3 and s["size"] == 1
    cache.clear()
    assert len(cache) == 0 and cache.stats()["hits"] == 0


def test_result_cache_rejects_bad_bounds():
    with pytest.raises(ValueError, match="capacity"):
        ResultCache(capacity=0)
    with pytest.raises(ValueError, match="ttl_s"):
        ResultCache(ttl_s=0.0)


def test_cache_ignores_execution_geometry(svc):
    """Same question, different batching -> one cached answer."""
    first = svc.explore(_space(0), k=4, chunk_size=8, superchunk=2)
    again = svc.explore(_space(0), k=4, chunk_size=4, superchunk=1)
    assert not first.serve["cache_hit"] and again.serve["cache_hit"]
    _assert_parity(first, again)


def test_service_cache_ttl_expiry():
    with ExploreService(coalesce_window_s=0.0, cache_ttl_s=0.05,
                        device="cpu") as svc:
        first = svc.explore(_space(0), k=4, chunk_size=8)
        time.sleep(0.1)
        again = svc.explore(_space(0), k=4, chunk_size=8)
        assert not first.serve["cache_hit"]
        assert not again.serve["cache_hit"]   # expired -> re-dispatched
        _assert_parity(first, again)


# ---------------------------------------------------------------------------
# streaming partials
# ---------------------------------------------------------------------------

def test_partial_stream_monotone_and_final(svc):
    h = svc.submit(_space(3), k=4, engine="fused", chunk_size=4,
                   superchunk=1, stream=True)
    updates = list(h.partials())
    assert updates, "stream must carry at least the final update"
    assert [u.seq for u in updates] == list(range(len(updates)))
    dones = [u.done for u in updates]
    assert dones == sorted(dones)
    assert all(not u.final for u in updates[:-1])
    final = updates[-1]
    assert final.final and final.done == final.span
    res = h.result()
    assert final.n_feasible == res.n_feasible
    np.testing.assert_allclose(
        [r[res.metric] for r in final.topk],
        [r[res.metric] for r in res.topk], rtol=REL)
    assert res.serve["partial_updates"] == len(updates)


def test_nonstreaming_handle_still_gets_final_update(svc):
    h = svc.submit(_space(0), k=4, chunk_size=8)
    updates = list(h.partials())
    assert len(updates) == 1 and updates[0].final
    assert h.result().n_points == _space(0).n_points


def test_stream_failure_reraises_on_consumer():
    s = TenantStream()
    s.push(PartialUpdate(seq=0, done=1, span=2, n_feasible=1, topk=[]))
    s.fail(RuntimeError("boom"))
    it = iter(s)
    assert next(it).seq == 0
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


# ---------------------------------------------------------------------------
# lifecycle: backpressure, deadlines, shutdown
# ---------------------------------------------------------------------------

def test_queue_full_backpressure(monkeypatch):
    gate = threading.Event()
    entered = threading.Event()
    orig = ExploreService._process_batch

    def gated(self, batch):
        entered.set()
        gate.wait(timeout=30.0)
        orig(self, batch)

    monkeypatch.setattr(ExploreService, "_process_batch", gated)
    svc = ExploreService(max_queue=1, coalesce_window_s=0.0, max_batch=1,
                         device="cpu")
    try:
        svc.submit(_space(0), k=3, chunk_size=8)   # worker takes this
        assert entered.wait(timeout=10.0)          # ... and is gated
        svc.submit(_space(1), k=3, chunk_size=8)   # fills the queue
        with pytest.raises(QueueFull, match="capacity"):
            svc.submit(_space(2), k=3, chunk_size=8)
        assert svc.metrics()["rejected"] == 1
    finally:
        gate.set()
        svc.close()


def test_deadline_expires_in_queue():
    svc = ExploreService(coalesce_window_s=0.3, device="cpu")
    try:
        h = svc.submit(_space(0), k=3, chunk_size=8, timeout_s=0.01)
        time.sleep(0.05)
        with pytest.raises(RequestTimeout, match="deadline expired"):
            h.result(timeout=10.0)
        assert svc.metrics()["expired"] == 1
    finally:
        svc.close()


def test_result_wait_timeout(svc):
    h = svc.submit(_space(0), k=3, chunk_size=8)
    with pytest.raises(RequestTimeout, match="not complete"):
        h.result(timeout=1e-4)
    h.result(timeout=60.0)  # and it still completes normally


def test_closed_service_rejects_submits():
    svc = ExploreService(device="cpu")
    svc.close()
    with pytest.raises(ServiceClosed, match="closed"):
        svc.submit(_space(0), k=3)
    svc.close()  # idempotent


def test_close_drains_backlog():
    svc = ExploreService(coalesce_window_s=0.0, device="cpu")
    handles = [svc.submit(_space(i), k=3, chunk_size=8)
               for i in range(3)]
    svc.close(drain=True)
    for i, h in enumerate(handles):
        _assert_parity(h.result(timeout=1.0), _solo(i, k=3, chunk_size=8))


def test_close_without_drain_fails_backlog():
    svc = ExploreService(coalesce_window_s=5.0, max_queue=8, device="cpu")
    svc.submit(_space(0), k=3, chunk_size=8)     # occupies the window
    backlog = [svc.submit(_space(i), k=3, chunk_size=8)
               for i in range(1, 4)]
    svc.close(drain=False)
    failed = 0
    for h in backlog:
        try:
            h.result(timeout=5.0)
        except ServiceClosed:
            failed += 1
    assert failed == len(backlog)


def test_submit_validation(svc):
    with pytest.raises(ValueError, match="k must be"):
        svc.submit(_space(0), k=0)
    with pytest.raises(ValueError, match="chunk_size must be"):
        svc.submit(_space(0), chunk_size=0)
    with pytest.raises(ValueError, match="unknown engine"):
        svc.submit(_space(0), engine="warp")
    with pytest.raises(TypeError, match="DesignSpace"):
        svc.submit({"variant": ["2d_in"]})
    with pytest.raises(ValueError, match="timeout_s"):
        svc.submit(_space(0), timeout_s=0.0)
    # the port's lanes: "cuda" needs a CUDA device, and the staged engine
    # runs its device's kernels (it takes no explicit lane)
    with pytest.raises(ValueError, match="CUDA device"):
        svc.submit(_space(0), backend="cuda")
    with pytest.raises(ValueError, match="requires engine='fused'"):
        svc.submit(_space(0), engine="staged", backend="torch")
    assert svc.metrics()["submitted"] == 0


# ---------------------------------------------------------------------------
# asyncio front end
# ---------------------------------------------------------------------------

def test_async_front_end(svc):
    async def main():
        r1, r2 = await asyncio.gather(
            svc.aexplore(_space(0), k=4, chunk_size=8),
            svc.aexplore(_space(1), k=4, chunk_size=8))
        h = await svc.asubmit(_space(2), k=4, chunk_size=8,
                              stream=True)
        updates = [u async for u in svc.apartials(h)]
        r3 = await svc.aresult(h)
        return r1, r2, updates, r3

    r1, r2, updates, r3 = asyncio.run(main())
    assert r1.serve is not None and r2.serve is not None
    assert updates and updates[-1].final
    _assert_parity(r3, _solo(2, k=4, chunk_size=8))


# ---------------------------------------------------------------------------
# the direct fallback: staged and grid engines run inline on the worker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine,chunk", [("staged", 8), ("monolithic", None),
                                          ("chunked", 8)])
def test_direct_fallback_equals_explore(svc, engine, chunk):
    res = svc.explore(_space(1), k=4, engine=engine, chunk_size=chunk)
    assert res.engine == engine and res.serve["coalesce_group"] == 1
    assert res.serve["dispatches"] == res.dispatches >= 1
    _assert_parity(res, explore(_space(1), k=4, engine=engine,
                                chunk_size=chunk, device="cpu"), rtol=0)
    # as the reference's, a direct result is not cached, and the engine
    # does not join the replay key: after a fused request for the same
    # question the direct request replays the fused answer
    assert not svc.explore(_space(1), k=4, engine=engine,
                           chunk_size=chunk).serve["cache_hit"]
    fused = svc.explore(_space(1), k=4, engine="fused", chunk_size=8)
    assert not fused.serve["cache_hit"]
    again = svc.explore(_space(1), k=4, engine=engine, chunk_size=chunk)
    assert again.serve["cache_hit"] and again.engine == "fused"


# ---------------------------------------------------------------------------
# parity with the reference's served results
# ---------------------------------------------------------------------------

def _assert_served_equal(ours, ref):
    """Top-k rows at rel 1e-6; flat indices, variants and counts
    exactly; summaries as the port's other parity tests hold them."""
    assert (ours.n_points, ours.n_feasible, ours.dispatches) \
        == (ref.n_points, ref.n_feasible, ref.dispatches)
    assert [(r["algorithm"], r["variant"], r["index"]) for r in ours.topk] \
        == [(r["algorithm"], r["variant"], r["index"]) for r in ref.topk]
    for o, r in zip(ours.topk, ref.topk):
        assert sorted(o) == sorted(r)
        for key, val in r.items():
            if isinstance(val, float):
                np.testing.assert_allclose(o[key], val, rtol=REL, atol=0,
                                           err_msg=key)
    assert list(ours.summaries) == list(ref.summaries)
    for label, rs in ref.summaries.items():
        os_ = ours.summaries[label]
        for key in ("n", "n_feasible", "argmin_index", "argmin_point"):
            assert os_[key] == rs[key], (label, key)
        for key in ("metric_min", "metric_mean"):
            np.testing.assert_allclose(os_[key], rs[key], rtol=REL, atol=0)


def _gauntlet(service, explore_fn, space_fn, n=8):
    out = {}

    def client(i):
        out[i] = explore_fn(space_fn(i), k=5, engine="fused", chunk_size=8,
                            superchunk=2, service=service)

    _concurrently(client, n)
    return out


def test_gauntlet_matches_reference_served():
    from repro.explore import DesignSpace as RefSpace
    from repro.explore import explore as ref_explore
    from repro.serve import ExploreService as RefService
    with RefService(coalesce_window_s=GATHER_S, max_batch=8) as ref_svc:
        ref = _gauntlet(ref_svc, ref_explore,
                        lambda i: RefSpace("edgaze", _grids(i)))
    with ExploreService(coalesce_window_s=GATHER_S, max_batch=8,
                        device="cpu") as svc:
        ours = _gauntlet(svc, explore, _space)
    for i in range(8):
        assert ref[i].backend == "xla" and ours[i].backend == "torch"
        _assert_served_equal(ours[i], ref[i])
        for key in ("coalesce_group", "segments", "dispatches",
                    "dispatch_share", "cache_hit", "deduped"):
            assert ours[i].serve[key] == ref[i].serve[key], key


@pytest.mark.parametrize("tenants", [1, 2], ids=["solo", "coalesced"])
def test_partial_stream_matches_reference(tenants):
    """Every update (solo: the ``on_partial`` snapshots; coalesced: the
    merged segments) equals the reference's at ``partial_interval_s=0``."""
    from repro.explore import DesignSpace as RefSpace
    from repro.serve import ExploreService as RefService

    def run(service, space_fn):
        handles = [service.submit(space_fn(3 + i), k=4, engine="fused",
                                  chunk_size=4, superchunk=1, stream=True)
                   for i in range(tenants)]
        return [(list(h.partials()), h.result(timeout=300))
                for h in handles]

    with RefService(coalesce_window_s=GATHER_S, max_batch=tenants,
                    partial_interval_s=0) as rs:
        ref = run(rs, lambda i: RefSpace("edgaze", _grids(i)))
    with ExploreService(coalesce_window_s=GATHER_S, max_batch=tenants,
                        partial_interval_s=0, device="cpu") as svc:
        ours = run(svc, _space)
    for (o_ups, o_res), (r_ups, r_res) in zip(ours, ref):
        assert o_res.serve["coalesce_group"] == tenants
        _assert_served_equal(o_res, r_res)
        assert len(o_ups) == len(r_ups) > 2
        for o, r in zip(o_ups, r_ups):
            assert (o.seq, o.done, o.span, o.n_feasible, o.final) \
                == (r.seq, r.done, r.span, r.n_feasible, r.final)
            assert [(x["variant"], x["index"]) for x in o.topk] \
                == [(x["variant"], x["index"]) for x in r.topk]
            np.testing.assert_allclose(
                [x["total_j"] for x in o.topk],
                [x["total_j"] for x in r.topk], rtol=REL, atol=0)


#: requests whose compat keys partition like the reference's: same
#: shapes with other values, other shapes, and each key field moved
_REQUESTS = [
    ("v0", dict()), ("v7", dict()), ("v0", dict(k=6)),
    ("v0", dict(metric="on_sensor_j")), ("v0", dict(chunk_size=4)),
    ("v0", dict(chunk_size=100)), ("v3", dict(chunk_size=12)),
    ("v0", dict(superchunk=1)), ("v5", dict(superchunk=None)),
    ("v0", dict(block_points=2)), ("wide", dict()), ("wide2", dict()),
    ("rhythmic", dict()), ("both", dict()), ("soc", dict()),
]


def _request_space(name, space_cls):
    grids = {"wide": dict(BASE, frame_rate=[15.0, 30.0, 60.0, 120.0]),
             "wide2": dict(BASE, frame_rate=[10.0, 20.0, 40.0, 80.0])}
    if name.startswith("v"):
        return space_cls("edgaze", _grids(int(name[1:])))
    if name in grids:
        return space_cls("edgaze", grids[name])
    if name == "rhythmic":
        return space_cls("rhythmic", {"cis_node": [130.0, 65.0]})
    if name == "both":
        return space_cls(["edgaze", "rhythmic"], MULTI)
    return space_cls("edgaze", _grids(0), soc_node=65)


def test_compat_key_groups_like_the_reference():
    from repro.explore import DesignSpace as RefSpace
    from repro.launch.mesh import make_batch_mesh
    from repro.serve.coalesce import compat_key as ref_key
    from repro.serve.coalesce import plan_segments as ref_segments
    from repro.serve.coalesce import prepare_request as ref_prepare
    mesh = make_batch_mesh(1)

    def partition(keys):
        groups = {}
        for j, key in enumerate(keys):
            groups.setdefault(key, []).append(j)
        return sorted(groups.values())

    ours, ref = [], []
    for name, kw in _REQUESTS:
        base = dict(k=5, metric="total_j", chunk_size=8,
                    block_points=4096, superchunk=2)
        base.update(kw)
        pr = prepare_request(_request_space(name, DesignSpace),
                             backend="torch", mesh=ONE, **base)
        rp = ref_prepare(_request_space(name, RefSpace), backend="xla",
                         mesh=mesh, **base)
        assert (pr.chunk, pr.s_len, pr.cpv, pr.wide, pr.total) \
            == (rp.chunk, rp.s_len, rp.cpv, rp.wide, rp.total)
        assert plan_segments(pr) == ref_segments(rp)
        ours.append(compat_key(pr, ONE))
        ref.append(ref_key(rp, mesh))
    assert partition(ours) == partition(ref)
    # v7 and soc join v0, v3 joins v0 at chunk 100 (both clamp to 12),
    # wide2 joins wide
    assert len(partition(ours)) == len(_REQUESTS) - 4


# ---------------------------------------------------------------------------
# the driver's on_partial hook
# ---------------------------------------------------------------------------

_HOOK_CASES = [
    dict(engine="fused", chunk_size=3, superchunk=None, index_range=None),
    dict(engine="fused", chunk_size=4, superchunk=3,
         index_range=(7, 2 * N_VAR - 5)),
    dict(engine="staged", chunk_size=5, superchunk=None, index_range=None),
    dict(engine="staged", chunk_size=8, superchunk=None,
         index_range=(3, 3 * N_VAR - 1)),
]


def _sweep(hook=None, **kw):
    progress = []
    st = _stream_impl(["edgaze", "rhythmic"], MULTI, k=4, device="cpu",
                      progress=lambda d, s: progress.append((d, s)),
                      on_partial=hook, **kw)
    return st, progress


def _snapshot_hook(snaps):
    def hook(done, span, snapshot):
        snaps.append((done, span, snapshot()))
    return hook


@pytest.mark.parametrize("case", _HOOK_CASES, ids=lambda c: "-".join(
    f"{v}" for v in c.values()))
def test_on_partial_once_per_dispatch_with_progress_done(case):
    calls = []
    st, progress = _sweep(lambda d, s, snap: calls.append((d, s)), **case)
    assert calls == progress and len(calls) == st.dispatches > 1


@pytest.mark.parametrize("case", _HOOK_CASES, ids=lambda c: "-".join(
    f"{v}" for v in c.values()))
def test_snapshots_match_the_references(case):
    """At every dispatch the port's snapshot equals the reference's
    ``_stream_impl(on_partial=)`` snapshot (fused: ``backend="xla"``;
    staged: the reference's Pallas pipeline in interpret mode)."""
    from repro.core.shard_sweep import _stream_impl as ref_stream
    from repro.launch.mesh import make_batch_mesh
    ours, ref = [], []
    _sweep(_snapshot_hook(ours), **case)
    ref_kw = dict(case, backend="xla") if case["engine"] == "fused" \
        else case
    ref_stream(["edgaze", "rhythmic"], MULTI, k=4, mesh=make_batch_mesh(1),
               on_partial=_snapshot_hook(ref), **ref_kw)
    assert [(d, s) for d, s, _ in ours] == [(d, s) for d, s, _ in ref]
    for (done, _, o), (_, _, r) in zip(ours, ref):
        assert o.n_points == r.n_points == done
        assert (o.dispatches, o.superchunk) == (r.dispatches, r.superchunk)
        assert o.occupancy == pytest.approx(r.occupancy, rel=1e-12)
        _assert_served_equal(o, r)


@pytest.mark.parametrize("case", _HOOK_CASES, ids=lambda c: "-".join(
    f"{v}" for v in c.values()))
def test_hook_changes_no_result(case):
    snaps = []
    with_hook, _ = _sweep(_snapshot_hook(snaps), **case)
    plain, _ = _sweep(**case)
    assert with_hook.topk == plain.topk
    assert json.dumps(with_hook.summaries) == json.dumps(plain.summaries)
    assert (with_hook.n_points, with_hook.n_feasible, with_hook.dispatches,
            with_hook.occupancy) == (plain.n_points, plain.n_feasible,
                                     plain.dispatches, plain.occupancy)
    # the last snapshot is the final result, as of its dispatch
    assert snaps[-1][2].topk == plain.topk
    assert snaps[-1][2].n_points == plain.n_points


def test_snapshot_outside_its_hook_raises():
    kept = []
    _sweep(lambda d, s, snap: kept.append(snap), engine="fused",
           chunk_size=5, superchunk=1)
    with pytest.raises(RuntimeError, match="only inside its hook"):
        kept[0]()


# ---------------------------------------------------------------------------
# the step cache
# ---------------------------------------------------------------------------

def test_step_builds_once_per_shape_key_across_threads():
    """16 threads sweep same-shape spaces at once, with a short switch
    interval: one build; results equal to sequential sweeps."""
    stream_cache_clear()
    kw = dict(k=4, engine="fused", chunk_size=8, superchunk=2,
              device="cpu")
    out = {}
    barrier = threading.Barrier(16)

    def client(i):
        barrier.wait(timeout=60)
        out[i] = explore(_space(i % 8), **kw)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _concurrently(client, 16)
    finally:
        sys.setswitchinterval(interval)
    info = stream_cache_info()
    assert info["step_builds"] == 1
    assert info["dispatches"] == sum(r.dispatches for r in out.values())
    for i, res in out.items():
        _assert_parity(res, explore(_space(i % 8), **kw), rtol=0)
    assert stream_cache_info()["step_builds"] == 1
    # each shape-key field builds its own step
    builds = 1
    for extra in (dict(superchunk=1), dict(chunk_size=4), dict(k=3),
                  dict(metric="on_sensor_j"), dict(engine="staged",
                                                   superchunk=None)):
        explore(_space(0), **dict(kw, **extra))
        builds += 1
        assert stream_cache_info()["step_builds"] == builds, extra
    stream_cache_clear()
    assert stream_cache_info()["step_builds"] == 0


def test_step_cache_keeps_the_most_recent_keys(monkeypatch):
    monkeypatch.setattr(shard_sweep, "_STEP_LIMIT", 2)
    stream_cache_clear()
    kw = dict(k=4, engine="fused", superchunk=2, device="cpu")
    for chunk in (8, 4, 8, 6, 4):
        explore(_space(0), chunk_size=chunk, **kw)
    # 8, 4 built; 8 hit; 6 built (evicts 4); 4 rebuilt
    assert stream_cache_info()["step_builds"] == 4
    assert len(shard_sweep._STEPS) == 2
    stream_cache_clear()
