"""``explore(progress=, pipeline_depth=)`` of the port against the
reference's.

* ``progress(done, span)`` fires once per dispatch with the reference's
  ``done`` (``repro/core/shard_sweep.py:1102-1109`` fused, ``:1152-1154``
  staged): the port's fused and staged engines on the CPU against the
  reference's ``explore(..., backend="xla")`` on the same space, chunk,
  superchunk and ``index_range``, as ``(done, span)`` lists;
* ``pipeline_depth`` changes no result, and on a CUDA device the host
  waits on exactly ``max(0, dispatches - pipeline_depth)`` events (the
  pacer's event class is replaced by a recorder here, so the count is
  checked without a card);
* the grid engines refuse both keywords with the reference's "requires
  a streaming engine" (``tests/test_explore.py:194-195``).
"""
import numpy as np
import pytest
import torch

import test_torch_explore as tte

GRIDS = {"variant": ["2d_in", "3d_in"],
         "cis_node": [130.0, 65.0, 28.0],
         "frame_rate": [15.0, 30.0, 60.0],
         "sys_rows": [8.0, 32.0]}
N_VAR = 3 * 3 * 2


def _progress_lists(algos, grids, **kw):
    from repro.explore import DesignSpace as RefSpace
    from repro.explore import explore as ref_explore
    from repro_torch.explore import DesignSpace, explore
    ref_calls, our_calls = [], []
    ref_kw = dict(kw, backend="xla") if kw.get("engine") == "fused" else kw
    ref = ref_explore(RefSpace(algos, grids),
                      progress=lambda d, s: ref_calls.append((d, s)),
                      **ref_kw)
    ours = explore(DesignSpace(algos, grids), device="cpu",
                   progress=lambda d, s: our_calls.append((d, s)), **kw)
    return ours, ref, our_calls, ref_calls


@pytest.mark.parametrize("chunk,superchunk,index_range", [
    (5, None, None), (5, 2, None), (4, 3, (7, 2 * N_VAR - 5)),
    (N_VAR, 1, (N_VAR - 2, N_VAR + 3)), (7, 16, (0, 0))])
def test_fused_progress_matches_reference(chunk, superchunk, index_range):
    ours, ref, got, want = _progress_lists(
        ["edgaze", "rhythmic"], GRIDS, engine="fused", chunk_size=chunk,
        superchunk=superchunk, index_range=index_range, k=4)
    assert got == want
    assert len(got) == ours.dispatches == ref.dispatches
    tte.assert_explore_equal(ours, ref)


@pytest.mark.parametrize("chunk,index_range", [
    (5, None), (8, (3, 3 * N_VAR - 1)), (N_VAR, (N_VAR - 2, N_VAR + 3))])
def test_staged_progress_matches_reference(chunk, index_range):
    ours, ref, got, want = _progress_lists(
        ["edgaze", "rhythmic"], GRIDS, engine="staged", chunk_size=chunk,
        index_range=index_range, k=4)
    assert got == want
    assert len(got) == ours.dispatches == ref.dispatches
    lo, hi = index_range or (0, 4 * N_VAR)
    assert got[-1] == (hi - lo, hi - lo)


@pytest.mark.parametrize("engine", ["fused", "staged"])
@pytest.mark.parametrize("depth", [0, 1, 2, 4, 100])
def test_pipeline_depth_bounds_event_waits(monkeypatch, engine, depth):
    """One event per dispatch; the host waits on the oldest whenever more
    than ``depth`` are pending: ``max(0, dispatches - depth)`` waits, and
    the same result as without pacing."""
    from repro_torch.core import shard_sweep
    from repro_torch.explore import DesignSpace, explore
    events = []

    class Recorder:
        def __init__(self):
            self.waited = False
            events.append(self)

        def record(self, stream=None):
            pass

        def synchronize(self):
            self.waited = True

    class FakeCudaPacer(shard_sweep._Pacer):
        def __init__(self, device, depth):
            super().__init__(device, depth)
            self.on_cuda = True

    monkeypatch.setattr(shard_sweep, "_Pacer", FakeCudaPacer)
    monkeypatch.setattr(torch.cuda, "Event", Recorder)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    space = DesignSpace(["edgaze"], GRIDS)
    kw = dict(engine=engine, chunk_size=4, k=3, device="cpu")
    if engine == "fused":
        kw["superchunk"] = 2
    paced = explore(space, pipeline_depth=depth, **kw)
    monkeypatch.undo()
    plain = explore(space, **kw)
    assert len(events) == paced.dispatches > 4
    assert sum(e.waited for e in events) == max(0, paced.dispatches - depth)
    assert [e.waited for e in events] == sorted(
        (e.waited for e in events), reverse=True)   # oldest first
    tte.assert_explore_equal(paced, plain, rel=0)


def test_cpu_dispatches_record_no_event(monkeypatch):
    from repro_torch.explore import DesignSpace, explore

    def no_event(*_a, **_k):
        raise AssertionError("an event was recorded on the CPU")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    res = explore(DesignSpace(["edgaze"], GRIDS), engine="fused",
                  chunk_size=3, k=2, device="cpu", pipeline_depth=1)
    assert res.dispatches >= 1


@pytest.mark.parametrize("engine", ["monolithic", "chunked"])
@pytest.mark.parametrize("kwargs", [dict(progress=print),
                                    dict(pipeline_depth=8)],
                         ids=["progress", "pipeline_depth"])
def test_grid_engines_refuse_streaming_keywords(engine, kwargs):
    from repro.explore import DesignSpace as RefSpace
    from repro.explore import explore as ref_explore
    from repro_torch.explore import DesignSpace, explore
    grids = {"variant": ["2d_in"], "cis_node": [65.0]}
    name = next(iter(kwargs))
    with pytest.raises(ValueError, match=f"{name}= requires a streaming "
                                         f"engine"):
        ref_explore(RefSpace(["edgaze"], grids), engine=engine, **kwargs)
    with pytest.raises(ValueError, match=f"{name}= requires a streaming "
                                         f"engine"):
        explore(DesignSpace(["edgaze"], grids), engine=engine, device="cpu",
                **kwargs)
    # the defaults pass
    res = explore(DesignSpace(["edgaze"], grids), engine=engine,
                  device="cpu", progress=None, pipeline_depth=4)
    assert res.engine == engine and np.isfinite(res.topk[0]["total_j"])
