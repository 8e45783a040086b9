"""End-to-end parity: ``repro_torch.explore`` == ``repro.explore`` (fused).

``repro_torch.explore.explore(space, engine="fused", device="cpu")``
(the torch twin of the megakernel) against the reference's
``explore(space, engine="fused", backend="xla")`` on one device, with
the semantics of the reference's ``_assert_stream_equal``
(``tests/test_fused_sweep.py``): ``n_points`` / ``n_feasible``; the top-k
``(algorithm, variant, index)`` and every full-row output at rel 1e-6;
per-variant ``n``, ``n_feasible``, ``metric_min``, ``metric_mean`` and
``argmin_index``; and ``dispatches``.  Where two reference candidates'
values lie within the tolerance of each other, either order is accepted
(the two packages evaluate the same f32 arithmetic with different
transcendental implementations, so near-ties may swap; exact ties keep
the lowest flat index in both).

The reference's own int64 streaming is broken on the installed jax
(ROADMAP R1), so the int64 cases are held against the oracle those
reference tests use: ``variant_grid(...).point(flat)`` plus a one-point
per-plan ``evaluate_batch``, which runs 32-bit.
"""
import numpy as np
import pytest

REL = 1e-6

FIXED = {"variant": ["2d_in", "3d_in"],
         "cis_node": [130.0, 65.0, 28.0],
         "frame_rate": [15.0, 30.0],
         "sys_rows": [8.0, 16.0, 32.0],
         "active_fraction_scale": [0.25, 1.0]}
MULTI = {"variant": ["2d_in", "3d_in"],
         "cis_node": [130.0, 65.0],
         "frame_rate": [15.0, 60.0],
         "sys_rows": [8.0, 32.0],
         "mem_tech": ["sram_hp", "stt"]}
TAILS = {"variant": ["2d_in", "3d_in"],
         "cis_node": [130.0, 65.0, 28.0],
         "frame_rate": [15.0, 30.0],
         "active_fraction_scale": [0.25, 1.0]}


def _key(row):
    return row["algorithm"], row["variant"], row["index"]


def assert_explore_equal(ours, ref, rel=REL):
    assert ours.n_points == ref.n_points
    assert ours.n_feasible == ref.n_feasible
    assert ours.dispatches == ref.dispatches
    metric = ref.metric
    ov = [r[metric] for r in ours.topk]
    rv = [r[metric] for r in ref.topk]
    assert len(ov) == len(rv)
    np.testing.assert_allclose(ov, rv, rtol=rel, atol=0)
    ref_rows = {_key(r): r for r in ref.topk}
    for j, (o, r) in enumerate(zip(ours.topk, ref.topk)):
        if _key(o) != _key(r):
            # near-tie: accepted only where the reference ranks a
            # neighbour within the tolerance (or at the list's end)
            near = [i for i in (j - 1, j + 1) if 0 <= i < len(rv)
                    and np.isclose(rv[i], rv[j], rtol=rel, atol=0)]
            assert near or j == len(rv) - 1, (j, _key(o), _key(r))
        match = ref_rows.get(_key(o))
        if match is None:
            continue
        assert sorted(o) == sorted(match)
        for name, val in match.items():
            if isinstance(val, str) or name == "index":
                assert o[name] == val, name
            else:
                np.testing.assert_allclose(o[name], val, rtol=rel, atol=0,
                                           err_msg=f"{_key(o)} {name}")
    assert sorted(ours.summaries) == sorted(ref.summaries)
    for label, rs in ref.summaries.items():
        os_ = ours.summaries[label]
        assert (os_["n"], os_["n_feasible"]) == (rs["n"], rs["n_feasible"])
        for name in ("metric_min", "metric_mean"):
            if np.isnan(rs[name]) or np.isnan(os_[name]):
                assert np.isnan(rs[name]) and np.isnan(os_[name])
            else:
                np.testing.assert_allclose(os_[name], rs[name], rtol=rel,
                                           atol=0, err_msg=f"{label}.{name}")
        assert os_["argmin_index"] == rs["argmin_index"], label
        assert os_["argmin_point"] == rs["argmin_point"], label


def _both(algos, grids, **kw):
    from repro.explore import DesignSpace as RefSpace
    from repro.explore import explore as ref_explore
    from repro.launch.mesh import make_batch_mesh
    from repro_torch.explore import DesignSpace, explore
    ref = ref_explore(RefSpace(algos, grids), engine="fused",
                      backend="xla", mesh=make_batch_mesh(1), **kw)
    ours = explore(DesignSpace(algos, grids), engine="fused", device="cpu",
                   **kw)
    assert ours.backend == "torch" and ours.engine == "fused"
    assert ref.backend == "xla"
    return ours, ref


@pytest.fixture(scope="module")
def fixed_case():
    return _both(["edgaze"], FIXED, chunk_size=13, k=7)


def test_explore_matches_reference_fixed_case(fixed_case):
    ours, ref = fixed_case
    assert_explore_equal(ours, ref)
    assert ours.n_points == 2 * 3 * 2 * 3 * 2
    assert ours.cache["stream"]["twin_calls"] >= 1


def test_explore_matches_reference_multi_algorithm():
    ours, ref = _both(["edgaze", "rhythmic"], MULTI, chunk_size=8, k=6)
    assert_explore_equal(ours, ref)
    assert {r["algorithm"] for r in ours.topk} <= {"edgaze", "rhythmic"}


@pytest.mark.parametrize("cut", ["full", "inside", "middle"])
def test_explore_matches_reference_index_range_tails(cut):
    """Cuts landing inside chunks and inside variants (the superchunk is
    pinned so the reference reuses one executable across the cuts)."""
    total = 2 * 3 * 2 * 2
    lo, hi = {"full": (0, total), "inside": (5, total - 3),
              "middle": (total // 2 - 1, total // 2 + 3)}[cut]
    ours, ref = _both(["edgaze"], TAILS, chunk_size=8, k=4,
                      index_range=(lo, hi), superchunk=16)
    assert_explore_equal(ours, ref)
    assert ours.n_points == hi - lo


def test_explore_matches_reference_property():
    """Hypothesis over grid shapes, chunk sizes and range cuts; k and
    the superchunk are pinned so the reference compiles at most four
    step executables."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")
    grids = [{"variant": ["2d_in", "3d_in"], "cis_node": [130.0, 28.0],
              "frame_rate": [15.0, 30.0, 60.0]},
             {"variant": ["3d_in"], "cis_node": [130.0, 65.0, 28.0],
              "sys_rows": [8.0, 32.0], "pixel_pitch_um": [3.0, 5.0]}]

    @hyp.settings(max_examples=8, deadline=None, derandomize=True)
    @hyp.given(st.tuples(st.integers(0, 1), st.sampled_from([3, 5]),
                         st.integers(0, 100), st.integers(0, 100)))
    def run(params):
        gi, chunk, lo_s, hi_s = params
        total = 12
        lo = lo_s % total
        hi = lo + 1 + (hi_s % (total - lo))
        ours, ref = _both(["edgaze"], grids[gi], chunk_size=chunk, k=4,
                          index_range=(lo, hi), superchunk=16)
        assert_explore_equal(ours, ref)

    run()


def test_superchunk_lengths_agree(fixed_case):
    """One dispatch per chunk (superchunk=1) and longer scans give the
    reference's results; the dispatch count follows ceil(chunks / s)."""
    from repro_torch.explore import DesignSpace, explore
    _ours, ref = fixed_case
    space = DesignSpace(["edgaze"], FIXED)
    one = explore(space, engine="fused", chunk_size=13, k=7, superchunk=1,
                  device="cpu")
    n_chunks = one.dispatches
    assert one.superchunk == 1 and n_chunks == 2 * -(-36 // 13)
    for s in (1, 4, None):
        res = explore(space, engine="fused", chunk_size=13, k=7,
                      superchunk=s, device="cpu")
        assert res.dispatches == -(-n_chunks // (s or n_chunks))
        res.dispatches = ref.dispatches
        assert_explore_equal(res, ref)


def test_best_by_algorithm_matches_reference():
    """``ExploreResult.best_by_algorithm`` / ``StreamResult.
    best_by_algorithm`` name the reference's best variant per algorithm,
    with its feasible count and argmin point."""
    ours, ref = _both(["edgaze", "rhythmic"], MULTI, chunk_size=8, k=2)
    ref_best = ref.best_by_algorithm()
    assert ref_best == ref.stream_result.best_by_algorithm()
    for best in (ours.best_by_algorithm(),
                 ours.stream_result.best_by_algorithm()):
        assert sorted(best) == sorted(ref_best) == ["edgaze", "rhythmic"]
        for algo, rec in ref_best.items():
            assert best[algo]["variant"] == rec["variant"]
            assert best[algo]["n_feasible"] == rec["n_feasible"]
            assert best[algo]["summary"]["argmin_point"] \
                == rec["summary"]["argmin_point"]
            np.testing.assert_allclose(best[algo]["summary"]["metric_min"],
                                       rec["summary"]["metric_min"],
                                       rtol=REL)


def test_stream_payload_matches_reference(fixed_case):
    from repro_torch.core.shard_sweep import StreamResult
    ours, ref = fixed_case
    payload = ours.stream_result.to_payload()
    assert sorted(payload) == sorted(ref.stream_result.to_payload())
    back = StreamResult.from_payload(payload)
    assert back.to_payload() == payload


def _oracle_total(grids, flat):
    from repro.core.batch import evaluate_batch, make_points
    from repro.core.sweep import (_normalize_grids, lower_variant,
                                  variant_grid)
    plan = lower_variant("edgaze", "3d_in")
    _variants, ngrids = _normalize_grids("edgaze", dict(grids))
    point = variant_grid(plan, ngrids).point(flat)
    ref = evaluate_batch(plan, make_points(
        plan, 1, **{ax: [val] for ax, val in point.items()}))
    return float(ref["total_j"][0])


@pytest.mark.parametrize("case", ["beyond_int32", "danger_window"])
def test_int64_tail_matches_oracle(case):
    """A tail index_range of a >= 2**31-point space (and of one whose last
    chunk overshoots 2**31) streams with int64 flat indices."""
    from repro_torch.explore import DesignSpace, explore
    if case == "beyond_int32":
        grids = {"variant": ["3d_in"],
                 "cis_node": list(np.linspace(28.0, 130.0, 1500)),
                 "frame_rate": list(np.linspace(15.0, 120.0, 1500)),
                 "active_fraction_scale": list(np.linspace(0.1, 1.0,
                                                           1000))}
        total, chunk, k, n = 1500 * 1500 * 1000, 64, 4, 150
        assert total >= 2 ** 31
    else:
        grids = {"variant": ["3d_in"],
                 "cis_node": list(np.linspace(28.0, 130.0, 1057)),
                 "sys_rows": list(np.linspace(4.0, 128.0, 18)),
                 "frame_rate": list(np.linspace(15.0, 120.0, 341)),
                 "active_fraction_scale": list(np.linspace(0.1, 1.0,
                                                           331))}
        total, chunk, k, n = 1057 * 18 * 341 * 331, 16, 3, 6
        assert total == 2 ** 31 - 2        # in the int32 danger window
    res = explore(DesignSpace(["edgaze"], grids), chunk_size=chunk, k=k,
                  index_range=(total - n, total), device="cpu")
    assert res.n_points == n and res.summaries["3d_in"]["n"] == n
    assert 0 < res.n_feasible <= n         # wrapped garbage would exceed
    for row in res.topk:
        assert total - n <= row["index"] < total
    row = res.topk[0]
    np.testing.assert_allclose(row["total_j"],
                               _oracle_total(grids, row["index"]),
                               rtol=REL)
    assert res.topk[0]["total_j"] <= res.topk[-1]["total_j"]
