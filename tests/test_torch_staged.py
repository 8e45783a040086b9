"""The port's staged engine and the ``explore()`` engine policy against
the reference's.

* ``explore(engine="staged")`` (``grid_decode`` -> banked evaluator ->
  ``block_stats`` -> top-k, one dispatch per variant-aligned chunk) on
  the CPU twins against the reference's staged engine on the same space,
  whole and cut by ``index_range``: top-k values, indices and full rows
  at rel 1e-6, summary means at rel 1e-5, ``engine`` / ``dispatches`` /
  ``chunk_size`` / ``n_feasible`` equal;
* the port's own parity chain fused == staged == monolithic on one space
  (the reference's ``tests/test_explore.py:370-384``);
* int64 flat indices past 2**31 through the staged engine, held against
  ``variant_grid(...).point(flat)`` plus a one-point per-plan
  ``evaluate_batch`` (the reference's int64 streaming is broken on the
  installed jax, ROADMAP R1);
* ``engine="auto"`` resolves as the reference's at 2^15, 2^15+1, 2^21
  and 2^21+1 points, with and without ``chunk_size`` and with
  ``index_range`` (spaces built, not swept);
* the argument checks raise as the reference's do, and the staged engine
  on the default device raises without a GPU.
"""
import numpy as np
import pytest
import torch

import test_torch_explore as tte

GRIDS = {"variant": ["2d_in", "3d_in"],
         "cis_node": [130.0, 65.0, 28.0],
         "frame_rate": [15.0, 30.0, 240.0],
         "sys_rows": [8.0, 32.0],
         "mem_tech": ["sram_hp", "stt"],
         "vdd_scale": [0.9, 1.0],
         "adc_bits": [-1.0, 10.0]}
N_VAR = 3 * 3 * 2 * 2 * 2 * 2


def _both(algos, grids, **kw):
    from repro.explore import DesignSpace as RefSpace
    from repro.explore import explore as ref_explore
    from repro.launch.mesh import make_batch_mesh
    from repro_torch.explore import DesignSpace, explore
    ref = ref_explore(RefSpace(algos, grids), mesh=make_batch_mesh(1), **kw)
    ours = explore(DesignSpace(algos, grids), device="cpu", **kw)
    assert (ours.engine, ours.dispatches, ours.chunk_size, ours.n_feasible,
            ours.superchunk) == (ref.engine, ref.dispatches, ref.chunk_size,
                                 ref.n_feasible, ref.superchunk)
    return ours, ref


@pytest.mark.parametrize("index_range", [None, (5, 2 * N_VAR - 7),
                                         (N_VAR - 3, N_VAR + 20)])
def test_staged_matches_reference(index_range):
    from repro_torch.kernels.grid_decode import COUNTS as DECODE
    from repro_torch.kernels.stream_reduce import COUNTS as STATS
    DECODE["twin_calls"] = STATS["twin_calls"] = 0
    ours, ref = _both(["edgaze", "rhythmic"], GRIDS, engine="staged",
                      chunk_size=16, k=6, index_range=index_range)
    tte.assert_explore_equal(ours, ref)
    assert ours.backend == "torch" and ours.stream_result.engine == "staged"
    assert DECODE["twin_calls"] == STATS["twin_calls"] == ours.dispatches
    lo, hi = index_range or (0, 4 * N_VAR)
    assert ours.n_points == hi - lo


def test_staged_best_by_algorithm_matches_reference():
    ours, ref = _both(["edgaze", "rhythmic"], GRIDS, engine="staged",
                      chunk_size=32, k=4)
    for res in (ours, ours.stream_result):
        best = res.best_by_algorithm()
        ref_best = ref.stream_result.best_by_algorithm()
        assert sorted(best) == sorted(ref_best) == ["edgaze", "rhythmic"]
        for algo, rec in ref_best.items():
            assert best[algo]["variant"] == rec["variant"]
            assert best[algo]["n_feasible"] == rec["n_feasible"]
            assert best[algo]["summary"]["argmin_point"] \
                == rec["summary"]["argmin_point"]


def test_fused_staged_monolithic_chain():
    """The port's own three-engine parity chain, hooks swept."""
    from repro_torch.explore import DesignSpace, explore
    space = DesignSpace(["edgaze", "rhythmic"],
                        {k: v for k, v in GRIDS.items() if k != "variant"})
    fused = explore(space, engine="fused", chunk_size=16, k=6,
                    device="cpu")
    staged = explore(space, engine="staged", chunk_size=16, k=6,
                     device="cpu")
    mono = explore(space, engine="monolithic", k=6, device="cpu")
    for other in (staged, mono):
        other.dispatches = fused.dispatches
        tte.assert_explore_equal(other, fused)
        assert [(r["algorithm"], r["variant"], r["index"])
                for r in other.topk] == [(r["algorithm"], r["variant"],
                                          r["index"]) for r in fused.topk]


def test_staged_int64_tail_matches_oracle():
    from repro_torch.explore import DesignSpace, explore
    grids = {"variant": ["3d_in"],
             "cis_node": list(np.linspace(28.0, 130.0, 1500)),
             "frame_rate": list(np.linspace(15.0, 120.0, 1500)),
             "active_fraction_scale": list(np.linspace(0.1, 1.0, 1000))}
    total, n = 1500 * 1500 * 1000, 150
    res = explore(DesignSpace(["edgaze"], grids), engine="staged",
                  chunk_size=64, k=4, index_range=(total - n, total),
                  device="cpu")
    assert res.n_points == n and res.dispatches == -(-n // 64)
    assert 0 < res.n_feasible <= n
    for row in res.topk:
        assert 2 ** 31 <= total - n <= row["index"] < total
        np.testing.assert_allclose(row["total_j"],
                                   tte._oracle_total(grids, row["index"]),
                                   rtol=tte.REL)


def _space_pair(n_points):
    """Reference and port spaces of ``n_points`` (one variant, two axes)."""
    from repro.explore import DesignSpace as RefSpace
    from repro_torch.explore import DesignSpace
    a = {32768: 128, 32769: 3, 2097152: 1024, 2097153: 3}[n_points]
    grids = {"variant": ["2d_in"],
             "cis_node": np.linspace(20.0, 130.0, a),
             "frame_rate": np.linspace(15.0, 240.0, n_points // a)}
    return RefSpace(["edgaze"], grids), DesignSpace(["edgaze"], grids)


@pytest.mark.parametrize("n_points", [2 ** 15, 2 ** 15 + 1, 2 ** 21,
                                      2 ** 21 + 1])
def test_auto_engine_policy_matches_reference(n_points):
    from repro.explore.api import _resolve_engine as ref_resolve
    from repro_torch.explore.api import _resolve_engine
    ref_space, space = _space_pair(n_points)
    assert space.n_points == ref_space.n_points == n_points
    for engine in ("auto", "monolithic", "chunked", "staged", "fused"):
        for chunk_size in (None, 4096):
            for index_range in (None, (0, 10)):
                args = (engine, chunk_size, index_range)
                assert _resolve_engine(engine, space, chunk_size,
                                       index_range) \
                    == ref_resolve(engine, ref_space, chunk_size,
                                   index_range), args


def test_auto_runs_the_resolved_engine():
    from repro_torch.explore import DesignSpace, explore
    space = DesignSpace(["edgaze"], {"variant": ["2d_in"],
                                     "cis_node": [130.0, 65.0]})
    assert explore(space, k=1, device="cpu").engine == "monolithic"
    assert explore(space, k=1, chunk_size=1,
                   device="cpu").engine == "chunked"
    assert explore(space, k=1, index_range=(0, 2),
                   device="cpu").engine == "fused"


@pytest.mark.parametrize("engine,kwargs,match", [
    ("monolithic", dict(index_range=(0, 1)), "index_range"),
    ("chunked", dict(superchunk=2), "superchunk"),
    ("monolithic", dict(block_points=128), "block_points"),
    ("chunked", dict(backend="torch"), "backend"),
    ("staged", dict(backend="torch"), "backend"),
    ("fused", dict(strict=True), "strict"),
    ("staged", dict(strict=True), "strict"),
])
def test_argument_checks_raise_like_the_reference(engine, kwargs, match):
    from repro.explore import DesignSpace as RefSpace
    from repro.explore import explore as ref_explore
    from repro_torch.explore import DesignSpace, explore
    grids = {"variant": ["2d_in"], "cis_node": [130.0, 65.0]}
    ref_kwargs = dict(kwargs)
    if ref_kwargs.get("backend") == "torch":
        ref_kwargs["backend"] = "xla"     # the reference's non-auto lane
    with pytest.raises(ValueError, match=match):
        ref_explore(RefSpace(["edgaze"], grids), k=1, engine=engine,
                    **ref_kwargs)
    with pytest.raises(ValueError, match=match):
        explore(DesignSpace(["edgaze"], grids), k=1, engine=engine,
                device="cpu", **kwargs)


def test_staged_default_device_without_cuda_raises(monkeypatch):
    from repro_torch.explore import DesignSpace, explore
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        explore(DesignSpace(["edgaze"], {"variant": ["2d_in"]}), k=1,
                engine="staged")
