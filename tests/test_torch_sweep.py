"""The port's per-plan evaluator, banked evaluator and grid engines
against the reference's.

* ``repro_torch.core.batch.evaluate_batch`` against
  ``repro.core.batch.evaluate_batch`` for every Ed-Gaze and Rhythmic
  variant and the registered ``toy`` pipeline, on the same seeded design
  points drawn from sweep grids (every memory technology, process nodes
  on, between and beyond the table knots, frame rates up to 3000 FPS),
  with the coefficient hooks off and on and ``keep_unit_energies`` both
  ways: every output at rel 1e-6, ``feasible`` exact.  The points come
  from value lists, as the reference's own evaluator parity tests draw
  them (``tests/test_grid_decode.py``): on continuous frame rates the
  model is ill-conditioned at a few points in a thousand — the
  reference's own per-plan and banked evaluators then disagree by
  2.1-2.3e-6 on ``cat_ADC_j``, one ulp of the interpolated log FoM;
* ``build_banked_eval`` (``eval_bank`` with mixed variant ids and
  ``eval_bank_uniform``) against the reference's, at rel 1e-6;
* ``explore(engine="monolithic" | "chunked")`` against the reference's
  on the same space: top-k rows and ``sweep_results`` tables at rel 1e-6,
  summary means at rel 1e-5, ``engine`` / ``dispatches`` /
  ``chunk_size`` / ``n_feasible`` equal, and ``best_by_algorithm``;
* the scalar oracle ``scalar_point`` against the reference's, and the
  grid engine's winner against it at the reference's 5e-4;
* ``strict=``, and the default device raising without a GPU.
"""
import numpy as np
import pytest
import torch

REL = 1e-6


@pytest.fixture
def toy():
    from repro.core.algorithms import register_algorithm as ref_register
    from repro.core.algorithms import unregister_algorithm as ref_unregister
    from repro.core.usecases.toy import TOY_VARIANTS as REF_VARIANTS
    from repro.core.usecases.toy import build_toy as ref_build
    from repro_torch.core.algorithms import (register_algorithm,
                                             unregister_algorithm)
    from repro_torch.core.usecases.toy import TOY_VARIANTS, build_toy
    ref_register("toy", ref_build, REF_VARIANTS)
    register_algorithm("toy", build_toy, TOY_VARIANTS)
    try:
        yield "toy"
    finally:
        ref_unregister("toy")
        unregister_algorithm("toy")


def _axes(n, seed, hooks):
    rng = np.random.default_rng(seed)
    axes = dict(
        cis_node=rng.choice([130.0, 110.0, 90.0, 65.0, 50.0, 28.0, 22.0,
                             16.0, 7.0, 180.0], n),
        soc_node=rng.choice([14.0, 22.0, 28.0, 40.0], n),
        mem_tech=rng.choice([-1, 0, 1, 2], n),
        sys_rows=rng.choice([4.0, 8.0, 16.0, 128.0], n),
        sys_cols=rng.choice([4.0, 32.0, 128.0], n),
        frame_rate=rng.choice([15.0, 24.0, 30.0, 60.0, 120.0, 240.0,
                               1000.0, 2000.0, 3000.0], n),
        active_fraction_scale=rng.choice([0.1, 0.25, 0.5, 0.8, 1.0], n),
        pixel_pitch_um=rng.choice([2.0, 3.0, 4.5, 6.0], n))
    if hooks:
        axes.update(vdd_scale=rng.choice([0.8, 0.95, 1.0, 1.2], n),
                    adc_bits=rng.choice([-1.0, 6.0, 8.0, 12.0], n))
    return axes


def _assert_outputs_equal(ours, ref, label):
    assert sorted(ours) == sorted(ref), label
    for key, rv in ref.items():
        ov, rv = np.asarray(ours[key]), np.asarray(rv)
        assert ov.shape == rv.shape, (label, key)
        if key == "feasible":
            np.testing.assert_array_equal(ov, rv, err_msg=f"{label} {key}")
        else:
            np.testing.assert_allclose(ov, rv, rtol=REL, atol=0,
                                       err_msg=f"{label} {key}")


def _variants():
    from repro_torch.core.algorithms import get_algorithm
    return [(a, v) for a in ("edgaze", "rhythmic")
            for v in get_algorithm(a).variants]


@pytest.mark.parametrize("hooks", [False, True])
def test_evaluate_batch_matches_reference(hooks, toy):
    from repro.core.batch import evaluate_batch as ref_eval
    from repro.core.batch import make_points as ref_points
    from repro.core.sweep import lower_variant as ref_lower
    from repro_torch.core.algorithms import get_algorithm
    from repro_torch.core.batch import evaluate_batch, make_points
    from repro_torch.core.grid import lower_variant
    cases = _variants() + [(toy, v) for v in get_algorithm(toy).variants]
    for i, (algo, variant) in enumerate(cases):
        axes = _axes(96, seed=i, hooks=hooks)
        keep = bool(i % 2)
        rp, pp = ref_lower(algo, variant), lower_variant(algo, variant)
        ref = ref_eval(rp, ref_points(rp, 96, **axes),
                       keep_unit_energies=keep)
        timings = {}
        ours = evaluate_batch(pp, make_points(pp, 96, device="cpu", **axes),
                              keep_unit_energies=keep, timings=timings)
        _assert_outputs_equal(ours, ref, (algo, variant, hooks))
        assert ("unit_e" in ours) == keep
        assert set(timings) == {"compile_s", "eval_s"}


def test_hook_defaults_run_no_hook_arithmetic():
    """``hooks`` is a specialisation: a batch at the hook defaults gives
    bit-identical outputs with the flag off (no hook arithmetic) and on
    (multiplications by exact ones)."""
    from repro_torch.core.batch import _hooks_active, eval_fn, make_points
    from repro_torch.core.grid import lower_variant
    plan = lower_variant("rhythmic", "2d_in")
    pts = make_points(plan, 8, device="cpu",
                      frame_rate=np.linspace(15.0, 240.0, 8))
    assert not _hooks_active(pts)
    off = eval_fn(plan)(pts, hooks=False)
    on = eval_fn(plan)(pts, hooks=True)
    for key in off:
        torch.testing.assert_close(off[key], on[key], rtol=0, atol=0)


def test_banked_eval_matches_reference():
    from repro.core.batch import build_banked_eval as ref_build
    from repro.core.batch import make_points as ref_points
    from repro.core.plan_bank import build_plan_bank as ref_bank
    from repro.core.sweep import lower_variant as ref_lower
    from repro_torch.core.batch import (banked_eval_fn, build_banked_eval,
                                        make_points)
    from repro_torch.core.grid import lower_variant
    from repro_torch.core.plan_bank import build_plan_bank
    variants = ("2d_in", "3d_in", "2d_in_mixed")       # differing units
    ref_plans = [ref_lower("edgaze", v) for v in variants]
    plans = [lower_variant("edgaze", v) for v in variants]
    rb, bank = ref_bank(ref_plans), build_plan_bank(plans, device="cpu")
    axes = _axes(64, seed=7, hooks=True)
    rpts = ref_points(ref_plans[0], 64, **axes)
    pts = make_points(plans[0], 64, device="cpu", **axes)
    ref_mixed, ref_uniform = ref_build(rb.dims)
    mixed, uniform = build_banked_eval(bank.dims)
    vid = np.random.default_rng(11).integers(0, 3, 64).astype(np.int32)
    _assert_outputs_equal(
        {k: v.numpy() for k, v in mixed(bank, vid, pts).items()},
        {k: np.asarray(v) for k, v in ref_mixed(rb.arrays, vid,
                                                rpts).items()}, "mixed")
    assert banked_eval_fn(bank.dims) is banked_eval_fn(bank.dims)
    for vi in range(3):
        _assert_outputs_equal(
            {k: v.numpy() for k, v in uniform(bank, vi, pts).items()},
            {k: np.asarray(v) for k, v in ref_uniform(rb.arrays, vi,
                                                      rpts).items()},
            ("uniform", vi))


GRID = {"variant": ["2d_in", "3d_in", "2d_off"],
        "cis_node": [130.0, 65.0, 28.0],
        "frame_rate": [15.0, 30.0, 60.0],
        "sys_rows": [8.0, 32.0],
        "mem_tech": ["sram", "stt"],
        "vdd_scale": [0.9, 1.0],
        "adc_bits": [-1.0, 10.0]}


def _assert_tables_equal(ours, ref):
    assert sorted(ours) == sorted(ref)
    for algo, r in ref.items():
        o = ours[algo]
        assert len(o) == len(r) and sorted(o.outputs) == sorted(r.outputs)
        assert sorted(o.params) == sorted(r.params)
        for key, col in r.params.items():
            np.testing.assert_array_equal(o.params[key], col, err_msg=key)
        _assert_outputs_equal(o.outputs, r.outputs, algo)
        assert o.variant_meta == r.variant_meta


@pytest.mark.parametrize("engine,chunk_size", [("monolithic", None),
                                               ("chunked", 16)])
def test_grid_engines_match_reference(engine, chunk_size):
    import test_torch_explore as tte
    from repro.explore import DesignSpace as RefSpace
    from repro.explore import explore as ref_explore
    from repro_torch.explore import DesignSpace, explore
    algos = ["edgaze", "rhythmic"]
    grids = dict(GRID, variant=["2d_in", "2d_off"])
    ref = ref_explore(RefSpace(algos, grids), engine=engine, k=9,
                      chunk_size=chunk_size)
    ours = explore(DesignSpace(algos, grids), engine=engine, k=9,
                   chunk_size=chunk_size, device="cpu")
    assert (ours.engine, ours.dispatches, ours.chunk_size,
            ours.n_feasible, ours.backend) == (
        ref.engine, ref.dispatches, ref.chunk_size, ref.n_feasible, None)
    tte.assert_explore_equal(ours, ref)
    _assert_tables_equal(ours.sweep_results, ref.sweep_results)
    best, ref_best = ours.best_by_algorithm(), ref.best_by_algorithm()
    assert sorted(best) == sorted(ref_best) == algos
    for algo in algos:
        assert best[algo]["variant"] == ref_best[algo]["variant"]
        assert best[algo]["n_feasible"] == ref_best[algo]["n_feasible"]
        np.testing.assert_allclose(best[algo]["summary"]["metric_min"],
                                   ref_best[algo]["summary"]["metric_min"],
                                   rtol=REL)


def test_scalar_oracle_matches_reference_and_the_grid_winner():
    from repro.core.sweep import scalar_point as ref_scalar
    from repro_torch.core.sweep import _sweep_impl, scalar_point
    grids = {k: v for k, v in GRID.items()
             if k not in ("vdd_scale", "adc_bits")}
    res = _sweep_impl("edgaze", grids, device="cpu")
    best = res.best(k=1)[0]
    kwargs = {ax: float(best[ax]) for ax in
              ("cis_node", "soc_node", "sys_rows", "sys_cols", "frame_rate",
               "active_fraction_scale", "pixel_pitch_um")}
    kwargs["mem_tech"] = int(best["mem_tech"])
    ours = scalar_point("edgaze", str(best["variant"]), **kwargs)
    assert ours == ref_scalar("edgaze", str(best["variant"]), **kwargs)
    np.testing.assert_allclose(best["total_j"], ours["total_j"], rtol=5e-4)
    assert res.select(variant=str(best["variant"]),
                      cis_node=best["cis_node"]).sum() == len(res) // 9
    with pytest.raises(NotImplementedError, match="coefficient-hook"):
        scalar_point("edgaze", "2d_in", vdd_scale=0.9)


def test_strict_raises_like_the_reference():
    """Every shipped variant carries structural stall notes, so a strict
    grid sweep raises the reference's message; a streaming engine
    refuses ``strict`` outright."""
    from repro.explore import DesignSpace as RefSpace
    from repro.explore import explore as ref_explore
    from repro_torch.explore import DesignSpace, explore
    for algo, grids in (("edgaze", {"variant": ["3d_in"]}),
                        ("rhythmic", {"frame_rate": [30.0, 30000.0]})):
        with pytest.raises(ValueError) as ref_err:
            ref_explore(RefSpace([algo], grids), k=1, strict=True)
        with pytest.raises(ValueError) as err:
            explore(DesignSpace([algo], grids), k=1, strict=True,
                    device="cpu")
        assert str(err.value) == str(ref_err.value)
        assert "pipeline stalls" in str(err.value)
    for engine in ("fused", "staged"):
        with pytest.raises(ValueError, match="strict=True requires a grid"):
            explore(DesignSpace(["edgaze"], {"variant": ["3d_in"]}), k=1,
                    strict=True, engine=engine, device="cpu")


@pytest.mark.parametrize("entry", ["make_points", "grid_engine"])
def test_default_device_without_cuda_raises(monkeypatch, entry):
    from repro_torch.core.batch import make_points
    from repro_torch.core.grid import lower_variant
    from repro_torch.explore import DesignSpace, explore
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "make_points": lambda: make_points(lower_variant("edgaze",
                                                         "2d_in"), 2),
        "grid_engine": lambda: explore(
            DesignSpace(["edgaze"], {"variant": ["2d_in"]}), k=1,
            engine="monolithic"),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
