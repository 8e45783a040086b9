"""``repro_torch.core`` exports the reference's names
(``repro/core/__init__.py``), and ``evaluate_bank`` agrees with the
reference's.

* ``__all__`` holds the reference's names; each resolves to the port's
  object (``evaluate_batch_sharded`` too, the batch split over a
  ``BatchMesh``), or, for the deprecated ``sweep`` / ``sweep_stream``
  shims left out on purpose, to a function that raises
  ``NotImplementedError`` naming what stands in its place.  The eager names are the copied model layer's own objects;
  the lazy ones resolve through the reference's ``__getattr__``.
* ``from repro_torch.core import *`` in a fresh interpreter loads no
  ``jax*`` and no ``repro`` module.
* ``evaluate_bank(bank, variant_ids, points)`` returns host numpy arrays
  equal at rel 1e-6 to the reference's, per variant and with mixed
  variant ids, on the reference test's bank and points
  (``tests/test_grid_decode.py:140-165``).
"""
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as core

SRC = Path(__file__).resolve().parents[1] / "src"
UNPORTED = {"sweep": r"deprecated sweep\(\) shim \(ROADMAP",
            "sweep_stream": r"deprecated sweep_stream\(\) shim \(ROADMAP"}
_VARIANTS = ("2d_in", "3d_in", "2d_in_mixed")   # differing unit counts


def test_all_matches_the_reference():
    assert sorted(core.__all__) == sorted(ref_core.__all__)
    assert sorted(core._LAZY_EXPORTS) == sorted(ref_core._LAZY_EXPORTS)


@pytest.mark.parametrize("name", sorted(ref_core.__all__))
def test_every_reference_name_resolves(name):
    obj = getattr(core, name)
    if name in UNPORTED:
        # `sweep` is also the name of a submodule: once that is imported
        # the package attribute is the module, in the reference as here
        fn = getattr(importlib.import_module(
            core._LAZY_EXPORTS[name], "repro_torch.core"), name)
        with pytest.raises(NotImplementedError, match=UNPORTED[name]):
            fn()
        return
    target = core._LAZY_EXPORTS.get(name)
    if target is not None:
        mod = importlib.import_module(target, "repro_torch.core")
        assert obj is getattr(mod, name)
    ref = getattr(ref_core, name)
    assert callable(obj) == callable(ref)
    assert isinstance(obj, type) == isinstance(ref, type)
    if callable(obj):
        assert obj.__module__.startswith("repro_torch.core."), obj
    else:
        assert obj == ref, name       # constants of the copied layer


def test_unknown_name_raises_attribute_error():
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        core.nope  # noqa: B018


def test_star_import_loads_no_jax_and_no_repro():
    child = ("import sys\nfrom repro_torch.core import *\n"
             "assert estimate_energy and evaluate_bank and PlanBank\n"
             "bad = sorted(m for m in sys.modules if m.startswith('jax') "
             "or m == 'repro' or m.startswith('repro.'))\n"
             "print('LOADED', bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", child],
                          env=dict(os.environ, PYTHONPATH=str(SRC)),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def _banks_and_points(n=64):
    from repro.core.batch import make_points as ref_points
    from repro.core.plan_bank import build_plan_bank as ref_bank
    from repro.core.sweep import lower_variant as ref_lower
    from repro_torch.core import build_plan_bank, make_points
    from repro_torch.core.grid import lower_variant
    rng = np.random.default_rng(7)
    axes = dict(cis_node=rng.choice([130.0, 65.0, 28.0], n),
                soc_node=rng.choice([14.0, 22.0], n),
                mem_tech=rng.choice([-1, 0, 1, 2], n),
                sys_rows=rng.choice([4.0, 16.0, 64.0], n),
                frame_rate=rng.choice([15.0, 60.0, 240.0], n),
                active_fraction_scale=rng.choice([0.25, 1.0], n),
                pixel_pitch_um=rng.choice([2.0, 5.0], n))
    ref_plans = [ref_lower("edgaze", v) for v in _VARIANTS]
    plans = [lower_variant("edgaze", v) for v in _VARIANTS]
    return ((ref_bank(ref_plans), ref_points(ref_plans[0], n, **axes)),
            (build_plan_bank(plans, device="cpu"),
             make_points(plans[0], n, device="cpu", **axes)))


def _assert_rel(got, want, what):
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        assert isinstance(got[key], np.ndarray), key
        np.testing.assert_allclose(got[key], ref, rtol=1e-6, atol=0,
                                   err_msg=(what, key))


@pytest.mark.parametrize("vi", range(len(_VARIANTS)))
def test_evaluate_bank_per_variant_matches_reference(vi):
    from repro.core.plan_bank import evaluate_bank as ref_evaluate_bank
    from repro_torch.core import evaluate_bank
    (rbank, rpts), (bank, pts) = _banks_and_points()
    ids = np.full(pts.batch, vi, np.int32)
    _assert_rel(evaluate_bank(bank, ids, pts),
                ref_evaluate_bank(rbank, ids, rpts), _VARIANTS[vi])


def test_evaluate_bank_mixed_variant_ids_matches_reference():
    from repro.core.plan_bank import evaluate_bank as ref_evaluate_bank
    from repro_torch.core import evaluate_bank
    (rbank, rpts), (bank, pts) = _banks_and_points()
    vid = np.random.default_rng(11).integers(
        0, len(_VARIANTS), pts.batch).astype(np.int32)
    _assert_rel(evaluate_bank(bank, vid, pts),
                ref_evaluate_bank(rbank, vid, rpts), "mixed")
