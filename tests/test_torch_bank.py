"""The port's registries, PlanBank and axis tables equal the reference's.

The axis registry must match field for field, and the fused ``(V, W)``
bank and the ``(n_axes, V * Lmax)`` axis table the megakernel reads must
be BIT-equal to the reference's (NaN sentinels included) for Ed-Gaze,
Rhythmic, both together, and the toy pipeline registered at runtime
through each package's ``register_algorithm``.
"""
import numpy as np
import pytest
import torch

import repro.core.axes as raxes
import repro_torch.core.axes as taxes

GRIDS = {"cis_node": [130.0, 65.0, 28.0],
         "frame_rate": [15.0, 30.0],
         "mem_tech": ["sram", "stt", "declared"],
         "vdd_scale": [0.9, 1.0],
         "adc_bits": [-1.0, 8.0]}


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.fixture
def toy_in_both():
    from repro.core.algorithms import (register_algorithm as rreg,
                                       unregister_algorithm as runreg)
    from repro.core.usecases.toy import TOY_VARIANTS, build_toy
    from repro_torch.core.algorithms import (register_algorithm as treg,
                                             unregister_algorithm as tunreg)
    from repro_torch.core.usecases.toy import (TOY_VARIANTS as TV,
                                               build_toy as tbuild)
    rreg("toy", build_toy, TOY_VARIANTS, overwrite=True)
    treg("toy", tbuild, TV, overwrite=True)
    try:
        yield "toy"
    finally:
        runreg("toy")
        tunreg("toy")


def test_axes_spec_matches_reference():
    assert taxes.AXES == raxes.AXES
    for ours, ref in zip((taxes.VARIANT_AXIS,) + taxes.AXES_SPEC,
                         (raxes.VARIANT_AXIS,) + raxes.AXES_SPEC):
        assert (ours.name, ours.kind, ours.doc, ours.default, ours.integer,
                ours.coeff_cols) == (ref.name, ref.kind, ref.doc,
                                     ref.default, ref.integer,
                                     ref.coeff_cols)
        assert (ours.encode is None) == (ref.encode is None)
        assert sorted(ours.coeff_hook or {}) == sorted(ref.coeff_hook or {})
    assert (taxes.TECH_DECLARED, taxes.ADC_DECLARED) \
        == (raxes.TECH_DECLARED, raxes.ADC_DECLARED)
    for v in ("sram", "sram_hp", "stt", "declared", None, -1, 2):
        assert taxes.encode_axis_value("mem_tech", v) \
            == raxes.encode_axis_value("mem_tech", v)


def test_coefficient_hooks_match_reference():
    rng = np.random.default_rng(3)
    vdd = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    adc = rng.choice([-1.0, 1.0, 4.0, 8.0, 12.0], 64).astype(np.float32)
    ref_bits = rng.choice([1.0, 8.0, 10.0], 64).astype(np.float32)
    for name in ("vdd_dynamic_scale", "vdd_static_scale"):
        ours = getattr(taxes, name)(torch.from_numpy(vdd)).numpy()
        ref = np.asarray(getattr(raxes, name)(vdd))
        np.testing.assert_array_equal(ours, ref)
    ours = taxes.adc_fom_mod(torch.from_numpy(adc),
                             torch.from_numpy(ref_bits)).numpy()
    ref = np.asarray(raxes.adc_fom_mod(adc, ref_bits))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)


def test_bank_layout_matches_reference():
    from repro.core.plan_bank import BankDims as RD, bank_layout as rlayout
    from repro_torch.core.plan_bank import (LAYOUT_FIELDS, BankDims,
                                            bank_layout)
    for dims in ((5, 2, 0, 1, 4, 3), (1, 3, 2, 1, 3, 2), (8, 2, 0, 1, 4, 3)):
        ours, ref = bank_layout(BankDims(*dims)), rlayout(RD(*dims))
        assert ours == ref
        assert LAYOUT_FIELDS == tuple(k for k in ref if k != "__width__")


@pytest.mark.parametrize("algos", [["edgaze"], ["rhythmic"],
                                   ["edgaze", "rhythmic"], ["toy"],
                                   ["edgaze", "toy"]])
def test_bank_and_axis_table_bit_equal(algos, toy_in_both):
    from repro.core.shard_sweep import _prepare_stream as rprep
    from repro_torch.core.shard_sweep import _prepare_stream as tprep
    ref = rprep(algos, GRIDS)
    ours = tprep(algos, GRIDS, device="cpu")
    assert tuple(ours.bank.dims) == tuple(ref.bank.dims)
    assert ours.labels == ref.labels and ours.n_var == ref.n_var
    assert ours.lmax == ref.lmax
    np.testing.assert_array_equal(_bits(ours.bank.fused.numpy()),
                                  _bits(ref.bank.arrays["fused"]))
    np.testing.assert_array_equal(_bits(ours.table2.numpy()),
                                  _bits(ref.table2))
    np.testing.assert_array_equal(ours.tables, np.asarray(ref.tables))


def test_bank_from_reference_round_trips():
    from repro.core.plan_bank import build_plan_bank as rbuild
    from repro.core.sweep import lower_variant as rlower
    from repro_torch.core.grid import lower_variant
    from repro_torch.core.plan_bank import (bank_from_reference,
                                            build_plan_bank)
    variants = ("2d_in", "3d_in", "2d_off")
    ref = rbuild([rlower("edgaze", v) for v in variants])
    carried = bank_from_reference(
        {"fused": np.asarray(ref.arrays["fused"])}, ref.dims, device="cpu")
    ours = build_plan_bank([lower_variant("edgaze", v) for v in variants],
                           device="cpu")
    assert carried.dims == ours.dims
    np.testing.assert_array_equal(_bits(carried.fused.numpy()),
                                  _bits(ours.fused.numpy()))
    again = bank_from_reference({"fused": carried.fused.numpy()},
                                carried.dims, device="cpu")
    np.testing.assert_array_equal(_bits(again.fused.numpy()),
                                  _bits(carried.fused.numpy()))
    with pytest.raises(ValueError, match="lay out"):
        bank_from_reference({"fused": np.zeros((3, 7), np.float32)},
                            ref.dims, device="cpu")
