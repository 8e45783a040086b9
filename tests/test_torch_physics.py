"""The port's coefficient-form Eq. 1-17 physics matches the reference.

``repro_torch.core.batch.build_coeff_compute`` against the reference's
``build_coeff_compute(dims, exact=True)`` on the SAME bank rows (carried
across with ``bank_from_reference``): every ``OUT_KEYS`` entry at rel
1e-6 (the reference's own parity tolerance) and ``feasible`` exactly.
The points cover off-default ``vdd_scale`` and ``adc_bits``, every
``mem_tech`` code and infeasible frame rates.  No shipped variant set
has linear analog terms or branching DAGs, so a synthetic row
(``repro_torch.testing.synthetic_bank``: ``L=2`` with a duplicate
scatter target, ``D=3`` with DAG edges) covers those branches.
"""
import numpy as np
import pytest
import torch

REL = 1e-6


def _points(n: int, seed: int):
    rng = np.random.default_rng(seed)
    pts = dict(
        cis_node=rng.choice([250.0, 130.0, 65.0, 45.0, 28.0, 16.0, 5.0], n),
        soc_node=rng.choice([14.0, 22.0, 28.0], n),
        mem_tech=rng.choice([-1.0, 0.0, 1.0, 2.0], n),
        sys_rows=rng.choice([4.0, 16.0, 64.0, 128.0], n),
        sys_cols=rng.choice([8.0, 32.0], n),
        frame_rate=rng.choice([15.0, 60.0, 240.0, 2000.0, 20000.0], n),
        active_fraction_scale=rng.choice([0.25, 1.0], n),
        pixel_pitch_um=rng.choice([2.0, 5.0], n),
        vdd_scale=rng.choice([0.8, 1.0, 1.3], n),
        adc_bits=rng.choice([-1.0, 1.0, 6.0, 12.0], n))
    return {k: v.astype(np.float32) for k, v in pts.items()}


def _compare(ref_dims, fused: np.ndarray, pts, *, want_infeasible=True):
    import jax
    import jax.numpy as jnp
    from repro.core.batch import build_coeff_compute as ref_compute
    from repro_torch.core.batch import OUT_KEYS, build_coeff_compute
    from repro_torch.core.plan_bank import bank_from_reference
    bank = bank_from_reference({"fused": fused}, tuple(ref_dims),
                               device="cpu")
    ours_fn = build_coeff_compute(bank.dims)
    # jitted, as the reference's fused twin runs it
    ref_fn = jax.jit(ref_compute(ref_dims, exact=True))
    tpts = {k: torch.from_numpy(v) for k, v in pts.items()}
    jpts = {k: jnp.asarray(v) for k, v in pts.items()}
    n_feasible = 0
    for vi in range(fused.shape[0]):
        ref = ref_fn(jnp.asarray(fused[vi]), jpts)
        ours = ours_fn(bank.fused[vi], tpts)
        assert sorted(ours) == sorted(ref) == sorted(OUT_KEYS)
        np.testing.assert_array_equal(ours["feasible"].numpy(),
                                      np.asarray(ref["feasible"]))
        n_feasible += int(np.asarray(ref["feasible"]).sum())
        for key in OUT_KEYS:
            np.testing.assert_allclose(
                ours[key].numpy(), np.asarray(ref[key]), rtol=REL, atol=0,
                err_msg=f"variant {vi} {key}")
    n_all = fused.shape[0] * len(pts["frame_rate"])
    assert n_feasible > 0
    if want_infeasible:
        assert n_feasible < n_all          # infeasible rates are covered


@pytest.mark.parametrize("algorithm", ["edgaze", "rhythmic"])
def test_coeff_compute_matches_reference(algorithm):
    from repro.core.algorithms import get_algorithm
    from repro.core.plan_bank import build_plan_bank
    from repro.core.sweep import lower_variant
    plans = [lower_variant(algorithm, v)
             for v in get_algorithm(algorithm).variants]
    bank = build_plan_bank(plans)
    _compare(bank.dims, np.asarray(bank.arrays["fused"]), _points(512, 5))


def test_coeff_compute_synthetic_linear_terms_and_dag():
    from repro.core.plan_bank import BankDims
    from repro_torch.testing import synthetic_bank
    dims, fused = synthetic_bank(0)
    assert dims.n_lin == 2 and dims.n_digital == 3
    _compare(BankDims(*dims), fused, _points(512, 7))


def test_synthetic_scatter_sums_duplicate_targets():
    """Both linear terms land in analog slot 1: zeroing one of them must
    change that slot's energy by exactly the other's contribution."""
    from repro_torch.core.batch import build_coeff_compute
    from repro_torch.core.plan_bank import bank_from_reference, bank_layout
    from repro_torch.testing import synthetic_bank
    dims, fused = synthetic_bank(0)
    off = bank_layout(dims)["lin_coeff"][0]
    one = fused.copy()
    one[0, off + 1] = 0.0
    pts = {k: torch.from_numpy(v) for k, v in _points(16, 2).items()}
    fn = build_coeff_compute(dims)
    both = fn(bank_from_reference({"fused": fused}, dims,
                                  device="cpu").fused[0], pts)
    single = fn(bank_from_reference({"fused": one}, dims,
                                    device="cpu").fused[0], pts)
    # slot 1 is the only COMP-A unit (synthetic weights)
    assert torch.all(both["cat_COMP-A_j"] > single["cat_COMP-A_j"])
