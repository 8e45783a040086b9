"""P14: the nine validation chips (Tbl. 2 / Fig. 7) and the paper's three
findings (Sec. 6) on the port.

* ``repro_torch.core.chips.validate_all()`` mirrors
  ``tests/test_checks_and_validation.py``'s gate (9 rows, MAPE < 15%,
  Pearson > 0.995, every row's error < 30%, non-negative breakdowns) and
  equals the reference's result exactly: the chips are verbatim copies
  running the same Python on the same floats;
* the three findings hold on ``repro_torch.core.usecases.run_study``
  (``device="cpu"``: the grid engine's torch twins);
* ``run_study`` equals the reference's row for row: exactly on the
  scalar engine (the same Python walk), and at the parity chain's rel
  1e-6 on the batched one, whose f32 evaluators (torch against XLA) part
  in the last ulp of a few category sums.
"""
import numpy as np
import pytest

from repro_torch.core.chips import chip_ids, validate_all
from repro_torch.core.usecases import run_study
from repro_torch.core.usecases.study import find_row


# ---------------------------------------------------------------------------
# nine-chip validation
# ---------------------------------------------------------------------------
def test_validation_mape_and_pearson():
    r = validate_all()
    assert len(r["rows"]) == 9
    assert r["mape"] < 0.15, f"MAPE {r['mape']:.3f} exceeds 15%"
    assert r["pearson"] > 0.995
    for row in r["rows"]:
        assert row["error"] < 0.30, (row["chip"], row["error"])


def test_all_chips_have_positive_breakdowns():
    r = validate_all()
    for row in r["rows"]:
        assert all(v >= 0 for v in row["breakdown"].values()), row["chip"]
        assert row["estimated_pj"] > 0


def test_validate_all_equals_reference_exactly():
    import repro.core.chips as ref
    assert chip_ids() == ref.chip_ids()
    ours, want = validate_all(), ref.validate_all()
    assert ours["mape"] == want["mape"]
    assert ours["pearson"] == want["pearson"]
    assert len(ours["rows"]) == len(want["rows"]) == 9
    for a, b in zip(ours["rows"], want["rows"]):
        assert a == b, a["chip"]


# ---------------------------------------------------------------------------
# the paper's three findings on the port's run_study
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rhythmic_rows():
    return run_study("rhythmic", device="cpu")


@pytest.fixture(scope="module")
def edgaze_rows():
    return run_study("edgaze", device="cpu")


def test_finding1_rhythmic_in_beats_off(rhythmic_rows):
    """Communication-dominant: in-sensor wins, more at finer CIS nodes."""
    for node in (130, 65):
        r_in = find_row(rhythmic_rows, "2d_in", node)
        r_off = find_row(rhythmic_rows, "2d_off", node)
        assert r_in["total_uj"] < r_off["total_uj"], node
    save130 = 1 - find_row(rhythmic_rows, "2d_in", 130)["total_uj"] / \
        find_row(rhythmic_rows, "2d_off", 130)["total_uj"]
    save65 = 1 - find_row(rhythmic_rows, "2d_in", 65)["total_uj"] / \
        find_row(rhythmic_rows, "2d_off", 65)["total_uj"]
    assert save65 > save130


def test_finding1_edgaze_in_loses_to_off(edgaze_rows):
    """Compute-dominant: in-sensor processing costs more than off."""
    for node in (130, 65):
        assert find_row(edgaze_rows, "2d_in", node)["total_uj"] > \
            find_row(edgaze_rows, "2d_off", node)["total_uj"]


def test_edgaze_65nm_leakage_flip(edgaze_rows):
    """65 nm 2D-In > 130 nm 2D-In because of SRAM leakage (Sec. 6.1)."""
    assert find_row(edgaze_rows, "2d_in", 65)["total_uj"] > \
        find_row(edgaze_rows, "2d_in", 130)["total_uj"]


def test_finding2_3d_beats_2d_in(edgaze_rows, rhythmic_rows):
    for rows in (edgaze_rows, rhythmic_rows):
        for node in (130, 65):
            assert find_row(rows, "3d_in", node)["total_uj"] < \
                find_row(rows, "2d_in", node)["total_uj"], node


def test_finding2_stt_reduces_3d(edgaze_rows):
    for node in (130, 65):
        assert find_row(edgaze_rows, "3d_in_stt", node)["total_uj"] < \
            find_row(edgaze_rows, "3d_in", node)["total_uj"]


def test_finding2_power_density(edgaze_rows):
    """Stacking raises power density vs 2D off-loading; 65 nm 2D-In is the
    leakage-driven outlier (Tbl. 3 pattern)."""
    off = find_row(edgaze_rows, "2d_off", 130)
    tdi = find_row(edgaze_rows, "3d_in", 130)
    assert tdi["density_mw_mm2"] > off["density_mw_mm2"]
    in65 = find_row(edgaze_rows, "2d_in", 65)
    assert in65["density_mw_mm2"] > tdi["density_mw_mm2"]


def test_finding3_mixed_signal_saves(edgaze_rows):
    """Analog S1/S2 cuts total energy, mostly via memory (Figs 11-13)."""
    for node in (130, 65):
        mixed = find_row(edgaze_rows, "2d_in_mixed", node)
        digital = find_row(edgaze_rows, "2d_in", node)
        assert mixed["total_uj"] < digital["total_uj"], node
        mem_saving = digital["breakdown_uj"].get("MEM-D", 0) - \
            mixed["breakdown_uj"].get("MEM-D", 0)
        total_saving = digital["total_uj"] - mixed["total_uj"]
        assert mem_saving > 0.5 * total_saving, node
    s65 = 1 - find_row(edgaze_rows, "2d_in_mixed", 65)["total_uj"] / \
        find_row(edgaze_rows, "2d_in", 65)["total_uj"]
    s130 = 1 - find_row(edgaze_rows, "2d_in_mixed", 130)["total_uj"] / \
        find_row(edgaze_rows, "2d_in", 130)["total_uj"]
    assert s65 > s130


# ---------------------------------------------------------------------------
# run_study against the reference's, row for row
# ---------------------------------------------------------------------------
def _rows_close(ours, want, rel):
    assert len(ours) == len(want)
    for a, b in zip(ours, want):
        assert a.keys() == b.keys()
        for key, val in b.items():
            if isinstance(val, dict):
                assert a[key].keys() == val.keys(), (b["variant"], key)
                for cat, x in val.items():
                    np.testing.assert_allclose(a[key][cat], x, rtol=rel,
                                               err_msg=f"{key}.{cat}")
            elif isinstance(val, float):
                np.testing.assert_allclose(a[key], val, rtol=rel,
                                           err_msg=key)
            else:
                assert a[key] == val, (key, a[key], val)


@pytest.mark.parametrize("algorithm", ["rhythmic", "edgaze"])
def test_run_study_scalar_equals_reference_exactly(algorithm):
    from repro.core.usecases import run_study as ref_run_study
    assert run_study(algorithm, engine="scalar") \
        == ref_run_study(algorithm, engine="scalar")


@pytest.mark.parametrize("algorithm", ["rhythmic", "edgaze"])
def test_run_study_batched_matches_reference(algorithm, rhythmic_rows,
                                             edgaze_rows):
    from repro.core.usecases import run_study as ref_run_study
    ours = {"rhythmic": rhythmic_rows, "edgaze": edgaze_rows}[algorithm]
    _rows_close(ours, ref_run_study(algorithm), 1e-6)


def test_run_study_default_device_without_cuda_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_study("rhythmic")
