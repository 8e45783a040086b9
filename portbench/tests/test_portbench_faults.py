"""``correct`` comes out false for each fault a cell can have, planted
under the timed path with the rest of a run driven as on the chip (the
look for a card skipped), and for the control; and true for a sound
run.  Tiny sizes, float32 on both sides, the cells' own limits."""
import time

import pytest
import torch

from portbench import faults
from portbench.harness import compare
from portbench.harness import manifest as mf
from portbench.reference.lowp import fp8
from portbench.run import run_cell
from portbench.tests import tiny

MAN = mf.load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
SEED = 2**31 + 777
CPU = torch.device("cpu")


def _kind(name):
    return mf.load_cell(MAN, name).kind


def _run(cell):
    res, _ = run_cell(MAN, cell, SEED, 0.05, False, CPU,
                      time.perf_counter())
    return res


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS
                                        for f in faults.FAULTS[_kind(c)]])
def test_fault_is_not_correct(name, fault):
    cell = tiny.cell(name)
    with faults.planted(cell.kind, fault):
        res = _run(cell)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(tiny.cell(name))
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference in float8 in the program's place fails a limit."""
    cell = tiny.cell(name)
    drv = mf.driver(cell.kind)
    st = drv.setup(cell, SEED, CPU)
    drv.window(st, 0.05, False)
    drv.release(st)
    ok, rows = compare.judge(drv.judge(st, cast=fp8), cell.limits)
    assert not ok, rows
