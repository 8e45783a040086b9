"""The last line's keys, as the driver reads them, from a run driven on
the CPU at a tiny size (the look for a card skipped)."""
import json
import time

import pytest
import torch

from portbench.harness import manifest as mf
from portbench.run import run_cell
from portbench.tests import tiny

MAN = mf.load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_result_line(name):
    cell = tiny.cell(name)
    res, rows = run_cell(MAN, cell, 99, 0.05, False, torch.device("cpu"),
                         time.perf_counter())
    line = json.loads(json.dumps(res))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 1 and line["failed"] == 0
    want = {m["name"]: m["unit"] for m in mf.cell_metrics(MAN, name, False)}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == set(cell.limits)
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    assert [r[0] for r in rows] == sorted(cell.limits)
