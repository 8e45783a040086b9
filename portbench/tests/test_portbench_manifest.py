"""Every manifest entry resolves to its files, and each file holds what
the contract and the program need."""
import inspect
import json
import re

import pytest

from portbench.harness import manifest as mf
from portbench.harness import program

MAN = mf.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_manifest_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    names = [x["name"] for g in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in MAN[g]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = mf.load_cell(MAN, cell)
    drv = mf.driver(c.kind)
    for name in ("setup", "window", "release", "judge"):
        assert callable(getattr(drv, name))
    e2e = [m["name"] for m in mf.cell_metrics(MAN, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert set(e2e) <= set(drv.E2E)
    per_layer = mf.cell_metrics(MAN, cell, True)
    assert per_layer
    for m in per_layer:
        assert callable(mf.reader(m["name"]).read)
        assert m["moves"] in e2e
    assert c.limits, "a cell compares at least one number"


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    path = mf.ROOT / entry["file"]
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])
    arch = cfg["arch"]
    published = {"d_model": ("d_model", "hidden_size"),
                 "n_layers": ("n_layers", "num_hidden_layers"),
                 "n_heads": ("n_heads", "num_attention_heads")}
    for key, names in published.items():
        assert arch[key] in [cfg[n] for n in names if n in cfg]
    assert arch["d_model"] // arch["n_heads"] == arch["head_dim"] or \
        arch["family"] == "moe"


def test_configs_are_the_programs_own():
    """The files state the architectures the port's configs hold."""
    from repro_torch.configs import get_config
    for name, arch_id in (("olmo-1b", "olmo_1b"),
                          ("granite-3.0-1b-a400m", "granite_moe_1b_a400m")):
        arch = json.loads((mf.BENCH / "configs" / f"{name}.json")
                          .read_text())["arch"]
        mine = program.model_config(arch_id, arch)
        theirs = get_config(arch_id)
        for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "vocab", "non_parametric_ln", "rope_theta",
                  "n_experts", "top_k", "expert_d_ff",
                  "moe_capacity_factor", "dtype", "remat_policy"):
            assert getattr(mine, f) == getattr(theirs, f), (name, f)
        program.check_layout(mine, arch)


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_adamw_is_the_steps(cell):
    """The optimizer settings a training mix states, which the reference
    takes, are the ones the program's step runs with; set-up refuses a
    mix that differs."""
    c = mf.load_cell(MAN, cell)
    if c.kind != "train":
        pytest.skip("no optimizer in this cell")
    from repro_torch.optim.adamw import adamw_update
    params = inspect.signature(adamw_update).parameters
    stated = c.traffic["adamw"]
    assert {k: params[k].default for k in stated} == stated
    program.check_adamw(stated)
    with pytest.raises(ValueError, match="AdamW"):
        program.check_adamw(dict(stated, eps=1e-5))


def test_layers_named_in_perf_md():
    text = (mf.ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in MAN["per_layer"]}:
        assert f"`{layer}`" in text, layer
