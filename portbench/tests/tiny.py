"""Cells of the manifest at a size a CPU test holds: the same drivers,
traffic kinds and limits, tiny widths and depth, float32 unless asked
otherwise."""
from __future__ import annotations

import copy
from typing import Dict

from portbench.harness import manifest as mf

TINY_ARCH = {"n_layers": 2, "d_model": 64, "n_heads": 4, "head_dim": 16,
             "d_ff": 128, "expert_d_ff": 32, "n_experts": 8, "top_k": 2,
             "vocab": 512, "text_vocab": 500}
TINY_TRAFFIC = {"batch": 4, "seq": 32, "cache_len": 32,
                "distinct_batches": 8}


def cell(name: str, dtype: str = "float32") -> mf.Cell:
    """The cell ``name`` (its files under ``workloads/``, ``configs/``
    and ``traffic/``) cut to the tiny size."""
    spec = mf.read_json(mf.BENCH / "workloads" / f"{name}.json")
    entry = {"name": name, **{k: spec[k] for k in ("config", "traffic",
                                                   "chips", "why")}}
    c = mf.Cell(name, entry, spec,
                mf.read_json(mf.BENCH / "configs" / f"{spec['config']}.json"),
                mf.read_json(mf.BENCH / "traffic" / f"{spec['traffic']}.json"))
    c = copy.deepcopy(c)
    arch: Dict = c.config["arch"]
    kv_ratio = arch["n_heads"] // arch["n_kv_heads"]
    for k, v in TINY_ARCH.items():
        if k in arch:
            arch[k] = v
    arch["n_kv_heads"] = arch["n_heads"] // kv_ratio
    arch["param_dtype"] = dtype
    for k, v in TINY_TRAFFIC.items():
        if k in c.traffic:
            c.traffic[k] = v
    return c
