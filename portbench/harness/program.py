"""The program under test, ``repro_torch``, as the cells drive it: its
model configuration built from a configuration file's ``arch``, and a
check that the weights the benchmark makes are the tree the program
takes.  Every import of the program sits inside a function."""
from __future__ import annotations

import inspect
from typing import Dict

import torch

from .inputs import layout


def model_config(name: str, arch: Dict):
    """``repro_torch``'s ``ModelConfig`` for ``arch``; raises where the
    file states something the program cannot run as stated."""
    from repro_torch.models import common
    from repro_torch.models.config import ModelConfig
    if arch["activation"] != "swiglu" or not arch["tied_embeddings"]:
        raise ValueError(f"{name}: the program runs SwiGLU with tied "
                         f"embeddings only")
    fn = {"layernorm": common.layernorm_np, "rmsnorm": common.rmsnorm}[
        arch["norm"]]
    if arch["norm_affine"] != (arch["norm"] == "rmsnorm"):
        raise ValueError(f"{name}: the program's layernorm has no scale, "
                         f"its rmsnorm has one")
    eps = inspect.signature(fn).parameters["eps"].default
    if eps != arch["norm_eps"]:
        raise ValueError(f"{name}: norm eps {arch['norm_eps']} stated, the "
                         f"program's is {eps}")
    kw = dict(arch_id=name, family=arch["family"],
              n_layers=arch["n_layers"], d_model=arch["d_model"],
              n_heads=arch["n_heads"], n_kv_heads=arch["n_kv_heads"],
              d_head=arch["head_dim"], vocab=arch["vocab"],
              non_parametric_ln=arch["norm"] == "layernorm",
              rope_theta=float(arch["rope_theta"]),
              dtype=arch["param_dtype"], remat_policy=arch["remat"])
    if arch["family"] == "moe":
        kw.update(d_ff=arch["expert_d_ff"], n_experts=arch["n_experts"],
                  top_k=arch["top_k"], expert_d_ff=arch["expert_d_ff"],
                  moe_capacity_factor=arch["capacity_factor"])
    else:
        kw.update(d_ff=arch["d_ff"])
    return ModelConfig(**kw)


def check_adamw(stated: Dict) -> None:
    """Raises where a training mix's optimizer settings, which the
    reference takes, are not those the program's step runs with: its
    ``adamw_update``'s own, which ``train_step`` does not override."""
    from repro_torch.optim.adamw import adamw_update
    params = inspect.signature(adamw_update).parameters
    own = {k: params[k].default for k in ("b1", "b2", "eps",
                                          "weight_decay", "max_grad_norm")}
    if stated != own:
        raise ValueError(f"the mix states AdamW {stated}; the program's "
                         f"step runs with {own}")


def check_layout(cfg, arch: Dict) -> None:
    """The program's parameter tree has the benchmark's paths, shapes
    and dtype."""
    from repro_torch.models import model as M
    want = {p: (tuple(s), getattr(torch, arch["param_dtype"]))
            for p, (s, _) in layout(arch).items()}
    got = {p: (tuple(s), d) for p, (s, d) in M.param_shapes(cfg).items()}
    if got != want:
        raise ValueError(f"{cfg.arch_id}: the program's parameters "
                         f"{sorted(set(got) ^ set(want)) or got} differ "
                         f"from the benchmark's layout")


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """``{"a/b": t}`` -> ``{"a": {"b": t}}``, the tree the program takes
    (the same tensors)."""
    tree: Dict = {}
    for path, leaf in flat.items():
        node = tree
        *head, last = path.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def flat(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The inverse of :func:`nest`, keys sorted at every level."""
    out: Dict[str, torch.Tensor] = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out
