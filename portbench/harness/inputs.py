"""Inputs made from the seed, on the device: the weights in the layout a
configuration's ``arch`` describes, and the token batches a traffic mix
asks for.  The same seed gives the same inputs; the reference gets the
same tensors (or makes them again from the same seed)."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

Layout = Dict[str, Tuple[Tuple[int, ...], str]]


def sub_seeds(seed: int, n: int):
    """``n`` independent 63-bit seeds from one seed of any size."""
    state = np.random.SeedSequence(int(seed)).generate_state(
        n, dtype=np.uint64)
    return [int(s) >> 1 for s in state]


def layout(arch: Dict) -> Layout:
    """{path: (shape, init)} of a decoder-only model, ``init`` ``normal``
    (times ``fan_in ** -0.5``, ``fan_in`` the second-last axis) or
    ``ones``.  Layers are stacked on a leading axis."""
    d, L = arch["d_model"], arch["n_layers"]
    H, KV, D = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    out: Layout = {"embed": ((arch["vocab"], d), "normal"),
                   "layers/wq": ((L, d, H * D), "normal"),
                   "layers/wk": ((L, d, KV * D), "normal"),
                   "layers/wv": ((L, d, KV * D), "normal"),
                   "layers/wo": ((L, H * D, d), "normal")}
    if arch["family"] == "moe":
        E, Fe = arch["n_experts"], arch["expert_d_ff"]
        out.update({"layers/router": ((L, d, E), "normal"),
                    "layers/we_gate": ((L, E, d, Fe), "normal"),
                    "layers/we_up": ((L, E, d, Fe), "normal"),
                    "layers/we_down": ((L, E, Fe, d), "normal")})
    elif arch["family"] == "dense":
        F = arch["d_ff"]
        out.update({"layers/w_gate": ((L, d, F), "normal"),
                    "layers/w_up": ((L, d, F), "normal"),
                    "layers/w_down": ((L, F, d), "normal")})
    else:
        raise ValueError(f"family {arch['family']!r}")
    if arch["norm_affine"]:
        out.update({"final_norm": ((d,), "ones"),
                    "layers/attn_norm": ((L, d), "ones"),
                    "layers/mlp_norm": ((L, d), "ones")})
    return dict(sorted(out.items()))


def make_weights(arch: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights in ``arch["param_dtype"]``: one normal draw of every
    ``normal`` leaf together, from a generator on ``device``."""
    dtype = getattr(torch, arch["param_dtype"])
    lay = layout(arch)
    sizes = {p: int(np.prod(s)) for p, (s, init) in lay.items()
             if init == "normal"}
    gen = torch.Generator(device=device).manual_seed(sub_seeds(seed, 2)[0])
    draw = torch.randn(sum(sizes.values()), generator=gen,
                       dtype=torch.float32, device=device)
    out, at = {}, 0
    for path, (shape, init) in lay.items():
        if init == "ones":
            out[path] = torch.ones(shape, dtype=dtype, device=device)
            continue
        n = sizes[path]
        out[path] = draw[at:at + n].view(shape).mul_(
            shape[-2] ** -0.5).to(dtype)
        at += n
    del draw
    return out


def make_tokens(arch: Dict, traffic: Dict, seed: int, device
                ) -> torch.Tensor:
    """``distinct_batches`` batches [P, B, S] of token ids below the
    text vocabulary.  ``zipf``: rank ``r`` drawn with probability about
    ``1 / r`` (natural text's word frequencies), mapped to ids by a
    random permutation of the vocabulary."""
    P, B, S = traffic["distinct_batches"], traffic["batch"], traffic["seq"]
    V = arch["text_vocab"]
    gen = torch.Generator(device=device).manual_seed(sub_seeds(seed, 2)[1])
    if traffic["tokens"] != "zipf":
        raise ValueError(f"token distribution {traffic['tokens']!r}")
    u = torch.rand((P, B, S), generator=gen, dtype=torch.float64,
                   device=device)
    rank = torch.exp(u * np.log(V)).long().sub_(1).clamp_(0, V - 1)
    perm = torch.randperm(V, generator=gen, device=device)
    return perm[rank]
