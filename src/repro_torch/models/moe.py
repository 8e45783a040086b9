"""Mixture-of-Experts FFN with capacity-buffer dispatch.

Torch counterpart of ``src/repro/models/moe.py``: tokens are
counting-sorted into per-expert capacity buffers (a prefix sum of the
one-hot routing in token-major ``[T*K]`` order ranks each token within
its expert), each expert runs a dense FFN over its buffer, and results
are gathered back with the router weights.  Tokens past an expert's
capacity ``C`` are dropped: zeroed and added at slot ``C - 1``, as the
reference's scatter-add does (a slot takes one token and zeros, so the
order of the adds cannot change it).  Everything stays on the device;
nothing is read on the host.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..distributed.ops import gather_rows, index_add_rows
from ..distributed.shardctx import axis_size, constrain
from .common import silu
from .config import ModelConfig


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: largest first, ties to the lower
    index (a stable descending sort; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(T: int, cfg: ModelConfig) -> int:
    """Slots an expert: ``max(int(T*K*cf/E + 0.999), 1)`` for ``T``
    tokens (decode has ``T = B``, so its capacity is not prefill's)."""
    return max(int(T * cfg.top_k * cfg.moe_capacity_factor
                   / cfg.n_experts + 0.999), 1)


def route(w: Dict, xt: torch.Tensor, cfg: ModelConfig):
    """Router and counting-sort dispatch of ``xt`` [T,D]: (probs [T,E]
    f32, renormalised gates [T,K], expert ids [T,K], slot [T*K] int64,
    keep [T*K]).  A token's slot is its rank among the earlier
    token-major ``[T*K]`` entries of its expert; one past the capacity
    is dropped (``keep`` false) and parked at slot ``C - 1``."""
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(xt.shape[0], cfg)
    logits = torch.einsum("td,de->te", xt, w["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, K)                   # [T,K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)             # renormalize
    flat_expert = expert_idx.reshape(-1)                      # [T*K]
    onehot = F.one_hot(flat_expert, E).to(torch.int32)        # [T*K,E]
    csum = torch.cumsum(onehot, dim=0, dtype=torch.int32)
    slot = torch.sum((csum - onehot) * onehot, dim=-1)        # rank per expert
    keep = slot < C
    return probs, gate_vals, expert_idx, \
        torch.where(keep, slot, C - 1), keep


def moe_ffn(w: Dict, x: torch.Tensor,
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """x: [B,S,D] -> (y [B,S,D], metrics)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    C = capacity(T, cfg)
    xt = x.reshape(T, D)
    probs, gate_vals, expert_idx, slot, keep = route(w, xt, cfg)
    flat_expert = expert_idx.reshape(-1)                      # [T*K]

    # ---- scatter tokens into expert buffers ---------------------------
    src = xt[:, None].expand(T, K, D).reshape(T * K, D)       # [T*K,D]
    src = torch.where(keep[:, None], src, 0.0)
    buffers = index_add_rows(E * C, flat_expert * C + slot, src).view(E, C, D)
    # EP when the expert count divides TP (granite: 32/16); otherwise TP
    # inside the expert matmuls (mixtral: 8 experts on 16-way model axis)
    ep = E % max(axis_size("model"), 1) == 0
    buffers = constrain(buffers, "model" if ep else None, None,
                        None if ep else "model")

    # ---- expert FFN (silu gate) ----------------------------------------
    h = torch.einsum("ecd,edf->ecf", buffers, w["we_gate"])
    u = torch.einsum("ecd,edf->ecf", buffers, w["we_up"])
    h = silu(h.float()).to(x.dtype) * u
    h = constrain(h, "model" if ep else None, None, None if ep else "model")
    out = torch.einsum("ecf,efd->ecd", h, w["we_down"])

    # ---- gather back + weighted combine --------------------------------
    gathered = gather_rows(out, flat_expert, slot)               # [T*K,D]
    gathered = torch.where(keep[:, None], gathered, 0.0)
    y = (gathered.reshape(T, K, D)
         * gate_vals.to(x.dtype)[..., None]).sum(dim=1)

    # ---- router aux (load-balancing) loss ------------------------------
    density = torch.mean(F.one_hot(expert_idx, E).float(),
                         dim=(0, 1))                          # fraction routed
    prob_mass = torch.mean(probs, dim=0)
    aux_loss = E * torch.sum(density * prob_mass)
    dropped = 1.0 - torch.mean(keep.float())
    return y.reshape(B, S, D), {"moe_aux_loss": aux_loss,
                                "moe_drop_fraction": dropped}
