"""The operations a decoder-only model's work needs, counted from its
shapes: what a step or a call must compute, whatever computes it.
Recomputation (rematerialisation), capacity padding and the masked half
of causal attention are not counted.  Every counted operation is a
matrix product: with a weight, or attention's ``Q K^T`` and ``P V``."""
from __future__ import annotations

from typing import Dict


def matmul_params(arch: Dict) -> int:
    """Weights a token passes through outside the embedding: the
    attention projections and the feed-forward layer (for an MoE, the
    router and the ``top_k`` experts it takes)."""
    d, L = arch["d_model"], arch["n_layers"]
    H, KV, D = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    attn = d * H * D + 2 * d * KV * D + H * D * d
    if arch["family"] == "moe":
        ffn = arch["top_k"] * 3 * d * arch["expert_d_ff"] \
            + d * arch["n_experts"]
    else:
        ffn = 3 * d * arch["d_ff"]
    return L * (attn + ffn)


def causal_pairs(seq: int) -> int:
    """(query, key) pairs a causal sequence of ``seq`` tokens scores."""
    return seq * (seq + 1) // 2


def attention_flops(arch: Dict, batch: int, seq: int) -> int:
    """Forward ``Q K^T`` and ``P V``: 4 * head_dim a pair, a head, a
    layer."""
    return 4 * arch["head_dim"] * arch["n_heads"] * arch["n_layers"] \
        * batch * causal_pairs(seq)


def train_step_flops(arch: Dict, batch: int, seq: int) -> int:
    """6 N T (forward and backward of every weight, the tied output head
    included) plus three times the forward attention."""
    n = matmul_params(arch) + arch["vocab"] * arch["d_model"]
    return 6 * n * batch * seq + 3 * attention_flops(arch, batch, seq)


def prefill_flops(arch: Dict, batch: int, seq: int) -> int:
    """2 N T over the prompt, the output head at the last position only,
    and the forward attention."""
    return 2 * matmul_params(arch) * batch * seq \
        + 2 * arch["vocab"] * arch["d_model"] * batch \
        + attention_flops(arch, batch, seq)
