# Verbatim copy of src/repro/configs/__init__.py (jax-free).
"""Assigned architecture configs (one module per arch) + registry."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from ..models.config import ModelConfig

ARCH_IDS: List[str] = [
    "llava_next_34b", "whisper_medium", "olmo_1b", "qwen2_5_32b", "qwen2_7b",
    "qwen3_4b", "falcon_mamba_7b", "granite_moe_1b_a400m", "mixtral_8x7b",
    "zamba2_1p2b",
]

#: CLI aliases (--arch accepts either form)
ALIASES = {
    "llava-next-34b": "llava_next_34b",
    "whisper-medium": "whisper_medium",
    "olmo-1b": "olmo_1b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen2-7b": "qwen2_7b",
    "qwen3-4b": "qwen3_4b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "mixtral-8x7b": "mixtral_8x7b",
    "zamba2-1.2b": "zamba2_1p2b",
}


def get_config(arch_id: str) -> ModelConfig:
    arch_id = ALIASES.get(arch_id, arch_id)
    mod = importlib.import_module(f".{arch_id}", __package__)
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def reduced(cfg: ModelConfig, n_layers: int = 2, d_model: int = 64,
            vocab: int = 128) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    scale = d_model / cfg.d_model
    heads = max(min(cfg.n_heads, 4), 1) if cfg.n_heads else 0
    kv = max(min(cfg.n_kv_heads, heads), 1) if cfg.n_kv_heads else 0
    upd = dict(
        n_layers=n_layers, d_model=d_model, vocab=vocab,
        n_heads=heads, n_kv_heads=kv, d_head=16 if heads else 0,
        d_ff=4 * d_model if cfg.d_ff else 0,
        expert_d_ff=d_model if cfg.expert_d_ff else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        ssm_heads=max(min(cfg.ssm_heads, 4), 1) if cfg.ssm_heads else 0,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        shared_attn_every=min(cfg.shared_attn_every, 2)
        if cfg.shared_attn_every else 0,
        n_encoder_layers=min(cfg.n_encoder_layers, 2)
        if cfg.n_encoder_layers else 0,
        encoder_seq=min(cfg.encoder_seq, 16) if cfg.encoder_seq else 0,
        attn_q_chunk=32,
        dtype="float32",
    )
    return dataclasses.replace(cfg, **upd)
