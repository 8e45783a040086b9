# Verbatim copy of src/repro/configs/zamba2_1p2b.py (jax-free).
"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 backbone + one SHARED attention block
applied every 6 mamba blocks.  For the long_500k cell the shared attention
uses a 4096 sliding window (documented in DESIGN.md §Arch-applicability).
[arXiv:2411.15242; hf]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2_1p2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=32000, ssm_state=64, ssm_conv=4, ssm_expand=2,
    ssm_version=2, ssm_heads=64, shared_attn_every=6, sliding_window=4096,
)
