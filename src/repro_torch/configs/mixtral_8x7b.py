# Verbatim copy of src/repro/configs/mixtral_8x7b.py (jax-free).
"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088; hf]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mixtral_8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=32000, n_experts=8, top_k=2, expert_d_ff=14336,
    sliding_window=4096, rope_theta=1_000_000.0,
)
