# Verbatim copy of src/repro/configs/qwen3_4b.py (jax-free).
"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.

QK-norm, GQA, no QKV bias.  [hf:Qwen/Qwen3-8B; hf]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3_4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=9728, vocab=151936, qk_norm=True, rope_theta=1_000_000.0,
)
