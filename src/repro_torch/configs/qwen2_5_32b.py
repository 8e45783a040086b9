# Verbatim copy of src/repro/configs/qwen2_5_32b.py (jax-free).
"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.

GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2_5_32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=27648, vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
)
