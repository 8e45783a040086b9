# Verbatim copy of src/repro/configs/qwen2_7b.py (jax-free).
"""qwen2-7b [dense]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

GQA with QKV bias.  [arXiv:2407.10671; hf]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2_7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_head=128,
    d_ff=18944, vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
)
