# Verbatim copy of src/repro/configs/llava_next_34b.py (jax-free).
"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Anyres-tiled vision frontend is a STUB: input_specs() supplies precomputed
patch embeddings to the transformer backbone.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava_next_34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=20480, vocab=64000, rope_theta=5_000_000.0, frontend="vision",
)
