# Verbatim copy of src/repro/configs/olmo_1b.py (jax-free).
"""olmo-1b [dense]: 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304.

Non-parametric LayerNorm (no learned scale/bias).  [arXiv:2402.00838; hf]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="olmo_1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=50304, non_parametric_ln=True,
)
