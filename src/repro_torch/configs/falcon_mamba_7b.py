# Verbatim copy of src/repro/configs/falcon_mamba_7b.py (jax-free).
"""falcon-mamba-7b [ssm]: 64L d_model=4096 attn-free vocab=65024 state=16.

Mamba-1 architecture (selective SSM, depthwise conv, no attention).
[arXiv:2410.05355; unverified]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="falcon_mamba_7b", family="ssm",
    n_layers=64, d_model=4096, d_ff=0, vocab=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_version=1,
)
