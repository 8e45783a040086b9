# Verbatim copy of src/repro/configs/whisper_medium.py (jax-free).
"""whisper-medium [audio]: 24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.

Encoder-decoder; the conv audio frontend is a STUB (precomputed 1500-frame
embeddings).  [arXiv:2212.04356; unverified]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper_medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51865, n_encoder_layers=24, encoder_seq=1500, frontend="audio",
)
