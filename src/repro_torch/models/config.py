# Verbatim copy of src/repro/models/config.py (jax-free).
"""Model configuration for the assigned architecture pool."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 32000
    d_head: int = 0                  # 0 => d_model // n_heads

    # flavour flags
    qkv_bias: bool = False           # qwen2/2.5
    qk_norm: bool = False            # qwen3
    non_parametric_ln: bool = False  # olmo
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 = full attention (mixtral: 4096)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0

    # SSM (mamba1/mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_version: int = 1             # 1 = mamba1 (falcon), 2 = mamba2 (zamba2)
    ssm_heads: int = 0               # mamba2 scalar-decay heads

    # hybrid (zamba2): one *shared* attention block applied every N blocks
    shared_attn_every: int = 0

    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 0             # stub frame count (1500 for whisper)

    # modality frontend stub: none | vision | audio
    frontend: str = "none"

    # training/serving defaults
    dtype: str = "bfloat16"
    attn_q_chunk: int = 1024         # blockwise-attention query chunk
    moe_capacity_factor: float = 1.25  # expert buffer slack (tokens dropped
    #                                    beyond capacity — standard behaviour)
    # §Perf hillclimb knobs (defaults = paper-faithful baseline)
    remat_policy: str = "full"       # full | dots (save matmul outputs)
    decode_no_repeat: bool = False   # grouped-einsum GQA decode (no K/V
    #                                  head materialization)

    # ---- derived -------------------------------------------------------
    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid / windowed attn)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks)."""
        d, L = self.d_model, self.n_layers
        n = self.vocab * d                       # embedding (tied head)
        if self.family in ("ssm",):
            n += L * self._mamba_params()
            return n
        if self.family == "hybrid":
            n_shared = self._attn_params() + 3 * d * self.d_ff
            n += L * self._mamba_params() + n_shared
            return n
        per_layer = self._attn_params()
        if self.family == "moe":
            per_layer += self.n_experts * 3 * d * self.expert_d_ff
            per_layer += d * self.n_experts      # router
        else:
            per_layer += 3 * d * self.d_ff       # gate/up/down
        n += L * per_layer
        if self.family == "encdec":
            n += self.n_encoder_layers * (self._attn_params()
                                          + 3 * d * self.d_ff)
            n += L * self._attn_params()         # cross-attention
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        n = self.vocab * d
        per_layer = self._attn_params() + d * self.n_experts
        per_layer += self.top_k * 3 * d * self.expert_d_ff
        return n + L * per_layer

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        return (d * self.n_heads * hd            # q
                + 2 * d * self.n_kv_heads * hd   # k, v
                + self.n_heads * hd * d)         # o

    def _mamba_params(self) -> int:
        d, di, s = self.d_model, self.d_inner, self.ssm_state
        n = 2 * d * di + di * self.ssm_conv + di * d   # in/conv/out
        if self.ssm_version == 1:
            dt_rank = max(d // 16, 1)
            n += di * (dt_rank + 2 * s) + dt_rank * di  # x_proj + dt_proj
            n += di * s + di                            # A, D
        else:
            nh = self.ssm_heads
            n += d * 2 * s + d * nh + 3 * nh            # bc/dt/A/D/bias
        return n
