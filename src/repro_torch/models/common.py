"""Shared model components: norms, RoPE, blockwise attention (GQA/SWA),
decode-step attention and the weight initialiser.

Torch counterpart of ``src/repro/models/common.py``, op for op: the same
order of operations and casts, so a reduced f32 model agrees with the
reference to ~1e-6 relative.  Attention is query-chunked in plain torch
ops, as the reference's is in plain ``jnp`` (no S x S score tensor when
``q_chunk < S``); no kernel of ``repro_torch.kernels`` is on this path,
as none of ``repro.kernels`` is on the reference's.  The sharding hints
(``constrain``) sit where the reference's do, with its axes; outside a
mesh they are the identity.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..distributed.ops import einsum, merge_dims, repeat_heads, split_dim
from ..distributed.shardctx import constrain
from ..spans import span
from .config import ModelConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Activation
# ---------------------------------------------------------------------------
def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``, the sigmoid as ``1 / (1 +
    exp(-x))``, each step rounded to ``x``'s dtype as XLA rounds it (in
    bf16, ``F.silu``'s single rounding differs from it in ~40% of
    elements, by an ulp)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, weight: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if weight is not None:
        x = x * weight.float()
    return x.to(dtype)


def layernorm_np(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Non-parametric LayerNorm (OLMo): no learned scale or bias."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dtype)


def norm(cfg: ModelConfig, x: torch.Tensor,
         weight: Optional[torch.Tensor]) -> torch.Tensor:
    with span("norm"):
        if cfg.non_parametric_ln:
            return layernorm_np(x)
        return rmsnorm(x, weight)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """``1 / theta ** (arange(0, hd, 2) / hd)`` in f32, bit-equal to XLA's.

    The exponent is divided in f32 as the reference does; the power is
    taken in f64 and rounded to f32 (torch's f32 ``pow`` is one ulp off
    XLA's on some entries of the published tables, e.g. entry 37 at
    ``hd = 128``, theta 1e6); the reciprocal is taken in f32.
    """
    expo = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(float(theta), expo.double()).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, D] with positions [B, S] (or [S])."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)  # [D/2]
    angles = positions.float()[..., None] * freqs        # [B,S,D/2]
    if angles.ndim == 2:                                  # [S, D/2]
        angles = angles[None]
    cos = torch.cos(angles)[..., None, :]                 # [B,S,1,D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blockwise causal attention (training / prefill)
# ---------------------------------------------------------------------------
def _repeat_kv(k: torch.Tensor, groups: int, q: torch.Tensor = None
               ) -> torch.Tensor:
    """``jnp.repeat(k, groups, axis=2)``: query head h reads kv head
    ``h // groups`` (on a mesh each rank makes the heads of its share of
    ``q``)."""
    if groups == 1:
        return k
    return repeat_heads(k, groups, like=q)


def _softmax_f32(scores: torch.Tensor, dtype) -> torch.Tensor:
    return torch.softmax(scores.float(), dim=-1).to(dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int = 0,
                      q_chunk: int = 1024) -> torch.Tensor:
    """q: [B,S,H,D], k/v: [B,Skv,KV,D] -> [B,S,H,D].

    Each query chunk sees only the keys it can attend to (the causal
    prefix, further clipped by the sliding ``window``), so peak score
    memory is B*H*q_chunk*Skv'.
    """
    b, s, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    groups = h // kv
    scale = 1.0 / (d ** 0.5)
    q_chunk = max(min(q_chunk, s), 1)
    while s % q_chunk:
        q_chunk -= 1

    outs = []
    for start in range(0, s, q_chunk):
        qc = q[:, start:start + q_chunk]                    # [B,c,H,D]
        if causal:
            kv_end = start + q_chunk
            kv_start = max(0, start - window) if window else 0
            kc = k[:, kv_start:kv_end]
            vc = v[:, kv_start:kv_end]
        else:
            kv_start, kv_end = 0, skv
            kc, vc = k, v
        kc = _repeat_kv(kc, groups, qc)
        vc = _repeat_kv(vc, groups, qc)
        scores = einsum("bqhd,bkhd->bhqk", qc, kc) * scale
        # scores always shard over heads ('model'), as the reference's
        scores = constrain(scores, "data", "model", None, None)
        if causal:
            qpos = start + torch.arange(q_chunk, device=q.device)[:, None]
            kpos = kv_start + torch.arange(kc.shape[1],
                                           device=q.device)[None, :]
            mask = qpos >= kpos
            if window:
                mask &= (qpos - kpos) < window
            scores = torch.where(mask[None, None], scores, NEG_INF)
        probs = _softmax_f32(scores, q.dtype)
        o = einsum("bhqk,bkhd->bqhd", probs, vc)
        outs.append(constrain(o, "data", None, "model", None))
    return torch.cat(outs, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor,
                     window: int = 0, no_repeat: bool = False
                     ) -> torch.Tensor:
    """One-token attention against the cache.

    q: [B,1,H,D]; k/v_cache: [B,Smax,KV,D]; cache_len: 0-d tensor, the
    length AFTER inserting the new token (read on the device, never on
    the host).  A sliding-window cache is a ring of ``window`` slots,
    every one valid once full.

    ``no_repeat=True``: a grouped einsum keeps K/V at KV heads, with no
    repeated (B,Smax,H,D) copy of the cache.
    """
    smax, kv, d = k_cache.shape[1:]
    h = q.shape[2]
    groups = h // kv
    scale = 1.0 / (d ** 0.5)
    positions = torch.arange(smax, device=q.device)
    if window:
        valid = positions < torch.clamp(cache_len, max=smax)
    else:
        valid = positions < cache_len

    if no_repeat:
        qg = split_dim(q, 2, (kv, groups))
        scores = einsum("bqkgd,bskd->bkgqs", qg, k_cache) * scale
        scores = torch.where(valid[None, None, None, None, :], scores,
                             NEG_INF)
        probs = _softmax_f32(scores, q.dtype)
        o = einsum("bkgqs,bskd->bqkgd", probs, v_cache)
        return merge_dims(o, 2)

    kc = _repeat_kv(k_cache, groups, q)
    vc = _repeat_kv(v_cache, groups, q)
    scores = einsum("bqhd,bkhd->bhqk", q, kc) * scale  # [B,H,1,Smax]
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = _softmax_f32(scores, q.dtype)
    return einsum("bhqk,bkhd->bqhd", probs, vc)


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal draws (f32, from ``gen`` on its device) times ``scale`` or
    ``fan_in ** -0.5`` (``fan_in = shape[-2]``), cast to ``dtype``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    out = torch.randn(shape, generator=gen, dtype=torch.float32,
                      device=gen.device)
    return out.mul_(std).to(dtype)
