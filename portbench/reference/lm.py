"""Plain decoder-only language model, float32, for judging the port.

Written from the published descriptions (OLMo, arXiv:2402.00838;
Granite 3.0 MoE; RoPE, arXiv:2104.09864; SwiGLU, arXiv:2002.05202) and
from what each configuration file says, with plain ``torch`` operations
only.  It imports nothing of the program under test and takes nothing
the program made: the weights and tokens come from the benchmark.

Where the system under test departs from the published model, this
file follows the system and says so, because the comparison is of two
computations of one function:

* the next-token labels are the input row rolled left by one, so the
  last position predicts the row's first token;
* a mixture-of-experts layer keeps the port's capacity rule: each
  expert takes at most ``C = max(int(T * K * cf / E + 0.999), 1)``
  token slots of the ``T`` tokens of the whole batch, ranked in
  token-major order, and a slot past ``C`` adds nothing (Granite's
  published MoE drops no token);
* no embedding, attention, residual or logit multiplier is applied
  (the configuration file lists them under ``reduced``).

``cast`` is applied to both operands of every product (projections,
attention, experts, logits).  The identity gives the reference; a
rounding to a lower precision gives the control that the comparison
must reject (:mod:`portbench.reference.lowp`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

Cast = Callable[[torch.Tensor], torch.Tensor]
NEG = float("-inf")


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def _mm(a: torch.Tensor, b: torch.Tensor, cast: Cast) -> torch.Tensor:
    return torch.matmul(cast(a), cast(b))


def norm(x: torch.Tensor, weight: Optional[torch.Tensor], arch: Dict
         ) -> torch.Tensor:
    """LayerNorm without affine parameters (OLMo) or RMSNorm with a
    scale (Granite), over the last axis."""
    eps = arch["norm_eps"]
    if arch["norm"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        y = (x - mu) / torch.sqrt(var + eps)
    elif arch["norm"] == "rmsnorm":
        y = x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps)
    else:
        raise ValueError(f"unknown norm {arch['norm']!r}")
    return y if weight is None else y * weight


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half form: x [B, S, H, D]; the pair
    (i, i + D/2) turns by ``pos / theta ** (2i / D)``."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    pos = torch.arange(x.shape[1], dtype=torch.float64, device=x.device)
    ang = (pos[:, None] * inv[None, :])
    cos = torch.cos(ang).to(x.dtype)[None, :, None, :]
    sin = torch.sin(ang).to(x.dtype)[None, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(h: torch.Tensor, w: Dict, arch: Dict, cast: Cast
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal multi-head attention with grouped K/V heads.  Returns the
    output [B, S, d] and the K (after RoPE) and V a KV cache holds,
    each [B, S, KV * D]."""
    b, s, _ = h.shape
    H, KV, D = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    q = _mm(h, w["wq"], cast).view(b, s, H, D)
    k = _mm(h, w["wk"], cast).view(b, s, KV, D)
    v = _mm(h, w["wv"], cast).view(b, s, KV, D)
    q, k = rope(q, arch["rope_theta"]), rope(k, arch["rope_theta"])
    g = H // KV
    kh = k.repeat_interleave(g, dim=2)           # head j reads kv j // g
    vh = v.repeat_interleave(g, dim=2)
    scores = _mm(q.transpose(1, 2), kh.permute(0, 2, 3, 1), cast)
    scores = scores / math.sqrt(D)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, NEG)
    probs = torch.softmax(scores, dim=-1)
    o = _mm(probs, vh.transpose(1, 2), cast)      # [B, H, S, D]
    o = o.transpose(1, 2).reshape(b, s, H * D)
    return _mm(o, w["wo"], cast), k.reshape(b, s, KV * D), \
        v.reshape(b, s, KV * D)


def swiglu(h: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
           down: torch.Tensor, cast: Cast) -> torch.Tensor:
    a = _mm(h, gate, cast)
    return _mm(torch.nn.functional.silu(a) * _mm(h, up, cast), down, cast)


def capacity(tokens: int, arch: Dict) -> int:
    return max(int(tokens * arch["top_k"] * arch["capacity_factor"]
                   / arch["n_experts"] + 0.999), 1)


def moe(h: torch.Tensor, w: Dict, arch: Dict, cast: Cast) -> torch.Tensor:
    """Top-k routed SwiGLU experts, gates renormalised over the k chosen,
    under the capacity rule of the module docstring."""
    b, s, d = h.shape
    E, K = arch["n_experts"], arch["top_k"]
    x = h.reshape(b * s, d)
    T = x.shape[0]
    probs = torch.softmax(_mm(x, w["router"], cast), dim=-1)
    # largest first, ties to the lower expert id
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[:, :K], idx[:, :K]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    flat = experts.reshape(-1)                    # token-major [T * K]
    order = torch.sort(flat, stable=True).indices
    sorted_e = flat[order]
    first = torch.searchsorted(sorted_e, torch.arange(
        E, device=x.device, dtype=sorted_e.dtype))
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(flat.numel(), device=x.device) \
        - first[sorted_e]
    keep = rank < capacity(T, arch)
    token = torch.arange(T, device=x.device).repeat_interleave(K)
    gate = gates.reshape(-1)
    y = torch.zeros_like(x)
    for e in range(E):
        sel = torch.nonzero((flat == e) & keep).squeeze(1)
        if sel.numel() == 0:
            continue
        out = swiglu(x[token[sel]], w["we_gate"][e], w["we_up"][e],
                     w["we_down"][e], cast)
        y = y.index_add(0, token[sel], out * gate[sel, None])
    return y.reshape(b, s, d)


def block(x: torch.Tensor, w: Dict, arch: Dict, cast: Cast
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    a, k, v = attention(norm(x, w.get("attn_norm"), arch), w, arch, cast)
    x = x + a
    h = norm(x, w.get("mlp_norm"), arch)
    if arch["family"] == "moe":
        x = x + moe(h, w, arch, cast)
    else:
        x = x + swiglu(h, w["w_gate"], w["w_up"], w["w_down"], cast)
    return x, k, v


def layers(params: Dict[str, torch.Tensor]) -> List[Dict]:
    """Each layer's weights, from one ``unbind`` of every stacked leaf
    ``layers/<name>`` [L, ...]."""
    cols = {p.split("/", 1)[1]: t.unbind(0) for p, t in params.items()
            if p.startswith("layers/")}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def hidden(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
           arch: Dict, cast: Cast = identity, remat: bool = False,
           on_layer: Optional[Callable] = None) -> torch.Tensor:
    """The final hidden states [B, S, d] after the last norm.
    ``remat`` recomputes each layer in the backward pass (to fit);
    ``on_layer(i, k, v)`` sees each layer's cache rows."""
    x = params["embed"][tokens]
    for i, w in enumerate(layers(params)):
        if remat and torch.is_grad_enabled():
            x, k, v = checkpoint(block, x, w, arch, cast,
                                 use_reentrant=False)
        else:
            x, k, v = block(x, w, arch, cast)
        if on_layer is not None:
            on_layer(i, k, v)
        del k, v
    return norm(x, params.get("final_norm"), arch)


def logits(params: Dict[str, torch.Tensor], h: torch.Tensor, cast: Cast
           ) -> torch.Tensor:
    """Tied output head: ``h @ embed.T``."""
    return _mm(h, params["embed"].t(), cast)


def loss(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         arch: Dict, cast: Cast = identity) -> torch.Tensor:
    """Mean next-token cross entropy over every position (labels as in
    the module docstring)."""
    h = hidden(params, tokens, arch, cast, remat=True)
    z = logits(params, h, cast)
    labels = torch.roll(tokens, -1, dims=1)
    lse = torch.logsumexp(z, dim=-1)
    tgt = torch.gather(z, -1, labels[..., None])[..., 0]
    return (lse - tgt).mean()


@torch.no_grad()
def prefill(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
            arch: Dict, cast: Cast = identity,
            on_layer: Optional[Callable] = None) -> torch.Tensor:
    """The last position's logits [B, V]; ``on_layer(i, k, v)`` gets
    each layer's K (after RoPE) and V, [B, S, KV * D]."""
    h = hidden(params, tokens, arch, cast, on_layer=on_layer)
    return logits(params, h[:, -1], cast)
