"""Selective state-space layers: Mamba-1 (falcon-mamba) and Mamba-2 (zamba2).

Torch counterpart of ``src/repro/models/ssm.py``.  The diagonal
recurrence ``h_t = a_t * h_{t-1} + b_t`` runs chunk by chunk
(:func:`_chunk_for` positions at a time); inside a chunk a log-depth
doubling scan over whole tensors composes the ``(a, b)`` pairs, as the
reference's ``lax.associative_scan`` does (another rounding order, the
same products: ``a`` in (0, 1) underflows to 0, never overflows).

Mamba-2 uses the SSD form: a scalar decay per head turns the
within-chunk recurrence into ``(C B^T * decay-mask) @ x``.  The decay
mask is taken as ``exp`` of the masked exponents, not masked after the
``exp`` as the reference does: the same values, but a finite gradient
where the masked exponents overflow (ROADMAP R7).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..distributed.ops import einsum
from ..distributed.shardctx import constrain
from .common import silu
from .config import ModelConfig


def _chunk_for(S: int) -> int:
    """Mamba-1 chunk size: ``max(256, S // 8)``, as the reference's."""
    return max(256, S // 8)


def _chunk_for_ssd(S: int) -> int:
    """Mamba-2 (SSD) chunk: the within-chunk decay mask is (c x c), so
    the chunk is capped at 1024 and the block count at ~32."""
    return max(256, min(1024, S // 16))


# ---------------------------------------------------------------------------
# Chunked diagonal scan (shared by mamba1 full-state and mamba2 state pass)
# ---------------------------------------------------------------------------
def _affine_scan(a: torch.Tensor,
                 b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis 1 of the maps ``h -> a h + b``, composed
    left to right (``combine(l, r) = (a_r a_l, a_r b_l + b_r)``), in
    ``ceil(log2 n)`` whole-tensor steps."""
    n = a.shape[1]
    d = 1
    while d < n:
        a_r, b_r = a[:, d:], b[:, d:]
        b = torch.cat([b[:, :d], a_r * b[:, :-d] + b_r], dim=1)
        a = torch.cat([a[:, :d], a_r * a[:, :-d]], dim=1)
        d *= 2
    return a, b


def chunked_diag_scan(log_a: torch.Tensor, b: torch.Tensor,
                      h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """log_a, b: [B, S, ...] (elementwise recurrence along S); h0: [B, ...].

    Returns (h_all [B,S,...], h_final [B,...]).
    """
    S = log_a.shape[1]
    CHUNK = _chunk_for(S)
    chunks = []
    h = h0.float()
    for s0 in range(0, S, CHUNK):
        a = torch.exp(log_a[:, s0:s0 + CHUNK].float())
        bb = b[:, s0:s0 + CHUNK].float()
        a_acc, b_acc = _affine_scan(a, bb)
        h_t = a_acc * h[:, None] + b_acc
        chunks.append(h_t.to(b.dtype))
        h = h_t[:, -1]
    return torch.cat(chunks, dim=1), h.to(b.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` in f32: ``logaddexp(x, 0)`` (``F.softplus``
    returns x itself above its threshold of 20)."""
    x = x.float()
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Mamba-1 (falcon-mamba)
# ---------------------------------------------------------------------------
def mamba1_forward(w: Dict, x: torch.Tensor, cfg: ModelConfig,
                   return_state: bool = False):
    """Full-sequence mamba1 block. x: [B,S,D] -> [B,S,D]; with
    ``return_state`` also the conv tail [B,dI,K-1] taken before the conv
    and the final state [B,dI,N] f32 (prefill's; the reference inlines
    this block there, without its two sharding hints)."""
    B, S, D = x.shape
    dI, N = cfg.d_inner, cfg.ssm_state
    xz = torch.einsum("bsd,de->bse", x, w["in_proj"])    # [B,S,2dI]
    xs, z = torch.chunk(xz, 2, dim=-1)
    xs = constrain(xs, "data", None, "model")
    conv_tail = xs[:, -(cfg.ssm_conv - 1):].transpose(1, 2)

    xs = _causal_conv(xs, w["conv_w"], w["conv_b"], cfg.ssm_conv)
    xs = silu(xs)

    proj = torch.einsum("bse,er->bsr", xs, w["x_proj"])  # [B,S,R+2N]
    dt_rank = w["dt_proj"].shape[0]
    dt, Bc, Cc = torch.split(proj, [dt_rank, N, N], dim=-1)
    dt = _softplus(einsum("bsr,re->bse", dt, w["dt_proj"])
                   + w["dt_bias"].float())               # [B,S,dI] f32
    A = -torch.exp(w["a_log"].float())                   # [dI,N] negative
    log_a = dt[..., None] * A                            # [B,S,dI,N]
    b_in = (dt[..., None] * Bc.float()[:, :, None, :]
            * xs.float()[..., None])                     # [B,S,dI,N]
    h0 = torch.zeros((B, dI, N), dtype=torch.float32, device=x.device)
    h_all, h_last = chunked_diag_scan(log_a, b_in, h0)   # [B,S,dI,N]
    y = einsum("bsen,bsn->bse", h_all.float(), Cc.float())
    y = y + w["d_skip"].float() * xs.float()
    y = (y * silu(z.float())).to(x.dtype)
    y = constrain(y, "data", None, "model")
    out = torch.einsum("bse,ed->bsd", y, w["out_proj"])
    if return_state:
        return out, conv_tail, h_last.float()
    return out


def mamba1_decode(w: Dict, x: torch.Tensor, conv_state: torch.Tensor,
                  ssm_state: torch.Tensor, cfg: ModelConfig):
    """Single-token step. x: [B,1,D]; conv_state: [B,dI,K-1];
    ssm_state: [B,dI,N] -> (y [B,1,D], new_conv, new_ssm)."""
    N = cfg.ssm_state
    xz = torch.einsum("bsd,de->bse", x, w["in_proj"])
    xs, z = torch.chunk(xz, 2, dim=-1)                   # [B,1,dI]
    xs1 = xs[:, 0]                                       # [B,dI]
    window = torch.cat([conv_state, xs1[..., None]], dim=-1)  # [B,dI,K]
    xc = torch.einsum("bek,ek->be", window, w["conv_w"]) + w["conv_b"]
    new_conv = window[..., 1:]
    xc = silu(xc)                                        # [B,dI]

    proj = torch.einsum("be,er->br", xc, w["x_proj"])
    dt_rank = w["dt_proj"].shape[0]
    dt, Bc, Cc = torch.split(proj, [dt_rank, N, N], dim=-1)
    # the bias is added in the model dtype here (f32 in the forward)
    dt = _softplus(torch.einsum("br,re->be", dt, w["dt_proj"])
                   + w["dt_bias"])
    A = -torch.exp(w["a_log"].float())
    a = torch.exp(dt[..., None] * A)                     # [B,dI,N]
    b_in = dt[..., None] * Bc.float()[:, None, :] * xc.float()[..., None]
    h = a * ssm_state.float() + b_in
    y = torch.einsum("ben,bn->be", h, Cc.float())
    y = y + w["d_skip"].float() * xc.float()
    y = (y * silu(z[:, 0].float())).to(x.dtype)
    out = torch.einsum("be,ed->bd", y, w["out_proj"])[:, None]
    return out, new_conv, h.to(ssm_state.dtype)


def _causal_conv(x: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, k: int) -> torch.Tensor:
    """Depthwise causal conv along S. x: [B,S,dI], conv_w: [dI,K].  The
    ``k - 1`` leading zeros are a cat, not ``F.pad`` (torch 2.11's
    DTensor fails to place its output)."""
    pad = torch.cat([torch.zeros((x.shape[0], k - 1, x.shape[2]),
                                 dtype=x.dtype, device=x.device), x], dim=1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    S = x.shape[1]
    for i in range(k):
        out = out + pad[:, i:i + S].float() * conv_w[:, i].float()
    return (out + conv_b.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 (zamba2): SSD with scalar decay per head
# ---------------------------------------------------------------------------
def mamba2_forward(w: Dict, x: torch.Tensor, cfg: ModelConfig,
                   return_state: bool = False):
    """x: [B,S,D] -> [B,S,D] (optionally also final conv/ssm states)."""
    B, S, D = x.shape
    dI, N, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    p = dI // nh
    xz = torch.einsum("bsd,de->bse", x, w["in_proj"])
    xs, z = torch.chunk(xz, 2, dim=-1)
    conv_tail = xs[:, -(cfg.ssm_conv - 1):].transpose(1, 2)  # [B,dI,K-1]
    xs = _causal_conv(xs, w["conv_w"], w["conv_b"], cfg.ssm_conv)
    xs = silu(xs)
    xs = constrain(xs, "data", None, "model")

    bc = torch.einsum("bsd,dn->bsn", x, w["bc_proj"])    # [B,S,2N]
    Bc, Cc = torch.chunk(bc, 2, dim=-1)
    dt = _softplus(torch.einsum("bsd,dh->bsh", x, w["dt_proj"])
                   + w["dt_bias"].float())               # [B,S,nh]
    A = -torch.exp(w["a_log"].float())                   # [nh]
    log_a = dt * A                                       # [B,S,nh]

    xh = xs.reshape(B, S, nh, p).float()
    Bf = Bc.float()
    Cf = Cc.float()

    ys = []
    CHUNK = _chunk_for_ssd(S)
    h = torch.zeros((B, nh, p, N), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, CHUNK):
        c = slice(s0, s0 + CHUNK)
        lacc = torch.cumsum(log_a[:, c], dim=1)          # [B,c,nh]
        xc = xh[:, c]                                    # [B,c,nh,p]
        Bcc, Ccc = Bf[:, c], Cf[:, c]                    # [B,c,N]
        L = lacc[:, :, None, :] - lacc[:, None, :, :]    # [B,q,k,nh]
        n = xc.shape[1]
        mask = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                     device=x.device))
        # the mask before the exp: the upper triangle may overflow to inf,
        # and the reference's exp-then-mask gives the same values but a
        # NaN gradient there (0 * inf; ROADMAP R7); exp(-inf) = 0
        G = einsum("bqn,bkn->bqk", Ccc, Bcc)[..., None] * \
            torch.exp(torch.where(mask[None, ..., None], L, -torch.inf))
        y_intra = einsum("bqkh,bkhp->bqhp", G * dt[:, c][:, None, :, :],
                         xc)
        # inter-chunk: contribution of carried state h
        y_inter = einsum("bqn,bhpn->bqhp", Ccc, h) * \
            torch.exp(lacc)[..., None]
        ys.append((y_intra + y_inter).to(x.dtype))
        # update carried state
        tail = torch.exp(lacc[:, -1:] - lacc)            # [B,c,nh]
        dB = (dt[:, c] * tail)[..., None] * Bcc[:, :, None, :]  # [B,c,nh,N]
        h = h * torch.exp(lacc[:, -1])[..., None, None] + \
            einsum("bchn,bchp->bhpn", dB, xc)
    y = torch.cat(ys, dim=1)                             # [B,S,nh,p]
    y = y.float() + w["d_skip"].float()[None, None, :, None] * xh
    y = y.reshape(B, S, dI)
    y = (y * silu(z.float())).to(x.dtype)
    y = constrain(y, "data", None, "model")
    out = torch.einsum("bse,ed->bsd", y, w["out_proj"])
    if return_state:
        return out, conv_tail, h
    return out


def mamba2_decode(w: Dict, x: torch.Tensor, conv_state: torch.Tensor,
                  ssm_state: torch.Tensor, cfg: ModelConfig):
    """x: [B,1,D]; conv_state: [B,dI,K-1]; ssm_state: [B,nh,p,N]."""
    B = x.shape[0]
    dI, nh = cfg.d_inner, cfg.ssm_heads
    p = dI // nh
    xz = torch.einsum("bsd,de->bse", x, w["in_proj"])
    xs, z = torch.chunk(xz, 2, dim=-1)
    xs1 = xs[:, 0]
    window = torch.cat([conv_state, xs1[..., None]], dim=-1)
    xc = torch.einsum("bek,ek->be", window, w["conv_w"]) + w["conv_b"]
    new_conv = window[..., 1:]
    xc = silu(xc)

    bc = torch.einsum("bd,dn->bn", x[:, 0], w["bc_proj"])
    Bc, Cc = torch.chunk(bc, 2, dim=-1)
    # the bias is added in the model dtype here (f32 in the forward)
    dt = _softplus(torch.einsum("bd,dh->bh", x[:, 0], w["dt_proj"])
                   + w["dt_bias"])                        # [B,nh]
    A = -torch.exp(w["a_log"].float())
    a = torch.exp(dt * A)                                 # [B,nh]
    xhead = xc.reshape(B, nh, p).float()
    dB = dt[..., None] * Bc.float()[:, None, :]           # [B,nh,N]
    h = ssm_state.float() * a[..., None, None] + \
        xhead[..., None] * dB[:, :, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, Cc.float())
    y = y + w["d_skip"].float()[None, :, None] * xhead
    y = y.reshape(B, dI)
    y = (y * silu(z[:, 0].float())).to(x.dtype)
    out = torch.einsum("be,ed->bd", y, w["out_proj"])[:, None]
    return out, new_conv, h.to(ssm_state.dtype)
