"""Unified model zoo: init / forward / prefill / decode for every family.

Torch counterpart of ``src/repro/models/model.py``.  Families: dense
(olmo, qwen2/2.5/3), vlm (llava backbone, stub frontend), moe (granite,
mixtral + SWA), ssm (falcon-mamba), hybrid (zamba2: mamba2 + one shared
attention block), encdec (whisper, stub audio frontend).

Conventions, as the reference's:
  * params are nested dicts of tensors; per-layer params are *stacked*
    on a leading L axis.  ``forward``'s layer stack is a Python loop over
    one ``unbind(0)`` of each stacked leaf (indexing ``w[i]`` per layer
    would make autograd build a zero ``[L, ...]`` gradient per layer and
    sum all L of them); under autograd ``remat`` wraps each layer in
    ``torch.utils.checkpoint`` (``cfg.remat_policy``: ``full``
    recomputes the layer, ``dots`` saves its 2-D products), as the
    reference's ``jax.remat``.  Neither ``remat`` nor ``unroll`` changes
    a value, and under ``torch.inference_mode()`` (serving) nothing is
    checkpointed;
  * attention projections are fused 2-D matrices;
  * caches are dicts of stacked buffers: fused ``[L, B, Sc, KV*hd]``
    K/V, a ring of ``window`` slots under a sliding window, f32 SSM
    state, and ``pos``, a 0-d int32 tensor on the device.

One difference, on purpose: :func:`decode_step` writes the new K/V row
and SSM state into the caller's cache tensors in place (the reference
returns new arrays) and returns a new dict with ``pos + 1``; copying
the cache for every token would cost more than the token.  Neither
:func:`prefill` nor :func:`decode_step` reads a device value on the
host: the cache slot is computed on the device from ``cache["pos"]``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, \
    create_selective_checkpoint_contexts

from ..distributed.ops import add_bias, index_copy_, lookup, merge_dims, \
    roll, split_dim, tied_logits
from ..distributed.shardctx import constrain
from ..kernels.runtime import resolve_device
from ..tree import unflatten
from .common import apply_rope, chunked_attention, decode_attention, \
    dense_init, norm, rmsnorm, silu
from .config import ModelConfig
from .moe import moe_ffn
from .ssm import mamba1_decode, mamba1_forward, mamba2_decode, \
    mamba2_forward

Params = Dict[str, Any]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ===========================================================================
# Parameter construction (concrete + abstract share one shape spec)
# ===========================================================================
def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """Flat {path: (shape, dtype)} description of the parameter tree."""
    d, hd = cfg.d_model, cfg.head_dim
    H, KV, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    dt = _dtype(cfg)
    out: Dict[str, Tuple[Tuple[int, ...], Any]] = {
        "embed": ((cfg.vocab, d), dt)}
    if not cfg.non_parametric_ln:
        out["final_norm"] = ((d,), dt)

    def attn(prefix: str, stack: Tuple[int, ...], cross: bool = False):
        p = "cross_" if cross else ""
        out[f"{prefix}/{p}wq"] = (stack + (d, H * hd), dt)
        out[f"{prefix}/{p}wk"] = (stack + (d, KV * hd), dt)
        out[f"{prefix}/{p}wv"] = (stack + (d, KV * hd), dt)
        out[f"{prefix}/{p}wo"] = (stack + (H * hd, d), dt)
        if cfg.qkv_bias and not cross:
            out[f"{prefix}/bq"] = (stack + (H * hd,), dt)
            out[f"{prefix}/bk"] = (stack + (KV * hd,), dt)
            out[f"{prefix}/bv"] = (stack + (KV * hd,), dt)
        if cfg.qk_norm and not cross:
            out[f"{prefix}/q_norm"] = (stack + (hd,), dt)
            out[f"{prefix}/k_norm"] = (stack + (hd,), dt)

    def mlp(prefix: str, stack: Tuple[int, ...]):
        if cfg.family == "moe" and prefix.startswith("layers"):
            E, Fe = cfg.n_experts, cfg.expert_d_ff
            out[f"{prefix}/router"] = (stack + (d, E), dt)
            out[f"{prefix}/we_gate"] = (stack + (E, d, Fe), dt)
            out[f"{prefix}/we_up"] = (stack + (E, d, Fe), dt)
            out[f"{prefix}/we_down"] = (stack + (E, Fe, d), dt)
        else:
            out[f"{prefix}/w_gate"] = (stack + (d, cfg.d_ff), dt)
            out[f"{prefix}/w_up"] = (stack + (d, cfg.d_ff), dt)
            out[f"{prefix}/w_down"] = (stack + (cfg.d_ff, d), dt)

    def norms(prefix: str, stack: Tuple[int, ...], names):
        if cfg.non_parametric_ln:
            return
        for n in names:
            out[f"{prefix}/{n}"] = (stack + (d,), dt)

    def mamba(prefix: str, stack: Tuple[int, ...]):
        dI, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
        out[f"{prefix}/norm"] = (stack + (d,), dt)
        out[f"{prefix}/in_proj"] = (stack + (d, 2 * dI), dt)
        out[f"{prefix}/conv_w"] = (stack + (dI, K), dt)
        out[f"{prefix}/conv_b"] = (stack + (dI,), dt)
        out[f"{prefix}/out_proj"] = (stack + (dI, d), dt)
        if cfg.ssm_version == 1:
            R = max(d // 16, 1)
            out[f"{prefix}/x_proj"] = (stack + (dI, R + 2 * N), dt)
            out[f"{prefix}/dt_proj"] = (stack + (R, dI), dt)
            out[f"{prefix}/dt_bias"] = (stack + (dI,), dt)
            out[f"{prefix}/a_log"] = (stack + (dI, N), dt)
            out[f"{prefix}/d_skip"] = (stack + (dI,), dt)
        else:
            nh = cfg.ssm_heads
            out[f"{prefix}/bc_proj"] = (stack + (d, 2 * N), dt)
            out[f"{prefix}/dt_proj"] = (stack + (d, nh), dt)
            out[f"{prefix}/dt_bias"] = (stack + (nh,), dt)
            out[f"{prefix}/a_log"] = (stack + (nh,), dt)
            out[f"{prefix}/d_skip"] = (stack + (nh,), dt)

    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        attn("layers", (L,))
        mlp("layers", (L,))
        norms("layers", (L,), ["attn_norm", "mlp_norm"])
    elif fam == "ssm":
        mamba("layers", (L,))
    elif fam == "hybrid":
        mamba("layers", (L,))
        attn("shared", ())
        out["shared/w_gate"] = ((d, cfg.d_ff), dt)
        out["shared/w_up"] = ((d, cfg.d_ff), dt)
        out["shared/w_down"] = ((cfg.d_ff, d), dt)
        norms("shared", (), ["attn_norm", "mlp_norm"])
    elif fam == "encdec":
        Le = cfg.n_encoder_layers
        attn("enc_layers", (Le,))
        mlp("enc_layers", (Le,))
        norms("enc_layers", (Le,), ["attn_norm", "mlp_norm"])
        out["enc_final_norm"] = ((d,), dt)
        attn("layers", (L,))
        attn("layers", (L,), cross=True)
        mlp("layers", (L,))
        norms("layers", (L,), ["attn_norm", "cross_norm", "mlp_norm"])
    else:
        raise ValueError(f"unknown family {fam}")
    return out


def abstract_params(cfg: ModelConfig) -> Params:
    """The parameter tree as ``meta`` tensors (shapes and dtypes, no
    storage)."""
    return unflatten({p: torch.empty(s, dtype=d, device="meta")
                       for p, (s, d) in param_shapes(cfg).items()})


def _generator(key: Union[int, torch.Generator],
               device: torch.device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        if key.device.type != device.type:
            raise ValueError(f"generator on {key.device}, params on "
                             f"{device}: pass a generator on the device")
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def init_params(cfg: ModelConfig, key: Union[int, torch.Generator] = 0,
                device="cuda") -> Params:
    """Initialised parameters on ``device`` (default ``cuda``; without a
    GPU that raises: pass ``device="cpu"``).

    ``key`` is a seed or a ``torch.Generator`` on the device.  Norms and
    ``d_skip`` are ones, biases zeros, mamba1's ``a_log`` is
    ``log(1..N)`` (zeros otherwise), every other weight normal x
    ``fan_in ** -0.5`` drawn in path order.  The draws cannot equal
    ``jax.random``'s: to hold the port to the reference, carry the
    reference's weights across (:mod:`repro_torch.models.convert`).
    """
    device = resolve_device(device)
    gen = _generator(key, device)
    flat = {}
    for path, (shape, dtype) in param_shapes(cfg).items():
        name = path.split("/")[-1]
        if "norm" in name or name == "d_skip":
            flat[path] = torch.ones(shape, dtype=dtype, device=device)
        elif name in ("bq", "bk", "bv", "conv_b", "dt_bias"):
            flat[path] = torch.zeros(shape, dtype=dtype, device=device)
        elif name == "a_log":
            if len(shape) >= 2 and shape[-1] == cfg.ssm_state and \
                    cfg.ssm_version == 1:
                a = torch.log(torch.arange(1, cfg.ssm_state + 1,
                                           dtype=torch.float32,
                                           device=device))
                flat[path] = a.expand(shape).to(dtype).contiguous()
            else:
                flat[path] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            flat[path] = dense_init(gen, shape, dtype)
    return unflatten(flat)


def _layer(stacked: Params, i) -> Params:
    """The weights of layer ``i`` (an int or a slice) of a stacked tree."""
    return {k: v[i] for k, v in stacked.items()}


# ===========================================================================
# Blocks
# ===========================================================================
def _proj_qkv(w, x, cfg: ModelConfig, positions):
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = torch.einsum("bsd,dq->bsq", x, w["wq"])
    k = torch.einsum("bsd,dq->bsq", x, w["wk"])
    v = torch.einsum("bsd,dq->bsq", x, w["wv"])
    if cfg.qkv_bias:
        q, k, v = (add_bias(q, w["bq"]), add_bias(k, w["bk"]),
                   add_bias(v, w["bv"]))
    q = split_dim(q, 2, (H, hd))
    k = split_dim(k, 2, (KV, hd))
    v = split_dim(v, 2, (KV, hd))
    if cfg.qk_norm:
        q = rmsnorm(q, w["q_norm"])
        k = rmsnorm(k, w["k_norm"])
    q = constrain(apply_rope(q, positions, cfg.rope_theta),
                  "data", None, "model", None)
    return q, apply_rope(k, positions, cfg.rope_theta), v


def _attend(w, q, k, v, cfg: ModelConfig, causal=True, window=0):
    o = chunked_attention(q, k, v, causal=causal, window=window,
                          q_chunk=cfg.attn_q_chunk)
    o = merge_dims(o, 2)
    return torch.einsum("bsq,qd->bsd", o, w["wo"])


def self_attention(w, x, cfg: ModelConfig, positions, causal=True,
                   window=0) -> torch.Tensor:
    q, k, v = _proj_qkv(w, x, cfg, positions)
    return _attend(w, q, k, v, cfg, causal=causal, window=window)


def cross_attention(w, x, memory, cfg: ModelConfig) -> torch.Tensor:
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = split_dim(torch.einsum("bsd,dq->bsq", x, w["cross_wq"]), 2, (H, hd))
    k = split_dim(torch.einsum("bsd,dq->bsq", memory, w["cross_wk"]), 2,
                  (KV, hd))
    v = split_dim(torch.einsum("bsd,dq->bsq", memory, w["cross_wv"]), 2,
                  (KV, hd))
    o = chunked_attention(q, k, v, causal=False, q_chunk=cfg.attn_q_chunk)
    return torch.einsum("bsq,qd->bsd", merge_dims(o, 2), w["cross_wo"])


def mlp_ffn(w, x, cfg: ModelConfig) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, w["w_gate"])
    u = torch.einsum("bsd,df->bsf", x, w["w_up"])
    h = constrain(h, "data", None, "model")
    h = silu(h.float()).to(x.dtype) * u
    return torch.einsum("bsf,fd->bsd", h, w["w_down"])


def _ffn(w, x, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """The MoE FFN on an MoE layer, else the dense one."""
    if cfg.family == "moe" and "router" in w:
        return moe_ffn(w, x, cfg)
    return mlp_ffn(w, x, cfg), {}


def attn_mlp_layer(w, x, cfg: ModelConfig, positions, causal=True) -> Tuple:
    h = norm(cfg, x, w.get("attn_norm"))
    x = x + self_attention(w, h, cfg, positions, causal=causal,
                           window=cfg.sliding_window)
    x = constrain(x, "data", None, "model")
    h = norm(cfg, x, w.get("mlp_norm"))
    y, aux = _ffn(w, h, cfg)
    return constrain(x + y, "data", None, "model"), aux


def attn_mlp_layer_with_cross(w, x, memory, cfg, positions):
    h = norm(cfg, x, w.get("attn_norm"))
    x = x + self_attention(w, h, cfg, positions, causal=True)
    h = norm(cfg, x, w.get("cross_norm"))
    x = x + cross_attention(w, h, memory, cfg)
    h = norm(cfg, x, w.get("mlp_norm"))
    return constrain(x + mlp_ffn(w, h, cfg), "data", None, "model"), {}


def mamba_layer(w, x, cfg: ModelConfig) -> torch.Tensor:
    h = norm(cfg, x, w["norm"])
    if cfg.ssm_version == 1:
        y = mamba1_forward(w, h, cfg)
    else:
        y = mamba2_forward(w, h, cfg)
    return constrain(x + y, "data", None, "model")


# ===========================================================================
# Forward
# ===========================================================================
def _embed_in(params, batch, cfg: ModelConfig):
    if "embeds" in batch:                       # vlm stub frontend
        x = batch["embeds"]
    else:
        x = lookup(params["embed"], batch["tokens"])
    return constrain(x.to(_dtype(cfg)), "data", None, "model")


def _logits_out(params, x, cfg: ModelConfig):
    x = norm(cfg, x, params.get("final_norm"))
    logits = tied_logits(x, params["embed"])
    return constrain(logits, "data", None, "model")


def _n_layers(stacked: Params) -> int:
    return next(iter(stacked.values())).shape[0]


def _unstack(stacked: Params) -> List[Params]:
    """Each layer's weights, from one ``unbind(0)`` of each stacked leaf
    (its backward stacks the L gradients once)."""
    cols = {k: v.unbind(0) for k, v in stacked.items()}
    return [{k: c[i] for k, c in cols.items()}
            for i in range(_n_layers(stacked))]


def _dots_policy(ctx, func, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: save the products with no
    batch dimension (the projections), recompute the rest.
    ``torch.einsum`` lowers every product to ``aten.bmm``; one with no
    batch dimension has a batch of 1."""
    if func is torch.ops.aten.bmm.default and args[0].shape[0] == 1:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: Optional[ModelConfig] = None):
    """``fn`` rematerialised in the backward pass (the reference's
    ``jax.remat``): ``full`` recomputes the whole call, ``dots`` keeps
    the outputs of its 2-D products."""
    kw = {}
    if cfg is not None and cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return wrapped


def _scan_layers(layer_fn, x, layers, remat=True, unroll=False, cfg=None):
    """The layer stack: ``layer_fn(w, x)`` for each layer's weights in
    turn (``layers`` a stacked tree or :func:`_unstack`'s list).  With
    ``remat`` each layer is rematerialised when autograd records;
    ``unroll`` (the reference's python-unrolled ``lax.scan``) changes
    nothing here."""
    del unroll
    if isinstance(layers, dict):
        layers = _unstack(layers)
    fn = _remat(layer_fn, cfg) if remat and torch.is_grad_enabled() \
        else layer_fn
    for w in layers:
        out = fn(w, x)
        x = out[0] if isinstance(out, tuple) else out
    return x


def forward(params: Params, batch: Dict, cfg: ModelConfig,
            remat: bool = True, unroll: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits [B,S,V]."""
    x = _embed_in(params, batch, cfg)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    fam = cfg.family

    if fam in ("dense", "vlm", "moe"):
        def layer(w, h):
            return attn_mlp_layer(w, h, cfg, positions)
        x = _scan_layers(layer, x, params["layers"], remat, unroll, cfg)
    elif fam == "ssm":
        def layer(w, h):
            return mamba_layer(w, h, cfg)
        x = _scan_layers(layer, x, params["layers"], remat, unroll, cfg)
    elif fam == "hybrid":
        x = _hybrid_forward(params, x, cfg, positions, remat, unroll)
    elif fam == "encdec":
        memory = _encode(params, batch["audio_embeds"], cfg, remat, unroll)

        def layer(w, h):
            return attn_mlp_layer_with_cross(w, h, memory, cfg, positions)
        x = _scan_layers(layer, x, params["layers"], remat, unroll, cfg)
    else:
        raise ValueError(fam)
    return _logits_out(params, x, cfg)


def _encode(params, audio_embeds, cfg: ModelConfig, remat=True,
            unroll=False):
    x = constrain(audio_embeds.to(_dtype(cfg)), "data", None, "model")
    positions = torch.arange(x.shape[1], device=x.device)
    ecfg = dataclasses.replace(cfg, family="dense", sliding_window=0)

    def layer(w, h):
        return attn_mlp_layer(w, h, ecfg, positions, causal=False)
    x = _scan_layers(layer, x, params["enc_layers"], remat, unroll, cfg)
    return norm(cfg, x, params.get("enc_final_norm"))


def _groups(cfg: ModelConfig):
    """Zamba2's mamba groups: (start, size) of each run of
    ``shared_attn_every`` blocks, ``ceil(L / every)`` of them."""
    every, L = cfg.shared_attn_every, cfg.n_layers
    return [(s, min(every, L - s)) for s in range(0, L, every)]


def _hybrid_forward(params, x, cfg: ModelConfig, positions, remat=True,
                    unroll=False):
    """Zamba2: groups of mamba2 blocks with ONE shared attention block
    applied after each group (the shared block's params are reused)."""
    shared = params["shared"]
    acfg = dataclasses.replace(cfg, family="dense")
    layers = _unstack(params["layers"])

    def layer(w, h):
        return mamba_layer(w, h, cfg)
    for start, g in _groups(cfg):
        x = _scan_layers(layer, x, layers[start:start + g], remat, unroll,
                         cfg)
        x, _ = attn_mlp_layer(shared, x, acfg, positions)
    return x


# ===========================================================================
# Caches / prefill / decode
# ===========================================================================
def _cache_seq_len(cfg: ModelConfig, max_seq: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, max_seq)
    return max_seq


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int) -> Dict:
    """The cache skeleton as ``meta`` tensors."""
    return _cache_impl(cfg, batch, max_seq, torch.device("meta"))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> Dict:
    """A zeroed cache on ``device`` (default ``cuda``; without a GPU that
    raises: pass ``device="cpu"``)."""
    return _cache_impl(cfg, batch, max_seq, resolve_device(device))


def _cache_impl(cfg: ModelConfig, B: int, max_seq: int,
                device: torch.device):
    dt = _dtype(cfg)
    hd, KV = cfg.head_dim, cfg.n_kv_heads
    S = _cache_seq_len(cfg, max_seq)

    def arr(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    cache: Dict[str, Any] = {"pos": arr((), torch.int32)}
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        cache["kv_k"] = arr((cfg.n_layers, B, S, KV * hd))
        cache["kv_v"] = arr((cfg.n_layers, B, S, KV * hd))
    elif fam == "ssm":
        cache["conv"] = arr((cfg.n_layers, B, cfg.d_inner, cfg.ssm_conv - 1))
        cache["ssm"] = arr((cfg.n_layers, B, cfg.d_inner, cfg.ssm_state),
                           torch.float32)
    elif fam == "hybrid":
        n_shared = len(_groups(cfg))
        cache["conv"] = arr((cfg.n_layers, B, cfg.d_inner, cfg.ssm_conv - 1))
        nh, p = cfg.ssm_heads, cfg.d_inner // cfg.ssm_heads
        cache["ssm"] = arr((cfg.n_layers, B, nh, p, cfg.ssm_state),
                           torch.float32)
        cache["kv_k"] = arr((n_shared, B, S, KV * hd))
        cache["kv_v"] = arr((n_shared, B, S, KV * hd))
    elif fam == "encdec":
        cache["kv_k"] = arr((cfg.n_layers, B, S, KV * hd))
        cache["kv_v"] = arr((cfg.n_layers, B, S, KV * hd))
        cache["enc_out"] = arr((B, cfg.encoder_seq, cfg.d_model))
    return cache


def _attn_decode_one(w, x, k_cache, v_cache, pos, cfg: ModelConfig,
                     window: int):
    """x: [B,1,D]; k/v_cache: [B,Sc,KV*hd] fused, written IN PLACE at the
    slot of ``pos``: ``pos % Sc`` under a window, else ``min(pos,
    Sc - 1)`` (the reference's ``dynamic_update_slice`` clamps, so a
    full cache that overflows rewrites its last slot)."""
    B = x.shape[0]
    hd, KV = cfg.head_dim, cfg.n_kv_heads
    q, k, v = _proj_qkv(w, x, cfg, pos.expand(B, 1))
    Sc = k_cache.shape[1]
    slot = pos % Sc if window > 0 else torch.clamp(pos, max=Sc - 1)
    slot = slot.long().reshape(1)
    index_copy_(k_cache, 1, slot, merge_dims(k, 2))
    index_copy_(v_cache, 1, slot, merge_dims(v, 2))
    o = decode_attention(q, split_dim(k_cache, 2, (KV, hd)),
                         split_dim(v_cache, 2, (KV, hd)), cache_len=pos + 1,
                         window=window, no_repeat=cfg.decode_no_repeat)
    return torch.einsum("bsq,qd->bsd", merge_dims(o, 2), w["wo"])


def decode_step(params: Params, tokens: torch.Tensor, cache: Dict,
                cfg: ModelConfig, unroll: bool = False
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens: [B,1] (or embeds [B,1,D]) -> logits
    [B,1,V].  Writes into ``cache``'s tensors in place and returns a new
    dict holding them with ``pos + 1``."""
    del unroll
    fam = cfg.family
    pos = cache["pos"]
    if tokens.ndim == 3:
        x = constrain(tokens.to(_dtype(cfg)), "data", None, "model")
    else:
        x = constrain(lookup(params["embed"], tokens).to(_dtype(cfg)),
                      "data", None, "model")

    if fam in ("dense", "vlm", "moe", "encdec"):
        for i in range(cfg.n_layers):
            w = _layer(params["layers"], i)
            hh = norm(cfg, x, w.get("attn_norm"))
            x = x + _attn_decode_one(w, hh, cache["kv_k"][i],
                                     cache["kv_v"][i], pos, cfg,
                                     cfg.sliding_window)
            if fam == "encdec":
                hh = norm(cfg, x, w.get("cross_norm"))
                x = x + cross_attention(w, hh, cache["enc_out"], cfg)
            hh = norm(cfg, x, w.get("mlp_norm"))
            x = x + _ffn(w, hh, cfg)[0]
    elif fam == "ssm":
        for i in range(cfg.n_layers):
            x = _mamba_decode_one(params, x, cache, i, cfg, mamba1_decode)
    elif fam == "hybrid":
        x = _hybrid_decode(params, x, cache, cfg)

    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return _logits_out(params, x, cfg), new_cache


def _mamba_decode_one(params, x, cache, i, cfg: ModelConfig, step):
    """Mamba block ``i`` on one token; its conv and SSM states are
    written into the cache in place."""
    w = _layer(params["layers"], i)
    conv, ssm = cache["conv"][i], cache["ssm"][i]
    y, new_conv, new_ssm = step(w, norm(cfg, x, w["norm"]), conv, ssm, cfg)
    conv.copy_(new_conv)
    ssm.copy_(new_ssm)
    return x + y


def _hybrid_decode(params, x, cache, cfg: ModelConfig):
    pos = cache["pos"]
    shared = params["shared"]
    acfg = dataclasses.replace(cfg, family="dense")
    for g_idx, (start, g) in enumerate(_groups(cfg)):
        for i in range(start, start + g):
            x = _mamba_decode_one(params, x, cache, i, cfg, mamba2_decode)
        # shared attention block
        hh = norm(acfg, x, shared.get("attn_norm"))
        x = x + _attn_decode_one(shared, hh, cache["kv_k"][g_idx],
                                 cache["kv_v"][g_idx], pos, acfg,
                                 cfg.sliding_window)
        hh = norm(acfg, x, shared.get("mlp_norm"))
        x = x + mlp_ffn(shared, hh, acfg)
    return x


# ---------------------------------------------------------------------------
# Prefill: full-sequence forward that also fills the cache
# ---------------------------------------------------------------------------
def prefill(params: Params, batch: Dict, cache: Dict,
            cfg: ModelConfig, unroll: bool = False
            ) -> Tuple[torch.Tensor, Dict]:
    """Process the prompt, fill the cache (new tensors, as the
    reference's), return last-position logits."""
    del unroll
    fam = cfg.family
    x = _embed_in(params, batch, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    new_cache = dict(cache)
    Sc = cache["kv_k"].shape[2] if "kv_k" in cache else 0

    def kv_into_cache(k, v):
        """k,v: [B,S,KV,hd] -> cache layout [B,Sc,KV*hd] (keep last Sc).

        Ring invariant: position p lives at slot p % Sc, so later decode
        writes (slot = pos % Sc) evict exactly the token that falls out
        of the window."""
        KVhd = cfg.n_kv_heads * cfg.head_dim
        kf = merge_dims(k, 2)
        vf = merge_dims(v, 2)
        if S >= Sc:
            kf, vf = kf[:, S - Sc:], vf[:, S - Sc:]
            shift = (S - Sc) % Sc
            if shift:
                kf = roll(kf, shift, 1)
                vf = roll(vf, shift, 1)
            return kf, vf
        # zeros after the prompt (a cat, not F.pad: torch 2.11's DTensor
        # fails to place F.pad's output)
        zeros = torch.zeros((B, Sc - S, KVhd), dtype=kf.dtype,
                            device=kf.device)
        return torch.cat([kf, zeros], dim=1), torch.cat([vf, zeros], dim=1)

    if fam in ("dense", "vlm", "moe", "encdec"):
        memory = None
        if fam == "encdec":
            memory = _encode(params, batch["audio_embeds"], cfg)
            new_cache["enc_out"] = memory
        ks, vs = [], []
        for i in range(cfg.n_layers):
            w = _layer(params["layers"], i)
            hh = norm(cfg, x, w.get("attn_norm"))
            q, k, v = _proj_qkv(w, hh, cfg, positions)
            x = x + _attend(w, q, k, v, cfg, window=cfg.sliding_window)
            if fam == "encdec":
                hh = norm(cfg, x, w.get("cross_norm"))
                x = x + cross_attention(w, hh, memory, cfg)
            hh = norm(cfg, x, w.get("mlp_norm"))
            x = x + _ffn(w, hh, cfg)[0]
            kc, vc = kv_into_cache(k, v)
            ks.append(kc)
            vs.append(vc)
        new_cache["kv_k"], new_cache["kv_v"] = torch.stack(ks), \
            torch.stack(vs)

    elif fam == "ssm":
        x, convs, ssms = _ssm_prefill(params, x, cfg)
        new_cache["conv"], new_cache["ssm"] = convs, ssms

    elif fam == "hybrid":
        x, states = _hybrid_prefill(params, x, cfg, positions,
                                    kv_into_cache)
        new_cache.update(states)

    new_cache["pos"] = torch.full((), S, dtype=torch.int32, device=x.device)
    logits = _logits_out(params, x[:, -1:], cfg)
    return logits, new_cache


def _ssm_prefill(params, x, cfg: ModelConfig):
    """Mamba-1 stack over the prompt: the output and each layer's conv
    tail (before the conv) and final f32 state."""
    convs, ssms = [], []
    for i in range(cfg.n_layers):
        w = _layer(params["layers"], i)
        y, conv_tail, h_last = mamba1_forward(w, norm(cfg, x, w["norm"]),
                                              cfg, return_state=True)
        x = x + y
        convs.append(conv_tail)
        ssms.append(h_last)
    return x, torch.stack(convs), torch.stack(ssms)


def _hybrid_prefill(params, x, cfg: ModelConfig, positions, kv_into_cache):
    """Mamba2 groups + shared attention, filling the shared block's
    caches."""
    shared = params["shared"]
    acfg = dataclasses.replace(cfg, family="dense")
    convs, ssms, kks, vvs = [], [], [], []
    for start, g in _groups(cfg):
        for i in range(start, start + g):
            w = _layer(params["layers"], i)
            y, conv_tail, hs = mamba2_forward(w, norm(cfg, x, w["norm"]),
                                              cfg, return_state=True)
            x = x + y
            convs.append(conv_tail)
            ssms.append(hs)
        hh = norm(acfg, x, shared.get("attn_norm"))
        q, k, v = _proj_qkv(shared, hh, acfg, positions)
        x = x + _attend(shared, q, k, v, cfg, window=cfg.sliding_window)
        hh = norm(acfg, x, shared.get("mlp_norm"))
        x = x + mlp_ffn(shared, hh, acfg)
        kc, vc = kv_into_cache(k, v)
        kks.append(kc)
        vvs.append(vc)
    return x, {"conv": torch.stack(convs), "ssm": torch.stack(ssms),
               "kv_k": torch.stack(kks), "kv_v": torch.stack(vvs)}
