"""The port's LM training step against the reference's, for all ten
architectures (``repro_torch.optim``, ``repro_torch.train``,
``repro_torch.models.model.forward`` under autograd).

The reference's weights are carried across (``models/convert.py``) and
each batch is built once with numpy and fed to both packages.

* the schedules at every step of ``0..total`` and AdamW on the same
  numpy grads, params and moments (f32 and bf16 leaves; a leaf without a
  gradient) within rel 1e-6 (bf16 params equal or one bf16 ulp apart);
  XLA fuses and folds, so these are not bit for bit;
* the gradients of ``_loss_fn`` (``jax.value_and_grad`` against
  autograd), f32, ``vocab_chunk`` 0 and 32: the loss within rel 1e-5,
  each leaf's gradient within ``1e-4 max|grad of the leaf|``;
* ``remat`` off, ``full`` and ``dots`` give bit-equal loss and grads
  (``dots`` saves the projections, ``full`` recomputes them), and the
  layer stack is unbound once (no per-layer ``select`` in the backward).

The train step itself is held to the reference's in
``tests/test_torch_lm_train_step.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.models.model as RM
from repro.configs import ARCH_IDS, get_config, reduced
from repro.optim import adamw_init as r_adamw_init
from repro.optim import adamw_update as r_adamw_update
from repro.optim import clip_by_global_norm as r_clip
from repro.optim import cosine_schedule as r_cosine
from repro.optim import linear_warmup_cosine as r_warmup
from repro.train.steps import _loss_fn as r_loss_fn
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule, linear_warmup_cosine)
from repro_torch.tree import leaves as tree_leaves
from repro_torch.train.steps import value_and_grad

B, S = 2, 48


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _np(t):
    """A port tensor (or None) as an f32 numpy copy."""
    return None if t is None else np.array(t.detach().float().numpy())


def _cfg(arch, dtype="float32"):
    return dataclasses.replace(reduced(get_config(arch)), dtype=dtype)


def _batch(cfg, seed=0):
    """One batch as numpy: tokens (vlm: embeddings and labels), whisper's
    stub audio frames too."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "vlm":
        out["embeds"] = rng.standard_normal((B, S, cfg.d_model),
                                            dtype=np.float32)
        out["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.family == "encdec":
        out["audio_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _weights(arch, dtype):
    cfg = _cfg(arch, dtype)
    return jax.tree.map(np.asarray, RM.init_params(cfg,
                                                   jax.random.PRNGKey(0)))


def _port_params(arch, dtype="float32"):
    """Fresh port tensors of the reference's weights (the step writes
    them in place)."""
    return params_from_numpy(_weights(arch, dtype), device="cpu")


def _jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tt(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref_grads(arch, vocab_chunk):
    cfg = _cfg(arch)
    fn = jax.jit(jax.value_and_grad(
        functools.partial(r_loss_fn, cfg=cfg, vocab_chunk=vocab_chunk),
        has_aux=True))
    (loss, _), grads = fn(_jx(_weights(arch, "float32")),
                          _jx(_batch(cfg)))
    return float(loss), _flat(jax.tree.map(np.asarray, grads))


def _rel(a, b):
    return abs(a - b) / abs(b)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
SCHEDULES = [("warmup_cosine", 3e-4, 100, 10_000),
             ("warmup_cosine", 1.0, 10, 100),
             ("warmup_cosine", 1e-3, 20, 200),
             ("cosine", 3e-4, 0, 1000),
             ("cosine", 1.0, 0, 100)]


@pytest.mark.parametrize("kind,base,warmup,total", SCHEDULES)
def test_schedules_match_reference_at_every_step(kind, base, warmup, total):
    """Every step of ``0..total`` (and past it) as a traced int32 step of
    the reference's: rel 1e-6.  The port's int and 0-d tensor steps give
    the vector's values."""
    if kind == "cosine":
        def ref(s):
            return r_cosine(s, base, total)

        def port(s):
            return cosine_schedule(s, base, total)
    else:
        def ref(s):
            return r_warmup(s, base, warmup, total)

        def port(s):
            return linear_warmup_cosine(s, base, warmup, total)
    steps = np.arange(total + 3, dtype=np.int32)
    r = np.asarray(jax.jit(jax.vmap(ref))(jnp.asarray(steps)))
    p = port(torch.from_numpy(steps)).numpy()
    assert p.dtype == np.float32
    np.testing.assert_allclose(p, r, rtol=1e-6, atol=0)
    for s in (0, warmup, warmup + 1, total // 2, total, total + 2):
        one = port(s)
        assert one.dtype == torch.float32 and one.shape == ()
        assert float(one) == float(p[s])
        assert float(port(torch.tensor(s, dtype=torch.int32))) == float(p[s])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
SHAPES = {"embed": (12, 8), "final_norm": (8,),
          "layers": {"wq": (3, 8, 8), "attn_norm": (3, 8), "bq": (3, 8)}}


def _tree(seed, dtype=np.float32, scale=1.0):
    rng = np.random.default_rng(seed)

    def make(shape):
        if isinstance(shape, dict):
            return {k: make(v) for k, v in shape.items()}
        return (rng.standard_normal(shape) * scale).astype(dtype)
    return make(SHAPES)


def _to_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _to_torch(tree, dtype):
    def one(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dtype)
    return {k: (_to_torch(v, dtype) if isinstance(v, dict) else one(v))
            for k, v in tree.items()}


def test_adamw_init_matches_reference():
    params = _tree(0)
    r = r_adamw_init(_to_jax(params, jnp.bfloat16))
    p = adamw_init(_to_torch(params, torch.bfloat16))
    assert p["count"].dtype == torch.int32 and p["count"].shape == ()
    for key in ("m", "v"):
        rf, pf = _flat(jax.tree.map(np.asarray, r[key])), _flat(p[key])
        assert sorted(rf) == sorted(pf)
        for k, t in pf.items():
            assert t.dtype == torch.float32 and not t.any()
            assert tuple(t.shape) == rf[k].shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clipped", "kept"])
def test_clip_by_global_norm_matches_reference(dtype, max_norm):
    grads = _tree(1, scale=0.3)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    rg, rn = r_clip(_to_jax(grads, jd), max_norm)
    pg, pn = clip_by_global_norm(_to_torch(grads, td), max_norm)
    np.testing.assert_allclose(float(pn), float(rn), rtol=1e-6)
    rf = _flat(jax.tree.map(lambda a: np.asarray(a, np.float32), rg))
    for k, t in _flat(pg).items():
        assert t.dtype == td
        if dtype == "float32":
            np.testing.assert_allclose(_np(t), rf[k], rtol=1e-6, atol=0)
        else:
            _assert_bf16_within_an_ulp(_np(t), rf[k])


def _assert_bf16_within_an_ulp(p, r):
    """Equal, or one bf16 ulp apart (the f32 scale may differ in its last
    bit, and the rounding to bf16 then lands on either side)."""
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(r), 1e-30))) - 7)
    assert np.all(np.abs(p - r) <= ulp), float(np.max(np.abs(p - r) / ulp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Third step (count 2 -> 3) on numpy params, grads and moments, the
    rate a 0-d f32: params, m, v and grad_norm within rel 1e-6 (bf16
    params equal or an ulp apart); decay on ndim >= 2 leaves, a stacked
    ``[L, d]`` norm included."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    params, grads = _tree(2), _tree(3, scale=0.4)
    m, v = _tree(4, scale=0.1), jax.tree.map(np.abs, _tree(5, scale=0.01))
    lr = np.float32(2.5e-3)
    r_state = {"m": _to_jax(m, jnp.float32), "v": _to_jax(v, jnp.float32),
               "count": jnp.asarray(2, jnp.int32)}
    rp, ro, rm = jax.jit(r_adamw_update)(_to_jax(grads, jd), r_state,
                                         _to_jax(params, jd),
                                         jnp.asarray(lr))
    p_state = {"m": _to_torch(m, torch.float32),
               "v": _to_torch(v, torch.float32),
               "count": torch.tensor(2, dtype=torch.int32)}
    pp, po, pm = adamw_update(_to_torch(grads, td), p_state,
                              _to_torch(params, td), torch.tensor(lr))
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-6)
    assert int(po["count"]) == 3 and po["count"].dtype == torch.int32
    for key in ("m", "v"):
        rf = _flat(jax.tree.map(np.asarray, ro[key]))
        for k, t in _flat(po[key]).items():
            assert t.dtype == torch.float32
            np.testing.assert_allclose(_np(t), rf[k], rtol=1e-6,
                                       atol=1e-6 * np.abs(rf[k]).max(),
                                       err_msg=f"{key}/{k}")
    rf = _flat(jax.tree.map(lambda a: np.asarray(a, np.float32), rp))
    for k, t in _flat(pp).items():
        assert t.dtype == td, k
        if dtype == "float32":
            np.testing.assert_allclose(_np(t), rf[k], rtol=1e-6, atol=0,
                                       err_msg=k)
        else:
            _assert_bf16_within_an_ulp(_np(t), rf[k])
    # the norm scales ([3, 8] stacked) decayed, the flat one did not
    p0 = _flat(_to_torch(params, torch.float32))
    assert not np.allclose(_np(_flat(pp)["layers/attn_norm"]),
                           _np(p0["layers/attn_norm"]))


def test_adamw_none_grad_is_the_references_zero_grad():
    """A leaf with no gradient: the reference's zero gradient (its moments
    decay, its weight decay applies); the port takes ``None`` as zeros."""
    params, grads = _tree(6), _tree(7, scale=0.2)
    m, v = _tree(8, scale=0.1), jax.tree.map(np.abs, _tree(9, scale=0.01))
    rgrads = dict(grads, embed=np.zeros_like(grads["embed"]))
    r_state = {"m": _to_jax(m, jnp.float32), "v": _to_jax(v, jnp.float32),
               "count": jnp.asarray(1, jnp.int32)}
    rp, ro, rm = r_adamw_update(_to_jax(rgrads, jnp.float32), r_state,
                                _to_jax(params, jnp.float32), 1e-3)
    pgrads = _to_torch(grads, torch.float32)
    pgrads["embed"] = None
    p_state = {"m": _to_torch(m, torch.float32),
               "v": _to_torch(v, torch.float32),
               "count": torch.tensor(1, dtype=torch.int32)}
    pp, po, pm = adamw_update(pgrads, p_state,
                              _to_torch(params, torch.float32), 1e-3)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-6)
    for got, want in ((pp, rp), (po["m"], ro["m"]), (po["v"], ro["v"])):
        rf = _flat(jax.tree.map(np.asarray, want))
        for k, t in _flat(got).items():
            np.testing.assert_allclose(_np(t), rf[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    assert not np.allclose(_np(po["m"]["embed"]), m["embed"])


def test_adamw_update_writes_in_place():
    """The step updates the caller's params and moments in place and
    returns the same dicts; nothing needs a gradient afterwards."""
    params = _to_torch(_tree(10), torch.float32)
    state = adamw_init(params)
    before = {k: t.clone() for k, t in _flat(params).items()}
    ptrs = [t.data_ptr() for t in tree_leaves(params)]
    pp, po, _ = adamw_update(_to_torch(_tree(11), torch.float32), state,
                             params, 1e-3)
    assert pp is params and po is state
    assert [t.data_ptr() for t in tree_leaves(pp)] == ptrs
    assert all(not torch.equal(before[k], t) for k, t in _flat(pp).items())
    assert int(state["count"]) == 1


# ---------------------------------------------------------------------------
# gradients and the train step, ten architectures
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab_chunk", [0, 32], ids=["full_ce", "chunk32"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grads_match_reference(arch, vocab_chunk):
    cfg = _cfg(arch)
    r_loss, r_grads = _ref_grads(arch, vocab_chunk)
    (loss, aux), grads = value_and_grad(_port_params(arch),
                                        _tt(_batch(cfg)), cfg, vocab_chunk)
    assert float(aux["loss"]) == float(loss)
    assert _rel(float(loss), r_loss) <= 1e-5
    p_grads = _flat(grads)
    assert sorted(p_grads) == sorted(r_grads)
    for k, r in r_grads.items():
        g = _np(p_grads[k])
        g = np.zeros_like(r) if g is None else g
        assert g.shape == r.shape, k
        err = np.abs(g - r).max()
        assert err <= 1e-4 * np.abs(r).max(), (k, err, np.abs(r).max())


# ---------------------------------------------------------------------------
# remat and the layer stack
# ---------------------------------------------------------------------------
class _Ops(TorchDispatchMode):
    """Counts the aten ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def _grads(cfg, remat, ops=None):
    params = _port_params(cfg.arch_id)
    batch = _tt(_batch(cfg))
    if ops is None:
        return value_and_grad(params, batch, cfg, remat=remat)
    with ops:
        return value_and_grad(params, batch, cfg, remat=remat)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_changes_no_bit(arch):
    """``remat=False``, ``full`` and ``dots``: the same loss and grads,
    bit for bit."""
    base = _cfg(arch)
    (loss, _), grads = _grads(base, remat=False)
    for policy in ("full", "dots"):
        cfg = dataclasses.replace(base, remat_policy=policy)
        (l2, _), g2 = _grads(cfg, remat=True)
        assert float(l2) == float(loss), policy
        for k, g in _flat(grads).items():
            assert torch.equal(_flat(g2)[k], g), (policy, k)


def test_remat_policies_recompute_what_they_should():
    """``full`` recomputes each layer's forward, projections included;
    ``dots`` keeps the 2-D products (a batch-1 ``bmm``) and recomputes the
    rest; off recomputes nothing.  Reduced qwen2-7b, S = 48 in query
    chunks of 24: a layer's attention is 4 products; the recompute stops
    at the last tensor the backward reads, so ``full`` recomputes 6 of
    the 7 projections (not ``w_down``, whose output nothing saves)."""
    base = _cfg("qwen2_7b")

    def count(cfg, remat):
        ops = _Ops()
        _grads(cfg, remat, ops)
        return (ops.ops.count(torch.ops.aten.bmm.default),
                ops.ops.count(torch.ops.aten._softmax.default))

    L = base.n_layers
    off = count(base, False)
    full = count(dataclasses.replace(base, remat_policy="full"), True)
    dots = count(dataclasses.replace(base, remat_policy="dots"), True)
    assert full[1] == dots[1] == 2 * off[1]      # the softmax recomputed
    assert dots[0] - off[0] == 4 * L             # the attention products
    assert full[0] - dots[0] == 6 * L            # and the projections


class _Shapes(_Ops):
    """Also keeps the output shape of each ``select_backward``."""

    def __init__(self):
        super().__init__()
        self.selects = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func is torch.ops.aten.select_backward.default:
            self.selects.append(tuple(out.shape))
        return out


@pytest.mark.parametrize("arch", ["olmo_1b", "zamba2_1p2b",
                                  "whisper_medium"])
def test_layer_stack_unbinds_once(arch):
    """Each stacked leaf is unbound once a forward: the backward stacks
    its L gradients once and builds no per-layer ``[L, ...]`` zeros (a
    ``select_backward`` to a stacked leaf's shape)."""
    cfg = _cfg(arch)
    ops = _Shapes()
    params = _port_params(arch)
    with ops:
        value_and_grad(params, _tt(_batch(cfg)), cfg)
    stacked = {tuple(t.shape) for k, t in _flat(params).items()
               if "layers/" in k}
    assert not stacked & set(ops.selects), ops.selects
    assert ops.ops.count(torch.ops.aten.unbind.int) == \
        sum(len(v) for k, v in params.items() if k.endswith("layers"))


# ---------------------------------------------------------------------------
# R7: mamba2's decay mask past the exp's range
# ---------------------------------------------------------------------------
def test_mamba2_grads_finite_past_the_exp_range():
    """Reduced zamba2 at S = 512 (an SSD chunk of 256): the masked decay
    exponents pass 88, where f32's exp overflows.  The reference's
    exp-then-mask gives a NaN gradient (ROADMAP R7); the port's
    mask-then-exp the same loss and finite gradients.  With ``dt_bias``
    at -8 (no overflow) both are finite and agree within 1e-4 max per
    leaf at the same chunk size."""
    cfg = _cfg("zamba2_1p2b")
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (1, 512)).astype(np.int32)}
    fn = jax.jit(jax.value_and_grad(functools.partial(r_loss_fn, cfg=cfg),
                                    has_aux=True))
    weights = _weights("zamba2_1p2b", "float32")
    calm = dict(weights, layers=dict(
        weights["layers"], dt_bias=np.full_like(weights["layers"]["dt_bias"],
                                                -8.0)))
    for tree, overflow in ((weights, True), (calm, False)):
        (r_loss, _), r_grads = fn(_jx(tree), _jx(batch))
        r_grads = _flat(jax.tree.map(np.asarray, r_grads))
        (loss, _), grads = value_and_grad(
            params_from_numpy(tree, device="cpu"), _tt(batch), cfg)
        assert _rel(float(loss), float(r_loss)) <= 1e-5
        p_grads = {k: _np(v) for k, v in _flat(grads).items()}
        assert all(np.isfinite(g).all() for g in p_grads.values())
        if overflow:
            assert not all(np.isfinite(g).all() for g in r_grads.values())
            continue
        for k, r in r_grads.items():
            err = np.abs(p_grads[k] - r).max()
            assert err <= 1e-4 * np.abs(r).max(), (k, err)
