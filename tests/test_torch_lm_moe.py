"""The port's MoE FFN against the reference's (``repro_torch.models.moe``
vs ``repro.models.moe``), on the reduced granite and mixtral configs.

The reference's own weights (``init_params``, f32 and bf16) are carried
across bit for bit; inputs come from a numpy seed.  Routing is exact:
the expert ids, slots and ``keep`` of ``moe.route`` equal the
reference's (its lines ``moe.py:33-53``, run here in jax), at capacity
factors that drop most tokens, some and none, in prefill (``T = B*S``)
and decode (``T = B``) shapes.  Outputs: f32 ``max|port - ref| <= 1e-4
max|ref|``, bf16 ``<= 2e-2 max|ref|``; the metrics at the f32 bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as RM
from repro.configs import get_config, reduced
from repro.models import moe as ref
from repro_torch.models import moe as port
from repro_torch.models.convert import params_from_numpy

ARCHS = ["granite_moe_1b_a400m", "mixtral_8x7b"]


def _cfg(arch, cf=1.25, dtype="float32"):
    return dataclasses.replace(reduced(get_config(arch)),
                               moe_capacity_factor=cf, dtype=dtype)


def _layer0(cfg, seed=0):
    """Layer 0's MoE weights: (reference jax tree, port tensors)."""
    params = RM.init_params(cfg, jax.random.PRNGKey(seed))
    w = {k: v[0] for k, v in params["layers"].items()
         if k in ("router", "we_gate", "we_up", "we_down")}
    return w, params_from_numpy(jax.tree.map(np.asarray, w), device="cpu")


def _x(cfg, b, s, seed):
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model),
                                                    dtype=np.float32)
    t = torch.from_numpy(x).to(getattr(torch, cfg.dtype))
    return jnp.asarray(t.float().numpy()).astype(cfg.dtype), t


def _ref_route(w, x, cfg):
    """The reference's routing, its own lines (``moe.py:33-53``)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    C = max(int(T * K * cfg.moe_capacity_factor / E + 0.999), 1)
    xt = x.reshape(T, D)
    logits = jnp.einsum("td,de->te", xt, w["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, K)
    gate_vals = gate_vals / jnp.clip(gate_vals.sum(-1, keepdims=True), 1e-9)
    flat_expert = expert_idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_expert, E, dtype=jnp.int32)
    csum = jax.lax.associative_scan(jnp.add, onehot, axis=0)
    slot = jnp.sum((csum - onehot) * onehot, axis=-1)
    keep = slot < C
    slot = jnp.where(keep, slot, C - 1)
    return (np.asarray(probs), np.asarray(gate_vals), np.asarray(expert_idx),
            np.asarray(slot), np.asarray(keep), C)


def _rel(p, r):
    p = p.float().numpy() if isinstance(p, torch.Tensor) else p
    r = np.asarray(jnp.asarray(r).astype(jnp.float32))
    return float(np.abs(p - r).max()) / max(float(np.abs(r).max()), 1e-30)


# (B, S, capacity factor): most tokens dropped, some, none; decode's T = B
SHAPES = [(2, 48, 0.5), (2, 48, 1.25), (2, 48, 8.0), (4, 1, 1.25),
          (1, 1, 1.25)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b,s,cf", SHAPES)
def test_routing_is_exact(arch, b, s, cf):
    cfg = _cfg(arch, cf)
    wr, wp = _layer0(cfg)
    xr, xp = _x(cfg, b, s, b * s)
    probs, gates, idx, slot, keep, C = _ref_route(wr, xr, cfg)
    assert port.capacity(b * s, cfg) == C
    p_probs, p_gates, p_idx, p_slot, p_keep = port.route(
        wp, xp.reshape(b * s, -1), cfg)
    np.testing.assert_array_equal(p_idx.numpy(), idx)
    np.testing.assert_array_equal(p_slot.numpy(), slot)
    np.testing.assert_array_equal(p_keep.numpy(), keep)
    assert _rel(p_probs, probs) <= 1e-6 and _rel(p_gates, gates) <= 1e-6
    if cf == 0.5:
        assert not keep.all()
    if cf == 8.0:
        assert keep.all()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b,s,cf", SHAPES)
def test_moe_ffn_matches_reference(arch, b, s, cf, dtype, tol):
    cfg = _cfg(arch, cf, dtype)
    wr, wp = _layer0(cfg)
    xr, xp = _x(cfg, b, s, 7 + b * s)
    y_r, m_r = ref.moe_ffn(wr, xr, cfg)
    y_p, m_p = port.moe_ffn(wp, xp, cfg)
    assert y_p.dtype == xp.dtype and y_p.shape == xp.shape
    assert _rel(y_p, y_r) <= tol
    for key in ("moe_aux_loss", "moe_drop_fraction"):
        assert m_p[key].dtype == torch.float32
        assert abs(float(m_p[key]) - float(m_r[key])) <= \
            1e-4 * max(abs(float(m_r[key])), 1e-3), key


def test_top_k_breaks_ties_to_the_lower_expert():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    vr, ir = jax.lax.top_k(jnp.asarray(probs), 3)
    vp, ip = port.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ir))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vr))


def test_decode_capacity_is_not_prefills():
    """Decode routes ``T = B`` tokens, so its capacity is its own."""
    cfg = _cfg("mixtral_8x7b")
    assert port.capacity(2 * 48, cfg) == 60
    assert port.capacity(2, cfg) == 2 and port.capacity(1, cfg) == 1
