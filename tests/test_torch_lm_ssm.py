"""The port's state-space layers against the reference's
(``repro_torch.models.ssm`` vs ``repro.models.ssm``): the chunked
diagonal scan, the causal conv, Mamba-1 (falcon-mamba) and Mamba-2
(zamba2), full-sequence and one-token steps.

The reference's own weights (layer 0 of ``init_params`` on the reduced
configs, plus seeded perturbations of the ones/zeros it initialises so
that every term moves) are carried across bit for bit; inputs come from
a numpy seed.  ``S = 520`` crosses both chunk rules (``_chunk_for`` and
``_chunk_for_ssd`` give 256: chunks of 256, 256 and 8).  The port scans
by log-depth doubling, the reference by ``lax.associative_scan``: the
same products in another order, so f32 outputs and states are held to
``1e-4 max|ref|`` and bf16 ones to ``2e-2 max|ref|``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as RM
from repro.configs import get_config, reduced
from repro.models import ssm as ref
from repro_torch.models import ssm as port
from repro_torch.models.convert import params_from_numpy

F32, BF16 = 1e-4, 2e-2
TOL = {"float32": F32, "bfloat16": BF16}


def _rel(p, r):
    p = p.float().numpy()
    r = np.asarray(jnp.asarray(r).astype(jnp.float32))
    assert p.shape == r.shape, (p.shape, r.shape)
    return float(np.abs(p - r).max()) / max(float(np.abs(r).max()), 1e-30)


def _cfg(arch, dtype="float32"):
    return dataclasses.replace(reduced(get_config(arch)), dtype=dtype)


def _layer0(cfg):
    """Layer 0's mamba weights, the initialiser's constants perturbed
    (seeded) so that conv bias, dt bias, A and D all move."""
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    w = jax.tree.map(np.asarray, {k: v[0] for k, v in
                                  params["layers"].items()})
    rng = np.random.default_rng(11)
    for name in ("conv_b", "dt_bias", "a_log", "d_skip"):
        a = w[name].astype(np.float32)
        w[name] = (a + 0.3 * rng.standard_normal(a.shape)).astype(
            w[name].dtype)
    return jax.tree.map(jnp.asarray, w), params_from_numpy(w, device="cpu")


def _x(cfg, b, s, seed):
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model),
                                                    dtype=np.float32)
    t = torch.from_numpy(x).to(getattr(torch, cfg.dtype))
    return jnp.asarray(t.float().numpy()).astype(cfg.dtype), t


@pytest.mark.parametrize("S", [1, 7, 256, 520, 2100])
def test_chunk_rules(S):
    assert port._chunk_for(S) == ref._chunk_for(S)
    assert port._chunk_for_ssd(S) == ref._chunk_for_ssd(S)


@pytest.mark.parametrize("S", [7, 520])
def test_chunked_diag_scan(S):
    rng = np.random.default_rng(S)
    log_a = -np.abs(rng.standard_normal((2, S, 5, 3))).astype(np.float32)
    b = rng.standard_normal((2, S, 5, 3)).astype(np.float32)
    h0 = rng.standard_normal((2, 5, 3)).astype(np.float32)
    h_r, last_r = ref.chunked_diag_scan(jnp.asarray(log_a), jnp.asarray(b),
                                        jnp.asarray(h0))
    h_p, last_p = port.chunked_diag_scan(torch.from_numpy(log_a),
                                         torch.from_numpy(b),
                                         torch.from_numpy(h0))
    assert _rel(h_p, h_r) <= F32 and _rel(last_p, last_r) <= F32


def test_affine_scan_matches_a_sequential_loop():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 4)))
    b = torch.from_numpy(rng.standard_normal((2, 37, 4)))
    a_acc, b_acc = port._affine_scan(a, b)
    h = torch.zeros(2, 4, dtype=torch.float64)
    prod = torch.ones(2, 4, dtype=torch.float64)
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        prod = prod * a[:, t]
        torch.testing.assert_close(b_acc[:, t], h, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(a_acc[:, t], prod, rtol=1e-12, atol=0)


def test_softplus_is_logaddexp_past_20():
    x = np.array([-50.0, -3.0, 0.0, 3.0, 19.5, 20.5, 40.0, 90.0],
                 np.float32)
    r = np.asarray(ref._softplus(jnp.asarray(x)))
    p = port._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(p, r, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv(dtype):
    cfg = _cfg("falcon_mamba_7b", dtype)
    w_r, w_p = _layer0(cfg)
    xr, xp = _x(dataclasses.replace(cfg, d_model=cfg.d_inner), 2, 40, 1)
    r = ref._causal_conv(xr, w_r["conv_w"], w_r["conv_b"], cfg.ssm_conv)
    p = port._causal_conv(xp, w_p["conv_w"], w_p["conv_b"], cfg.ssm_conv)
    assert p.dtype == xp.dtype
    assert _rel(p, r) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba1_forward(dtype, S=520):
    cfg = _cfg("falcon_mamba_7b", dtype)
    w_r, w_p = _layer0(cfg)
    xr, xp = _x(cfg, 2, S, S)
    r = ref.mamba1_forward(w_r, xr, cfg)
    p = port.mamba1_forward(w_p, xp, cfg)
    assert p.dtype == xp.dtype
    assert _rel(p, r) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_and_state(dtype, S=520):
    cfg = _cfg("zamba2_1p2b", dtype)
    w_r, w_p = _layer0(cfg)
    xr, xp = _x(cfg, 2, S, S + 1)
    r, conv_r, h_r = ref.mamba2_forward(w_r, xr, cfg, return_state=True)
    p, conv_p, h_p = port.mamba2_forward(w_p, xp, cfg, return_state=True)
    assert p.dtype == xp.dtype and h_p.dtype == torch.float32
    assert _rel(p, r) <= TOL[dtype]
    assert _rel(conv_p, conv_r) <= TOL[dtype]
    assert _rel(h_p, h_r) <= TOL[dtype]
    assert _rel(port.mamba2_forward(w_p, xp, cfg), r) <= TOL[dtype]


def test_mamba2_masks_an_infinite_upper_triangle():
    """Steep decays make ``exp(L)`` overflow above the diagonal; the
    mask comes after the exp, so the result stays finite and equal."""
    cfg = _cfg("zamba2_1p2b")
    w_r, w_p = _layer0(cfg)
    big = np.full(cfg.ssm_heads, np.log(200.0), np.float32)
    w_r = dict(w_r, a_log=jnp.asarray(big),
               dt_bias=jnp.full(cfg.ssm_heads, 30.0))
    w_p = dict(w_p, a_log=torch.from_numpy(big),
               dt_bias=torch.full((cfg.ssm_heads,), 30.0))
    xr, xp = _x(cfg, 2, 520, 5)
    r = ref.mamba2_forward(w_r, xr, cfg)
    p = port.mamba2_forward(w_p, xp, cfg)
    assert bool(torch.isfinite(p).all()) and np.isfinite(np.asarray(r)).all()
    assert _rel(p, r) <= F32


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_1p2b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step(arch, dtype):
    """Three one-token steps from a seeded state; the state dtype (f32)
    and the model-dtype ``dt_bias`` add of the reference kept."""
    cfg = _cfg(arch, dtype)
    w_r, w_p = _layer0(cfg)
    rng = np.random.default_rng(9)
    dI, N = cfg.d_inner, cfg.ssm_state
    conv = rng.standard_normal((2, dI, cfg.ssm_conv - 1)).astype(np.float32)
    conv_p = torch.from_numpy(conv).to(getattr(torch, dtype))
    conv_r = jnp.asarray(conv_p.float().numpy()).astype(dtype)
    shape = (2, dI, N) if cfg.ssm_version == 1 else \
        (2, cfg.ssm_heads, dI // cfg.ssm_heads, N)
    ssm_np = rng.standard_normal(shape).astype(np.float32)
    ssm_r, ssm_p = jnp.asarray(ssm_np), torch.from_numpy(ssm_np)
    step_r = ref.mamba1_decode if cfg.ssm_version == 1 else ref.mamba2_decode
    step_p = port.mamba1_decode if cfg.ssm_version == 1 else \
        port.mamba2_decode
    for t in range(3):
        xr, xp = _x(cfg, 2, 1, 20 + t)
        y_r, conv_r, ssm_r = step_r(w_r, xr, conv_r, ssm_r, cfg)
        y_p, conv_p, ssm_p = step_p(w_p, xp, conv_p, ssm_p, cfg)
        assert y_p.dtype == xp.dtype and ssm_p.dtype == torch.float32
        assert _rel(y_p, y_r) <= TOL[dtype]
        assert _rel(conv_p, conv_r) <= TOL[dtype]
        assert _rel(ssm_p, ssm_r) <= TOL[dtype]
