"""The port's shared model components against the reference's
(``repro_torch.models.common`` vs ``repro.models.common``).

Inputs come from a numpy seed and go through both, jax eagerly on the
CPU.  Bounds: the RoPE table bit for bit over every published
``(head_dim, rope_theta)`` of a config that attends (torch's f32 ``pow``
is one ulp off XLA's on some entries at ``hd = 128``, which reduced
widths never show); f32
``max|port - ref| <= 1e-4 max|ref|``; bf16 ``<= 2e-2 max|ref|``;
``_repeat_kv`` exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config
from repro.models import common as ref
from repro_torch.models import common as port

F32, BF16 = 1e-4, 2e-2
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _pair(a, dtype=torch.float32):
    """numpy f32 -> (jax array, torch tensor) of ``dtype``: the bf16
    rounding is torch's, carried to jax bit for bit."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)
    return jnp.asarray(t.float().numpy()).astype(JNP[dtype]), t


def _close(p, r, tol):
    p = p.float().numpy()
    r = np.asarray(jnp.asarray(r).astype(jnp.float32))
    assert p.shape == r.shape
    err = float(np.abs(p - r).max())
    assert err <= tol * float(np.abs(r).max()), (err, float(np.abs(r).max()))


#: the published configs that attend (falcon-mamba has no attention and
#: builds no RoPE table)
ATTENDING = [a for a in ARCH_IDS if get_config(a).has_attention]


@pytest.mark.parametrize("arch", ATTENDING)
def test_rope_table_bitwise_at_published_widths(arch):
    cfg = get_config(arch)
    r = np.asarray(ref.rope_frequencies(cfg.head_dim, cfg.rope_theta))
    p = port.rope_frequencies(cfg.head_dim, cfg.rope_theta).numpy()
    assert p.dtype == np.float32
    np.testing.assert_array_equal(p.view(np.uint32), r.view(np.uint32))


def test_rope_table_at_falcon_mambas_nominal_width():
    """falcon-mamba (no attention) has a nominal head_dim of 4096, a
    table no model builds.  XLA's f32 ``pow`` (glibc's ``powf``) is not
    correctly rounded at one of its 2048 entries (787), where the f64
    power rounded to f32 is one ulp away and its reciprocal two; every
    other entry is bit-equal."""
    cfg = get_config("falcon_mamba_7b")
    assert not cfg.has_attention and cfg.head_dim == 4096
    r = np.asarray(ref.rope_frequencies(cfg.head_dim, cfg.rope_theta))
    p = port.rope_frequencies(cfg.head_dim, cfg.rope_theta).numpy()
    ulps = np.abs(p.view(np.int32).astype(np.int64)
                  - r.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2 and int((ulps > 0).sum()) <= 1, ulps.nonzero()


@pytest.mark.parametrize("hd,theta", [(16, 1e6), (16, 5e6), (64, 1e4),
                                      (128, 1e4)])
def test_rope_table_bitwise_at_other_widths(hd, theta):
    r = np.asarray(ref.rope_frequencies(hd, theta))
    p = port.rope_frequencies(hd, theta).numpy()
    np.testing.assert_array_equal(p.view(np.uint32), r.view(np.uint32))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, BF16)])
@pytest.mark.parametrize("decode", [False, True])
def test_apply_rope(dtype, tol, decode):
    rng = np.random.default_rng(0)
    B, S, H, D = 2, 1 if decode else 40, 3, 128
    xr, xp = _pair(rng.standard_normal((B, S, H, D)), dtype)
    if decode:                      # [B, 1] positions, one a sequence
        pos = np.array([[4095], [17]], np.int32)
    else:                           # [S] positions
        pos = np.arange(4000, 4000 + S, dtype=np.int32)
    r = ref.apply_rope(xr, jnp.asarray(pos), 1e6)
    p = port.apply_rope(xp, torch.from_numpy(pos), 1e6)
    assert p.dtype == dtype
    _close(p, r, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, BF16)])
@pytest.mark.parametrize("kind", ["rms", "rms_noweight", "layernorm_np"])
def test_norms(dtype, tol, kind):
    rng = np.random.default_rng(1)
    xr, xp = _pair(3 * rng.standard_normal((2, 5, 64)) + 1, dtype)
    wr, wp = _pair(rng.standard_normal(64), dtype)
    if kind == "rms":
        r, p = ref.rmsnorm(xr, wr), port.rmsnorm(xp, wp)
    elif kind == "rms_noweight":
        r, p = ref.rmsnorm(xr, None), port.rmsnorm(xp, None)
    else:
        r, p = ref.layernorm_np(xr), port.layernorm_np(xp)
    assert p.dtype == dtype
    _close(p, r, tol)


@pytest.mark.parametrize("arch", ["olmo_1b", "qwen2_7b"])
def test_norm_follows_the_config(arch):
    cfg = get_config(arch)
    rng = np.random.default_rng(2)
    xr, xp = _pair(rng.standard_normal((1, 3, 32)))
    wr, wp = _pair(rng.standard_normal(32))
    _close(port.norm(cfg, xp, wp), ref.norm(cfg, xr, wr), 1e-6)


@pytest.mark.parametrize("groups", [1, 4, 7])
def test_repeat_kv_exact(groups):
    k = np.random.default_rng(3).standard_normal((2, 5, 3, 4),
                                                 dtype=np.float32)
    r = np.asarray(ref._repeat_kv(jnp.asarray(k), groups))
    p = port._repeat_kv(torch.from_numpy(k), groups).numpy()
    np.testing.assert_array_equal(p, r)


# (B, S, H, KV, D, causal, window, q_chunk): MHA, GQA, MQA; a query chunk
# that steps down to divide S (50 -> 25, 48 -> 24); windows inside and
# past a chunk; no causal mask (cross attention, Skv != S)
ATTN = [(2, 64, 4, 4, 16, True, 0, 32), (2, 50, 4, 2, 16, True, 0, 32),
        (1, 48, 8, 1, 32, True, 0, 32), (2, 48, 4, 2, 16, True, 32, 32),
        (1, 64, 4, 1, 16, True, 8, 16), (2, 40, 4, 2, 16, False, 0, 32),
        (2, 48, 4, 2, 16, True, 0, 1024)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32),
                                       (torch.bfloat16, BF16)])
@pytest.mark.parametrize("case", ATTN)
def test_chunked_attention(case, dtype, tol):
    B, S, H, KV, D, causal, window, qc = case
    skv = S if causal else 24
    rng = np.random.default_rng(sum(case[:5]))
    qr, qp = _pair(rng.standard_normal((B, S, H, D)), dtype)
    kr, kp = _pair(rng.standard_normal((B, skv, KV, D)), dtype)
    vr, vp = _pair(rng.standard_normal((B, skv, KV, D)), dtype)
    r = ref.chunked_attention(qr, kr, vr, causal=causal, window=window,
                              q_chunk=qc)
    p = port.chunked_attention(qp, kp, vp, causal=causal, window=window,
                               q_chunk=qc)
    assert p.dtype == dtype and p.shape == (B, S, H, D)
    _close(p, r, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32),
                                       (torch.bfloat16, BF16)])
@pytest.mark.parametrize("no_repeat", [False, True])
@pytest.mark.parametrize("window,cache_len", [(0, 1), (0, 20), (0, 32),
                                              (32, 20), (32, 45)])
def test_decode_attention(dtype, tol, no_repeat, window, cache_len):
    B, Smax, H, KV, D = 2, 32, 8, 2, 16
    rng = np.random.default_rng(cache_len + window)
    qr, qp = _pair(rng.standard_normal((B, 1, H, D)), dtype)
    kr, kp = _pair(rng.standard_normal((B, Smax, KV, D)), dtype)
    vr, vp = _pair(rng.standard_normal((B, Smax, KV, D)), dtype)
    r = ref.decode_attention(qr, kr, vr, jnp.asarray(cache_len, jnp.int32),
                             window=window, no_repeat=no_repeat)
    p = port.decode_attention(qp, kp, vp,
                              torch.tensor(cache_len, dtype=torch.int32),
                              window=window, no_repeat=no_repeat)
    assert p.dtype == dtype and p.shape == (B, 1, H, D)
    _close(p, r, tol)


def test_dense_init_scale_dtype_and_generator():
    gen = torch.Generator().manual_seed(5)
    w = port.dense_init(gen, (3, 512, 256), torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (3, 512, 256)
    assert abs(float(w.float().std()) - 512 ** -0.5) < 0.02 * 512 ** -0.5
    again = port.dense_init(torch.Generator().manual_seed(5), (3, 512, 256),
                            torch.bfloat16)
    assert torch.equal(w, again)
    one = port.dense_init(gen, (1000,), torch.float32, scale=2.0)
    assert abs(float(one.std()) - 2.0) < 0.2
    assert port.NEG_INF == ref.NEG_INF == -1e30
