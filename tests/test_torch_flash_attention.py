"""The port's ``flash_attention`` (K9) against the reference.

``repro_torch.kernels.ops.flash_attention`` on CPU tensors (the wrapper
runs its plain-torch twin, ``flash_attention_torch``) against
``repro.kernels.ops.flash_attention`` (the Pallas kernel in interpret
mode, ``bq = bk = 64`` as ``tests/test_kernels.py`` runs it), and the
``use_pallas=False`` routes against each other (the twin against
``ref.flash_attention_ref``), on the same inputs made from a numpy seed.
Shapes: the reference test's MHA, GQA and MQA cases, ragged S (100, 127,
250) and B = 2, causal and not, at f32, bf16 and f16.

Tolerances, elementwise on the outputs compared in f32, ``atol = rtol``:
f32 1e-5 (the two sum in different orders and the Pallas softmax is
online: they differ by < 1e-6 at these sizes); bf16 1e-2 and f16 2e-3
(one rounding of the output dtype, an ulp of 2^-8 and 2^-11 relative,
on top of that).  The twin's query chunk changes nothing beyond 1e-6.

For CPU tensors the wrapper counts a twin call; the CUDA kernels are
held against the twin on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``).  The arithmetic of the tensor-core route, P split
into two halves before it multiplies V, is emulated here in plain torch
(:func:`_split_pv_emulation`) and held against the twin within one
rounding of the half output plus ``1e-5 (1 + |twin|)``
(``repro_torch.testing.half_rule``, the card's rule in ``chip_smoke.py``);
a P rounded once to the half dtype misses that rule by far, which is why
the kernel splits it.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.testing import half_rule

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
             torch.float16: jnp.float16}
SHAPES = [(1, 2, 2, 128, 32),     # MHA     (tests/test_kernels.py)
          (2, 4, 2, 256, 64),     # GQA 2x
          (1, 8, 1, 128, 64),     # MQA
          (2, 4, 2, 100, 32),     # ragged S, B = 2
          (1, 2, 1, 127, 16),     # S prime: the reference's blocks are 1
          (1, 4, 2, 250, 64)]     # ragged S


def _qkv(shape, seed, dtype):
    """q, k, v as torch tensors of ``dtype`` and as jax arrays holding
    the same values."""
    b, h, hkv, s, d = shape
    rng = np.random.default_rng(seed)
    out = []
    for heads in (h, hkv, hkv):
        t = torch.from_numpy(rng.normal(size=(b, heads, s, d)).astype(
            np.float32)).to(dtype)
        out.append((t, jnp.asarray(t.float().numpy()).astype(
            JAX_DTYPE[dtype])))
    return out


def _assert_close(got, want, dtype):
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_reference_kernel(shape, causal, dtype):
    from repro_torch.kernels import ops
    (q, qj), (k, kj), (v, vj) = _qkv(shape, sum(shape) + causal, dtype)
    want = ref_ops.flash_attention(qj, kj, vj, causal=causal, bq=64, bk=64)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert tuple(got.shape) == tuple(want.shape)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[3]])
def test_oracle_route_matches_reference_oracle(shape, causal, dtype):
    from repro_torch.kernels import ops
    (q, qj), (k, kj), (v, vj) = _qkv(shape, 7 + causal, dtype)
    want = ref_ops.flash_attention(qj, kj, vj, causal=causal,
                                   use_pallas=False)
    _assert_close(ops.flash_attention(q, k, v, causal=causal,
                                      use_pallas=False), want, dtype)


def _qkv_dtypes(shape, seed, dtypes):
    """q, k, v of one dtype each, as torch tensors and as jax arrays
    holding the same values."""
    b, h, hkv, s, d = shape
    rng = np.random.default_rng(seed)
    out = []
    for heads, dt in zip((h, hkv, hkv), dtypes):
        t = torch.from_numpy(rng.normal(size=(b, heads, s, d)).astype(
            np.float32)).to(dt)
        out.append((t, jnp.asarray(t.float().numpy()).astype(JAX_DTYPE[dt])))
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtypes", [
    (torch.bfloat16, torch.float32, torch.float16),
    (torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.float16, torch.float16, torch.float32)],
    ids=lambda d: "_".join(str(t)[6:] for t in d))
def test_mixed_dtypes_match_reference_kernel(dtypes, causal):
    """Each operand in its own dtype, as the reference takes them: the
    output in q's dtype, within q's dtype's tolerance."""
    from repro_torch.kernels import ops
    shape = (1, 4, 2, 100, 32)
    (q, qj), (k, kj), (v, vj) = _qkv_dtypes(shape, 31 + causal, dtypes)
    want = ref_ops.flash_attention(qj, kj, vj, causal=causal, bq=64, bk=64)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert tuple(got.shape) == tuple(want.shape)
    _assert_close(got, want, dtypes[0])


@pytest.mark.parametrize("dtype", list(TOL), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("d", [160, 256])
def test_head_dims_past_128_match_reference_kernel(d, dtype):
    """Head dims the wgmma route does not take (D > 128) run the SIMT
    route on the card; the twin takes them as the reference does."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import route
    shape = (1, 2, 1, 100, d)
    (q, qj), (k, kj), (v, vj) = _qkv(shape, d, dtype)
    want = ref_ops.flash_attention(qj, kj, vj, causal=True, bq=64, bk=64)
    _assert_close(ops.flash_attention(q, k, v, causal=True), want, dtype)
    assert route(q, k, v) == "simt"


@pytest.mark.parametrize("causal", [True, False])
def test_twin_independent_of_query_chunk(causal, monkeypatch):
    """Chunks of 1, 3 and 37 query rows against one chunk of all 100."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    (q, _), (k, _), (v, _) = _qkv((2, 4, 2, 100, 32), 3, torch.float32)
    whole = fa.flash_attention_torch(q, k, v, causal)
    per_row = 2 * 4 * 100                  # scores of one query row
    for rows in (1, 3, 37):
        monkeypatch.setattr(fa, "_TWIN_SCORES", rows * per_row)
        part = fa.flash_attention_torch(q, k, v, causal)
        np.testing.assert_allclose(part.numpy(), whole.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_causal_first_row_is_the_first_value_row():
    """Row 0 attends to column 0 alone, so it is v[..., 0, :] exactly,
    with each query head reading its GQA kv head."""
    from repro_torch.kernels import ops
    (q, _), (k, _), (v, _) = _qkv((2, 6, 3, 20, 16), 5, torch.float32)
    out = ops.flash_attention(q, k, v, causal=True)
    want = v.repeat_interleave(2, dim=1)[:, :, 0]
    assert torch.equal(out[:, :, 0], want)


def test_ops_flash_attention_takes_no_block_keywords():
    from repro_torch.kernels import ops
    (q, _), (k, _), (v, _) = _qkv((1, 2, 1, 8, 16), 1, torch.float32)
    with pytest.raises(TypeError):
        ops.flash_attention(q, k, v, bq=64)
    with pytest.raises(TypeError):
        ops.flash_attention(q, k, v, bk=32, use_pallas=False)


def test_wrapper_on_cpu_runs_the_twin_and_checks_its_input():
    from repro_torch.kernels import flash_attention as fn
    from repro_torch.kernels.flash_attention import COUNTS, reset_counts
    (q, _), (k, _), (v, _) = _qkv((1, 4, 2, 9, 16), 2, torch.float32)
    reset_counts()
    out = fn(q, k, v)
    assert COUNTS == {"kernel_launches": 0, "wgmma_launches": 0,
                      "simt_launches": 0, "twin_calls": 1}
    assert out.shape == q.shape and out.dtype == q.dtype
    with pytest.raises(ValueError, match="not a multiple"):
        fn(q[:, :3], k, v)
    with pytest.raises(ValueError, match="share B, S and D"):
        fn(q, k[:, :, :5], v[:, :, :5])
    with pytest.raises(ValueError, match=r"\[B, H, S, D\]"):
        fn(q[0], k[0], v[0])
    for bad in (torch.float64, torch.int32):
        with pytest.raises(ValueError, match="float32, float16 or bfloat16"):
            fn(q.to(bad), k.to(bad), v.to(bad))
    # mixed operand dtypes are taken, as the reference casts each to f32;
    # the output is in q's dtype
    mixed = fn(q, k.half(), v.bfloat16())
    assert mixed.dtype == q.dtype and mixed.shape == q.shape
    assert COUNTS["twin_calls"] == 2


# ---------------------------------------------------------------------------
# the tensor-core route's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------
def _split_pv_emulation(q, k, v, causal, split=True, bn=64):
    """The wgmma route of ``csrc/flash_attention.cu`` in plain torch, for
    the tests only: f32 scores of exact half products (summed in f64,
    rounded to f32) times ``1/sqrt(D)``; an online softmax in f32 over
    tiles of ``bn`` kv rows from a running max of -1e30; P (scaled by
    2^8 for f16) as ``P_hi = half(P)`` plus ``P_lo = half(P - P_hi)``,
    each times V, accumulated in f32; ``acc / max(l, 1e-30)`` rounded once.
    ``split=False`` drops ``P_lo``: P rounded once, as SDPA rounds it."""
    dt = q.dtype
    b, h, s, d = q.shape
    group = h // k.shape[1]
    vf = v.float().repeat_interleave(group, dim=1)
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    pscale = 256.0 if dt == torch.float16 else 1.0
    scores = (q.double() @ k.double().repeat_interleave(group, dim=1)
              .transpose(-1, -2)).float() * scale
    if causal:
        rows = torch.arange(s)
        scores = scores.masked_fill(rows[None, :] > rows[:, None],
                                    float("-inf"))
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    for k0 in range(0, s, bn):
        tile = scores[..., k0:k0 + bn]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        p = torch.exp(tile - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        ps = p * pscale
        hi = ps.to(dt).float()
        acc = acc * alpha + hi @ vf[..., k0:k0 + bn, :]
        if split:
            acc = acc + (ps - hi).to(dt).float() @ vf[..., k0:k0 + bn, :]
    return ((acc / pscale) / l.clamp_min(1e-30)).to(dt)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_p_arithmetic_within_one_rounding_of_twin(shape, causal,
                                                        dtype):
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    (q, _), (k, _), (v, _) = _qkv(shape, sum(shape) + 3 * causal, dtype)
    twin = fa.flash_attention_torch(q, k, v, causal)
    emulated = _split_pv_emulation(q, k, v, causal)
    assert emulated.dtype == dtype and emulated.shape == twin.shape
    assert half_rule(emulated, twin) <= 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=lambda d: str(d)[6:])
def test_one_rounded_p_misses_the_rule(dtype):
    """At S = 1024, D = 128, causal, the split P stays within one rounding
    of the twin while a P rounded once to the half dtype does not: the
    reason the kernel multiplies V twice."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    (q, _), (k, _), (v, _) = _qkv((1, 4, 2, 1024, 128), 11, dtype)
    twin = fa.flash_attention_torch(q, k, v, True)
    assert half_rule(_split_pv_emulation(q, k, v, True), twin) <= 1.0
    assert half_rule(_split_pv_emulation(q, k, v, True, split=False),
                      twin) > 2.0


def test_route_picks_the_tensor_cores_for_aligned_half_operands():
    from repro_torch.kernels.flash_attention import route
    (q, _), (k, _), (v, _) = _qkv((1, 4, 2, 16, 64), 4, torch.float32)
    assert route(q, k, v) == "simt"
    for dt in (torch.bfloat16, torch.float16):
        qh, kh, vh = q.to(dt), k.to(dt), v.to(dt)
        assert route(qh, kh, vh) == "wgmma"
        # D = 12: rows of 24 bytes, which TMA does not move
        assert route(qh[..., :12].contiguous(), kh[..., :12].contiguous(),
                     vh[..., :12].contiguous()) == "simt"
        # a base 2 bytes past an aligned one
        flat = torch.empty(qh.numel() + 1, dtype=dt)
        shifted = flat[1:].view(qh.shape)
        assert shifted.is_contiguous() and route(shifted, kh, vh) == "simt"
        # mixed operand dtypes and head dims past 128 take the SIMT kernel
        assert route(qh, kh.float(), vh) == "simt"
        assert route(qh, kh, vh.to(torch.float16 if dt == torch.bfloat16
                                   else torch.bfloat16)) == "simt"
        big = torch.zeros(1, 2, 16, 136, dtype=dt)
        assert route(big, big[:, :1].contiguous(),
                     big[:, :1].contiguous()) == "simt"
        ok = torch.zeros(1, 2, 16, 128, dtype=dt)
        assert route(ok, ok, ok) == "wgmma"

