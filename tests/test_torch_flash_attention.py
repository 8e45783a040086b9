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
the kernel splits it.  The 3xTF32 route's arithmetic (f32 and mixed
operands) is emulated the same way (:func:`_tf32x3_emulation`: every f32
operand and P split into two TF32 parts rounded as ``cvt.rna`` rounds,
:func:`_rna_tf32`, three products of them each exact in f32) and held
within ``1e-5`` of the twin and of the reference in interpret mode; one
TF32 product (``hi . hi``) misses that, which is why the kernel takes
three.  Where inputs are scaled by 8 (scores of hundreds) no other f32
summation order of the function, an exact one included, stays within
``1e-5`` of the twin (an ulp of a score is ~3e-5 of P); there the
emulation's distance from the f64 function is held to at most the
twin's own.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.testing import (attention_f64, f64_error, half_rule,
                                 rounded_f64_error)

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
@pytest.mark.parametrize("d", [160, 256, 288, 320, 512, 520])
def test_head_dims_past_128_match_reference_kernel(d, dtype):
    """Head dims the TMA routes do not take (D > 128) run the 3xTF32
    route through registers up to 256 and the wide 3xTF32 route past it
    on the card; the twin takes them as the reference does."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import route
    shape = (1, 2, 1, 100, d)
    (q, qj), (k, kj), (v, vj) = _qkv(shape, d, dtype)
    want = ref_ops.flash_attention(qj, kj, vj, causal=True, bq=64, bk=64)
    _assert_close(ops.flash_attention(q, k, v, causal=True), want, dtype)
    assert route(q, k, v) == ("tf32x3_wide" if d > 256 else "tf32x3_any")


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
                      "tf32x3_launches": 0, "tf32x3_any_launches": 0,
                      "tf32x3_wide_launches": 0, "twin_calls": 1}
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
    # f32 operands with D <= 128 and TMA-movable rows: the 3xTF32 route;
    # the rest up to D = 256 the 3xTF32 route through registers; past 256
    # the wide 3xTF32 route, whatever the dtypes and alignment
    assert route(q, k, v) == "tf32x3"
    for d, want in ((4, "tf32x3"), (100, "tf32x3"), (128, "tf32x3"),
                    (160, "tf32x3_any"), (18, "tf32x3_any"),
                    (2, "tf32x3_any"), (256, "tf32x3_any")):
        f = torch.zeros(1, 2, 16, d)
        assert route(f, f[:, :1].contiguous(), f[:, :1].contiguous()) \
            == want, d
    f32, f16, bf16 = torch.float32, torch.float16, torch.bfloat16
    for d in (257, 264, 288, 320, 384, 512, 520, 1024):
        for dts in ((f32,) * 3, (bf16,) * 3, (f16,) * 3, (bf16, f32, f16),
                    (f32, bf16, bf16), (f16, f16, f32)):
            f = torch.zeros(1, 2, 16, d, dtype=dts[0])
            kv = (torch.zeros(1, 1, 16, d, dtype=dt) for dt in dts[1:])
            assert route(f, *kv) == "tf32x3_wide", (d, dts)
            flat = torch.empty(f.numel() + 1, dtype=dts[0])
            shifted = flat[1:].view(f.shape)    # off a 16-byte boundary
            assert route(shifted, *(torch.zeros(1, 1, 16, d, dtype=dt)
                                    for dt in dts[1:])) == "tf32x3_wide"
    flat = torch.empty(q.numel() + 1, dtype=torch.float32)
    shifted = flat[1:].view(q.shape)            # 4 bytes past an aligned base
    assert shifted.is_contiguous() and route(shifted, k, v) == "tf32x3_any"
    for dt in (torch.bfloat16, torch.float16):
        qh, kh, vh = q.to(dt), k.to(dt), v.to(dt)
        assert route(qh, kh, vh) == "wgmma"
        # D = 12: rows of 24 bytes, which TMA does not move
        assert route(qh[..., :12].contiguous(), kh[..., :12].contiguous(),
                     vh[..., :12].contiguous()) == "tf32x3_any"
        # a base 2 bytes past an aligned one
        flat = torch.empty(qh.numel() + 1, dtype=dt)
        shifted = flat[1:].view(qh.shape)
        assert shifted.is_contiguous() \
            and route(shifted, kh, vh) == "tf32x3_any"
        # mixed operand dtypes take the 3xTF32 route, with D a multiple of
        # 8 (a half operand's rows are 16-byte multiples there), up to 128
        assert route(qh, kh.float(), vh) == "tf32x3"
        assert route(qh, kh, vh.to(torch.float16 if dt == torch.bfloat16
                                   else torch.bfloat16)) == "tf32x3"
        assert route(q, kh, vh) == "tf32x3"
        assert route(qh[..., :12].contiguous(), k[..., :12].contiguous(),
                     v[..., :12].contiguous()) == "tf32x3_any"
        big = torch.zeros(1, 2, 16, 136, dtype=dt)
        assert route(big, big[:, :1].contiguous(),
                     big[:, :1].contiguous()) == "tf32x3_any"
        assert route(big, big[:, :1].float(), big[:, :1].float()) \
            == "tf32x3_any"
        wide = torch.zeros(1, 2, 16, 264, dtype=dt)
        assert route(wide, wide[:, :1].contiguous(),
                     wide[:, :1].float()) == "tf32x3_wide"
        ok = torch.zeros(1, 2, 16, 128, dtype=dt)
        assert route(ok, ok, ok) == "wgmma"


@pytest.mark.parametrize("dts,d,forced", [
    # wgmma reads k and v in q's dtype: a mixed call is refused
    ((torch.float16, torch.float32, torch.float32), 64, "wgmma"),
    ((torch.bfloat16, torch.bfloat16, torch.float16), 64, "wgmma"),
    # the TMA routes take no D past 128, nor f32 with D % 4 != 0
    ((torch.float32,) * 3, 160, "tf32x3"),
    ((torch.bfloat16,) * 3, 160, "wgmma"),
    ((torch.float32,) * 3, 18, "tf32x3"),
    # the route through registers takes no D past 256
    ((torch.float32,) * 3, 264, "tf32x3_any"),
    ((torch.bfloat16, torch.float32, torch.float16), 1024, "tf32x3_any"),
    # the wide route is taken only where route() picks it (D > 256)
    ((torch.float32,) * 3, 256, "tf32x3_wide"),
    ((torch.bfloat16,) * 3, 64, "tf32x3_wide"),
    # nor do the TMA routes take D past 256
    ((torch.float32,) * 3, 320, "tf32x3"),
    ((torch.bfloat16,) * 3, 520, "wgmma"),
    ((torch.float32,) * 3, 64, "cutlass"),
    # the SIMT kernel is gone: no D takes it
    ((torch.float32,) * 3, 320, "simt"),
    ((torch.bfloat16, torch.float32, torch.float16), 64, "simt"),
])
def test_forced_route_must_take_the_operands(dts, d, forced):
    """A route forced past :func:`route` is refused, before any device
    check, unless it is the picked one (``"tf32x3_wide"`` past D = 256)
    or ``"tf32x3_any"`` at ``D <= 256``: those take every input of their
    D."""
    from repro_torch.kernels.flash_attention import _run, route
    q = torch.zeros(1, 2, 16, d, dtype=dts[0])
    k = torch.zeros(1, 1, 16, d, dtype=dts[1])
    v = torch.zeros(1, 1, 16, d, dtype=dts[2])
    assert route(q, k, v) != forced
    with pytest.raises(ValueError, match="does not take"):
        _run(q, k, v, True, forced)
    takes = {route(q, k, v)} | ({"tf32x3_any"} if d <= 256 else set())
    for ok in takes:
        with pytest.raises(ValueError, match="runs on CUDA or CPU"):
            _run(q, k, v, True, ok)


# ---------------------------------------------------------------------------
# the 3xTF32 route's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------
def _rna_tf32(x):
    """``x`` (f32) rounded to TF32, nearest with ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds: half of the dropped unit added to the
    magnitude bits, the 13 low bits cleared (a carry rounds into the
    exponent)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_parts(x):
    """``x = hi + lo``: ``hi = tf32(x)``, ``lo = tf32(x - hi)`` (the
    difference is exact in f32); zero for a half operand's lo."""
    hi = _rna_tf32(x.float())
    return hi, _rna_tf32(x.float() - hi)


def _tf32x3_prod(a, bt, products=3):
    """``a @ bt`` as the 3xTF32 route multiplies: each operand split into
    TF32 parts, ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` (each product exact
    in f32) summed in f64 and rounded to f32; ``products=1`` keeps ``hi .
    hi`` alone."""
    ah, al = (t.double() for t in _tf32_parts(a))
    bh, bl = (t.double() for t in _tf32_parts(bt))
    out = ah @ bh
    if products == 3:
        out = out + al @ bh + ah @ bl
    return out.float()


def _softmax_pv(x, v, causal, dtype, products=3, bn=32):
    """The tensor-core routes' tail from base-2 scores ``x`` (``[B, H, S,
    S]`` f32, already times ``scale * log2(e)``): masked under ``causal``,
    an online softmax in base 2 over tiles of ``bn`` kv rows from a running
    max of -1e30, P split into TF32 parts and ``P_lo V_hi + P_hi V_lo +
    P_hi V_hi`` added to the f32 accumulator a tile at a time; ``acc /
    max(l, 1e-30)`` rounded once to ``dtype``."""
    b, h, s, _ = x.shape
    group = h // v.shape[1]
    vf = v.float().repeat_interleave(group, dim=1)
    if causal:
        rows = torch.arange(s)
        x = x.masked_fill(rows[None, :] > rows[:, None], float("-inf"))
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, vf.shape[-1]))
    for k0 in range(0, s, bn):
        tile = x[..., k0:k0 + bn]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        p = torch.exp2(tile - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        acc = acc * alpha + _tf32x3_prod(p, vf[..., k0:k0 + bn, :], products)
    return (acc / l.clamp_min(1e-30)).to(dtype)


def _scale2(d):
    """``scale * log2(e)`` in f32, as the kernels compute it."""
    return torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) \
        * torch.tensor(1.44269504088896341, dtype=torch.float32)


def _tf32x3_emulation(q, k, v, causal, products=3, bn=32):
    """The 3xTF32 route of ``csrc/flash_attention.cu`` in plain torch, for
    the tests only: each operand split into TF32 parts, the scores
    ``q_lo k_hi + q_hi k_lo + q_hi k_hi`` (each product exact in f32,
    summed in f64, rounded to f32) times ``scale * log2(e)``; then
    :func:`_softmax_pv` over tiles of ``bn`` kv rows.  ``products=1`` keeps
    ``hi . hi`` alone: one TF32 product."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    x = _tf32x3_prod(q.float(), kf.transpose(-1, -2), products) \
        * _scale2(q.shape[-1])
    return _softmax_pv(x, v, causal, q.dtype, products, bn)


def test_rna_tf32_rounds_as_cvt_rna():
    f = torch.float32
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32) * 1e3)
    r = _rna_tf32(x)
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    # at most half of TF32's unit (2^-10 of the binade) from x
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    e = 2.0 ** -11                       # half a TF32 unit at 1
    cases = [(1 + e, 1 + 2 * e),         # a tie goes away from zero (even
             (-(1 + e), -(1 + 2 * e)),   # would give 1)
             (1 + 3 * e, 1 + 4 * e),     # a tie between two odd neighbours
             (1 + e - 2.0 ** -23, 1.0),  # just under a tie: down
             (1 + e + 2.0 ** -23, 1 + 2 * e),
             (2 - e, 2.0),               # the carry rounds into the exponent
             (float("inf"), float("inf")),
             (3.4028234663852886e38, float("inf")),   # FLT_MAX rounds up
             (0.0, 0.0), (1.5, 1.5)]
    got = _rna_tf32(torch.tensor([a for a, _ in cases], dtype=f))
    assert got.tolist() == [b for _, b in cases]
    # the split: hi + lo is x to within 2^-22 of it, lo exact in f32
    hi, lo = _tf32_parts(x)
    assert ((hi.double() + lo.double() - x.double()).abs()
            <= x.double().abs() * 2.0 ** -22).all()
    # a half value is exact in TF32: its lo is zero
    for dt in (torch.float16, torch.bfloat16):
        hi, lo = _tf32_parts(x.to(dt))
        assert torch.equal(hi, x.to(dt).float()) and (lo == 0).all()


MIXES = [(torch.float32,) * 3,
         (torch.bfloat16, torch.float32, torch.float32),
         (torch.float32, torch.bfloat16, torch.float16),
         (torch.float16, torch.float16, torch.float32)]


def _mix_id(dts):
    return "_".join(str(t)[6:] for t in dts)


@pytest.mark.parametrize("dtypes", MIXES, ids=_mix_id)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_tf32x3_arithmetic_within_tolerance(shape, causal, dtypes):
    """The emulated 3xTF32 arithmetic against the twin and the reference
    kernel (interpret mode): f32 output within 1e-5 of both; a half
    output within one rounding of the twin (``half_rule``) and within its
    dtype's tolerance of the reference."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    (q, qj), (k, kj), (v, vj) = _qkv_dtypes(shape, sum(shape) + causal,
                                            dtypes)
    got = _tf32x3_emulation(q, k, v, causal)
    twin = fa.flash_attention_torch(q, k, v, causal)
    want = ref_ops.flash_attention(qj, kj, vj, causal=causal, bq=64, bk=64)
    assert got.dtype == dtypes[0] and got.shape == twin.shape
    _assert_close(got, want, dtypes[0])
    if dtypes[0] == torch.float32:
        np.testing.assert_allclose(got.numpy(), twin.numpy(), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert half_rule(got, twin) <= 1.0


@pytest.mark.parametrize("dtypes", MIXES, ids=_mix_id)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[4], SHAPES[5]])
def test_tf32x3_arithmetic_at_scores_of_hundreds(shape, causal, dtypes):
    """Inputs scaled by 8: scores reach ~300, where the f64 function itself
    misses 1e-5 against the twin (another summation order, not another
    function), and so do the twin and the reference against it.  The
    emulation's f32 result is held to the f64 function within twice the
    twin's own distance, and one TF32 product misses it by far.  A half q
    is taken as its f32 values (its lo is zero, so the arithmetic is the
    same) and the output compared before its one rounding to q's dtype;
    from the half q itself the output is one rounding of the f64 function
    to q's dtype."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    b, h, hkv, s, d = shape
    rng = np.random.default_rng(sum(shape) + 5 * causal)
    q, k, v = (torch.from_numpy(8 * rng.normal(size=(b, n, s, d)).astype(
        np.float32)).to(dt) for n, dt in zip((h, hkv, hkv), dtypes))
    qf = q.float()
    got = _tf32x3_emulation(qf, k, v, causal)
    twin = fa.flash_attention_torch(qf, k, v, causal)
    want = torch.from_numpy(np.array(ref_ops.flash_attention(
        *(jnp.asarray(t.float().numpy()).astype(JAX_DTYPE[t.dtype])
          for t in (qf, k, v)), causal=causal, bq=64, bk=64)))
    exact = attention_f64(q, k, v, causal)
    ours, theirs = f64_error(got, exact), f64_error(twin, exact)
    assert f64_error(exact.float(), twin.double()) > 1e-5
    assert theirs > 1e-5 and f64_error(want, exact) > 1e-5
    # the same order of error as f32's own (three TF32 products keep ~22
    # bits of each operand, f32 24), and far under one TF32 product's
    assert ours <= 2 * theirs
    one = _tf32x3_emulation(qf, k, v, causal, products=1)
    assert f64_error(one, exact) > 20 * ours
    if dtypes[0] != torch.float32:
        half = _tf32x3_emulation(q, k, v, causal)
        assert half.dtype == dtypes[0]
        assert rounded_f64_error(half, exact) <= 2 * theirs
        # without its cross term q_hi k_lo the half-q call misses it
        one = _tf32x3_emulation(q, k, v, causal, products=1)
        assert rounded_f64_error(one, exact) > 2 * theirs


def test_one_tf32_product_misses_the_rule():
    """At S = 1024, D = 128, causal, three TF32 products stay within 1e-5
    of the twin while ``hi . hi`` alone (one TF32 product a product, as
    TF32 matmuls compute) does not: the reason the kernel takes three."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    (q, _), (k, _), (v, _) = _qkv((1, 4, 2, 1024, 128), 13, torch.float32)
    twin = fa.flash_attention_torch(q, k, v, True).numpy()
    three = _tf32x3_emulation(q, k, v, True).numpy()
    one = _tf32x3_emulation(q, k, v, True, products=1).numpy()
    np.testing.assert_allclose(three, twin, rtol=1e-5, atol=1e-5)
    over = np.abs(one - twin) - 1e-5 * (1 + np.abs(twin))
    assert over.max() > 1e-4


def test_p_fragment_and_v_row_permutation_compose_to_p_v():
    """The kernel hands P's accumulator registers to a k8 A fragment
    unshuffled and permutes V's rows instead: lane (g, t) holds S columns
    (2t, 2t + 1) of rows g and g + 8 where the A fragment means columns
    (t, t + 4), so logical column kappa of a slice is P's column
    perm(kappa), and V^T's column kappa must hold V's row perm(kappa)."""
    perm = [0, 2, 4, 6, 1, 3, 5, 7]
    rng = np.random.default_rng(2)
    p = rng.normal(size=(16, 8))
    v = rng.normal(size=(8, 24))
    a = np.zeros((16, 8))                 # the A operand the MMA sees
    for lane in range(32):
        g, t = lane // 4, lane % 4
        acc = [p[g, 2 * t], p[g, 2 * t + 1], p[g + 8, 2 * t],
               p[g + 8, 2 * t + 1]]       # the S accumulator's registers
        frag = [acc[0], acc[2], acc[1], acc[3]]   # a[0], a[1], a[2], a[3]
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = frag
    b = v[perm]                           # V^T's column kappa: V's row perm
    np.testing.assert_allclose(a @ b, p @ v, rtol=1e-13, atol=1e-13)
    assert not np.allclose(a @ v, p @ v)  # without the permutation: wrong


# ---------------------------------------------------------------------------
# the 3xTF32 route through registers (tf32x3_any), emulated on the CPU
# ---------------------------------------------------------------------------
def _any_plan(d):
    """The staged head width DP and kv tile of ``csrc/flash_attention.cu``'s
    ``ta::Plan`` for head dim ``d``: DP one of 32, 64, 128, 160, 192, 256,
    kv rows a tile 32 up to DP = 160, 24 at 192, 16 at 256."""
    dp = next(x for x in (32, 64, 128, 160, 192, 256) if d <= x)
    return dp, 32 if dp <= 160 else 24 if dp == 192 else 16


ANY_MIXES = [(torch.float32,) * 3, (torch.bfloat16,) * 3,
             (torch.float16,) * 3,
             (torch.bfloat16, torch.float32, torch.float16),
             (torch.float32, torch.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("dtypes", ANY_MIXES, ids=_mix_id)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [160, 256])
def test_tf32x3_any_arithmetic_within_tolerance(d, causal, dtypes):
    """The route's arithmetic at its kv tile (32 rows at D = 160, 16 at
    256) against the twin and the reference kernel (interpret mode): an
    f32 output within 1e-5 of both, a half output within one rounding of
    the twin and its dtype's tolerance of the reference."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    shape = (1, 2, 1, 100, d)
    (q, qj), (k, kj), (v, vj) = _qkv_dtypes(shape, d + causal, dtypes)
    assert fa.route(q, k, v) == "tf32x3_any"
    got = _tf32x3_emulation(q, k, v, causal, bn=_any_plan(d)[1])
    twin = fa.flash_attention_torch(q, k, v, causal)
    want = ref_ops.flash_attention(qj, kj, vj, causal=causal, bq=64, bk=64)
    assert got.dtype == dtypes[0] and got.shape == twin.shape
    _assert_close(got, want, dtypes[0])
    if dtypes[0] == torch.float32:
        np.testing.assert_allclose(got.numpy(), twin.numpy(), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert half_rule(got, twin) <= 1.0


@pytest.mark.parametrize("dtypes", ANY_MIXES[:2] + ANY_MIXES[3:4],
                         ids=_mix_id)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [160, 256])
def test_tf32x3_any_arithmetic_at_scores_of_hundreds(d, causal, dtypes):
    """Inputs scaled by 8, at the route's kv tile: the f32 result (a half
    q taken at its f32 values) within twice the twin's distance from the
    f64 function, which the twin and the reference both miss by more than
    1e-5; one TF32 product outside it; a half q's own output within one
    rounding of the f64 function beyond that."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    bn = _any_plan(d)[1]
    rng = np.random.default_rng(d + 5 * causal)
    q, k, v = (torch.from_numpy(8 * rng.normal(size=(1, n, 100, d)).astype(
        np.float32)).to(dt) for n, dt in zip((2, 1, 1), dtypes))
    qf = q.float()
    got = _tf32x3_emulation(qf, k, v, causal, bn=bn)
    twin = fa.flash_attention_torch(qf, k, v, causal)
    want = torch.from_numpy(np.array(ref_ops.flash_attention(
        *(jnp.asarray(t.float().numpy()).astype(JAX_DTYPE[t.dtype])
          for t in (qf, k, v)), causal=causal, bq=64, bk=64)))
    exact = attention_f64(q, k, v, causal)
    ours, theirs = f64_error(got, exact), f64_error(twin, exact)
    assert theirs > 1e-5 and f64_error(want, exact) > 1e-5
    assert ours <= 2 * theirs
    # one TF32 product misses the rule; by far where an f32 q or k feeds
    # the cross terms of the scores (with half q and k only P_lo V goes)
    one = f64_error(_tf32x3_emulation(qf, k, v, causal, products=1, bn=bn),
                    exact)
    assert one > 2 * theirs
    assert k.dtype != torch.float32 or one > 20 * ours
    if dtypes[0] != torch.float32:
        half = _tf32x3_emulation(q, k, v, causal, bn=bn)
        assert half.dtype == dtypes[0]
        assert rounded_f64_error(half, exact) <= 2 * theirs


def _mma_m16n8k8(a_regs, b_regs):
    """What one ``mma.sync.m16n8k8`` computes from the 32 lanes' fragments
    (PTX's layouts; lane = 4 g + t): A (16 x 8) from a[0] (g, t), a[1]
    (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4); B (8 x 8) from b0
    (t, g), b1 (t + 4, g).  Returns the 32 lanes' D fragments: (g, 2t),
    (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)."""
    a = np.zeros((16, 8))
    b = np.zeros((8, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = a_regs[lane]
        b[t, g], b[t + 4, g] = b_regs[lane]
    d = a @ b
    return [(d[l // 4, 2 * (l % 4)], d[l // 4, 2 * (l % 4) + 1],
             d[l // 4 + 8, 2 * (l % 4)], d[l // 4 + 8, 2 * (l % 4) + 1])
            for l in range(32)]


def _unit_k(l):
    """Where lane l's unit lies in its 32-unit block (``unit_k``)."""
    return l ^ (l >> 3)


def _unit_v(l, nt):
    """Lane l's unit of V's n8 tile nt (``unit_v``)."""
    return _unit_k(l) ^ ((nt & 1) << 2)


def _stored_units(km, vm):
    """K (``[bn, dp]``) and V tiles as the producer of the routes through
    registers stores them: K chunk c = (row 8 nt + g, slice) stores unit 4
    g + t at step t; V chunk c = (j, nt, t) unit 4 g + t at step g; a unit
    lies at ``_unit_k(l)`` of its block, V's at ``_unit_v(l, nt)``.  Each
    quarter warp of a store step (128 producer threads) falls on eight
    distinct 16-byte bank groups."""
    bn, dp = km.shape
    sl_n, nt_n = dp // 8, bn // 8
    k_units = np.full((nt_n * sl_n * 32, 2), np.nan)
    v_units = np.full((nt_n * sl_n * 32, 2), np.nan)
    k_waves, v_waves = {}, {}
    for c in range(bn * sl_n):
        g, sl, nt = c % 8, (c // 8) % sl_n, (c // 8) // sl_n
        row = km[8 * nt + g, 8 * sl:8 * sl + 8]
        for t in range(4):
            u = (nt * sl_n + sl) * 32 + _unit_k(4 * g + t)
            k_units[u] = row[t], row[t + 4]
            k_waves.setdefault((c // 8, t), []).append(u % 8)
    for c in range(nt_n * sl_n * 4):
        t, nt, j = c % 4, (c // 4) % sl_n, (c // 4) // sl_n
        for g in range(8):
            u = (j * sl_n + nt) * 32 + _unit_v(4 * g + t, nt)
            v_units[u] = vm[8 * j + 2 * t, 8 * nt + g], \
                vm[8 * j + 2 * t + 1, 8 * nt + g]
            v_waves.setdefault((c // 8, g), []).append(u % 8)
    assert not np.isnan(k_units).any() and not np.isnan(v_units).any()
    for waves in (k_waves, v_waves):        # quarter warps: lanes 8w..8w+7
        assert all(sorted(w) == list(range(8)) for w in waves.values())
    return k_units, v_units


def _q_frags(qm, sl):
    """The 32 lanes' A fragments of Q's k8 slice sl (its unit)."""
    return [(qm[l // 4, 8 * sl + l % 4], qm[l // 4 + 8, 8 * sl + l % 4],
             qm[l // 4, 8 * sl + l % 4 + 4],
             qm[l // 4 + 8, 8 * sl + l % 4 + 4]) for l in range(32)]


def _p_frags(p, j):
    """kv slice j's A fragments of P, straight from the S accumulator:
    (c0, c2, c1, c3) of n8 tile j as (a0 .. a3)."""
    a = []
    for l in range(32):
        g, t = l // 4, l % 4
        c = (p[g, 8 * j + 2 * t], p[g, 8 * j + 2 * t + 1],
             p[g + 8, 8 * j + 2 * t], p[g + 8, 8 * j + 2 * t + 1])
        a.append((c[0], c[2], c[1], c[3]))
    return a


def _frag_matrix(frags, cols):
    """An m16n8 accumulator's lanes (per n8 tile) as a ``[16, 8 n]``
    matrix."""
    out = np.zeros((16, 8 * len(frags)))
    for nt, frag in enumerate(frags):
        for l in range(32):
            g, t = l // 4, l % 4
            (out[g, 8 * nt + 2 * t], out[g, 8 * nt + 2 * t + 1],
             out[g + 8, 8 * nt + 2 * t], out[g + 8, 8 * nt + 2 * t + 1]) = \
                frag[l]
    return out[:, :cols]


@pytest.mark.parametrize("d", [160, 192, 256])
def test_mma_sync_units_compose_to_q_k_and_p_v(d):
    """The kernel's shared-memory units, as its producer stores them and
    its consumer warps read them, through m16n8k8's fragment layouts give
    Q K^T and P V of one tile (one warp's 16 query rows, the tile's kv
    rows, every column of DP): Q's unit (warp, slice, lane) is the A
    fragment; K's (nt, slice, lane 4 g + t) holds K row 8 nt + g at columns
    8 slice + t, + t + 4; P passes from the S accumulator to the A
    fragment unshuffled, V's unit (j, nt, lane) holding V rows 8 j + 2t,
    8 j + 2t + 1 (the row permutation (0, 2, 4, 6, 1, 3, 5, 7)) at column
    8 nt + g; each unit at its swizzled place in its block.  Each quarter
    warp of the producer's stores and of the consumer's loads touches
    eight distinct 16-byte bank groups."""
    dp, bn = _any_plan(d)
    sl_n, nt_n = dp // 8, bn // 8
    rng = np.random.default_rng(d)
    qm = rng.normal(size=(16, dp))
    km = rng.normal(size=(bn, dp))
    vm = rng.normal(size=(bn, dp))
    k_units, v_units = _stored_units(km, vm)
    for w in range(4):                      # the consumer's loads
        assert sorted(_unit_k(l) % 8 for l in range(8 * w, 8 * w + 8)) \
            == list(range(8))
        assert sorted(_unit_v(l, 1) % 8 for l in range(8 * w, 8 * w + 8)) \
            == list(range(8))
    # the consumer: S over the slices, n8 tile nt
    s_frag = [[(0.0,) * 4] * 32 for _ in range(nt_n)]
    for sl in range(sl_n):
        a = _q_frags(qm, sl)
        for nt in range(nt_n):
            b = [tuple(k_units[(nt * sl_n + sl) * 32 + _unit_k(l)])
                 for l in range(32)]
            s_frag[nt] = [tuple(x + y for x, y in zip(acc, part)) for acc, part
                          in zip(s_frag[nt], _mma_m16n8k8(a, b))]
    s = _frag_matrix(s_frag, bn)
    np.testing.assert_allclose(s, qm @ km.T, rtol=1e-12, atol=1e-12)
    # P V: P's kv slice j is S's n8 tile j, (c0, c2, c1, c3) as (a0..a3)
    p = rng.normal(size=(16, bn))
    o = np.zeros((16, dp))
    for j in range(nt_n):
        a = _p_frags(p, j)
        for nt in range(sl_n):
            b = [tuple(v_units[(j * sl_n + nt) * 32 + _unit_v(l, nt)])
                 for l in range(32)]
            for l, part in enumerate(_mma_m16n8k8(a, b)):
                g, t = l // 4, l % 4
                o[g, 8 * nt + 2 * t] += part[0]
                o[g, 8 * nt + 2 * t + 1] += part[1]
                o[g + 8, 8 * nt + 2 * t] += part[2]
                o[g + 8, 8 * nt + 2 * t + 1] += part[3]
    np.testing.assert_allclose(o, p @ vm, rtol=1e-12, atol=1e-12)
    # without the permutation (V rows 8 j + t, 8 j + t + 4): wrong
    b_plain = [(vm[l % 4, l // 4], vm[l % 4 + 4, l // 4]) for l in range(32)]
    a0 = [(p[l // 4, 2 * (l % 4)], p[l // 4 + 8, 2 * (l % 4)],
           p[l // 4, 2 * (l % 4) + 1], p[l // 4 + 8, 2 * (l % 4) + 1])
          for l in range(32)]
    got = np.array(_mma_m16n8k8(a0, b_plain))
    want = (p[:, :8] @ vm[:8, :8])
    assert not np.allclose(got[:, 0], [want[l // 4, 2 * (l % 4)]
                                       for l in range(32)])


# ---------------------------------------------------------------------------
# the 3xTF32 route past D = 256 (tf32x3_wide), emulated on the CPU
# ---------------------------------------------------------------------------
def _wide_plan(d):
    """``csrc/flash_attention.cu``'s ``ta::WidePlan`` for head dim ``d``
    past 256: the staged slab width DP (320, 384, else slabs of 512), kv
    rows a tile (16 at DP = 320, 8 at 384 and 512) and the slab count."""
    dp = 320 if d <= 320 else 384 if d <= 384 else 512
    return dp, 16 if dp == 320 else 8, -(-d // dp)


def _wide_emulation(q, k, v, causal, products=3):
    """The tf32x3_wide route in plain torch, for the tests only: O's
    columns over a pair of warps.  Warp c of the pair takes columns [c W,
    (c + 1) W) of each DP-column slab (W = DP / 2, D zero-padded to the
    slabs): each slab's partial scores of that half are the 3xTF32 products
    (:func:`_tf32x3_prod`, rounded to f32), added in f32 in slab order;
    the pair's exchange adds half 0's sum to half 1's in f32.  Then
    :func:`_softmax_pv` over the plan's kv tiles (each O column is one
    warp's, so P V is the route through registers' arithmetic)."""
    b, h, s, d = q.shape
    dp, bn, n_ds = _wide_plan(d)
    pad = n_ds * dp - d
    group = h // k.shape[1]
    qf = torch.nn.functional.pad(q.float(), (0, pad))
    kf = torch.nn.functional.pad(k.float(), (0, pad)).repeat_interleave(
        group, dim=1)
    halves = []
    for c in (0, 1):
        acc = None
        for dc in range(n_ds):
            cols = slice(dc * dp + c * dp // 2, dc * dp + (c + 1) * dp // 2)
            part = _tf32x3_prod(qf[..., cols],
                                kf[..., cols].transpose(-1, -2), products)
            acc = part if acc is None else acc + part
        halves.append(acc)
    x = (halves[0] + halves[1]) * _scale2(d)
    return _softmax_pv(x, v, causal, q.dtype, products, bn)


def test_wide_emulation_adds_the_halves_not_the_whole_row():
    """The pair's two f32 partials, added, are another rounding than one
    f32 sum over all of D: the emulation models the exchange, not the
    route through registers' single sum."""
    (q, _), (k, _), (v, _) = _qkv((1, 2, 1, 64, 320), 3, torch.float32)
    assert not torch.equal(_wide_emulation(q, k, v, False),
                           _tf32x3_emulation(q, k, v, False, bn=16))


#: the one operand mix a head dim's wide-route case also holds to the
#: reference kernel in interpret mode (the twin is held to it above)
WIDE_REF_MIX = {320: ANY_MIXES[0], 384: ANY_MIXES[3], 520: ANY_MIXES[1]}


@pytest.mark.parametrize("dtypes", ANY_MIXES, ids=_mix_id)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [320, 384, 520])
def test_tf32x3_wide_arithmetic_within_tolerance(d, causal, dtypes):
    """The wide route's arithmetic (the column pair, half 0 + half 1, its
    kv tile, the slab walk at D = 520) against the twin: an f32 output
    within 1e-5, a half output within one rounding; for one mix a head
    dim (:data:`WIDE_REF_MIX`), also within its dtype's tolerance of the
    reference kernel (interpret mode)."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    shape = (1, 2, 1, 100, d)
    (q, qj), (k, kj), (v, vj) = _qkv_dtypes(shape, d + causal, dtypes)
    assert fa.route(q, k, v) == "tf32x3_wide"
    got = _wide_emulation(q, k, v, causal)
    twin = fa.flash_attention_torch(q, k, v, causal)
    assert got.dtype == dtypes[0] and got.shape == twin.shape
    if dtypes == WIDE_REF_MIX[d]:
        want = ref_ops.flash_attention(qj, kj, vj, causal=causal, bq=64,
                                       bk=64)
        _assert_close(got, want, dtypes[0])
    if dtypes[0] == torch.float32:
        np.testing.assert_allclose(got.numpy(), twin.numpy(), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert half_rule(got, twin) <= 1.0


@pytest.mark.parametrize("dtypes", ANY_MIXES[:2] + ANY_MIXES[3:4],
                         ids=_mix_id)
@pytest.mark.parametrize("d", [264, 512, 1024])
def test_tf32x3_wide_slab_walk_matches_twin(d, dtypes):
    """The slab walk past 512 columns (D = 1024: two slabs; each walk sums
    every score over both in order) and the plans at 264 and 512, held to
    the twin: f32 within 1e-5, a half output within one rounding."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    (q, _), (k, _), (v, _) = _qkv_dtypes((1, 2, 1, 40, d), d, dtypes)
    got = _wide_emulation(q, k, v, True)
    twin = fa.flash_attention_torch(q, k, v, True)
    if dtypes[0] == torch.float32:
        np.testing.assert_allclose(got.numpy(), twin.numpy(), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert half_rule(got, twin) <= 1.0


@pytest.mark.parametrize("dtypes", ANY_MIXES[:2] + ANY_MIXES[3:4],
                         ids=_mix_id)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [320, 520])
def test_tf32x3_wide_arithmetic_at_scores_of_hundreds(d, causal, dtypes):
    """Inputs scaled by 8: the wide route's f32 result (a half q taken at
    its f32 values) within twice the twin's distance from the f64
    function, which the twin misses by more than 1e-5 (and so does the
    reference, run for the first mix of each head dim); one TF32 product
    outside it; a half q's own output within one rounding of the f64
    function beyond that."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    rng = np.random.default_rng(d + 5 * causal)
    q, k, v = (torch.from_numpy(8 * rng.normal(size=(1, n, 100, d)).astype(
        np.float32)).to(dt) for n, dt in zip((2, 1, 1), dtypes))
    qf = q.float()
    got = _wide_emulation(qf, k, v, causal)
    twin = fa.flash_attention_torch(qf, k, v, causal)
    exact = attention_f64(q, k, v, causal)
    ours, theirs = f64_error(got, exact), f64_error(twin, exact)
    assert theirs > 1e-5 and ours <= 2 * theirs
    if dtypes == ANY_MIXES[0]:
        want = torch.from_numpy(np.array(ref_ops.flash_attention(
            *(jnp.asarray(t.float().numpy()).astype(JAX_DTYPE[t.dtype])
              for t in (qf, k, v)), causal=causal, bq=64, bk=64)))
        assert f64_error(want, exact) > 1e-5
    one = f64_error(_wide_emulation(qf, k, v, causal, products=1), exact)
    assert one > 2 * theirs
    assert k.dtype != torch.float32 or one > 20 * ours
    if dtypes[0] != torch.float32:
        half = _wide_emulation(q, k, v, causal)
        assert half.dtype == dtypes[0]
        assert rounded_f64_error(half, exact) <= 2 * theirs


@pytest.mark.parametrize("d", [320, 384, 512])
def test_mma_sync_units_compose_across_the_column_pair(d):
    """The wide route's split halves: the producer stores a whole tile of
    DP columns as the route through registers does (its stores free of
    bank conflicts at the wide plan's tiles too); warp c of the pair reads
    Q's units of columns [c W, (c + 1) W) and K's blocks of slices c W / 8
    onward, and its m16n8k8 partials, half 0's + half 1's, give Q K^T of
    the tile; each warp's P V over V's n8 tiles c W / 8 onward (an even
    first tile, so the swizzle's parity holds) gives its columns of P V."""
    dp, bn, _ = _wide_plan(d)
    sl_n, nt_n, half = dp // 8, bn // 8, dp // 16
    assert half % 2 == 0
    rng = np.random.default_rng(d)
    qm = rng.normal(size=(16, dp))
    km = rng.normal(size=(bn, dp))
    vm = rng.normal(size=(bn, dp))
    k_units, v_units = _stored_units(km, vm)
    partials = []
    for c in (0, 1):
        s_frag = [[(0.0,) * 4] * 32 for _ in range(nt_n)]
        for sl in range(half):
            a = _q_frags(qm[:, c * dp // 2:(c + 1) * dp // 2], sl)
            for nt in range(nt_n):
                b = [tuple(k_units[(nt * sl_n + c * half + sl) * 32
                                   + _unit_k(l)]) for l in range(32)]
                s_frag[nt] = [tuple(x + y for x, y in zip(acc, part))
                              for acc, part in zip(s_frag[nt],
                                                   _mma_m16n8k8(a, b))]
        partials.append(_frag_matrix(s_frag, bn))
        cols = slice(c * dp // 2, (c + 1) * dp // 2)
        np.testing.assert_allclose(partials[c], qm[:, cols] @ km[:, cols].T,
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(partials[0] + partials[1], qm @ km.T,
                               rtol=1e-12, atol=1e-12)
    p = rng.normal(size=(16, bn))
    for c in (0, 1):
        o_frag = [[(0.0,) * 4] * 32 for _ in range(half)]
        for j in range(nt_n):
            a = _p_frags(p, j)
            for nt in range(half):
                b = [tuple(v_units[(j * sl_n + c * half + nt) * 32
                                   + _unit_v(l, nt)]) for l in range(32)]
                o_frag[nt] = [tuple(x + y for x, y in zip(acc, part))
                              for acc, part in zip(o_frag[nt],
                                                   _mma_m16n8k8(a, b))]
        cols = slice(c * dp // 2, (c + 1) * dp // 2)
        np.testing.assert_allclose(_frag_matrix(o_frag, dp // 2),
                                   p @ vm[:, cols], rtol=1e-12, atol=1e-12)
