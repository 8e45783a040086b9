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
                      "tf32x3_launches": 0, "simt_launches": 0,
                      "twin_calls": 1}
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
    # f32 operands with D <= 128 and TMA-movable rows: the 3xTF32 route
    assert route(q, k, v) == "tf32x3"
    for d, want in ((4, "tf32x3"), (100, "tf32x3"), (128, "tf32x3"),
                    (160, "simt"), (18, "simt"), (2, "simt")):
        f = torch.zeros(1, 2, 16, d)
        assert route(f, f[:, :1].contiguous(), f[:, :1].contiguous()) \
            == want, d
    flat = torch.empty(q.numel() + 1, dtype=torch.float32)
    shifted = flat[1:].view(q.shape)            # 4 bytes past an aligned base
    assert shifted.is_contiguous() and route(shifted, k, v) == "simt"
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
        # mixed operand dtypes take the 3xTF32 route, with D a multiple of
        # 8 (a half operand's rows are 16-byte multiples there), up to 128
        assert route(qh, kh.float(), vh) == "tf32x3"
        assert route(qh, kh, vh.to(torch.float16 if dt == torch.bfloat16
                                   else torch.bfloat16)) == "tf32x3"
        assert route(q, kh, vh) == "tf32x3"
        assert route(qh[..., :12].contiguous(), k[..., :12].contiguous(),
                     v[..., :12].contiguous()) == "simt"
        big = torch.zeros(1, 2, 16, 136, dtype=dt)
        assert route(big, big[:, :1].contiguous(),
                     big[:, :1].contiguous()) == "simt"
        assert route(big, big[:, :1].float(), big[:, :1].float()) == "simt"
        ok = torch.zeros(1, 2, 16, 128, dtype=dt)
        assert route(ok, ok, ok) == "wgmma"


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


def _tf32x3_emulation(q, k, v, causal, products=3, bn=32):
    """The 3xTF32 route of ``csrc/flash_attention.cu`` in plain torch, for
    the tests only: each operand split into TF32 parts, the scores
    ``q_lo k_hi + q_hi k_lo + q_hi k_hi`` (each product exact in f32,
    summed in f64, rounded to f32) times ``scale * log2(e)``; an online
    softmax in base 2 over tiles of ``bn`` kv rows from a running max of
    -1e30; P split the same way and ``P_lo V_hi + P_hi V_lo + P_hi V_hi``
    added to the f32 accumulator a tile at a time; ``acc / max(l,
    1e-30)`` rounded once to q's dtype.  ``products=1`` keeps ``hi . hi``
    alone: one TF32 product."""
    b, h, s, d = q.shape
    group = h // k.shape[1]

    def prod(a, bt):
        ah, al = (t.double() for t in _tf32_parts(a))
        bh, bl = (t.double() for t in _tf32_parts(bt))
        out = ah @ bh
        if products == 3:
            out = out + al @ bh + ah @ bl
        return out.float()

    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scale2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) \
        * torch.tensor(1.44269504088896341, dtype=torch.float32)
    x = prod(q.float(), kf.transpose(-1, -2)) * scale2
    if causal:
        rows = torch.arange(s)
        x = x.masked_fill(rows[None, :] > rows[:, None], float("-inf"))
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    for k0 in range(0, s, bn):
        tile = x[..., k0:k0 + bn]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        p = torch.exp2(tile - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        acc = acc * alpha + prod(p, vf[..., k0:k0 + bn, :])
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


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
