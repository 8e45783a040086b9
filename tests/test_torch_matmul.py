"""The port's ``matmul`` (K8) twin against the reference kernel.

``repro_torch.kernels.matmul.matmul_torch`` against
``repro.kernels.matmul`` (the Pallas kernel, in interpret mode on the
CPU, with ``tests/test_kernels.py``'s blocks) at the reference test's
shapes plus ``(1, 4000, 90)``, a narrow cut of the Ed-Gaze DNN's
``(1, 64000, 900)``.  The two sum over K in different orders, so they are
held elementwise to ``|twin - ref| <= 1e-5 * (|a| @ |b|)``, a bound on
the f32 rounding of any summation order at these depths.

f16 and bf16 operands (each side its own dtype, the output in ``a``'s,
as the reference allows) go through both ``use_pallas`` routes against
the reference's: both accumulate in f32, so they are held to the rule
plus one unit in the last place of the output dtype (each side rounds
its f32 sum once).

Also: the wrapper's route plan (wgmma / tile / skinny, tile width, split
K, one launch for small products), a numpy emulation of the tensor cores'
truncating f32 accumulation that shows why the wgmma kernel promotes each
64-deep tile's sums with an IEEE add, the ``ops`` contract (no TPU block
keywords), and the CPU wrapper's twin call.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import matmul as ref_matmul
from repro.kernels import ref

RULE = 1e-5


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


JAX_DTYPE = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16,
             torch.float32: jnp.float32}


def _assert_rule(got, want, a, b):
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert got.shape == want.shape
    assert (err <= RULE * scale).all(), float((err / (RULE * scale)).max())


@pytest.mark.parametrize("mkn", [(64, 64, 64), (130, 70, 150), (16, 256, 8),
                                 (1, 64, 1), (1, 4000, 90)])
def test_twin_matches_reference_kernel(mkn):
    from repro_torch.kernels.matmul import matmul_torch
    m, k, n = mkn
    a, b = _operands(m, k, n, seed=m + k + n)
    blocks = {} if mkn == (1, 4000, 90) else dict(bm=64, bn=64, bk=32)
    want = np.asarray(ref_matmul(jnp.asarray(a), jnp.asarray(b), **blocks))
    got = matmul_torch(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    _assert_rule(got, want, a, b)


def test_twin_matches_oracle():
    from repro_torch.kernels.matmul import matmul_torch
    a, b = _operands(96, 64, 80, seed=3)
    want = np.asarray(ref.matmul_ref(jnp.asarray(a), jnp.asarray(b)))
    got = matmul_torch(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    _assert_rule(got, want, a, b)


def test_twin_slices_long_k():
    """Products deeper than one slice of the twin's broadcast buffer sum
    across slices (K = 5000 at N = 4000 takes 5 slices)."""
    from repro_torch.kernels.matmul import matmul_torch
    a, b = _operands(1, 5000, 4000, seed=8)
    got = matmul_torch(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = (a.astype(np.float64) @ b.astype(np.float64))
    _assert_rule(got, want, a, b)


@pytest.mark.parametrize("mnk,skinny,splits", [
    ((1, 900, 64000), True, 66),      # the Ed-Gaze DNN's first layer
    ((1, 2, 900), True, 1),           # its second layer: one launch
    ((1024, 1024, 1024), False, 3),   # 128 tiles: 3 slices fill the card
    ((130, 70, 150), False, 1),       # K too shallow to split
    ((8, 64, 4096), True, 16),
    ((9, 64, 4096), False, 16),
])
def test_split_plan(mnk, skinny, splits):
    """K is split only while the blocks leave SMs idle, into slices of at
    least 256 rows, a multiple of 16, covering K exactly once; a product
    of fewer than 2^20 multiply-adds is never split (f32 operands)."""
    from repro_torch.kernels.matmul import plan
    m, n, k = mnk
    f32 = torch.float32
    got = plan(m, n, k, f32, f32, aligned=True, sms=132)
    assert (got.route == "skinny", got.splits) == (skinny, splits)
    depth = got.depth
    assert depth % 16 == 0 and (got.splits - 1) * depth < k <= \
        got.splits * depth
    assert got.splits == 1 or depth >= 256


F16, BF16, F32 = torch.float16, torch.bfloat16, torch.float32


@pytest.mark.parametrize("mnk,dtypes,aligned,want", [
    # half operands of one dtype, aligned, K and N multiples of 8: wgmma
    ((1024, 1024, 1024), (BF16, BF16), True, ("wgmma", 64, 1)),
    ((1024, 1024, 1024), (F16, F16), True, ("wgmma", 64, 1)),
    ((4096, 4096, 4096), (BF16, BF16), True, ("wgmma", 128, 1)),
    ((1000, 4104, 200), (BF16, BF16), True, ("wgmma", 128, 1)),
    ((130, 1000, 72), (F16, F16), True, ("wgmma", 64, 1)),
    ((9, 4096, 1024), (F16, F16), True, ("wgmma", 64, 3)),
    ((256, 256, 16384), (BF16, BF16), True, ("wgmma", 64, 16)),
    # anything else with M > 8: the FP32 tile
    ((1024, 1024, 1024), (F32, F32), True, ("tile", 64, 3)),
    ((4096, 4096, 4096), (F32, F32), True, ("tile", 128, 1)),
    ((1024, 1024, 1024), (BF16, F32), True, ("tile", 64, 3)),
    ((1024, 1024, 1024), (BF16, F16), True, ("tile", 64, 3)),
    ((1024, 1024, 1024), (BF16, BF16), False, ("tile", 64, 3)),
    ((9, 64, 4100), (F16, F16), True, ("tile", 64, 16)),      # K % 8
    ((9, 60, 4096), (F16, F16), True, ("tile", 64, 16)),      # N % 8
    ((64, 3, 0), (F16, F16), True, ("tile", 64, 1)),          # K = 0
    ((100, 100, 100), (F32, F32), True, ("tile", 64, 1)),     # one launch
    # M <= 8: the skinny kernel
    ((8, 64, 4096), (F16, F16), True, ("skinny", 128, 16)),
    ((1, 900, 64000), (BF16, BF16), True, ("skinny", 128, 66)),
    ((1, 2, 900), (F32, F32), True, ("skinny", 128, 1)),      # one launch
], ids=str)
def test_route_plan(mnk, dtypes, aligned, want):
    """The route from the dtypes, the alignment and K, N modulo 8; 64
    output columns a block where 128-wide tiles would be fewer than the
    SMs; K split only while the blocks number fewer than the SMs (wgmma:
    half of them) and the product has 2^20 multiply-adds or more; slices
    a multiple of 64 (wgmma) or 16 deep."""
    from repro_torch.kernels.matmul import plan, route
    m, n, k = mnk
    got = plan(m, n, k, *dtypes, aligned=aligned, sms=132)
    assert (got.route, got.tile_n, got.splits) == want
    assert got.route == route(m, n, k, *dtypes, aligned)
    unit = 64 if got.route == "wgmma" else 16
    assert got.depth % unit == 0
    assert (got.splits - 1) * got.depth < max(k, 1) <= got.splits * got.depth
    if m * n * k < 1 << 20:
        assert got.splits == 1


# ---------------------------------------------------------------------------
# the tensor cores' accumulation, emulated on the CPU
# ---------------------------------------------------------------------------
def _round_toward_zero(x):
    """f64 values to f32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _tensor_core_emulation(a, b, promote):
    """The wgmma route's f32 sums in numpy, for the tests only: each k16
    step adds its 16 exact products (half operands multiply exactly) to the
    f32 accumulator and rounds toward zero, as Hopper's tensor cores
    truncate.  ``promote``: each 64-deep tile's four steps start from zero
    and the tile's sum is added to the running f32 sums with one IEEE
    (round-to-nearest) add, as ``matmul_wgmma_kernel`` does."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    part = acc
    for k0 in range(0, a.shape[1], 16):
        prod = a64[:, k0:k0 + 16] @ b64[k0:k0 + 16]
        if not promote:
            acc = _round_toward_zero(acc.astype(np.float64) + prod)
            continue
        first = k0 % 64 == 0
        part = _round_toward_zero(prod if first else
                                  part.astype(np.float64) + prod)
        if k0 % 64 == 48 or k0 + 16 >= a.shape[1]:
            acc = (acc + part).astype(np.float32)
    return acc


def _positive_halves(m, k, n, seed, dtype):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(size=(m, k)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(size=(k, n)).astype(np.float32))
    return a.to(dtype).float().numpy(), b.to(dtype).float().numpy()


@pytest.mark.parametrize("dtype", [BF16, F16], ids=str)
def test_truncating_accumulation_needs_the_promotion(dtype):
    """At K = 16384 with positive half operands, truncating every k16 step
    of one f32 accumulator drifts past the K8 rule against the twin's f32
    sums, while a fresh accumulator per 64-deep tile, promoted with an
    IEEE add, stays within it: why the wgmma kernel promotes."""
    from repro_torch.kernels.matmul import matmul_torch
    a, b = _positive_halves(4, 16384, 16, 5, dtype)
    twin = matmul_torch(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    rule = RULE * (a.astype(np.float64) @ b.astype(np.float64))

    def over_rule(got):
        return float((np.abs(got.astype(np.float64) - twin) / rule).max())

    assert over_rule(_tensor_core_emulation(a, b, promote=False)) > 1.0
    assert over_rule(_tensor_core_emulation(a, b, promote=True)) <= 1.0


def test_promotion_emulation_is_exact_on_short_k():
    """One k16 step of small integers is exact under either accumulation,
    and a ragged last tile (K = 80) is added once."""
    rng = np.random.default_rng(2)
    a = rng.integers(0, 8, (3, 80)).astype(np.float32)
    b = rng.integers(0, 8, (80, 5)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    for promote in (False, True):
        np.testing.assert_array_equal(
            _tensor_core_emulation(a, b, promote), want)


def test_ops_matmul_takes_no_block_keywords():
    from repro_torch.kernels import ops
    a, b = (torch.from_numpy(x) for x in _operands(4, 8, 3, seed=1))
    with pytest.raises(TypeError):
        ops.matmul(a, b, bm=64)
    with pytest.raises(TypeError):
        ops.matmul(a, b, bk=32, use_pallas=False)


def test_wrapper_on_cpu_runs_the_twin_and_checks_its_input():
    from repro_torch.kernels import matmul as fn
    from repro_torch.kernels.matmul import COUNTS, reset_counts
    a, b = (torch.from_numpy(x) for x in _operands(3, 5, 2, seed=2))
    reset_counts()
    out = fn(a, b)
    assert COUNTS == {"kernel_launches": 0, "wgmma_launches": 0,
                      "tile_launches": 0, "skinny_launches": 0,
                      "twin_calls": 1}
    assert tuple(out.shape) == (3, 2)
    with pytest.raises(ValueError, match=r"\[M, K\] @ \[K, N\]"):
        fn(torch.zeros(3, 5), torch.zeros(4, 2))
    with pytest.raises(ValueError, match="float32"):
        fn(torch.zeros(3, 5, dtype=torch.float64), torch.zeros(5, 2))
    assert COUNTS["twin_calls"] == 1


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("dtypes", [
    (torch.float16, torch.float16), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float16, torch.float32),
    (torch.float32, torch.bfloat16)], ids=lambda d: f"{d[0]}@{d[1]}"[6:])
@pytest.mark.parametrize("mkn", [(130, 70, 150), (1, 4000, 90)])
def test_half_operands_follow_each_reference_route(mkn, dtypes, use_pallas):
    from repro_torch.kernels import ops
    from repro_torch.testing import ulp
    from repro.kernels import ops as ref_ops
    m, k, n = mkn
    a, b = _operands(m, k, n, seed=m + n + len(str(dtypes)))
    a_t, b_t = torch.from_numpy(a).to(dtypes[0]), torch.from_numpy(b).to(
        dtypes[1])
    a_j = jnp.asarray(a_t.float().numpy()).astype(JAX_DTYPE[dtypes[0]])
    b_j = jnp.asarray(b_t.float().numpy()).astype(JAX_DTYPE[dtypes[1]])
    blocks = dict(bm=64, bn=64, bk=32) if use_pallas and m > 1 else {}
    want = np.asarray(ref_ops.matmul(a_j, b_j, use_pallas=use_pallas,
                                     **blocks).astype(jnp.float32))
    got = ops.matmul(a_t, b_t, use_pallas=use_pallas)
    assert got.dtype == dtypes[0] and tuple(got.shape) == want.shape
    got = got.float().numpy()
    scale = (np.abs(a_t.double().numpy()) @ np.abs(b_t.double().numpy()))
    both = np.maximum(np.abs(got), np.abs(want))
    bound = RULE * scale + (ulp(torch.from_numpy(both), dtypes[0]).numpy()
                            if dtypes[0] != torch.float32 else 0.0)
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= bound).all(), float((err / bound).max())
