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

Also: the wrapper's split-K plan, the ``ops`` contract (no TPU block
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
    ((1, 2, 900), True, 3),           # its second layer
    ((1024, 1024, 1024), False, 1),   # enough tiles: no split
    ((130, 70, 150), False, 1),       # K too shallow to split
    ((8, 64, 4096), True, 16),
    ((9, 64, 4096), False, 16),
])
def test_split_plan(mnk, skinny, splits):
    """K is split only while tiles leave SMs idle, into slices of at
    least 256 rows, a multiple of 16, covering K exactly once."""
    from repro_torch.kernels.matmul import split_plan
    m, n, k = mnk
    got_skinny, got_splits, depth = split_plan(m, n, k, sms=132)
    assert (got_skinny, got_splits) == (skinny, splits)
    assert depth % 16 == 0 and (got_splits - 1) * depth < k <= \
        got_splits * depth
    assert got_splits == 1 or depth >= 256


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
    assert COUNTS == {"kernel_launches": 0, "twin_calls": 1}
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
