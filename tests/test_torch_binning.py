"""The port's ``binning`` (K5) twin against the reference kernel.

``repro_torch.kernels.binning.binning_torch`` against
``repro.kernels.binning`` (the Pallas kernel, in interpret mode on the
CPU, as ``tests/test_kernels.py`` runs it) on the same seeded frames.
f32 is bit-equal: both sum each window from 0 row by row and multiply by
``f32(1 / factor**2)``.  f16 holds at the reference test's rtol 5e-3 (the
f32 accumulator is rounded to f16 at one place in each), bf16 at
``atol = rtol = 1e-2`` (one bf16 rounding), on both ``use_pallas``
routes.

Shapes also straddle the card's vec2 route (outputs of V - 1, V and
V + 1 columns for its 2 f32 or 4 f16/bf16 outputs a thread, and of
2V - 1, 2V, 2V + 1) and take the functional path's 400 x 640 and
720 x 1280 frames.

For a CPU tensor the wrapper runs the twin and counts a twin call; the
CUDA kernels are held against the twin bit for bit on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``), on the route
that :func:`plan` picks (tested here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import binning as ref_binning
from repro.kernels import ref


def _img(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


@pytest.mark.parametrize("shape", [(32, 64), (64, 96), (120, 160), (17, 33),
                                   (9, 6), (10, 10), (17, 14), (16, 18),
                                   (400, 640), (720, 1280)])
@pytest.mark.parametrize("factor", [2, 3, 4])
def test_twin_bit_equal_to_reference_kernel(shape, factor):
    from repro_torch.kernels.binning import binning_torch
    img = _img(shape, seed=shape[0] * factor)
    want = np.asarray(ref_binning(jnp.asarray(img), factor=factor))
    got = binning_torch(torch.from_numpy(img), factor).numpy()
    assert got.shape == (shape[0] // factor, shape[1] // factor)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(8, 8), (16, 16)])
def test_twin_where_the_reference_sums_pairwise(shape):
    """At frames 8 and 16 columns wide the reference kernel's CPU lowering
    (XLA, interpret mode) sums each 2 x 2 window pairwise, ``(a + b) +
    (c + d)``; the twin keeps the CUDA kernel's order, row by row from 0.
    Each is exact to its order, and the two agree within 4 units in the
    last place of the window's mean of magnitudes."""
    from repro_torch.kernels.binning import binning_torch
    img = _img(shape, seed=shape[1] * 2)
    want = np.asarray(ref_binning(jnp.asarray(img), factor=2))
    got = binning_torch(torch.from_numpy(img), 2).numpy()
    a, b = img[0::2, 0::2], img[0::2, 1::2]
    c, d = img[1::2, 0::2], img[1::2, 1::2]
    quarter = np.float32(0.25)
    np.testing.assert_array_equal(want, ((a + b) + (c + d)) * quarter)
    np.testing.assert_array_equal(
        got, ((((np.float32(0) + a) + b) + c) + d) * quarter)
    mags = (np.abs(a) + np.abs(b) + np.abs(c) + np.abs(d)) * quarter
    assert (np.abs(got - want) <= 4 * np.spacing(mags)).all()


@pytest.mark.parametrize("factor", [2, 4])
def test_twin_f16_matches_reference_kernel(factor):
    from repro_torch.kernels.binning import binning_torch
    img = _img((32, 64), seed=7, dtype=np.float16)
    want = np.asarray(ref_binning(jnp.asarray(img), factor=factor))
    got = binning_torch(torch.from_numpy(img), factor)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.numpy().astype(np.float32),
                               want.astype(np.float32), rtol=5e-3,
                               atol=5e-3)


def test_twin_window_order():
    """Each window sums from 0 row by row, then one multiply by
    ``f32(1/9)``: the order the CUDA kernel keeps, bit for bit."""
    from repro_torch.kernels.binning import binning_torch
    img = _img((17, 33), seed=3)
    acc = np.zeros((5, 11), np.float32)
    for di in range(3):
        for dj in range(3):
            acc = acc + img[di:15:3, dj:33:3]
    want = acc * np.float32(1.0 / 9.0)
    np.testing.assert_array_equal(
        binning_torch(torch.from_numpy(img), 3).numpy(), want)


def test_oracle_route_takes_batch_dims():
    """``use_pallas=False`` takes leading batch dims, as
    ``ref.binning_ref`` does; each frame is the 2-D result."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.binning import binning_torch
    frames = _img((3, 20, 30), seed=5)
    got = ops.binning(torch.from_numpy(frames), 2, use_pallas=False)
    assert tuple(got.shape) == (3, 10, 15)
    for i in range(3):
        assert torch.equal(got[i], binning_torch(torch.from_numpy(frames[i])))
    want = np.asarray(ref.binning_ref(jnp.asarray(frames), 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_wrapper_on_cpu_runs_the_twin_and_checks_its_input():
    from repro_torch.kernels import binning as fn
    from repro_torch.kernels.binning import COUNTS, reset_counts
    reset_counts()
    out = fn(torch.from_numpy(_img((9, 12), seed=1)), 3)
    assert COUNTS == {"kernel_launches": 0, "vec2_launches": 0,
                      "scalar_launches": 0, "twin_calls": 1}
    assert tuple(out.shape) == (3, 4)
    with pytest.raises(ValueError, match="2-D"):
        fn(torch.zeros(2, 8, 8))
    with pytest.raises(ValueError, match="float32, float16 or bfloat16"):
        fn(torch.zeros(8, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="positive int"):
        fn(torch.zeros(8, 8), 0)
    assert COUNTS["twin_calls"] == 1


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("factor", [2, 3, 4])
def test_bf16_follows_each_reference_route(factor, use_pallas):
    from repro_torch.kernels import ops
    from repro.kernels import ops as ref_ops
    img = torch.from_numpy(_img((33, 47), seed=factor)).to(torch.bfloat16)
    want = ref_ops.binning(jnp.asarray(img.float().numpy()).astype(
        jnp.bfloat16), factor, use_pallas=use_pallas)
    got = ops.binning(img, factor, use_pallas=use_pallas)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16],
                         ids=["float16", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 14), (16, 16), (16, 18), (31, 33),
                                   (400, 640), (720, 1280)])
def test_twin_half_matches_reference_kernel(shape, dtype):
    """f16 and bf16 frames at factor 2 around the vec2 route's 4 outputs
    a thread (and twice that) and at the path's frames: within one
    rounding of the dtype, the tolerances of the f16 and bf16 tests
    above."""
    from repro_torch.kernels.binning import binning_torch
    img = torch.from_numpy(_img(shape, seed=shape[1])).to(dtype)
    jdt = jnp.float16 if dtype == torch.float16 else jnp.bfloat16
    want = ref_binning(jnp.asarray(img.float().numpy()).astype(jdt), factor=2)
    got = binning_torch(img, 2)
    assert got.dtype == dtype
    tol = 5e-3 if dtype == torch.float16 else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


F32, F16, BF16 = torch.float32, torch.float16, torch.bfloat16


@pytest.mark.parametrize("w,factor,dtype,aligned,want", [
    (1280, 2, F32, True, "vec2"),         # the path's frames
    (640, 2, F32, True, "vec2"),
    (1280, 2, BF16, True, "vec2"),
    (1280, 2, F32, False, "scalar"),      # an offset view
    (1282, 2, F32, True, "scalar"),       # rows of 5128 bytes
    (1284, 2, F32, True, "vec2"),         # output rows of 2568 bytes
    (1300, 2, F16, True, "scalar"),       # rows of 2600 bytes
    (1304, 2, F16, True, "vec2"),
    (1280, 3, F32, True, "scalar"),
    (1280, 4, BF16, True, "scalar")])
def test_plan_picks_the_route(w, factor, dtype, aligned, want):
    from repro_torch.kernels.binning import COUNTS, plan
    assert plan(w, factor, dtype, aligned) == want
    assert f"{want}_launches" in COUNTS
