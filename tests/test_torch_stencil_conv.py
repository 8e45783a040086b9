"""The port's ``stencil_conv`` (K6) twin against the reference.

``repro_torch.kernels.stencil_conv.stencil_conv_torch`` against
``repro.kernels.ref.stencil_conv_ref`` bit for bit (both sum the taps
from 0 in ``di``-outer, ``dj``-inner order as separate multiplies and
adds), and against the Pallas kernel (``repro.kernels.stencil_conv``, in
interpret mode on the CPU) at ``rtol=1e-5, atol=1e-6 * max|ref|``: the
Pallas kernel's own sums differ from ``stencil_conv_ref`` by up to ~2e-7
of the output's magnitude.  Shapes and stencil sizes are those of
``tests/test_kernels.py`` plus a 3 x 5 stencil.

f16 and bf16 frames take the reference's two arithmetics:
``ops.stencil_conv(use_pallas=True)`` sums in f32 as the Pallas kernel
does and is held to it within one unit in the last place of the output
dtype (plus the f32 tolerance above); ``use_pallas=False`` sums in the
promoted dtype as ``stencil_conv_ref`` does and equals it bit for bit.

For a CPU tensor the wrapper runs the twin (at f32 accumulation) and
counts a twin call; the CUDA kernel is held against that twin bit for bit
on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels import stencil_conv as ref_stencil

SHAPES = [(32, 48), (64, 96), (100, 140)]
JAX_DTYPE = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16,
             torch.float32: jnp.float32}
STENCILS = [(2, 2), (3, 3), (5, 5), (3, 5)]


def _case(shape, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=k).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", STENCILS)
def test_twin_bit_equal_to_oracle(shape, k):
    from repro_torch.kernels.stencil_conv import stencil_conv_torch
    img, ker = _case(shape, k, seed=shape[0] + 10 * k[0] + k[1])
    want = np.asarray(ref.stencil_conv_ref(jnp.asarray(img),
                                           jnp.asarray(ker)))
    got = stencil_conv_torch(torch.from_numpy(img),
                             torch.from_numpy(ker)).numpy()
    assert got.shape == (shape[0] - k[0] + 1, shape[1] - k[1] + 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", STENCILS)
def test_twin_matches_reference_kernel(shape, k):
    from repro_torch.kernels.stencil_conv import stencil_conv_torch
    img, ker = _case(shape, k, seed=7 * shape[1] + k[0] * k[1])
    want = np.asarray(ref_stencil(jnp.asarray(img), jnp.asarray(ker)))
    got = stencil_conv_torch(torch.from_numpy(img),
                             torch.from_numpy(ker)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


def test_twin_promotes_like_the_oracle():
    """An f16 image against f32 taps accumulates in f32 and returns f16,
    as ``stencil_conv_ref`` promotes."""
    from repro_torch.kernels.stencil_conv import stencil_conv_torch
    img, ker = _case((20, 24), (3, 3), seed=2)
    img16 = img.astype(np.float16)
    want = np.asarray(ref.stencil_conv_ref(jnp.asarray(img16),
                                           jnp.asarray(ker)))
    got = stencil_conv_torch(torch.from_numpy(img16), torch.from_numpy(ker))
    assert got.dtype == torch.float16
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_on_cpu_runs_the_twin_and_checks_its_input():
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_conv as fn
    from repro_torch.kernels.stencil_conv import COUNTS, reset_counts
    img, ker = _case((12, 10), (3, 3), seed=1)
    reset_counts()
    out = fn(torch.from_numpy(img), torch.from_numpy(ker))
    assert COUNTS == {"kernel_launches": 0, "twin_calls": 1}
    assert tuple(out.shape) == (10, 8)
    ops.stencil_conv(torch.from_numpy(img), torch.from_numpy(ker),
                     use_pallas=False)
    assert COUNTS == {"kernel_launches": 0, "twin_calls": 2}
    with pytest.raises(ValueError, match="2-D"):
        fn(torch.zeros(12), torch.zeros(3, 3))
    with pytest.raises(ValueError, match="no 'valid' output"):
        fn(torch.zeros(4, 4), torch.zeros(5, 3))
    with pytest.raises(ValueError, match="float32"):
        fn(torch.zeros(8, 8, dtype=torch.float64), torch.zeros(3, 3))
    with pytest.raises(ValueError, match="float32"):
        fn(torch.zeros(8, 8), torch.zeros(3, 3, dtype=torch.int32))
    assert COUNTS["twin_calls"] == 2


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16],
                         ids=["float16", "bfloat16"])
@pytest.mark.parametrize("taps_f32", [False, True])
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("shape,k", [((64, 96), (3, 3)),
                                     ((100, 140), (3, 5))])
def test_half_frames_follow_each_reference_route(shape, k, use_pallas,
                                                 taps_f32, dtype):
    from repro_torch.kernels import ops
    from repro_torch.testing import ulp
    from repro.kernels import ops as ref_ops
    img, ker = _case(shape, k, seed=shape[0] + k[1] + 3 * taps_f32)
    img_t = torch.from_numpy(img).to(dtype)
    ker_t = torch.from_numpy(ker).to(torch.float32 if taps_f32 else dtype)
    img_j = jnp.asarray(img_t.float().numpy()).astype(JAX_DTYPE[dtype])
    ker_j = jnp.asarray(ker_t.float().numpy()).astype(
        JAX_DTYPE[ker_t.dtype])
    got = ops.stencil_conv(img_t, ker_t, use_pallas=use_pallas)
    want = np.asarray(ref_ops.stencil_conv(img_j, ker_j,
                                           use_pallas=use_pallas)
                      .astype(jnp.float32))
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    got = got.float().numpy()
    if use_pallas:
        both = np.maximum(np.abs(got), np.abs(want))
        bound = ulp(torch.from_numpy(both), dtype).numpy() \
            + 1e-6 * float(np.abs(want).max())
        assert (np.abs(got - want) <= bound).all()
    else:
        np.testing.assert_array_equal(got, want)


def test_pallas_route_sums_in_f32():
    """An f16 frame against f16 taps: the wrapper's (Pallas) route sums in
    f32 and rounds once, the oracle route rounds every partial sum to
    f16; each is its own twin's arithmetic."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.stencil_conv import stencil_conv_torch
    img, ker = _case((40, 50), (5, 5), seed=11)
    img_t = torch.from_numpy(img).half()
    ker_t = torch.from_numpy(ker).half()
    f32 = stencil_conv_torch(img_t.float(), ker_t.float()).half()
    assert torch.equal(ops.stencil_conv(img_t, ker_t), f32)
    promoted = stencil_conv_torch(img_t, ker_t)
    assert torch.equal(ops.stencil_conv(img_t, ker_t, use_pallas=False),
                       promoted)
    assert not torch.equal(f32, promoted)
