"""The port's ``binning`` (K5) twin against the reference kernel.

``repro_torch.kernels.binning.binning_torch`` against
``repro.kernels.binning`` (the Pallas kernel, in interpret mode on the
CPU, as ``tests/test_kernels.py`` runs it) on the same seeded frames.
f32 is bit-equal: both sum each window from 0 row by row and multiply by
``f32(1 / factor**2)``.  f16 holds at the reference test's rtol 5e-3 (the
f32 accumulator is rounded to f16 at one place in each).

For a CPU tensor the wrapper runs the twin and counts a twin call; the
CUDA kernel is held against the twin bit for bit on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import binning as ref_binning
from repro.kernels import ref


def _img(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


@pytest.mark.parametrize("shape", [(32, 64), (64, 96), (120, 160), (17, 33)])
@pytest.mark.parametrize("factor", [2, 3, 4])
def test_twin_bit_equal_to_reference_kernel(shape, factor):
    from repro_torch.kernels.binning import binning_torch
    img = _img(shape, seed=shape[0] * factor)
    want = np.asarray(ref_binning(jnp.asarray(img), factor=factor))
    got = binning_torch(torch.from_numpy(img), factor).numpy()
    assert got.shape == (shape[0] // factor, shape[1] // factor)
    np.testing.assert_array_equal(got, want)


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
    assert COUNTS == {"kernel_launches": 0, "twin_calls": 1}
    assert tuple(out.shape) == (3, 4)
    with pytest.raises(ValueError, match="2-D"):
        fn(torch.zeros(2, 8, 8))
    with pytest.raises(ValueError, match="float32 or float16"):
        fn(torch.zeros(8, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="positive int"):
        fn(torch.zeros(8, 8), 0)
    assert COUNTS["twin_calls"] == 1
