"""The port's ``frame_event`` (K7) twin against the reference kernel.

``repro_torch.kernels.frame_event.frame_event_torch`` against
``repro.kernels.frame_event`` (the Pallas kernel, in interpret mode on the
CPU) and ``repro.kernels.ref.frame_event_ref``: exact, at the reference
test's shapes and thresholds, in f16, on the f32 rounding case
``cur = f32(0.7), prev = 0, threshold = 0.7`` (an event in f32, none in
f64) and on NaN (no event).

For a CPU tensor the wrapper runs the twin and counts a twin call; the
CUDA kernel is held against the twin bit for bit on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import frame_event as ref_event
from repro.kernels import ref


def _pair(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(dtype),
            rng.normal(size=shape).astype(dtype))


def _both(cur, prev, threshold):
    want = np.asarray(ref_event(jnp.asarray(cur), jnp.asarray(prev),
                                threshold=threshold))
    oracle = np.asarray(ref.frame_event_ref(jnp.asarray(cur),
                                            jnp.asarray(prev), threshold))
    return want, oracle


@pytest.mark.parametrize("shape", [(64, 96), (33, 47)])
@pytest.mark.parametrize("threshold", [0.1, 0.5, 1.5])
def test_twin_equals_reference_kernel(shape, threshold):
    from repro_torch.kernels.frame_event import frame_event_torch
    cur, prev = _pair(shape, seed=shape[1] + int(10 * threshold))
    want, oracle = _both(cur, prev, threshold)
    got = frame_event_torch(torch.from_numpy(cur), torch.from_numpy(prev),
                            threshold)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), oracle)


def test_twin_f16_equals_reference_kernel():
    from repro_torch.kernels.frame_event import frame_event_torch
    cur, prev = _pair((33, 47), seed=4, dtype=np.float16)
    want, _ = _both(cur, prev, 0.5)
    got = frame_event_torch(torch.from_numpy(cur), torch.from_numpy(prev),
                            0.5)
    assert got.dtype == torch.float16
    np.testing.assert_array_equal(got.numpy(), want)


def test_threshold_compares_in_float32():
    from repro_torch.kernels import frame_event as fn
    cur = np.float32([[0.7, 0.69999]])
    prev = np.zeros((1, 2), np.float32)
    want, oracle = _both(cur, prev, 0.7)
    np.testing.assert_array_equal(want, [[1.0, 0.0]])
    np.testing.assert_array_equal(oracle, want)
    got = fn(torch.from_numpy(cur), torch.from_numpy(prev), 0.7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_nan_gives_no_event():
    from repro_torch.kernels import frame_event as fn
    cur = np.float32([[np.nan, 1.0, np.inf]])
    prev = np.float32([[0.0, np.nan, np.inf]])
    want, _ = _both(cur, prev, 0.1)
    got = fn(torch.from_numpy(cur), torch.from_numpy(prev), 0.1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), [[0.0, 0.0, 0.0]])


def test_wrapper_on_cpu_runs_the_twin_and_checks_its_input():
    from repro_torch.kernels import frame_event as fn
    from repro_torch.kernels.frame_event import COUNTS, reset_counts
    cur, prev = _pair((6, 5), seed=1)
    reset_counts()
    out = fn(torch.from_numpy(cur), torch.from_numpy(prev), 0.3)
    assert COUNTS == {"kernel_launches": 0, "twin_calls": 1}
    assert tuple(out.shape) == (6, 5)
    with pytest.raises(ValueError, match="one shape"):
        fn(torch.zeros(6, 5), torch.zeros(5, 6))
    with pytest.raises(ValueError, match="2-D"):
        fn(torch.zeros(2, 6, 5), torch.zeros(2, 6, 5))
    with pytest.raises(ValueError, match="one dtype"):
        fn(torch.zeros(6, 5), torch.zeros(6, 5, dtype=torch.float16))
    assert COUNTS["twin_calls"] == 1
