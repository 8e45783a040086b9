"""The port's ``category_reduce`` (K4) twin against the reference kernel.

``repro_torch.kernels.category_reduce.category_reduce_torch`` against
``repro.kernels.category_reduce`` (the Pallas kernel, in interpret mode
on the CPU, as ``tests/test_sweep.py`` runs it) on the same seeded
``[B, U]`` energies and ``[U, C]`` weights, for ragged ``B`` (not a
multiple of the reference's block) and every ``U`` from 1 to 11.
Tolerance rel 1e-6: the weights are the evaluators' 0/1 category
columns, so every product is exact and only the summation order (the
reference's dot against the twin's unit order) can differ.

For a CPU tensor the wrapper runs the twin and counts a twin call; the
CUDA kernel is held against the twin bit for bit on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

REL = 1e-6


def _case(b, u, c, seed):
    rng = np.random.default_rng(seed)
    e = rng.uniform(1e-12, 1e-6, size=(b, u)).astype(np.float32)
    w = (rng.uniform(size=(u, c)) > 0.5).astype(np.float32)
    w[:, -2] = 1.0                         # a total column, as the evaluator
    return e, w


@pytest.mark.parametrize("u", list(range(1, 12)))
def test_twin_matches_reference_kernel(u):
    import jax.numpy as jnp
    from repro.kernels import category_reduce as ref_reduce
    from repro_torch.kernels.category_reduce import category_reduce_torch
    for b in (1, 533, 2049):               # ragged against the 2048 block
        e, w = _case(b, u, 10, seed=100 * u + b)
        ref = np.asarray(ref_reduce(jnp.asarray(e), jnp.asarray(w)))
        ours = category_reduce_torch(torch.from_numpy(e),
                                     torch.from_numpy(w)).numpy()
        assert ours.shape == ref.shape == (b, 10)
        np.testing.assert_allclose(ours, ref, rtol=REL, atol=0)


def test_twin_sums_units_in_order():
    """``out[:, c]`` is the running sum over units in order, bit for bit
    (the order the CUDA kernel keeps)."""
    from repro_torch.kernels.category_reduce import category_reduce_torch
    e, w = _case(257, 7, 4, seed=3)
    acc = np.zeros((257, 4), np.float32)
    for u in range(7):
        acc = acc + e[:, u:u + 1] * w[u][None, :]
    ours = category_reduce_torch(torch.from_numpy(e),
                                 torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(ours, acc)


def test_wrapper_on_cpu_runs_the_twin():
    from repro_torch.kernels import category_reduce as fn
    from repro_torch.kernels.category_reduce import COUNTS, reset_counts
    e, w = _case(9, 3, 5, seed=1)
    reset_counts()
    out = fn(torch.from_numpy(e), torch.from_numpy(w))
    assert COUNTS == {"kernel_launches": 0, "twin_calls": 1}
    assert tuple(out.shape) == (9, 5)
    with pytest.raises(ValueError, match=r"\[B, U\] @ \[U, C\]"):
        fn(torch.zeros(4, 3), torch.zeros(2, 5))
