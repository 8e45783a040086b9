"""Int8 cross-pod gradient compression of the port against the
reference's (``repro_torch.distributed.compression`` against
``repro.distributed.compression``).

* ``quantize_int8`` / ``dequantize_int8`` bit for bit with the
  reference's on linspace, random, all-zero and huge-range inputs, f32
  and bf16 (``torch.round`` and ``jnp.round`` both round half to even);
* the round trip within one LSB, and the one-pod reduction the identity
  within one LSB with the residual kept (mirrors of
  ``tests/test_runtime.py``'s compression tests), on a one-rank gloo
  group in this process;
* no ``pod`` axis: the trees come back as they were;
* four gloo ranks, a ``pod`` x ``data`` mesh of 2 x 2, a different
  gradient tree on each (f32, bf16, a DTensor leaf sharded over
  ``data``, one sharded over ``pod`` and ``data`` as ``fsdp`` places a
  matrix), reduced twice with error feedback: every output equal to a
  numpy oracle of the reference's formula on the whole leaf, as the
  reference's ``shard_map`` sees it (int32 sum of the int8 payloads,
  the mean of the scales, the residual kept).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.distributed.compression import dequantize_int8 as r_dequantize
from repro.distributed.compression import quantize_int8 as r_quantize
from repro_torch.distributed import (cross_pod_grad_reduce, dequantize_int8,
                                     quantize_int8)
from repro_torch.launch import LMMesh, make_mesh

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"


def _cases():
    rng = np.random.default_rng(0)
    yield "linspace", np.linspace(-3, 3, 101, dtype=np.float32)
    yield "random", rng.standard_normal((64, 129)).astype(np.float32)
    yield "random_3d", (rng.standard_normal((4, 8, 33)) * 1e-3).astype(
        np.float32)
    yield "zeros", np.zeros((7, 5), np.float32)
    yield "halves", (np.arange(-300, 301, dtype=np.float32) / 2)
    yield "wide", np.concatenate([rng.standard_normal(500) * 1e-6,
                                  [1e4, -3e3]]).astype(np.float32)
    yield "one", np.array([0.25], np.float32)


CASES = dict(_cases())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_quantize_int8_is_bit_equal_to_reference(case, dtype):
    x = CASES[case]
    if dtype == "bfloat16":
        xr = jnp.asarray(x.astype(ml_dtypes.bfloat16))
        xp = torch.from_numpy(x).to(torch.bfloat16)
        assert np.array_equal(np.asarray(xr, np.float32), xp.float().numpy())
    else:
        xr, xp = jnp.asarray(x), torch.from_numpy(x)
    rq, rs = r_quantize(xr)
    pq, ps = quantize_int8(xp)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    assert ps.shape == () and tuple(pq.shape) == x.shape
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    assert ps.numpy().tobytes() == np.asarray(rs).tobytes()
    np.testing.assert_array_equal(dequantize_int8(pq, ps).numpy(),
                                  np.asarray(r_dequantize(rq, rs)))


def test_quantize_roundtrip_bounded():
    x = torch.linspace(-3, 3, 101)
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs().max()
    assert float(err) <= float(s) + 1e-9


@pytest.fixture
def one_rank_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_cross_pod_reduce_identity_single_pod(one_rank_group):
    mesh = make_mesh((1,), ("pod",))
    assert mesh.device_mesh is not None
    g = {"w": torch.linspace(-1, 1, 32)}
    e = {"w": torch.zeros(32)}
    red, err = cross_pod_grad_reduce(g, mesh, e)
    lsb = float(g["w"].abs().max() / 127)
    assert float((red["w"] - g["w"]).abs().max()) <= lsb + 1e-7
    # error feedback keeps the residual
    np.testing.assert_allclose(err["w"].numpy(),
                               (g["w"] - red["w"]).numpy(), atol=1e-6)


def test_cross_pod_reduce_takes_views(one_rank_group):
    """A gradient that is a view (a transposed leaf, a bf16 slice) is
    reduced as its values: a collective takes a contiguous buffer."""
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
    base = torch.randn(6, 4, generator=torch.Generator().manual_seed(3))
    g = {"t": base.t(), "s": base.to(torch.bfloat16)[:, 1]}
    e = {k: torch.zeros(v.shape) for k, v in g.items()}
    red, err = cross_pod_grad_reduce(g, mesh, e)
    for k, v in g.items():
        q, s = quantize_int8(v)
        assert red[k].dtype == v.dtype and red[k].shape == v.shape
        assert torch.equal(red[k], dequantize_int8(q, s).to(v.dtype)), k
        assert torch.equal(err[k], v.float() - dequantize_int8(q, s)), k


def test_cross_pod_reduce_without_a_pod_axis_is_the_identity():
    g = {"w": torch.randn(5), "b": {"c": torch.randn(2, 3)}}
    e = {"w": torch.zeros(5), "b": {"c": torch.zeros(2, 3)}}
    red, err = cross_pod_grad_reduce(g, LMMesh((4, 2), ("data", "model")),
                                     e)
    assert red is g and err is e


def _oracle(grads, errors):
    """The reference's formula in numpy, for every rank at once."""
    out_red, out_err = [], []
    qs, scales, x32s = [], [], []
    for g, e in zip(grads, errors):
        x32 = g.astype(np.float32) + e
        scale = np.float32(np.abs(x32).max()) / np.float32(127.0) \
            + np.float32(1e-12)
        q = np.clip(np.round(x32 / scale), -127, 127).astype(np.int8)
        qs.append(q)
        scales.append(scale)
        x32s.append(x32)
    summed = np.sum([q.astype(np.int32) for q in qs], axis=0)
    n = np.float32(len(grads))
    mean_scale = np.float32(np.sum(scales, dtype=np.float32)) / n
    reduced = summed.astype(np.float32) * mean_scale / n
    for q, scale, x32 in zip(qs, scales, x32s):
        out_err.append(x32 - q.astype(np.float32) * scale)
        out_red.append(reduced)
    return out_red, out_err


def _whole(k, locs, r):
    """Rank ``r``'s whole leaf ``k`` as the reduction sees it, from every
    rank's local tensor: a plain leaf is the rank's own, ``e`` (sharded
    over ``data``, replicated over pods) its pod's two shards, ``f``
    (sharded over ``pod`` and ``data``) all four."""
    if k == "e":
        return np.concatenate(locs[2 * (r // 2):2 * (r // 2) + 2])
    if k == "f":
        return np.concatenate(locs)
    return locs[r]


def _local(k, whole, r):
    """Rank ``r``'s shard of a whole leaf ``k``."""
    if k == "e":
        return np.split(whole, 2)[r % 2]
    if k == "f":
        return np.split(whole, 4)[r]
    return whole


def test_two_pod_reduction_matches_numpy_oracle(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(HERE / "torch_lm_mesh_job.py"), "pod",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    runs = []
    for r in range(4):
        with np.load(tmp_path / "out" / f"pod{r}.npz") as z:
            runs.append(dict(z))
    keys = [k.split(":", 1)[1] for k in runs[0] if k.startswith("grad:")]
    assert sorted(keys) == ["a", "b/c", "d", "e", "f"]
    pods = [(0, 2), (1, 3)]          # the pod groups: same data index
    for k in keys:
        locs = [run[f"grad:{k}"] for run in runs]
        wholes = [_whole(k, locs, r) for r in range(4)]
        if k != "f":                 # f: every pod sees the same leaf
            assert not np.array_equal(wholes[0], wholes[2]), k
        errors = [np.zeros_like(w, np.float32) for w in wholes]
        for rnd in (0, 1):
            red = [None] * 4
            for pair in pods:
                got, err = _oracle([wholes[r] for r in pair],
                                   [errors[r] for r in pair])
                for r, g, e in zip(pair, got, err):
                    red[r], errors[r] = g, e
            for r, run in enumerate(runs):
                want = _local(k, red[r], r)
                if k == "d":      # a bf16 gradient comes back in bf16
                    want = want.astype(ml_dtypes.bfloat16).astype(
                        np.float32)
                np.testing.assert_array_equal(
                    run[f"red{rnd}:{k}"], want,
                    err_msg=f"{k} rank {r} round {rnd}")
                np.testing.assert_array_equal(
                    run[f"err{rnd}:{k}"], _local(k, errors[r], r),
                    err_msg=f"{k} rank {r} round {rnd}")
