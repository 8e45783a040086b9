"""The LM stack on a mesh of 8 gloo ranks (``repro_torch.distributed``,
``repro_torch.launch.make_host_mesh``, ``repro_torch.ckpt.
restore_resharded``), mirroring ``tests/test_multidevice.py`` and
``tests/test_runtime.py::test_restore_resharded_roundtrip``.

One subprocess spawns 8 ranks joined over a ``file://`` store under the
test's temporary directory and runs ``tests/torch_lm_mesh_job.py``'s
``mesh`` program on a ``(4, 2)`` ``data`` x ``model`` mesh, for
``qwen3_4b``, ``granite_moe_1b_a400m`` and ``falcon_mamba_7b`` (reduced,
f32, ``d_model`` 64) on the reference's weights carried across and one
batch of 8 x 64 tokens; the ranks write their results to files that the
tests read:

* one train step on the mesh against the reference's single-device step:
  the loss within rel 1e-5 (the reference's own mesh test allows 2e-2),
  grad_norm within rel 1e-4, the gathered moments within
  ``1e-4 max|leaf|`` and parameters within the f32 bounds of
  ``tests/test_torch_lm_train_step.py`` (``1e-3 lr + 1e-6 |p|`` where the
  first moment is above 1e-3 of its leaf's largest, ``2 lr + 1e-6 |p|``
  elsewhere); the same under ``fsdp`` for ``qwen3_4b``; every rank's
  metrics equal; parameters and moments placed as ``param_shardings``
  says, before and after the step;
* the prefill on the mesh (``cache_shardings``, ``input_shardings``)
  within ``1e-4 max|x|`` of the port's one-device prefill, logits and
  cache;
* ``remat`` off, ``full`` and ``dots`` on the mesh: bit-equal loss and
  gradients;
* a checkpoint saved on the mesh restores in the reference bit for bit;
  it and the reference's own checkpoint restore onto a ``(2, 2)`` mesh
  of 4 ranks with ``restore_resharded``, bit-equal, under ``tp`` and
  ``fsdp``, with ``param_shardings``'s placements.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as RM
from repro.ckpt import CheckpointManager as RCheckpointManager
from repro.configs import get_config, reduced
from repro.optim import adamw_init as r_adamw_init
from repro.train.steps import build_train_step as r_build_train_step
from repro_torch.models import model as PM
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import paths

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
ARCHS = ("qwen3_4b", "granite_moe_1b_a400m", "falcon_mamba_7b")
STEP = dict(warmup_steps=1, total_steps=10)
B, S = 8, 64


def _cfg(arch):
    return dataclasses.replace(reduced(get_config(arch)), dtype="float32")


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(k.key) for k in path)] = np.asarray(leaf)
    return out


@functools.lru_cache(maxsize=None)
def _weights(arch):
    return _flat(RM.init_params(_cfg(arch), jax.random.PRNGKey(0)))


def _tokens(arch):
    cfg = _cfg(arch)
    rng = np.random.default_rng(7)
    return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _nest(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_mesh")
    os.makedirs(d / "in")
    for arch in ARCHS:
        np.savez(d / "in" / f"{arch}.npz", **_weights(arch))
        np.save(d / "in" / f"{arch}_tokens.npy", _tokens(arch))
    RCheckpointManager(str(d / "in" / "ref_ckpt")).save(
        3, jax.tree.map(jnp.asarray, _nest(_weights(ARCHS[0]))))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(HERE / "torch_lm_mesh_job.py"), "mesh", str(d),
         *ARCHS], env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    reports = []
    for r in range(8):
        with open(d / "out" / f"rank{r}.json") as f:
            reports.append(json.load(f))
    return d / "out", reports


def _load(path, prefix):
    with np.load(path) as z:
        return {k.split(":", 1)[1]: z[k] for k in z.files
                if k.startswith(prefix + ":")}


@functools.lru_cache(maxsize=None)
def _ref_step(arch):
    cfg = _cfg(arch)
    params = jax.tree.map(jnp.asarray, _nest(_weights(arch)))
    fn = jax.jit(r_build_train_step(cfg, **STEP))
    p, o, m = fn(params, r_adamw_init(params),
                 {"tokens": jnp.asarray(_tokens(arch))}, 1)
    return (_flat(p), {k: _flat(o[k]) for k in ("m", "v")},
            {k: float(v) for k, v in m.items()})


def _rel(a, b):
    return abs(a - b) / abs(b)


def _check_step(out, reports, arch, profile):
    r_params, r_moments, r_metrics = _ref_step(arch)
    key = f"{arch}_{profile}"
    metrics = reports[0]["metrics"][key]
    assert all(r["metrics"][key] == metrics for r in reports), \
        "metrics differ between ranks"
    assert all(r["placements"][key] for r in reports)
    assert _rel(metrics["loss"], r_metrics["loss"]) <= 1e-5
    assert _rel(metrics["grad_norm"], r_metrics["grad_norm"]) <= 1e-4
    assert _rel(metrics["lr"], r_metrics["lr"]) <= 1e-6
    path = out / f"{key}.npz"
    for name in ("m", "v"):
        got = _load(path, name)
        assert sorted(got) == sorted(r_moments[name])
        for k, t in got.items():
            r = r_moments[name][k]
            assert np.abs(t - r).max() <= 1e-4 * np.abs(r).max(), (name, k)
    lr = r_metrics["lr"]
    start = _weights(arch)
    for k, t in _load(path, "params").items():
        r, g = r_params[k], np.abs(r_moments["m"][k])
        strong = g > 1e-3 * g.max()
        bound = np.where(strong, 1e-3 * lr, 2 * lr) + 1e-6 * np.abs(r)
        assert np.all(np.abs(t - r) <= bound), k
        assert not np.array_equal(t, start[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_reference(job, arch):
    _check_step(*job, arch, "tp")


def test_mesh_fsdp_train_step_matches_reference(job):
    _check_step(*job, ARCHS[0], "fsdp")


@functools.lru_cache(maxsize=None)
def _one_device_prefill(arch):
    cfg = _cfg(arch)
    params = params_from_numpy(_nest(_weights(arch)), device="cpu")
    cache = PM.init_cache(cfg, B, 80, device="cpu")
    with torch.inference_mode():
        logits, cache = PM.prefill(
            params, {"tokens": torch.from_numpy(_tokens(arch))}, cache, cfg)
    return logits.numpy(), {k: v.float().numpy() for k, v in paths(cache)}


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefill_matches_one_device(job, arch):
    out, _ = job
    logits, cache = _one_device_prefill(arch)
    got = _load(out / f"{arch}_prefill.npz", "logits")["logits"]
    assert got.shape == logits.shape
    assert np.abs(got - logits).max() <= 1e-4 * np.abs(logits).max()
    got_cache = _load(out / f"{arch}_prefill.npz", "cache")
    assert sorted(got_cache) == sorted(cache)
    for k, v in cache.items():
        assert got_cache[k].shape == v.shape, k
        assert np.abs(got_cache[k] - v).max() <= \
            1e-4 * max(np.abs(v).max(), 1.0), k


def test_mesh_remat_policies_agree(job):
    _, reports = job
    for r in reports:
        for name in ("full", "dots"):
            assert r["remat"][name] == {"loss_equal": True,
                                        "grads_max_diff": 0.0}, name


@pytest.mark.parametrize("profile", ["tp", "fsdp"])
def test_restore_resharded_onto_a_2x2_mesh(job, profile):
    """The mesh's checkpoint (the tp step's parameters) and the
    reference's own, each onto 4 of the 8 ranks: bit-equal, placed as
    ``param_shardings`` says, each rank holding a quarter of a leaf that
    the mesh shards over both axes."""
    out, reports = job
    saved = _load(out / f"{ARCHS[0]}_tp.npz", "params")
    for src, want in (("mesh_ckpt", saved), ("ref_ckpt", _weights(ARCHS[0]))):
        got = _load(out / f"restore_{src}_{profile}.npz", "params")
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
        for r in reports[:4]:
            assert r["placements"][f"restore_{src}_{profile}"], src
        local = reports[0]["restore_local_shapes"][f"{src}_{profile}"]
        quarters = [k for k, shp in local.items()
                    if np.prod(shp) * 4 == want[k].size]
        assert quarters, src
    for r in reports[4:]:
        assert f"restore_mesh_ckpt_{profile}" not in r["placements"]


def test_mesh_checkpoint_restores_in_the_reference(job):
    """Saved on 8 ranks (rank 0 writes the reference's layout), read by
    the reference's ``CheckpointManager``: equal to the gathered tp
    step's parameters and moments, its manifest as written."""
    out, reports = job
    assert all(r["latest_step"] == 1 for r in reports)
    assert sorted(os.listdir(out / "mesh_ckpt")) == ["step_00000001"]
    skel = _nest(_weights(ARCHS[0]))
    skel = jax.tree.map(jnp.asarray, skel)
    opt = r_adamw_init(skel)
    p, o, manifest = RCheckpointManager(str(out / "mesh_ckpt")).restore(
        skel, opt)
    assert manifest == {"step": 1, "metadata": {"mesh": "4x2"}}
    saved = _load(out / f"{ARCHS[0]}_tp.npz", "params")
    for k, v in _flat(p).items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    for name in ("m", "v"):
        saved = _load(out / f"{ARCHS[0]}_tp.npz", name)
        for k, v in _flat(o[name]).items():
            np.testing.assert_array_equal(v, saved[k], err_msg=k)
    assert int(o["count"]) == 1
