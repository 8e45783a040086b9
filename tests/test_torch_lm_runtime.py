"""The port's training runtime (``repro_torch.ckpt.CheckpointManager``,
``repro_torch.data``, ``repro_torch.train.TrainLoop``,
``repro_torch.launch.train``) against the reference's contract.

* mirrors, by name, of the reference's own tests
  (``tests/test_runtime.py``: checkpoints, data, the loop's resume, the
  chunked cross entropy, the schedule; ``tests/test_archs.py``: one
  train step of each reduced architecture);
* checkpoints cross between the packages: a directory written by the
  reference's ``CheckpointManager`` (f32 and bf16 params, AdamW state)
  restores in the port bit for bit, and an f32 one written by the port
  restores in the reference; the layout (``step_<N:08d>/``, ``a/b/c``
  keys, bf16 as ``|V2`` records) is the reference's;
* the cross entropy (full and chunked, f32 and bf16 logits) and
  ``batch_for_shape``'s numpy part equal the reference's; the dataset's
  draws (Philox, not threefry) keep its contract;
* ``python -m repro_torch.launch.train --reduced --device cpu`` for a
  dense, an MoE and an SSM architecture; with ``--devices 2`` on a
  ``(2, 1)`` gloo mesh under ``tp`` and ``fsdp``; ``--multi-pod`` alone
  on the host mesh; and its refusals (``--production-mesh`` below 256 or
  512 ranks raises the reference's ``RuntimeError``; vlm).
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as RM
from repro.ckpt import CheckpointManager as RefManager
from repro.configs import ARCH_IDS
from repro.configs import get_config as r_get_config
from repro.configs import reduced as r_reduced
from repro.data import SyntheticTextDataset as RefDataset
from repro.data import batch_for_shape as r_batch_for_shape
from repro.optim import adamw_init as r_adamw_init
from repro.train.steps import cross_entropy_loss as r_cross_entropy
import repro_torch.models.model as M
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticTextDataset, batch_for_shape
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw_init, linear_warmup_cosine
from repro_torch.tree import leaves as tree_leaves
from repro_torch.train import TrainLoop, build_train_step
from repro_torch.train import loop as loop_module
from repro_torch.train.steps import cross_entropy_loss

SRC = Path(__file__).resolve().parents[1] / "src"


def _tiny():
    cfg = reduced(get_config("olmo_1b"), n_layers=1, d_model=32, vocab=64)
    return cfg, M.init_params(cfg, 0, device="cpu")


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# Checkpointing (tests/test_runtime.py)
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip():
    cfg, params = _tiny()
    opt = adamw_init(params)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        mgr.save(5, params, opt, {"note": "x"})
        p2, o2, manifest = mgr.restore(params, opt)
        assert manifest["step"] == 5
        assert manifest["metadata"] == {"note": "x"}
        _equal_trees(params, p2)
        _equal_trees(opt, o2)


def test_checkpoint_keep_k_and_atomicity():
    cfg, params = _tiny()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, params)
        assert mgr.list_steps() == [3, 4]
        assert not any(n.endswith(".tmp") for n in os.listdir(d))


def test_checkpoint_async():
    cfg, params = _tiny()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=3)
        mgr.async_save(7, params)
        mgr.wait()
        assert mgr.latest_step() == 7


def test_shape_mismatch_rejected():
    cfg, params = _tiny()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, params)
        cfg2 = reduced(get_config("olmo_1b"), n_layers=1, d_model=64,
                       vocab=64)
        params2 = M.init_params(cfg2, 0, device="cpu")
        with pytest.raises(ValueError, match="shape mismatch"):
            mgr.restore(params2)


def test_async_save_snapshots_now_and_raises_at_wait(tmp_path):
    """The snapshot is taken at the call (a later in-place write does not
    reach the checkpoint); a failed write is raised by the next wait."""
    cfg, params = _tiny()
    mgr = CheckpointManager(str(tmp_path / "a"), keep=2)
    want = params["embed"].clone()
    gate = threading.Event()
    real = mgr._write_flat

    def slow(*args):
        gate.wait(timeout=60)
        return real(*args)
    mgr._write_flat = slow
    mgr.async_save(3, params)
    params["embed"].add_(1.0)                 # after the snapshot
    gate.set()
    mgr.wait()
    p2, _, _ = mgr.restore(params)
    assert torch.equal(p2["embed"], want)

    def fail(*args):
        raise OSError("disk full")
    mgr._write_flat = fail
    mgr.async_save(4, params)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                                 # raised once
    assert mgr.list_steps() == [3]


def test_restore_takes_each_skeleton_leafs_dtype():
    """A bf16 skeleton reads its ``|V2`` records back bit for bit; the
    count stays int32 and 0-d."""
    cfg = reduced(get_config("qwen3_4b"), n_layers=1, d_model=32, vocab=64)
    params = M.init_params(dataclasses.replace(cfg, dtype="bfloat16"), 1,
                           device="cpu")
    opt = adamw_init(params)
    opt["count"] += 3
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(2, params, opt)
        with np.load(os.path.join(d, "step_00000002", "params.npz")) as z:
            assert all(z[k].dtype == np.dtype("V2") for k in z.files)
        p2, o2, _ = mgr.restore(params, opt)
    _equal_trees(params, p2)
    _equal_trees(opt, o2)
    assert o2["count"].shape == () and int(o2["count"]) == 3


def _ref_state(dtype):
    cfg = r_reduced(r_get_config("qwen2_7b"), n_layers=2, d_model=32,
                    vocab=64)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    params = RM.init_params(cfg, jax.random.PRNGKey(3))
    opt = r_adamw_init(params)
    rng = np.random.default_rng(0)
    opt = {"m": jax.tree.map(lambda a: jnp.asarray(
               rng.standard_normal(a.shape), jnp.float32), opt["m"]),
           "v": jax.tree.map(lambda a: jnp.asarray(
               rng.random(a.shape), jnp.float32), opt["v"]),
           "count": jnp.asarray(7, jnp.int32)}
    return params, opt


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(dtype, tmp_path):
    params, opt = _ref_state(dtype)
    RefManager(str(tmp_path)).save(9, params, opt, {"loss": 1.5})
    p_params = params_from_numpy(_numpy_tree(params), device="cpu")
    p_opt = params_from_numpy(_numpy_tree(opt), device="cpu")
    skel_p = jax.tree.map(torch.zeros_like, p_params)
    skel_o = jax.tree.map(torch.zeros_like, p_opt)
    got_p, got_o, manifest = CheckpointManager(str(tmp_path)).restore(
        skel_p, skel_o)
    assert manifest == {"step": 9, "metadata": {"loss": 1.5}}
    _equal_trees(p_params, got_p)
    _equal_trees(p_opt, got_o)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    params, opt = _ref_state("float32")
    p_params = params_from_numpy(_numpy_tree(params), device="cpu")
    p_opt = params_from_numpy(_numpy_tree(opt), device="cpu")
    CheckpointManager(str(tmp_path)).save(4, p_params, p_opt, {"a": 1})
    skel_p = jax.tree.map(jnp.zeros_like, params)
    skel_o = jax.tree.map(jnp.zeros_like, opt)
    got_p, got_o, manifest = RefManager(str(tmp_path)).restore(skel_p,
                                                               skel_o)
    assert manifest == {"step": 4, "metadata": {"a": 1}}
    for want, got in ((params, got_p), (opt, got_o)):
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_layout_is_the_references(dtype, tmp_path):
    """Same directory names, files, keys (in order), shapes and record
    dtypes as the reference writes for the same state."""
    params, opt = _ref_state(dtype)
    RefManager(str(tmp_path / "ref")).save(12, params, opt)
    CheckpointManager(str(tmp_path / "port")).save(
        12, params_from_numpy(_numpy_tree(params), device="cpu"),
        params_from_numpy(_numpy_tree(opt), device="cpu"))
    for root in ("ref", "port"):
        assert os.listdir(tmp_path / root) == ["step_00000012"]
    for name in ("params.npz", "opt_state.npz"):
        with np.load(tmp_path / "ref" / "step_00000012" / name) as r, \
                np.load(tmp_path / "port" / "step_00000012" / name) as p:
            assert r.files == p.files
            for k in r.files:
                assert (r[k].dtype, r[k].shape) == (p[k].dtype, p[k].shape)
                assert r[k].tobytes() == p[k].tobytes(), k
    assert sorted(os.listdir(tmp_path / "port" / "step_00000012")) == \
        ["manifest.json", "opt_state.npz", "params.npz"]


# ---------------------------------------------------------------------------
# Data pipeline (tests/test_runtime.py)
# ---------------------------------------------------------------------------
def test_data_deterministic_and_skippable():
    ds = SyntheticTextDataset(100, 16, 8, seed=3)
    a = ds.batch_at(7)
    b = ds.batch_at(7)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(ds.batch_at(7), ds.batch_at(8))
    # a fresh dataset (a restarted run) gives the same batch at step 7
    np.testing.assert_array_equal(SyntheticTextDataset(100, 16, 8,
                                                       seed=3).batch_at(7),
                                  a)
    assert not np.array_equal(SyntheticTextDataset(100, 16, 8,
                                                   seed=4).batch_at(7), a)


def test_data_shards_disjoint_and_cover():
    full = SyntheticTextDataset(100, 8, 8, seed=1)
    s0 = SyntheticTextDataset(100, 8, 8, seed=1, num_shards=2, shard_id=0)
    s1 = SyntheticTextDataset(100, 8, 8, seed=1, num_shards=2, shard_id=1)
    assert full.batch_at(0).shape == (8, 8)
    assert s0.batch_at(0).shape == (4, 8)
    assert not np.array_equal(s0.batch_at(0), s1.batch_at(0))
    with pytest.raises(ValueError, match="divide evenly"):
        SyntheticTextDataset(100, 8, 6, num_shards=4)


def test_structured_mode_learnable():
    ds = SyntheticTextDataset(97, 32, 4, seed=0, mode="structured")
    toks = ds.batch_at(0)
    # ~90 % of transitions follow the affine chain
    follows = (toks[:, 1:] == (31 * toks[:, :-1] + 17) % 97).mean()
    assert follows > 0.7


@pytest.mark.parametrize("mode", ["random", "structured"])
def test_dataset_draws_keep_the_references_contract(mode):
    """Shapes, dtype, range and iteration as the reference's; the draws
    themselves differ (Philox, not threefry).  Structured: ~81% of
    transitions follow the chain (each of two tokens kept with p 0.9),
    and ~10% of tokens are noise, as the reference's."""
    kw = dict(vocab=50304, seq_len=256, global_batch=8, seed=5, mode=mode)
    ours, ref = SyntheticTextDataset(**kw), RefDataset(**kw)
    a, r = ours.batch_at(3), ref.batch_at(3)
    assert a.dtype == r.dtype == np.int32 and a.shape == r.shape
    assert a.min() >= 0 and a.max() < 50304
    it = iter(ours)
    np.testing.assert_array_equal(next(it), ours.batch_at(0))
    np.testing.assert_array_equal(next(it), ours.batch_at(1))
    if mode == "structured":
        for toks in (a, r):
            follows = (toks[:, 1:] == (31 * toks[:, :-1] + 17) % 50304)
            assert 0.77 < follows.mean() < 0.85


@pytest.mark.parametrize("arch", ["llava_next_34b", "whisper_medium",
                                  "qwen3_4b"])
def test_batch_for_shape_matches_the_references_numpy_part(arch):
    """``embeds`` and ``audio_embeds`` come from ``default_rng(seed +
    step)``: equal to the reference's; the tokens keep their contract."""
    r_cfg = r_reduced(r_get_config(arch))
    ours = batch_for_shape(reduced(get_config(arch)), 2, 24, step=3, seed=1)
    ref = r_batch_for_shape(r_cfg, 2, 24, step=3, seed=1)
    assert sorted(ours) == sorted(ref)
    for k in ours:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == \
            ref[k].shape, k
        if k in ("embeds", "audio_embeds"):
            np.testing.assert_array_equal(ours[k], ref[k])


# ---------------------------------------------------------------------------
# Train loop: resume + straggler accounting (tests/test_runtime.py)
# ---------------------------------------------------------------------------
def test_train_loop_resume():
    cfg = reduced(get_config("olmo_1b"), n_layers=1, d_model=32, vocab=64)
    params = M.init_params(cfg, 0, device="cpu")
    opt = adamw_init(params)
    ds = SyntheticTextDataset(cfg.vocab, 16, 4, seed=1, mode="structured")
    step_fn = build_train_step(cfg, total_steps=30)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        out1 = TrainLoop(step_fn, ds, mgr, checkpoint_every=5).run(
            params, opt, num_steps=10)
        assert out1["step"] == 10
        # second loop resumes from the final checkpoint, not from scratch
        out2 = TrainLoop(step_fn, ds, mgr, checkpoint_every=5).run(
            params, opt, num_steps=15)
        assert out2["step"] == 15
        assert mgr.latest_step() == 15


def test_resumed_loop_equals_an_uninterrupted_one(tmp_path):
    """6 steps, then a new loop to 8 resumed from the checkpoint: the
    same history and the same state, bit for bit, as 8 steps straight."""
    cfg = reduced(get_config("qwen3_4b"), n_layers=2, d_model=32, vocab=64)
    ds = SyntheticTextDataset(cfg.vocab, 16, 4, seed=2, mode="structured")
    step_fn = build_train_step(cfg, warmup_steps=2, total_steps=8)

    def fresh():
        p = M.init_params(cfg, 0, device="cpu")
        return p, adamw_init(p)

    mgr = CheckpointManager(str(tmp_path / "run"), keep=1)
    TrainLoop(step_fn, ds, mgr, checkpoint_every=2).run(*fresh(),
                                                        num_steps=6)
    assert mgr.list_steps() == [6]
    resumed = TrainLoop(step_fn, ds, mgr, checkpoint_every=2).run(
        *fresh(), num_steps=8, log_every=1)
    straight = TrainLoop(step_fn, ds, CheckpointManager(
        str(tmp_path / "straight")), checkpoint_every=100).run(
        *fresh(), num_steps=8, log_every=1)
    assert [h["step"] for h in resumed["history"]] == [7, 8]
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in straight["history"][-2:]]
    _equal_trees(resumed["params"], straight["params"])
    _equal_trees(resumed["opt_state"], straight["opt_state"])


def test_train_loop_logs_checkpoints_and_counts_stragglers(tmp_path,
                                                          monkeypatch):
    """History at ``log_every`` and the last step, async checkpoints every
    ``checkpoint_every`` with the loss, a final synchronous one; a step
    slower than ``straggler_factor`` x the EWMA is counted (the loop's
    clock is a fake one that each step advances: 10 ms, 1 s at step 6)."""
    cfg = reduced(get_config("olmo_1b"), n_layers=1, d_model=32, vocab=64)
    params = M.init_params(cfg, 0, device="cpu")
    ds = SyntheticTextDataset(cfg.vocab, 16, 4, seed=1, mode="structured")
    base = build_train_step(cfg, total_steps=10)
    clock = [0.0]
    monkeypatch.setattr(loop_module, "time", SimpleNamespace(
        monotonic=lambda: clock[0]))

    def step_fn(p, o, b, s):
        clock[0] += 1.0 if s == 6 else 0.01
        return base(p, o, b, s)
    mgr = CheckpointManager(str(tmp_path), keep=10)
    out = TrainLoop(step_fn, ds, mgr, checkpoint_every=3).run(
        params, adamw_init(params), num_steps=7, log_every=2)
    assert [h["step"] for h in out["history"]] == [2, 4, 6, 7]
    assert all(np.isfinite(h["loss"]) and h["step_time_s"] > 0
               for h in out["history"])
    assert mgr.list_steps() == [3, 6, 7]
    assert out["straggler_steps"] == 1 and not out["preempted"]
    _, _, m6 = mgr.restore(params, None, step=6)
    _, _, m7 = mgr.restore(params, None, step=7)
    assert set(m6["metadata"]) == {"loss"}
    assert m7["metadata"] == {"final": True, "preempted": False}


# ---------------------------------------------------------------------------
# Cross entropy and the schedule (tests/test_runtime.py)
# ---------------------------------------------------------------------------
def test_vocab_chunked_ce_matches_full():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((2, 8, 100),
                                                  dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, 100, (2, 8)))
    full = cross_entropy_loss(logits, labels, vocab_chunk=0)
    chunked = cross_entropy_loss(logits, labels, vocab_chunk=32)
    np.testing.assert_allclose(float(full), float(chunked), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab_chunk", [0, 32, 7, 100])
def test_cross_entropy_matches_reference(dtype, vocab_chunk):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((2, 8, 100)) * 3).astype(np.float32)
    labels = rng.integers(0, 100, (2, 8)).astype(np.int32)
    ref = r_cross_entropy(jnp.asarray(logits, getattr(jnp, dtype)),
                          jnp.asarray(labels), vocab_chunk)
    ours = cross_entropy_loss(torch.from_numpy(logits).to(
        getattr(torch, dtype)), torch.from_numpy(labels), vocab_chunk)
    assert ours.dtype == torch.float32 and ours.shape == ()
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


def test_lr_schedule():
    assert float(linear_warmup_cosine(0, 1.0, 10, 100)) == pytest.approx(0.0)
    assert float(linear_warmup_cosine(10, 1.0, 10, 100)) == pytest.approx(1.0)
    assert float(linear_warmup_cosine(100, 1.0, 10, 100)) == \
        pytest.approx(0.1, abs=1e-3)


# ---------------------------------------------------------------------------
# Every architecture takes a train step (tests/test_archs.py)
# ---------------------------------------------------------------------------
def _arch_batch(cfg, b=2, s=64):
    rng = np.random.default_rng(0)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))}
    if cfg.family == "vlm":
        out = {"embeds": torch.from_numpy(rng.standard_normal(
            (b, s, cfg.d_model), dtype=np.float32)),
            "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))}
    elif cfg.family == "encdec":
        out["audio_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_smoke(arch):
    cfg = reduced(get_config(arch))
    params = M.init_params(cfg, 0, device="cpu")
    before = [t.clone() for t in tree_leaves(params)]
    opt = adamw_init(params)
    step_fn = build_train_step(cfg, warmup_steps=2, total_steps=10)
    p2, o2, metrics = step_fn(params, opt, _arch_batch(cfg), 1)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    # params actually changed
    delta = max(float((a - b).abs().max()) for a, b in
                zip(before, tree_leaves(p2)))
    assert delta > 0


# ---------------------------------------------------------------------------
# The entry point: python -m repro_torch.launch.train
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["olmo_1b", "granite_moe_1b_a400m",
                                  "falcon_mamba_7b"])
def test_launch_train_runs_on_the_cpu(arch, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--reduced", "--device", "cpu", "--steps", "4", "--seq", "32",
         "--global-batch", "4", "--checkpoint-every", "2",
         "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"arch: {arch} (reduced)" in proc.stdout
    assert "finished at step 4" in proc.stdout
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000004"]
    with open(tmp_path / "step_00000004" / "manifest.json") as f:
        assert json.load(f)["metadata"] == {"final": True,
                                            "preempted": False}


def _launch(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--seq", "32", "--global-batch", "4",
         "--ckpt-dir", str(tmp_path), *args],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-6000:]
    return proc.stdout


def _final_loss(stdout):
    line = [ln for ln in stdout.splitlines() if ln.startswith("step ")][-1]
    return float(line.split("loss")[1].split()[0])


@pytest.mark.parametrize("profile", ["tp", "fsdp"])
def test_launch_train_on_a_two_rank_cpu_mesh(profile, tmp_path):
    """``--devices 2``: two gloo ranks on the host mesh; rank 0 alone
    prints and publishes the checkpoint."""
    out = _launch(["--devices", "2", "--steps", "2", "--profile", profile],
                  tmp_path)
    assert f"mesh: {{'data': 2, 'model': 1}}  profile: {profile}" in out
    assert out.count("finished at step 2") == 1
    assert np.isfinite(_final_loss(out))
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]


@pytest.mark.parametrize("flags,need", [(["--production-mesh"], 256),
                                        (["--production-mesh",
                                          "--multi-pod"], 512)])
def test_launch_train_production_mesh_needs_its_ranks(flags, need,
                                                      tmp_path):
    with pytest.raises(RuntimeError, match=f"needs {need} devices"):
        launch_train.main(["--reduced", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path), *flags])


def test_launch_train_multi_pod_alone_runs_on_the_host_mesh(tmp_path):
    """As in the reference, ``--multi-pod`` without ``--production-mesh``
    keeps the host mesh: one device here, the step on plain tensors."""
    out = _launch(["--multi-pod", "--steps", "2"], tmp_path)
    assert "mesh: {'data': 1, 'model': 1}  profile: tp" in out
    assert "finished at step 2" in out and np.isfinite(_final_loss(out))


def test_launch_train_refuses_vlm(tmp_path):
    with pytest.raises(SystemExit, match="vlm"):
        launch_train.main(["--arch", "llava_next_34b", "--reduced",
                           "--device", "cpu", "--ckpt-dir", str(tmp_path)])
