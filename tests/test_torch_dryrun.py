"""The port's dry run (``repro_torch.launch.dryrun``, ``launch/shapes.py``)
against the reference's (``repro.launch.dryrun``, ``repro.launch.shapes``).

Mirrors ``tests/test_dryrun.py``'s six tests: 40 cells; ``long_500k``
skips exactly the seven full-attention architectures and no other cell is
skipped; ``input_specs`` gives ``meta`` tensors; the shape contract; and
one cell through the command line in a fresh process
(``python -m repro_torch.launch.dryrun --arch olmo_1b --shape decode_32k
--no-costs --device cpu``) on the 16 x 16 and the 2 x 16 x 16 mesh of a
fake process group of 512 ranks: ``ok``, 256 / 512 chips, a positive
per-device peak.

Parity with the reference: ``SHAPES`` and ``all_cells()`` equal;
``input_specs`` shapes and dtypes equal for all 40 cells;
``_batch_shardings``' specs equal on ``AbstractMesh`` ``(16, 16)`` and
``(2, 16, 16)`` for every cell under both profiles (the port on a
shape-only ``LMMesh``).

The L-diff: ``base + L * per_layer`` (plus ``n_shared * shared_cost``),
``layer_costs`` of traces at L = 2 and L = 4, equals a direct trace at
L = 6 for a
dense and an SSM train step, an MoE and the hybrid prefill (reduced
width, a fake ``(2, 2)`` mesh): FLOPs, collective bytes and HLO bytes exactly
(the hybrid with a shared block every 4 layers, so that L = 2 and L = 4
hold one each, as the published zamba2's every 6 does).
The record: ``run_cell``'s keys are the reference's (``_compile``'s,
``as_dict()``'s, ``tpu_energy_report``'s) plus ``hw``; its roofline and
energy read the full-depth trace's counts, which ``cost_base +
n_layers * per_layer`` gives back.  The dry run refuses a real process
group, and a group that ``run_cell`` started ends with the cell.  The
layout helpers the uneven head counts and torch 2.11 need
(``distributed/ops.py``: ``split_dim``,
``merge_dims``, ``repeat_heads``, ``add_bias``, ``index_copy_``,
``cumsum``, ``tied_logits``, ``shard_span``) equal the plain ops on 4
gloo ranks (``tests/torch_dist_ops_job.py``) and on plain tensors; the
active mesh reaches the autograd engine's threads.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

jax.devices()                       # fix this process's device count first
_FLAGS = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as RD  # noqa: E402  (sets XLA_FLAGS at import)
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.energy import roofline as r_roof  # noqa: E402
from repro.energy import tpu_energy as r_energy  # noqa: E402
from repro.launch import shapes as r_shapes  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, reduced  # noqa: E402
from repro_torch.distributed import ops  # noqa: E402
from repro_torch.launch import LMMesh  # noqa: E402
from repro_torch.launch import dryrun as PD  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.shapes import (SHAPES, ShapeSpec,  # noqa: E402
                                       all_cells)

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
COMPILE_KEYS = {"compile_s", "flops_dev", "bytes_dev", "bytes_hlo_dev",
                "coll_bytes_dev", "coll_ops", "arg_gb_dev", "temp_gb_dev",
                "out_gb_dev", "peak_gb_dev"}


_REAL_GROUP = r"""
import os, sys, tempfile
import torch.distributed as dist
from repro_torch.launch import dryrun
d = tempfile.mkdtemp()
dist.init_process_group("gloo", init_method=f"file://{d}/s", rank=0,
                        world_size=1)
try:
    dryrun.fake_group()
except RuntimeError as e:
    print("REFUSED", e)
"""


@pytest.fixture(scope="module", autouse=True)
def procs(tmp_path_factory):
    """The fresh processes of this file, started together before its
    first test: the command line on each mesh, the gloo ranks of the
    layout helpers, a real group that the dry run refuses."""
    root = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    cmds = {m: [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                "olmo_1b", "--shape", "decode_32k", "--mesh", m,
                "--no-costs", "--device", "cpu", "--out",
                str(root / f"{m}.json")] for m in ("single", "multi")}
    cmds["gloo"] = [sys.executable, str(HERE / "torch_dist_ops_job.py"),
                    str(root / "store")]
    cmds["real"] = [sys.executable, "-c", _REAL_GROUP]
    running = {k: subprocess.Popen(c, env=env, text=True,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE)
               for k, c in cmds.items()}
    done = {}

    def result(key):
        if key not in done:
            out, err = running[key].communicate(timeout=300)
            done[key] = (running[key].returncode, out, err)
        return done[key]
    result.root = root
    yield result
    for p in running.values():
        p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def fake_pg():
    import torch.distributed as dist
    own = not dist.is_initialized()
    PD.fake_group()
    yield
    if own:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# tests/test_dryrun.py, mirrored
# ---------------------------------------------------------------------------
def test_cell_matrix_is_40():
    assert len(all_cells()) == 40          # 10 archs x 4 shapes


def test_long500k_skips_exactly_the_full_attention_archs():
    skipped = {arch for arch, shape, skip in all_cells()
               if shape.name == "long_500k" and skip}
    assert skipped == {"llava_next_34b", "whisper_medium", "olmo_1b",
                       "qwen2_5_32b", "qwen2_7b", "qwen3_4b",
                       "granite_moe_1b_a400m"}
    runnable = {arch for arch, shape, skip in all_cells()
                if shape.name == "long_500k" and not skip}
    assert runnable == {"falcon_mamba_7b", "mixtral_8x7b", "zamba2_1p2b"}


def test_no_other_cell_skipped():
    for arch, shape, skip in all_cells():
        if shape.name != "long_500k":
            assert skip is None, (arch, shape.name)


def test_input_specs_are_abstract():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            spec = PD.input_specs(cfg, shape)
            for v in spec.values():
                assert isinstance(v, torch.Tensor) and v.is_meta
            if shape.kind == "decode":
                assert spec["tokens"].shape[0] == shape.global_batch
            elif cfg.family == "vlm":
                assert tuple(spec["embeds"].shape[:2]) == (
                    shape.global_batch, shape.seq_len)
            else:
                assert tuple(spec["tokens"].shape) == (shape.global_batch,
                                                       shape.seq_len)


def test_shape_contract():
    assert SHAPES["train_4k"].kind == "train"
    assert SHAPES["prefill_32k"].kind == "prefill"
    assert SHAPES["decode_32k"].kind == "decode"       # serve_step, not train
    assert SHAPES["long_500k"].kind == "decode"
    assert SHAPES["long_500k"].seq_len == 524288
    assert SHAPES["long_500k"].global_batch == 1


@pytest.mark.parametrize("mesh,chips", [("single", 256), ("multi", 512)])
def test_dryrun_cell_runs_on_production_mesh(procs, mesh, chips):
    """One cheap cell through the command line in a fresh process, on
    the fake group's production mesh, written where ``--out`` says."""
    rc, out, err = procs(mesh)
    assert rc == 0, err[-2000:]
    rec = json.loads((procs.root / f"{mesh}.json").read_text())[
        f"olmo_1b|decode_32k|{mesh}"]
    assert rec["status"] == "ok", rec
    assert rec["chips"] == chips
    assert rec["scan_peak_gb_dev"] > 0
    assert rec["hw"] == "H100" and rec["fits_hbm"] is True
    assert "[ok] olmo_1b|decode_32k|" in out


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------
def test_shapes_and_cells_equal_the_reference():
    assert {k: tuple(vars(v).values()) for k, v in SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in r_shapes.SHAPES.items()}
    mine = [(a, tuple(vars(s).values()), r) for a, s, r in all_cells()]
    ref = [(a, tuple(vars(s).values()), r)
           for a, s, r in r_shapes.all_cells()]
    assert mine == ref


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


def test_input_specs_equal_the_reference():
    for arch, shape, _ in all_cells():
        mine = PD.input_specs(get_config(arch), shape)
        ref = RD.input_specs(r_get_config(arch),
                             r_shapes.SHAPES[shape.name])
        assert {k: (tuple(v.shape), _dtype_name(v.dtype))
                for k, v in mine.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()}, \
            (arch, shape.name)


@pytest.mark.parametrize("profile", ["tp", "fsdp"])
@pytest.mark.parametrize("sizes,names", [
    ((16, 16), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model"))])
def test_batch_shardings_equal_the_reference(sizes, names, profile):
    rmesh = AbstractMesh(sizes, names)
    pmesh = LMMesh(sizes, names)
    for arch, shape, _ in all_cells():
        ref = RD._batch_shardings(
            rmesh, r_get_config(arch),
            RD.input_specs(r_get_config(arch), r_shapes.SHAPES[shape.name]),
            shape.global_batch, profile=profile)
        mine = PD._batch_shardings(
            pmesh, get_config(arch), PD.input_specs(get_config(arch), shape),
            shape.global_batch, profile=profile)
        assert {k: tuple(v.spec) for k, v in mine.items()} == \
            {k: tuple(v.spec) for k, v in ref.items()}, (arch, shape.name)


# ---------------------------------------------------------------------------
# The L-diff, the record, the process group
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,kind", [
    ("qwen3_4b", "train"), ("granite_moe_1b_a400m", "prefill"),
    ("falcon_mamba_7b", "train"), ("zamba2_1p2b", "prefill")])
def test_layer_diff_is_exact(fake_pg, arch, kind):
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = reduced(get_config(arch), n_layers=2, d_model=64)
    if cfg.family == "hybrid":
        # one shared block at L = 2 and at L = 4, as the published zamba2
        # (every 6) has: the diff then holds mamba layers only
        cfg = dataclasses.replace(cfg, shared_attn_every=4)
    shape = ShapeSpec("x", kind, 32, 4)

    def cost(c):
        return PD._compile(c, shape, mesh, True, device="cpu")
    cfg4 = PD._reduced_cfg(cfg, 4)
    ce = (cost(PD._reduced_cfg(cfg, 2, shared_every=1))
          if cfg.family == "hybrid" else None)
    per_layer, base, shared, _ = PD.layer_costs(
        cfg4, cost(cfg4), cost(PD._reduced_cfg(cfg, 2)), ce)
    n_shared = 0
    if cfg.family == "hybrid":
        n_shared = -(-6 // cfg.shared_attn_every)
        assert shared["flops_dev"] > 0
    direct = cost(PD._reduced_cfg(cfg, 6))
    for k in ("flops_dev", "coll_bytes_dev", "bytes_hlo_dev"):
        assert base[k] + 6 * per_layer[k] + n_shared * shared[k] == \
            direct[k], k
    assert per_layer["flops_dev"] > 0 and per_layer["coll_bytes_dev"] > 0


def test_record_keys_are_the_references_plus_hw(fake_pg):
    rec = PD.run_cell("olmo_1b", SHAPES["decode_32k"], device="cpu")
    assert rec["status"] == "ok", rec.get("error")
    ref_scan = {f"scan_{k}" for k in COMPILE_KEYS}
    assert set(rec) == {"arch", "shape", "mesh", "kind", "status", "chips",
                        "fits_hbm", "roofline", "energy", "per_layer",
                        "cost_base", "hw"} | ref_scan
    assert set(rec["roofline"]) == set(r_roof.roofline_terms(
        1, 1, 1, 1, 1).as_dict()) | {"bytes_hlo_global"}
    assert set(rec["energy"]) == set(r_energy.tpu_energy_report(1, 1, 1, 1))
    assert rec["hw"] == "H100" and rec["chips"] == 256
    assert rec["roofline"]["chips"] == 256
    assert rec["per_layer"]["flops_dev"] > 0
    # the costs are the full-depth trace's, and the diff gives them back
    assert rec["roofline"]["flops_global"] == rec["scan_flops_dev"] * 256
    L = get_config("olmo_1b").n_layers
    for k in ("flops_dev", "bytes_hlo_dev", "coll_bytes_dev"):
        assert rec["cost_base"][k] + L * rec["per_layer"][k] == \
            pytest.approx(rec[f"scan_{k}"], rel=1e-12), k
    import torch.distributed as dist
    assert dist.is_initialized()    # the fixture's group outlives the cell
    skip = PD.run_cell("olmo_1b", SHAPES["long_500k"], device="cpu")
    assert skip["status"] == "skipped" and skip["hw"] == "H100"


def test_dry_run_refuses_a_real_group_and_never_writes_benchmarks(procs):
    rc, out, err = procs("real")
    assert "REFUSED a 'gloo' process group is running" in out, out + err
    assert PD.RESULTS_DIR == SRC.parent / "build"
    assert "benchmarks" not in PD.RESULTS_DIR.parts


def test_mesh_context_reaches_the_autograd_threads():
    """The active mesh is the process's: the autograd engine recomputes a
    rematerialised layer on its device thread, which must take the
    forward's sharding hints (a thread-local mesh made that recompute
    shard otherwise: torch.utils.checkpoint's metadata check failed on
    the card's dry run)."""
    import threading
    from repro_torch.distributed import constrain, current_mesh, use_mesh
    mesh = LMMesh((2, 2), ("data", "model"))
    seen = []
    with use_mesh(mesh, profile="fsdp"):
        t = threading.Thread(target=lambda: seen.append(
            (current_mesh(), __import__(
                "repro_torch.distributed.shardctx",
                fromlist=["x"]).current_profile())))
        t.start()
        t.join(timeout=60)
    assert not t.is_alive() and seen == [(mesh, "fsdp")]
    assert current_mesh() is None
    x = torch.ones(2)
    assert constrain(x, "data") is x


def test_layout_helpers_on_plain_tensors():
    x = torch.randn(2, 3, 20)
    assert torch.equal(ops.split_dim(x, 2, (5, 4)), x.reshape(2, 3, 5, 4))
    assert torch.equal(ops.merge_dims(x.reshape(2, 3, 5, 4), 2), x)
    k = torch.randn(2, 3, 2, 4)
    assert torch.equal(ops.repeat_heads(k, 3),
                       k.repeat_interleave(3, dim=2))
    b = torch.randn(20)
    assert torch.equal(ops.add_bias(x, b), x + b)
    assert torch.equal(ops.cumsum(x, 1), torch.cumsum(x, 1))
    t = torch.randn(7, 20)
    assert torch.equal(ops.tied_logits(x, t), torch.einsum("bsd,vd->bsv",
                                                           x, t))
    cache, row = torch.randn(2, 6, 20), torch.randn(2, 1, 20)
    want = cache.clone().index_copy_(1, torch.tensor([4]), row)
    assert torch.equal(ops.index_copy_(cache, 1, torch.tensor([4]), row),
                       want)


def test_layout_helpers_on_gloo_ranks(procs):
    rc, out, err = procs("gloo")
    assert rc == 0 and "RANKS OK" in out, out[-2000:] + err[-4000:]
