"""The PyTorch port stands alone: no jax, no ``repro``, no silent CPU.

* a fresh interpreter that imports ``repro_torch`` and runs a tiny CPU
  ``explore`` on the grid, staged and fused engines has loaded no
  ``jax*`` module and no ``repro`` / ``repro.*`` module, nor has one that
  runs CPU campaigns (serial and ``workers=2``; each worker reports its
  own modules, none of them either), nor one that imports
  ``repro_torch.serve`` and serves a coalesced pair, a streamed request
  and a staged one on the CPU, and neither has
  one that imports ``repro_torch.functional`` and runs ``fig5_pipeline``
  and ``edgaze_frontend`` on CPU tensors, then
  ``repro_torch.kernels.ops.flash_attention`` on CPU tensors, nor one
  that imports ``repro_torch.models`` and serves a reduced model through
  ``repro_torch.launch.serve_lm`` on the CPU, then trains it a step and
  runs ``repro_torch.launch.train`` for two;
* an AST scan of every ``src/repro_torch/**/*.py`` and of
  ``chip_smoke.py`` finds no ``import jax`` and no ``import repro`` /
  ``from repro ...``;
* without CUDA, ``explore(space)`` on the default device raises, and so
  do the LM stack's ``init_params``, ``init_cache``,
  ``params_from_numpy``, ``serve_lm`` and ``launch.train``;
* the sweep-backend policy mirrors the reference's
  (``tests/test_kernels.py``): ``auto`` follows the device, the
  environment overrides ``auto``, an explicit argument beats the
  environment, and invalid values raise listing the valid set.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

_CHILD = r"""
import sys
import repro_torch
from repro_torch.explore import DesignSpace, explore
space = DesignSpace(["edgaze"], {"variant": ["2d_in"],
                                 "cis_node": [130.0, 65.0]})
for engine, backend in (("auto", None), ("staged", "torch"),
                        ("fused", "torch")):
    res = explore(space, k=2, engine=engine, device="cpu")
    assert res.n_points == 2 and res.backend == backend, res
bad = sorted(m for m in sys.modules
             if m.startswith("jax") or m == "repro" or m.startswith("repro."))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_import_and_cpu_explore_load_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


_CHILD_FUNCTIONAL = r"""
import sys
import torch
import repro_torch.functional as fn
img = torch.rand(64, 96, generator=torch.Generator().manual_seed(0))
assert tuple(fn.fig5_pipeline(img).shape) == (30, 46)
events, binned = fn.edgaze_frontend(img, torch.zeros(32, 48))
assert events.shape == binned.shape == (32, 48)
from repro_torch.kernels import ops
q = torch.rand(1, 4, 70, 16, dtype=torch.bfloat16)
kv = torch.rand(1, 2, 70, 16, dtype=torch.bfloat16)
assert ops.flash_attention(q, kv, kv).shape == q.shape
bad = sorted(m for m in sys.modules
             if m.startswith("jax") or m == "repro" or m.startswith("repro."))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


_CHILD_CAMPAIGN = r"""
import sys, tempfile
from repro_torch.campaign import CampaignOptions
from repro_torch.explore import DesignSpace, explore
space = DesignSpace(["edgaze"], {"variant": ["2d_in", "3d_in"],
                                 "cis_node": [130.0, 65.0]})
for workers in (None, 2):
    with tempfile.TemporaryDirectory() as d:
        res = explore(space, k=2, engine="fused", chunk_size=2,
                      device="cpu", checkpoint_dir=d, workers=workers,
                      campaign=CampaignOptions(shard_points=1))
        assert res.n_points == 4 and not res.campaign["partial"], res
        if workers:
            mods = res.campaign["worker_modules"]
            assert len(mods) == 2, mods
            print("WORKERS", sorted(m for ms in mods.values() for m in ms))
bad = sorted(m for m in sys.modules
             if m.startswith("jax") or m == "repro" or m.startswith("repro."))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_cpu_campaigns_load_no_jax_and_no_repro():
    """A serial and a ``workers=2`` campaign, in the parent and in each
    spawned worker."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _CHILD_CAMPAIGN], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "WORKERS []" in proc.stdout
    assert "LOADED []" in proc.stdout


_CHILD_SERVE = r"""
import sys, threading
import repro_torch.serve
from repro_torch.explore import DesignSpace, explore
from repro_torch.serve import ExploreService
grids = {"variant": ["2d_in", "3d_in"], "cis_node": [130.0, 65.0]}
spaces = [DesignSpace(["edgaze"], dict(grids, vdd_scale=[0.8 + 0.1 * i]))
          for i in range(2)]
with ExploreService(coalesce_window_s=0.2, device="cpu") as svc:
    out = {}
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, explore(spaces[i], k=2, chunk_size=1, service=svc)))
        for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(r.serve["coalesce_group"] == 2 for r in out.values()), out
    h = svc.submit(spaces[0], k=2, chunk_size=1, superchunk=1, stream=True)
    assert list(h.partials())[-1].final
    assert svc.explore(spaces[1], k=3, engine="staged").engine == "staged"
bad = sorted(m for m in sys.modules
             if m.startswith("jax") or m == "repro" or m.startswith("repro."))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_serve_on_cpu_loads_no_jax_and_no_repro():
    """``repro_torch.serve``: a coalesced pair through
    ``explore(service=)``, a streamed request and a staged one."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _CHILD_SERVE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_functional_on_cpu_loads_no_jax_and_no_repro():
    """The functional pipelines and ``ops.flash_attention`` on CPU
    tensors."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _CHILD_FUNCTIONAL],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


_CHILD_LM = r"""
import sys
import repro_torch.models
from repro_torch.launch import serve_lm
from repro_torch.models import model as M
from repro_torch.train import build_prefill
assert serve_lm.main(["--arch", "zamba2_1p2b", "--device", "cpu",
                      "--batch", "1", "--prompt-len", "40",
                      "--new-tokens", "3"]) == 0
import tempfile
import repro_torch.ckpt, repro_torch.data, repro_torch.optim
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticTextDataset
from repro_torch.launch import train
from repro_torch.train import TrainLoop, build_train_step
cfg = reduced(get_config("zamba2_1p2b"))
params = M.init_params(cfg, 0, device="cpu")
opt = repro_torch.optim.adamw_init(params)
ds = SyntheticTextDataset(cfg.vocab, 16, 2, mode="structured")
params, opt, m = build_train_step(cfg)(params, opt,
                                       {"tokens": ds.batch_at(0)}, 0)
assert m["loss"].isfinite()
with tempfile.TemporaryDirectory() as d:
    assert train.main(["--arch", "qwen3_4b", "--reduced", "--device", "cpu",
                       "--steps", "2", "--seq", "16", "--ckpt-dir", d]) == 0
import repro_torch.distributed as D
from repro_torch.launch import LMMesh
mesh = LMMesh((2, 16, 16), ("pod", "data", "model"))
for profile in ("tp", "fsdp"):
    D.param_shardings(M.abstract_params(get_config("mixtral_8x7b")), mesh,
                      profile=profile)
D.cache_shardings(mesh, M.abstract_cache(cfg, 32, 64), 32)
q, s = D.quantize_int8(params["embed"])
assert q.dtype.itemsize == 1
bad = sorted(m for m in sys.modules
             if m.startswith("jax") or m == "repro" or m.startswith("repro."))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_lm_serving_on_cpu_loads_no_jax_and_no_repro():
    """``repro_torch.models`` and the serving entry point
    ``repro_torch.launch.serve_lm``, serving a reduced zamba2 (mamba2
    blocks, the shared attention block, a ring past its window); then a
    CPU train step of the same model and two steps of the training entry
    point ``repro_torch.launch.train`` (optim, data, ckpt, the loop),
    and the mesh's rules and int8 compression (``repro_torch.
    distributed``) at the production mesh's sizes."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _CHILD_LM], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
    assert "arch=zamba2_1p2b family=hybrid" in proc.stdout


@pytest.mark.parametrize("entry", ["init_params", "init_cache",
                                   "params_from_numpy", "serve_lm",
                                   "launch_train"])
def test_lm_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                              entry):
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve_lm, train
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_numpy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("qwen2_7b"))
    calls = {
        "init_params": lambda: M.init_params(cfg, 0),
        "init_cache": lambda: M.init_cache(cfg, 1, 8),
        "params_from_numpy": lambda: params_from_numpy(
            {"embed": np.zeros((2, 2), np.float32)}),
        "serve_lm": lambda: serve_lm.main(["--arch", "qwen2_7b"]),
        "launch_train": lambda: train.main(["--arch", "qwen2_7b",
                                            "--reduced"]),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _offenders(files):
    return [(str(path), name) for path in files for name in _imports(path)
            if name.split(".")[0] in ("jax", "jaxlib", "repro")]


def test_port_sources_import_no_jax_and_no_repro():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20, files
    assert PORT / "launch" / "mesh.py" in files
    for module in ("models/model.py", "models/config.py",
                   "configs/qwen2_7b.py", "train/steps.py",
                   "launch/serve_lm.py", "train/loop.py", "optim/adamw.py",
                   "optim/schedule.py", "data/synthetic.py",
                   "ckpt/manager.py", "launch/train.py"):
        assert PORT / module in files, module
    offenders = _offenders(files)
    assert not offenders, offenders


def test_chip_smoke_imports_no_jax_and_no_repro():
    """The GPU smoke script drives the port alone."""
    script = SRC.parent / "chip_smoke.py"
    assert "repro_torch" in script.read_text()
    offenders = _offenders([script])
    assert not offenders, offenders


def test_default_device_without_cuda_raises(monkeypatch):
    from repro_torch.explore import DesignSpace, explore
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    space = DesignSpace(["edgaze"], {"variant": ["2d_in"]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        explore(space, k=1)


@pytest.mark.parametrize("entry", ["build_plan_bank", "bank_from_reference",
                                   "_prepare_stream"])
def test_bank_and_prep_default_device_without_cuda_raises(monkeypatch,
                                                          entry):
    """The lower-level entry points also default to ``cuda``: without a
    GPU they raise rather than build CPU tensors the wrapper would hand
    to the twin."""
    import numpy as np
    from repro_torch.core import plan_bank
    from repro_torch.core.grid import lower_variant
    from repro_torch.core.shard_sweep import _prepare_stream
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = lower_variant("edgaze", "2d_in")
    calls = {
        "build_plan_bank": lambda: plan_bank.build_plan_bank([plan]),
        "bank_from_reference": lambda: plan_bank.bank_from_reference(
            {"fused": np.zeros((1, 1), np.float32)}, (1, 0, 0, 0, 0, 0)),
        "_prepare_stream": lambda: _prepare_stream(
            "edgaze", {"variant": ["2d_in"]}),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_unported_engines_and_layers_raise(tmp_path):
    """Every engine of ``explore()`` runs, and so do a campaign
    (``checkpoint_dir=`` with ``campaign=`` and ``workers=``), a
    served request (``service=``; anything but a service raises
    ``TypeError``) and the multi-device split (``mesh=``, a
    ``BatchMesh``; anything else raises ``TypeError``)."""
    from repro_torch.campaign import CampaignOptions
    from repro_torch.explore import DesignSpace, explore
    from repro_torch.launch import make_batch_mesh
    from repro_torch.serve import ExploreService
    space = DesignSpace(["edgaze"], {"variant": ["2d_in"]})
    for engine in ("monolithic", "chunked", "staged", "fused"):
        res = explore(space, k=1, engine=engine, device="cpu")
        assert res.engine == engine and res.n_points == 1
    res = explore(space, k=1, device="cpu", checkpoint_dir=str(tmp_path),
                  campaign=CampaignOptions(), workers=1)
    assert res.n_points == 1 and res.campaign["n_executed"] == 1
    for engine in ("monolithic", "staged", "fused"):
        res = explore(space, k=1, engine=engine,
                      mesh=make_batch_mesh(2, device="cpu"))
        assert res.n_devices == 2 and res.n_points == 1, res
    with pytest.raises(TypeError, match="BatchMesh"):
        explore(space, k=1, device="cpu", mesh=object())
    with ExploreService(device="cpu") as svc:
        res = explore(space, k=1, service=svc, device="cpu")
    assert res.serve is not None and res.n_points == 1
    with pytest.raises(TypeError, match="ExploreService"):
        explore(space, k=1, device="cpu", service=object())
    with pytest.raises(ValueError, match="unknown engine"):
        explore(space, k=1, engine="warp", device="cpu")


# ---------------------------------------------------------------------------
# sweep-backend selection (mirrors tests/test_kernels.py:155-220)
# ---------------------------------------------------------------------------
def test_resolve_backend_auto_follows_device(monkeypatch):
    from repro_torch.kernels import runtime
    monkeypatch.delenv("REPRO_TORCH_SWEEP_BACKEND", raising=False)
    for deferred in (None, "auto"):
        assert runtime.explicit_backend(deferred) is None
        assert runtime.resolve_backend(deferred, "cpu") == "torch"
        assert runtime.resolve_backend(deferred, "cuda") == "cuda"


def test_resolve_backend_env_override(monkeypatch):
    from repro_torch.kernels import runtime
    monkeypatch.setenv("REPRO_TORCH_SWEEP_BACKEND", "torch")
    assert runtime.resolve_backend(None, "cuda") == "torch"
    assert runtime.explicit_backend(None) == "torch"
    monkeypatch.setenv("REPRO_TORCH_SWEEP_BACKEND", "cuda")
    assert runtime.resolve_backend("auto", "cuda") == "cuda"
    # "auto" in the env defers to the device policy
    monkeypatch.setenv("REPRO_TORCH_SWEEP_BACKEND", "auto")
    assert runtime.explicit_backend(None) is None


def test_resolve_backend_argument_beats_env(monkeypatch):
    from repro_torch.kernels import runtime
    monkeypatch.setenv("REPRO_TORCH_SWEEP_BACKEND", "cuda")
    assert runtime.resolve_backend("torch", "cpu") == "torch"
    monkeypatch.setenv("REPRO_TORCH_SWEEP_BACKEND", "torch")
    assert runtime.resolve_backend("cuda", "cuda") == "cuda"


def test_resolve_backend_invalid_values_raise(monkeypatch):
    from repro_torch.kernels import runtime
    monkeypatch.setenv("REPRO_TORCH_SWEEP_BACKEND", "triton")
    with pytest.raises(ValueError) as ei:
        runtime.resolve_backend(None, "cpu")
    msg = str(ei.value)
    assert "REPRO_TORCH_SWEEP_BACKEND" in msg and "'triton'" in msg
    assert "'cuda'" in msg and "'torch'" in msg
    monkeypatch.delenv("REPRO_TORCH_SWEEP_BACKEND")
    with pytest.raises(ValueError, match="pallas"):
        runtime.resolve_backend("pallas", "cpu")


def test_resolve_backend_cuda_on_cpu_raises(monkeypatch):
    from repro_torch.kernels import runtime
    monkeypatch.delenv("REPRO_TORCH_SWEEP_BACKEND", raising=False)
    with pytest.raises(ValueError, match="CUDA device"):
        runtime.resolve_backend("cuda", "cpu")
    monkeypatch.setenv("REPRO_TORCH_SWEEP_BACKEND", "cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        runtime.resolve_backend(None, "cpu")


def test_kernel_wrapper_on_cpu_tensors_runs_the_twin():
    """For a CPU tensor the wrapper takes the twin, and only the twin
    counter moves; the kernel counter moves only where it launches."""
    from repro_torch.core.batch import build_coeff_compute
    from repro_torch.core.shard_sweep import _prepare_stream
    from repro_torch.kernels import fused_sweep as fs
    prep = _prepare_stream("edgaze", {"variant": ["2d_in"],
                                      "cis_node": [130.0, 65.0]},
                           device="cpu")
    fs.reset_counts()
    out = fs.fused_sweep_block(
        prep.table2, prep.bank.fused[0], 0, 0, prep.total,
        compute=build_coeff_compute(prep.bank.dims), metric="total_j",
        axis_names=tuple(prep.vgrids[0].names), shape=prep.vgrids[0].shape,
        n_var=prep.n_var, total=prep.total, chunk=prep.n_var, lmax=prep.lmax,
        block_points=4, kk=2)
    assert fs.COUNTS == {"kernel_launches": 0, "twin_calls": 1,
                         "cluster1_launches": 0, "cluster2_launches": 0,
                         "cluster4_launches": 0, "cluster8_launches": 0}
    assert [tuple(t.shape) for t in out] == [(1, 2), (1, 2), (1,), (1,)]
