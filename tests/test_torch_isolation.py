"""The PyTorch port stands alone: no jax, no ``repro``, no silent CPU.

* a fresh interpreter that imports ``repro_torch`` and runs a tiny CPU
  ``explore`` on the grid, staged and fused engines has loaded no
  ``jax*`` module and no ``repro`` / ``repro.*`` module, and neither has
  one that imports ``repro_torch.functional`` and runs ``fig5_pipeline``
  and ``edgaze_frontend`` on CPU tensors;
* an AST scan of every ``src/repro_torch/**/*.py`` and of
  ``chip_smoke.py`` finds no ``import jax`` and no ``import repro`` /
  ``from repro ...``;
* without CUDA, ``explore(space)`` on the default device raises;
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
bad = sorted(m for m in sys.modules
             if m.startswith("jax") or m == "repro" or m.startswith("repro."))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_functional_on_cpu_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _CHILD_FUNCTIONAL],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


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


def test_unported_engines_and_layers_raise():
    """Every engine of ``explore()`` runs; the multi-device, campaign and
    serving layers still raise naming their ROADMAP item."""
    from repro_torch.explore import DesignSpace, explore
    space = DesignSpace(["edgaze"], {"variant": ["2d_in"]})
    for engine in ("monolithic", "chunked", "staged", "fused"):
        res = explore(space, k=1, engine=engine, device="cpu")
        assert res.engine == engine and res.n_points == 1
    for kwarg in ("mesh", "checkpoint_dir", "campaign", "workers",
                  "service"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            explore(space, k=1, device="cpu", **{kwarg: object()})
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
    assert fs.COUNTS == {"kernel_launches": 0, "twin_calls": 1}
    assert [tuple(t.shape) for t in out] == [(1, 2), (1, 2), (1,), (1,)]
