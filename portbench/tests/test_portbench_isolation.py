"""The import check compares whole top-level names, the benchmark loads
none of the JAX reference, and a run without a card, or without the
program beside it, prints no result."""
import json
import shutil
import subprocess
import sys

from portbench.harness import isolation
from portbench.harness import manifest as mf


def test_whole_top_level_names():
    assert isolation.forbidden_loaded(
        ["repro_torch", "repro_torch.models", "reproducible", "jaxtyping",
         "portbench.run", "flaxen"]) == []
    assert isolation.forbidden_loaded(
        ["repro", "repro.core.sweep", "jax.numpy", "jaxlib.xla_client",
         "flax.linen"]) == ["flax", "jax", "jaxlib", "repro"]


def test_benchmark_modules_load_no_jax():
    """Everything a run imports, in a fresh process: no forbidden name."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from portbench.run import prepare_process; prepare_process()\n"
        "import portbench.run, portbench.calibrate, portbench.faults\n"
        "from portbench.harness import manifest as mf\n"
        "man = mf.load_manifest()\n"
        "for w in man['workloads']:\n"
        "    c = mf.load_cell(man, w['name']); d = mf.driver(c.kind)\n"
        "    from portbench.harness import program\n"
        "    program.model_config(w['config'], c.arch)\n"
        "    import repro_torch.train, repro_torch.optim\n"
        "for m in man['per_layer']: mf.reader(m['name'])\n"
        "from portbench.harness import isolation\n"
        "print(isolation.forbidden_loaded())\n"
    ) % (str(mf.ROOT / "src"), str(mf.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd, env_extra=None):
    cell = mf.load_manifest()["workloads"][0]["name"]
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "3141592653", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def _no_result(out):
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    for ln in lines:
        try:
            rec = json.loads(ln)
        except ValueError:
            continue
        assert "metrics" not in rec


def test_no_card_no_result(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    out = _run(mf.ROOT)
    assert out.returncode != 0
    _no_result(out)


def test_benchmark_alone_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(mf.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(mf.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    _no_result(out)
