"""Build and load the port's CUDA kernels: ``nvcc`` -> shared library ->
``ctypes``.

Each kernel source under ``repro_torch/csrc/`` is compiled at first use
into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         --fmad=false -shared -Xcompiler -fPIC -o lib<name>-<hash>.so <src>

into ``build/repro_torch/`` at the repository root (listed in
``.gitignore``), keyed by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads in milliseconds.  No
PyTorch header is included: a build takes seconds, not minutes.  A
failed build raises with nvcc's stderr in the message.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: Hopper only (``sm_90a``).  No fast-math: the kernels rely on isnan,
#: +-inf and IEEE division; ``--fmad=false`` keeps the separate
#: multiply/add rounding of the plain-torch twins.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

#: loaded libraries by source name: (handle, build log, build seconds)
_LOADED: Dict[str, Tuple[ctypes.CDLL, str, float]] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH); the CUDA "
            f"kernels are built from source at first use and need the "
            f"CUDA toolkit")
    return found


def _compile(src: Path, out: Path) -> str:
    """Compile ``src`` into ``out`` atomically; returns nvcc's output."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {src.name}:\n"
                f"$ {' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)        # concurrent builds race harmlessly
        return proc.stderr + proc.stdout
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; memoized per
    process."""
    hit = _LOADED.get(name)
    if hit is not None:
        return hit[0]
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not out.is_file():
        log = _compile(src, out)
        (out.with_suffix(".log")).write_text(log)
    elif out.with_suffix(".log").is_file():
        log = out.with_suffix(".log").read_text()
    lib = ctypes.CDLL(str(out))
    _LOADED[name] = (lib, log, time.perf_counter() - t0)
    return lib


def build_info(name: str) -> Dict[str, object]:
    """``{"seconds", "log"}`` of a loaded library: the first-use build
    (or load) time in this process and nvcc's ``-Xptxas=-v`` report."""
    _lib, log, seconds = _LOADED[name]
    return {"seconds": seconds, "log": log}
