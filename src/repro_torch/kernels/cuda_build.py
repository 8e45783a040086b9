"""Build and load the port's CUDA kernels: ``nvcc`` -> shared library ->
``ctypes``.

Each kernel source under ``repro_torch/csrc/`` is compiled at first use
into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         --fmad=false -shared -Xcompiler -fPIC -o lib<name>-<hash>.so <src>

into ``build/repro_torch/`` at the repository root (listed in
``.gitignore``), keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one loads in milliseconds.  No PyTorch header is included: a
build takes seconds, not minutes.  :func:`build_libraries` starts one
nvcc per source, all at once, and waits for them together.  A failed
build raises with nvcc's stderr in the message.

Every wrapper checks its CUDA operands with :func:`check_operands` and
calls its library's C entry point through :func:`launch`, which passes
the current stream, switches the current
device only when the operands lie on another one, and raises on a
nonzero ``cudaError_t``.
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

import torch

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
#: SM count by device index
_SMS: Dict[int, int] = {}


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


def _library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by the source, the
    shared headers and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_libraries(names) -> float:
    """Build every missing ``csrc/<name>.cu`` at once (one nvcc process
    per source, started together) and wait for all of them; returns the
    wall seconds.  Raises with nvcc's output if any build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for name in dict.fromkeys(names):
            out = _library_path(name)
            if out.is_file():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                   str(CSRC_DIR / f"{name}.cu")]
            jobs.append((name, out, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for name, out, tmp, cmd, proc in jobs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) building "
                              f"{name}.cu:\n$ {' '.join(cmd)}\n"
                              f"{stderr}{stdout}")
                continue
            os.replace(tmp, out)        # concurrent builds race harmlessly
            out.with_suffix(".log").write_text(stderr + stdout)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _name, _out, tmp, _cmd, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return time.perf_counter() - t0


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; memoized per
    process."""
    hit = _LOADED.get(name)
    if hit is not None:
        return hit[0]
    out = _library_path(name)
    t0 = time.perf_counter()
    if not out.is_file():
        build_libraries([name])
    log_path = out.with_suffix(".log")
    log = log_path.read_text() if log_path.is_file() else ""
    lib = ctypes.CDLL(str(out))
    _LOADED[name] = (lib, log, time.perf_counter() - t0)
    return lib


def check_operands(name: str, device, dtypes, **tensors) -> None:
    """Raise ``ValueError`` unless every tensor lies on ``device``, is
    contiguous and has one of ``dtypes``: what a kernel takes."""
    for arg, t in tensors.items():
        if t.dtype not in dtypes or not t.is_contiguous() \
                or t.device != device:
            raise ValueError(
                f"{name}: {arg} must be a contiguous "
                f"{' or '.join(str(d) for d in dtypes)} tensor on {device}, "
                f"got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})")


def sm_count(device) -> int:
    """The number of SMs of a CUDA device (its index, or the current
    device when it has none); read once per device."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def launch(name: str, entry, device, *args) -> None:
    """Call a kernel's C entry point with ``args`` and the current stream
    of ``device`` last; raise if it returns a nonzero ``cudaError_t`` (a
    refused launch never runs, and a later synchronise does not report
    it).

    The stream comes from ``torch._C._cuda_getCurrentRawStream``, the
    call PyTorch's own code generator (Inductor) makes for its kernel
    launches: it returns the pointer and builds no ``torch.cuda.Stream``.
    On an H100's host (``chip_smoke.py``'s ``launch_probe`` line) it takes
    0.13-0.23 us a call against 2.8-5.3 us for the public
    ``torch.cuda.current_stream(index).cuda_stream``.

    The C entry launches on the calling thread's current device, so the
    device is switched (``torch.cuda.device``) only when it is not
    already ``device``'s: one integer compare (0.1-0.2 us) on the common
    path instead of a context manager (1.8-3.5 us) on every call."""
    index = device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if torch._C._cuda_getDevice() == index:
        err = entry(*args, stream)
    else:
        with torch.cuda.device(index):
            err = entry(*args, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def build_info(name: str) -> Dict[str, object]:
    """``{"seconds", "log"}`` of a loaded library: the first-use build
    (or load) time in this process and nvcc's ``-Xptxas=-v`` report."""
    _lib, log, seconds = _LOADED[name]
    return {"seconds": seconds, "log": log}
