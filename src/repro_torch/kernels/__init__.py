"""Hand-written CUDA kernels of the port and their plain-torch twins.

* ``fused_sweep`` (K1) — the fused decode -> evaluate -> reduce sweep
  megakernel of the fused streaming engine;
* ``grid_decode`` (K2) — flat stream indices -> axis values + variant
  ids, for the staged engine;
* ``stream_reduce`` (K3a/K3b) — per-block (and per-variant) masked
  min / argmin / sum / count, for the staged engine;
* ``category_reduce`` (K4) — ``[B, U] @ [U, C]`` per-category sums of
  the per-plan evaluator (grid engines);
* ``runtime`` — device and sweep-backend selection; ``cuda_build`` —
  ``nvcc`` builds and ``ctypes`` loading.

Each wrapper launches its CUDA kernel on a CUDA tensor and runs its twin
(``*_torch``) on a CPU tensor.  Importing this package builds nothing;
the fused-sweep names load lazily (``fused_sweep`` imports the core
physics, which imports ``category_reduce`` from here).
"""
import importlib

from .category_reduce import category_reduce, category_reduce_torch
from .grid_decode import grid_decode, grid_decode_torch, grid_strides
from .runtime import (SWEEP_BACKENDS, explicit_backend, resolve_backend,
                      resolve_device)
from .stream_reduce import (block_stats, block_stats_banked,
                            block_stats_banked_torch, block_stats_torch,
                            masked_stats)

_LAZY = ("fused_sweep_block", "fused_sweep_block_torch")

__all__ = ["SWEEP_BACKENDS", "block_stats", "block_stats_banked",
           "block_stats_banked_torch", "block_stats_torch",
           "category_reduce", "category_reduce_torch", "explicit_backend",
           "fused_sweep_block", "fused_sweep_block_torch", "grid_decode",
           "grid_decode_torch", "grid_strides", "masked_stats",
           "resolve_backend", "resolve_device"]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(".fused_sweep", __name__), name)
