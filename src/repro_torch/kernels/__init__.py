"""Hand-written CUDA kernels of the port and their plain-torch twins.

* ``fused_sweep`` (K1) — the fused decode -> evaluate -> reduce sweep
  megakernel of the fused streaming engine;
* ``grid_decode`` (K2) — flat stream indices -> axis values + variant
  ids, for the staged engine: a thread takes four positions of one
  output row, decodes the first without a division (magic multipliers,
  shared with K1), steps to the rest and stores 16 bytes;
* ``stream_reduce`` (K3a/K3b) — per-block (and per-variant) masked
  min / argmin / sum / count, for the staged engine;
* ``category_reduce`` (K4) — ``[B, U] @ [U, C]`` per-category sums of
  the per-plan evaluator (grid engines);
* ``binning`` (K5), ``stencil_conv`` (K6), ``frame_event`` (K7) and
  ``matmul`` (K8) — the functional simulator's kernels, reached through
  ``ops`` (the reference's ``ops.py`` contract, with ``use_pallas``);
* ``flash_attention`` (K9) — online-softmax attention with a GQA head
  map, reached through ``ops.flash_attention``;
* ``runtime`` — device and sweep-backend selection; ``cuda_build`` —
  ``nvcc`` builds, ``ctypes`` loading and launches.

Each wrapper launches its CUDA kernel on a CUDA tensor and runs its twin
(``*_torch``) on a CPU tensor.  Importing this package builds nothing;
the fused-sweep names load lazily (``fused_sweep`` imports the core
physics, which imports ``category_reduce`` from here).
"""
import importlib

from .binning import binning, binning_torch
from .category_reduce import category_reduce, category_reduce_torch
from .flash_attention import flash_attention, flash_attention_torch
from .frame_event import frame_event, frame_event_torch
from .grid_decode import grid_decode, grid_decode_torch, grid_strides
from .matmul import matmul, matmul_torch
from .runtime import (SWEEP_BACKENDS, explicit_backend, resolve_backend,
                      resolve_device)
from .stencil_conv import stencil_conv, stencil_conv_torch
from .stream_reduce import (block_stats, block_stats_banked,
                            block_stats_banked_torch, block_stats_torch,
                            masked_stats)

_LAZY = ("fused_sweep_block", "fused_sweep_block_torch")

__all__ = ["SWEEP_BACKENDS", "binning", "binning_torch", "block_stats",
           "block_stats_banked", "block_stats_banked_torch",
           "block_stats_torch", "category_reduce", "category_reduce_torch",
           "explicit_backend", "flash_attention", "flash_attention_torch",
           "frame_event", "frame_event_torch",
           "fused_sweep_block", "fused_sweep_block_torch", "grid_decode",
           "grid_decode_torch", "grid_strides", "masked_stats", "matmul",
           "matmul_torch", "resolve_backend", "resolve_device",
           "stencil_conv", "stencil_conv_torch"]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(".fused_sweep", __name__), name)
