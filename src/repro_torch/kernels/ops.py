"""The functional simulator's kernel entry points (the ``ops.py`` contract).

The reference's ``repro/kernels/ops.py`` for binning, stencil_conv,
frame_event and matmul, with its signatures and ``use_pallas`` keyword:

* ``use_pallas=True`` runs the hand-written CUDA kernel on a CUDA tensor
  (or raises) and the kernel's plain-torch twin on a CPU tensor;
* ``use_pallas=False`` runs the twin on either device, as the reference
  runs its pure-jnp oracle (``repro/kernels/ref.py``).

``matmul`` takes no block sizes: ``bm``/``bn``/``bk`` were the TPU's
tile knobs, and passing one raises ``TypeError``.  ``flash_attention``
(K9) is not ported yet.
"""
from __future__ import annotations

from .binning import binning as _binning, binning_torch
from .frame_event import frame_event as _frame_event, frame_event_torch
from .matmul import matmul as _matmul, matmul_torch
from .stencil_conv import stencil_conv as _stencil_conv, stencil_conv_torch


def binning(image, factor: int = 2, use_pallas: bool = True):
    if not use_pallas:
        return binning_torch(image, factor)
    return _binning(image, factor=factor)


def stencil_conv(image, kernel, use_pallas: bool = True):
    if not use_pallas:
        return stencil_conv_torch(image, kernel)
    return _stencil_conv(image, kernel)


def frame_event(cur, prev, threshold: float = 0.1, use_pallas: bool = True):
    if not use_pallas:
        return frame_event_torch(cur, prev, threshold)
    return _frame_event(cur, prev, threshold=threshold)


def matmul(a, b, use_pallas: bool = True):
    if not use_pallas:
        return matmul_torch(a, b)
    return _matmul(a, b)
