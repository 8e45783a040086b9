"""Flash attention with a GQA head map and its torch twin.

Port of the reference's K9 (``repro/kernels/flash_attention.py::
_flash_kernel``), reached through the ``ops`` contract
(``ops.flash_attention``): ``q [B, H, S, D]`` attends over ``k, v [B, Hkv,
S, D]`` with ``H % Hkv == 0``, query head ``h`` reading kv head
``h // (H // Hkv)``; scores are ``f32(q) @ f32(k).T`` times
``1 / sqrt(D)``, masked to ``row >= col`` under ``causal``; the output is
``[B, H, S, D]`` in ``q.dtype``.

* :func:`flash_attention` — the wrapper around the hand-written CUDA
  kernel ``repro_torch/csrc/flash_attention.cu`` (one block per 64 query
  rows of one head, K/V tiles of 64 rows staged as f32 in shared memory,
  an online softmax in f32, FP32 on CUDA cores).  It takes f32, f16 or
  bf16 operands of one dtype, any ``S >= 1`` and head dims up to 128.
  For CUDA tensors it launches the kernel or raises; for CPU tensors it
  runs the twin.  It takes no block sizes: ``bq``/``bk`` were the TPU's
  tile knobs and do not change the function.
* :func:`flash_attention_torch` — the plain-torch twin
  (``repro.kernels.ref.flash_attention_ref``): f32 softmax attention with
  the kv heads repeated, ``torch.matmul`` at full f32 precision (TF32
  off), over chunks of query rows so that no ``[B, H, S, S]`` score
  tensor is held at once.

Kernel, twin and reference sum in different orders and the kernel's
softmax is online, so they agree within a tolerance, not bit for bit: f32
``atol = rtol = 1e-5``, and one rounding of the output dtype beyond it.

What bounds the kernel on the card: the operations, ``4 D`` per unmasked
score.  In f32 all of them are FP32 (1.20e11 for qwen2-7b's heads at
S = 4096, causal: 1.80 ms at 67 TFLOP/s).  With f16/bf16 operands the
``2 D`` of ``Q K^T`` multiply half values, exact in f32, which the tensor
cores could do at 989 TFLOP/s; only ``P V`` (P in f32) needs FP32: 0.96 ms.

:data:`COUNTS` counts kernel launches and twin calls.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from .cuda_build import check_operands, launch, load_library

#: launches of the CUDA kernel / calls of the torch twin since the last
#: :func:`reset_counts`
COUNTS: Dict[str, int] = {"kernel_launches": 0, "twin_calls": 0}

#: dtypes the kernel takes, with their codes in the C interface
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: the largest head dim the kernel stages (``kMaxD`` in the .cu source)
_MAX_D = 128
#: the twin holds at most this many f32 scores at once
_TWIN_SCORES = 1 << 26

_LIB = {}


def reset_counts() -> None:
    """Zero the launch / twin-call counters."""
    for key in COUNTS:
        COUNTS[key] = 0


def _check_shapes(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> Tuple[int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q [B, H, S, D] and k, v "
                         f"[B, Hkv, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d:
        raise ValueError(f"k, v {tuple(k.shape)} must share B, S and D with "
                         f"q {tuple(q.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"GQA: {h} query heads are not a multiple of "
                         f"{hkv} kv heads")
    return b, h, hkv, s, d


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Softmax attention in f32, ``[B, H, S, D]`` in ``q.dtype``; at most
    ``_TWIN_SCORES`` scores are held at once (the chunk of query rows
    does not change the result beyond f32 rounding)."""
    COUNTS["twin_calls"] += 1
    b, h, hkv, s, d = _check_shapes(q, k, v)
    group = h // hkv
    kf = k.to(device=q.device, dtype=torch.float32)
    vf = v.to(device=q.device, dtype=torch.float32)
    if group > 1:
        kf = kf.repeat_interleave(group, dim=1)
        vf = vf.repeat_interleave(group, dim=1)
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    out = torch.empty((b, h, s, d), dtype=torch.float32, device=q.device)
    step = max(1, _TWIN_SCORES // max(b * h * s, 1))
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        for r0 in range(0, s, step):
            qc = q[:, :, r0:r0 + step].to(torch.float32)
            scores = torch.matmul(qc, kf.transpose(-1, -2)) * scale
            if causal:
                rows = torch.arange(r0, r0 + qc.shape[2], device=q.device)
                cols = torch.arange(s, device=q.device)
                scores = scores.masked_fill(cols[None, :] > rows[:, None],
                                            float("-inf"))
            out[:, :, r0:r0 + step] = torch.matmul(
                torch.softmax(scores, dim=-1), vf)
    finally:
        torch.set_float32_matmul_precision(precision)
    return out.to(q.dtype)


def load_kernel_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = _LIB.get("lib")
    if lib is not None:
        return lib
    lib = load_library("flash_attention")
    lib.repro_flash_attention.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.repro_flash_attention.restype = ctypes.c_int
    _LIB["lib"] = lib
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention of ``q [B, H, S, D]`` over ``k, v [B, Hkv, S, D]``.

    On CUDA tensors it launches the hand-written kernel on the current
    stream (no synchronisation) or raises; on CPU tensors it runs the
    twin.  The operands are f32, f16 or bf16, of one dtype; the kernel
    takes them contiguous, on one device, with ``D <= 128``.
    """
    b, h, hkv, s, d = _check_shapes(q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes q, k, v of one dtype, "
                         f"float32, float16 or bfloat16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    dev = q.device
    if dev.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{dev}, {k.device}, {v.device}")
    check_operands("flash_attention", dev, (q.dtype,), q=q, k=k, v=v)
    if d > _MAX_D:
        raise ValueError(f"flash_attention stages head dims up to {_MAX_D}, "
                         f"got D = {d}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = load_kernel_library()
    launch("flash_attention", lib.repro_flash_attention, dev, q.data_ptr(),
           k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
           b * h, h, hkv, s, d, 1.0 / math.sqrt(d), int(bool(causal)))
    COUNTS["kernel_launches"] += 1
    return out
