"""Flash attention with a GQA head map and its torch twin.

Port of the reference's K9 (``repro/kernels/flash_attention.py::
_flash_kernel``), reached through the ``ops`` contract
(``ops.flash_attention``): ``q [B, H, S, D]`` attends over ``k, v [B, Hkv,
S, D]`` with ``H % Hkv == 0``, query head ``h`` reading kv head
``h // (H // Hkv)``; scores are ``f32(q) @ f32(k).T`` times
``1 / sqrt(D)``, masked to ``row >= col`` under ``causal``; the output is
``[B, H, S, D]`` in ``q.dtype``.

* :func:`flash_attention` — the wrapper around the hand-written CUDA
  kernels of ``repro_torch/csrc/flash_attention.cu``.  Each operand is
  f32, f16 or bf16 (the reference casts each to f32; the output is in
  ``q.dtype``), with any ``S >= 1`` and any head dim, and it picks one of
  four routes (:func:`route`), all on Hopper's tensor cores:

  - ``"wgmma"``, f16/bf16 operands of one dtype with ``D % 8 == 0``,
    ``D <= 128`` and 16-byte-aligned bases: Hopper's tensor cores.  K/V
    tiles arrive by TMA into a ring of shared-memory stages; ``Q K^T`` and
    ``P V`` are ``wgmma`` products with f32 accumulators, and P keeps its
    f32 precision as the sum of two halves, ``P_hi + P_lo``, each
    multiplied by V;
  - ``"tf32x3"``, f32 and mixed operands (any other combination of the
    three dtypes) with ``D <= 128``, rows of a 16-byte multiple (``D % 4
    == 0`` when all are f32, ``D % 8 == 0`` when one is a half type) and
    16-byte-aligned bases: the tensor cores in TF32, three TF32 products
    for each f32 one.  Each f32 operand is split as ``hi = tf32(x)``, ``lo =
    tf32(x - hi)`` (round to nearest, ties away), and ``a b`` becomes
    ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` with f32 accumulation, each
    term exact in f32: one TF32 product keeps ~2^-11 of a score, which is
    another function than the reference's, while the three keep ~2^-22.
    A half operand is exact in TF32, so its ``lo`` and the product it
    feeds are dropped; P is split as the operands are;
  - ``"tf32x3_any"``, every other call with ``D <= 256`` (D past 128, rows
    TMA does not move, a misaligned base), any dtype mix: the same 3xTF32
    arithmetic in warp-level ``mma.sync`` products, the operands loaded
    through registers (16-byte loads where base and row allow), split by
    a producer warpgroup and staged in shared memory;
  - ``"tf32x3_wide"``, every call with ``D > 256``, any dtype mix and
    alignment: the same 3xTF32 ``mma.sync`` arithmetic with O's columns
    split over a pair of warps for each 16 query rows; each warp
    multiplies its half of Q by its half of K, the pair adds the two
    partial scores in one order (half 0 + half 1), and each warp
    multiplies P by its half of V.  Past ``D = 512`` O is written in slabs
    of 512 columns, one kv walk a slab, each walk summing every score over
    all of D in the same order.

  For CUDA tensors it launches the route's kernel or raises; for CPU
  tensors it runs the twin.  It takes no block sizes: ``bq``/``bk`` were
  the TPU's tile knobs and do not change the function.
* :func:`flash_attention_torch` — the plain-torch twin
  (``repro.kernels.ref.flash_attention_ref``): f32 softmax attention with
  the kv heads repeated, ``torch.matmul`` at full f32 precision (TF32
  off), over chunks of query rows so that no ``[B, H, S, S]`` score
  tensor is held at once.

Kernels, twin and reference sum in different orders and the kernels'
softmax is online, so they agree within a tolerance, not bit for bit: f32
``atol = rtol = 1e-5``, and one rounding of the output dtype beyond it.
The split P is within ``2^-16`` (bf16) or ``2^-22`` (f16) of the f32 P; a
P rounded once to the half dtype, as ``scaled_dot_product_attention``
rounds it, is another function and misses that tolerance.  The
tolerance is the reference's at scores of a few units; at scores of
hundreds an ulp of a score is ~3e-5 of P, so any other summation order
of the same f32 function (an exact one included) misses ``1e-5`` against
the twin there: such inputs are held to the exact (f64) function instead.

What bounds the kernels on the card: the operations.  For qwen2-7b's
heads at S = 4096, causal, the wgmma route does ``6 D`` half operations
per unmasked score (``2 D`` for ``Q K^T``, ``4 D`` for the split
``P V``) at the tensor cores' 989 TFLOP/s: 1.80e11, 0.182 ms.  The
tf32x3 route does ``12 D`` TF32 operations (``2 D`` fewer for each
half operand: ``10 D`` with a bf16 q) at 495 TFLOP/s: 3.61e11,
0.729 ms; the tf32x3_any route counts the same, 0.140 ms at f32, D = 160,
1x16x16x1500 full, and the tf32x3_wide route 0.279 ms at D = 320 (0.0699
ms with every operand bf16: ``6 D`` half operations at 989 TFLOP/s).

:data:`COUNTS` counts kernel launches, in all and by route, and twin
calls.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from .cuda_build import check_operands, launch, load_library

#: launches of the CUDA kernels (in all, and of each route's kernel) /
#: calls of the torch twin since the last :func:`reset_counts`
COUNTS: Dict[str, int] = {"kernel_launches": 0, "wgmma_launches": 0,
                          "tf32x3_launches": 0, "tf32x3_any_launches": 0,
                          "tf32x3_wide_launches": 0, "twin_calls": 0}

#: dtypes the kernel takes, with their codes in the C interface
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: the largest head dim of the TMA routes (``kMaxD`` in the .cu source)
_MAX_D = 128
#: the largest head dim of the tf32x3_any route; tf32x3_wide takes more
_MAX_D_ANY = 256
#: dtypes the wgmma route takes
_HALF = (torch.float16, torch.bfloat16)
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


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that :func:`flash_attention` launches for CUDA operands.
    Both TMA routes take ``D`` up to 128, rows of a 16-byte multiple (TMA
    moves no other) and 16-byte-aligned bases (a tensor map's address):
    ``"wgmma"`` f16/bf16 operands of one dtype (``D % 8 == 0``),
    ``"tf32x3"`` any other mix of f32, f16 and bf16 (``D % 4 == 0`` when
    all are f32, else ``D % 8 == 0``); ``"tf32x3_any"`` every other call
    with ``D <= 256``; ``"tf32x3_wide"`` every call with ``D > 256``."""
    d = q.shape[-1]
    if d > _MAX_D_ANY:
        return "tf32x3_wide"
    dtypes = {q.dtype, k.dtype, v.dtype}
    if d <= _MAX_D and all(t.data_ptr() % 16 == 0 for t in (q, k, v)):
        if len(dtypes) == 1 and q.dtype in _HALF:
            if d % 8 == 0:
                return "wgmma"
        elif d % (4 if dtypes == {torch.float32} else 8) == 0:
            return "tf32x3"
    return "tf32x3_any"


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
    lib.repro_flash_attention_wgmma.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.repro_flash_attention_wgmma.restype = ctypes.c_int
    lib.repro_flash_attention_tf32x3.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.repro_flash_attention_tf32x3.restype = ctypes.c_int
    lib.repro_flash_attention_tf32x3_any.argtypes = \
        lib.repro_flash_attention_tf32x3.argtypes
    lib.repro_flash_attention_tf32x3_any.restype = ctypes.c_int
    lib.repro_flash_attention_tf32x3_wide.argtypes = \
        lib.repro_flash_attention_tf32x3.argtypes
    lib.repro_flash_attention_tf32x3_wide.restype = ctypes.c_int
    _LIB["lib"] = lib
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention of ``q [B, H, S, D]`` over ``k, v [B, Hkv, S, D]``.

    On CUDA tensors it launches the kernel of :func:`route` on the
    current stream (no synchronisation) or raises; on CPU tensors it runs
    the twin.  Each operand is f32, f16 or bf16 and the output is in
    ``q.dtype``; the kernels take them contiguous, on one device.
    """
    _check_shapes(q, k, v)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        _check_dtypes(q, k, v)
        return flash_attention_torch(q, k, v, causal)
    return _run(q, k, v, causal, route(q, k, v))


def _check_dtypes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if any(t.dtype not in _DTYPES for t in (q, k, v)):
        raise ValueError(f"flash_attention takes float32, float16 or "
                         f"bfloat16 operands, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")


def _run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
         picked: str) -> torch.Tensor:
    """The kernel of route ``picked`` on CUDA operands, counted on that
    route: :func:`flash_attention` passes :func:`route`'s pick, and
    ``chip_smoke.py`` forces ``"tf32x3_any"`` where it times it beside
    the picked one.  Only :func:`route`'s pick and ``"tf32x3_any"``
    (``D <= 256``) are taken: any other raises ``ValueError`` (the TMA
    routes read operands of other dtypes or alignments wrongly)."""
    b, h, hkv, s, d = _check_shapes(q, k, v)
    _check_dtypes(q, k, v)
    takes = {route(q, k, v)} | (
        {"tf32x3_any"} if d <= _MAX_D_ANY else set())
    if picked not in takes:
        raise ValueError(f"flash_attention route {picked!r} does not take "
                         f"{q.dtype}, {k.dtype}, {v.dtype} at D = {d}; "
                         f"it takes {sorted(takes)}")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{dev}, {k.device}, {v.device}")
    check_operands("flash_attention", dev, tuple(_DTYPES), q=q, k=k, v=v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = load_kernel_library()
    scale = 1.0 / math.sqrt(d)
    codes = (_DTYPES[q.dtype], _DTYPES[k.dtype], _DTYPES[v.dtype])
    if picked == "wgmma":
        launch("flash_attention", lib.repro_flash_attention_wgmma, dev,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               codes[0], b, h, hkv, s, d, scale, int(bool(causal)))
    else:
        entry = getattr(lib, f"repro_flash_attention_{picked}")
        launch("flash_attention", entry, dev,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               *codes, b, h, hkv, s, d, scale, int(bool(causal)))
    COUNTS[f"{picked}_launches"] += 1
    COUNTS["kernel_launches"] += 1
    return out
