"""Helpers of the parity checks: synthetic PlanBank rows, the ulp and the
kernels' division by magic multipliers.

:func:`ulp` is one unit in the last place of a float dtype at given
magnitudes: an f16 or bf16 result rounded once from two f32 sums that
differ by ``e`` may differ by ``e`` plus one ulp, so the kernels' half
outputs are held to their twins' within that (:func:`half_rule`).


No shipped variant set lowers to linear-in-delay analog terms: Ed-Gaze,
Rhythmic and the toy pipeline all have ``n_lin == 0``, and their digital
DAGs are chains.  :func:`synthetic_bank` builds, from a numpy seed, a
one-variant fused row that reaches those branches: ``L = 2`` linear terms
scattering into the SAME analog slot (the scatter-add must sum them),
``D = 3`` digital stages with two incoming DAG edges on the last one, a
fixed-node stage, explicit memory energies beside computed ones, and a
stacked die.  The parity tests and ``chip_smoke.py`` feed this row to the
reference, the torch twin and the CUDA kernel alike.
:func:`synthetic_wide_bank` draws a row past four slots in every dim
(``WIDE_DIMS``), the widths at which the fused-sweep kernel takes its
16-slot instantiation.

:func:`fdiv` is the decode's division of K1 and K2 (``fdiv`` of
``csrc/grid_decode.cuh``) in torch, so that the CPU tests hold the
kernels' index arithmetic to floor division and to ``grid_decode_torch``.

:func:`attention_f64` is softmax attention computed in f64 (one rounding
at the end): where scores reach hundreds, an ulp of a score is ~3e-5 of
P, so two f32 summation orders of the same attention differ by more
than K9's f32 tolerance of 1e-5 and neither is the reference for the
other; both are held to this (:func:`f64_error`).

:func:`stats_case` draws the block-stats kernels' (K3a, K3b) edge cases:
ties, NaN, +-inf, masked blocks and ids outside ``[0, V)`` on three id
layouts, for the CPU tests, the card tests and ``chip_smoke.py``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .core.energy import CATEGORIES
from .core.plan_bank import BankDims, bank_layout

#: the id layouts of :func:`stats_case`
STATS_LAYOUTS = ("run", "interleaved", "single")
#: dims of the synthetic bank: V=1, A=3, L=2, F=1, D=3, M=2
SYNTHETIC_DIMS = BankDims(1, 3, 2, 1, 3, 2)
#: dims of the wide synthetic bank: V=1, A=5, L=6, F=5, D=6, M=5
WIDE_DIMS = BankDims(1, 5, 6, 5, 6, 5)


def synthetic_bank(seed: int = 0) -> Tuple[BankDims, np.ndarray]:
    """``(dims, fused)``: a ``(1, W)`` f32 fused row in the
    :func:`~repro_torch.core.plan_bank.bank_layout` of
    :data:`SYNTHETIC_DIMS`, drawn from ``seed``."""
    dims = SYNTHETIC_DIMS
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, n: rng.uniform(lo, hi, n)          # noqa: E731
    nan = np.nan
    c = len(CATEGORIES)
    A, L, F, D, M = tuple(dims)[1:]
    vals = {
        "a_const": u(1e-13, 1e-11, A), "a_pad_coeff": u(0.05, 0.5, A),
        "a_ops": u(1e4, 1e6, A),
        "lin_arr": np.array([1, 1]),                 # duplicate target
        "lin_coeff": u(1e-7, 1e-5, L), "lin_inv": u(1.0, 8.0, L),
        "fom_arr": np.array([2]), "fom_scale": u(0.5, 2.0, F),
        "fom_inv": u(1.0, 4.0, F), "fom_bits": np.array([10.0]),
        "d_valid": np.ones(D), "d_is_sys": np.array([1.0, 0.0, 0.0]),
        "d_dyn": u(1e-7, 1e-5, D), "d_role": np.array([0.0, 1.0, 2.0]),
        "d_node": np.array([65.0, 65.0, 40.0]), "d_static": u(1e-5, 1e-3, D),
        "d_clock": u(1e8, 5e8, D), "d_cycles": u(1e4, 1e6, D),
        "d_macs": np.array([5e6, 0.0, 0.0]),
        "d_util": np.array([0.8, 1.0, 1.0]),
        "d_edge_w": np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                              [0.5, 1.0, 0.0]]),
        "d_edge_mask": np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                                 [1.0, 1.0, 0.0]]),
        "m_reads_fixed": u(1e3, 1e5, M), "m_reads_dnn2": u(1e4, 1e6, M),
        "m_writes": u(1e3, 1e5, M), "m_bits_total": u(1e5, 1e7, M),
        "m_bits_pa": np.array([64.0, 128.0]), "m_size_f": u(0.5, 2.0, M),
        "m_alpha": u(0.1, 1.0, M), "m_role": np.array([0.0, 2.0]),
        "m_node": np.array([65.0, 28.0]), "m_area_role": np.array([0.0, 1.0]),
        "m_tech": np.array([0.0, 1.0]), "m_read_x": np.array([nan, 3e-12]),
        "m_write_x": np.array([nan, nan]), "m_leak_x": np.array([nan, 2e-6]),
        "n_phases": 2.0, "stacked": 1.0, "n_pixels": 640.0 * 400.0,
        "utsv_bytes": 2.5e5, "mipi_bytes": 4e4,
    }
    # units [analog x3 | digital x3 | memory x2 | utsv | mipi]: one
    # category each, the total column, and on-sensor for all but the last
    units = dims.n_units
    weights = np.zeros((units, c + 2))
    cats = [0, 1, 3, 4, 4, 4, 2, 5, 7, 6]
    for i, cat in enumerate(cats):
        weights[i, cat] = 1.0
        weights[i, c] = 1.0
        weights[i, c + 1] = 1.0 if i < units - 1 else 0.0
    vals["weights"] = weights
    layout = bank_layout(dims)
    fused = np.zeros((1, layout["__width__"][0]), np.float32)
    for name, v in vals.items():
        off, shape = layout[name]
        size = int(np.prod(shape)) if shape else 1
        fused[0, off:off + size] = np.asarray(v, np.float32).reshape(size)
    return dims, fused


def synthetic_wide_bank(seed: int = 0) -> Tuple[BankDims, np.ndarray]:
    """``(dims, fused)``: a ``(1, W)`` f32 fused row of :data:`WIDE_DIMS`
    drawn from ``seed``: linear and FoM terms scattered over the analog
    slots with repeats, FoM reference bits at and above 1, a digital DAG
    with an invalid stage, every node role, memory technology and
    explicit-energy override."""
    dims = WIDE_DIMS
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, n: rng.uniform(lo, hi, n)          # noqa: E731
    cyc = lambda opts, n: np.resize(np.asarray(opts, float), n)  # noqa: E731
    nan = np.nan
    c = len(CATEGORIES)
    A, L, F, D, M = tuple(dims)[1:]
    edge_mask = np.tril(rng.uniform(size=(D, D)) > 0.4, -1).astype(float)
    edge_mask[np.arange(1, D), np.arange(D - 1)] = 1.0     # a chain, and more
    vals = {
        "a_const": u(1e-13, 1e-11, A), "a_pad_coeff": u(0.05, 0.5, A),
        "a_ops": u(1e4, 1e6, A),
        "lin_arr": rng.integers(0, A, L), "lin_coeff": u(1e-7, 1e-5, L),
        "lin_inv": u(1.0, 8.0, L),
        "fom_arr": rng.integers(0, A, F), "fom_scale": u(0.5, 2.0, F),
        "fom_inv": u(1.0, 4.0, F), "fom_bits": cyc([10.0, 1.0, 8.0], F),
        "d_valid": cyc([1.0, 1.0, 0.0], D), "d_is_sys": cyc([1.0, 0.0], D),
        "d_dyn": u(1e-7, 1e-5, D), "d_role": cyc([0.0, 1.0, 2.0], D),
        "d_node": cyc([65.0, 40.0, 28.0, 90.0], D),
        "d_static": u(1e-5, 1e-3, D), "d_clock": u(1e8, 5e8, D),
        "d_cycles": u(1e4, 1e6, D), "d_macs": cyc([5e6, 0.0], D),
        "d_util": cyc([0.8, 1.0], D),
        "d_edge_w": edge_mask * u(0.25, 1.0, D * D).reshape(D, D),
        "d_edge_mask": edge_mask,
        "m_reads_fixed": u(1e3, 1e5, M), "m_reads_dnn2": u(1e4, 1e6, M),
        "m_writes": u(1e3, 1e5, M), "m_bits_total": u(1e5, 1e7, M),
        "m_bits_pa": cyc([64.0, 128.0, 32.0], M), "m_size_f": u(0.5, 2.0, M),
        "m_alpha": u(0.1, 1.0, M), "m_role": cyc([0.0, 1.0, 2.0], M),
        "m_node": cyc([65.0, 28.0, 45.0], M),
        "m_area_role": cyc([0.0, 1.0, 2.0, 1.0], M),
        "m_tech": cyc([0.0, 1.0, 2.0], M),
        "m_read_x": cyc([nan, 3e-12, nan], M),
        "m_write_x": cyc([nan, nan, 5e-12], M),
        "m_leak_x": cyc([nan, 2e-6], M),
        "n_phases": 2.0, "stacked": 0.0, "n_pixels": 640.0 * 400.0,
        "utsv_bytes": 2.5e5, "mipi_bytes": 4e4,
    }
    units = dims.n_units
    weights = np.zeros((units, c + 2))
    for i in range(units):
        weights[i, i % c] = 1.0
        weights[i, c] = 1.0
        weights[i, c + 1] = 1.0 if i < units - 1 else 0.0
    vals["weights"] = weights
    layout = bank_layout(dims)
    fused = np.zeros((1, layout["__width__"][0]), np.float32)
    for name, v in vals.items():
        off, shape = layout[name]
        size = int(np.prod(shape)) if shape else 1
        fused[0, off:off + size] = np.asarray(v, np.float32).reshape(size)
    return dims, fused


def ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One unit in the last place of ``dtype`` at the magnitudes of ``x``
    (f64; the smallest normal's below it)."""
    fi = torch.finfo(dtype)
    return fi.eps * torch.exp2(torch.floor(torch.log2(
        x.abs().double().clamp_min(fi.tiny))))


def half_rule(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max over the elements of ``|got - want|`` over one ulp of the half
    dtype at ``max(|got|, |want|)`` plus ``1e-5 (1 + |want|)`` (another
    f32 summation order): at most 1 when the two are one rounding of the
    half dtype apart."""
    g, w = got.double(), want.double()
    rule = ulp(torch.maximum(g.abs(), w.abs()), got.dtype) \
        + 1e-5 * (1.0 + w.abs())
    return float(((g - w).abs() / rule).max())


def attention_f64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> torch.Tensor:
    """Softmax attention of ``q [B, H, S, D]`` over ``k, v [B, Hkv, S,
    D]`` (GQA head map) in f64 from the operands' values, ``[B, H, S,
    D]`` f64."""
    b, h, s, d = q.shape
    group = h // k.shape[1]
    kd = k.double().repeat_interleave(group, dim=1)
    vd = v.double().repeat_interleave(group, dim=1)
    scores = (q.double() @ kd.transpose(-1, -2)) / np.sqrt(d)
    if causal:
        rows = torch.arange(s, device=q.device)
        scores = scores.masked_fill(rows[None, :] > rows[:, None],
                                    float("-inf"))
    return torch.softmax(scores, dim=-1) @ vd


def f64_error(got: torch.Tensor, exact: torch.Tensor) -> float:
    """Max over the elements of ``|got - exact| / (1 + |exact|)``."""
    return float(((got.double() - exact).abs()
                  / (1.0 + exact.abs())).max())


def rounded_f64_error(got: torch.Tensor, exact: torch.Tensor) -> float:
    """:func:`f64_error` less one rounding of ``got``'s dtype: the max over
    the elements of ``(|got - exact| - ulp) / (1 + |exact|)``, the ulp of
    ``got``'s dtype at ``max(|got|, |exact|)``."""
    g = got.double()
    slack = ulp(torch.maximum(g.abs(), exact.abs()), got.dtype)
    return float((((g - exact).abs() - slack) / (1.0 + exact.abs())).max())


def mulhi(n: torch.Tensor, m: int, bits: int) -> torch.Tensor:
    """``(n * m) >> bits`` for int64 ``n >= 0``: directly at 32 bits (n <
    2^31, m < 2^32), in 16-bit limbs at 64 (the product has 128 bits)."""
    if bits == 32:
        return (n * m) >> 32
    nl = [(n >> (16 * i)) & 0xFFFF for i in range(4)]
    ml = [(m >> (16 * i)) & 0xFFFF for i in range(4)]
    cols = [0] * 8
    for i in range(4):
        for j in range(4):
            cols[i + j] = cols[i + j] + nl[i] * ml[j]
    carry, limbs = 0, []
    for k in range(8):
        c = cols[k] + carry
        limbs.append(c & 0xFFFF)
        carry = c >> 16
    return limbs[4] | (limbs[5] << 16) | (limbs[6] << 32) | (limbs[7] << 48)


def fdiv(n: torch.Tensor, d: int, bits: int) -> torch.Tensor:
    """The kernels' ``(mulhi(n, m) + n) >> s`` with ``d``'s multiplier
    (:func:`repro_torch.kernels.grid_decode.magic`), without overflowing
    int64."""
    from .kernels.grid_decode import magic
    m, s = magic(d, bits)
    if m == 0:
        raise ValueError(f"no {bits}-bit multiplier divides by {d}")
    t = mulhi(n, m, bits)
    if s == 0:
        return t + n
    return ((t >> 1) + (n >> 1) + (t & n & 1)) >> (s - 1)


def stats_case(b: int, bp: int, n_variants: int, layout: str, seed: int,
               ties: bool = False):
    """``(values, mask, ids)`` of K3a's and K3b's edge cases, numpy, from
    ``seed``: values from a grid of multiples of 1/8 below 4 (sums exact
    in any order; ``ties``: only 0.5, 1.25 and 2.0, so that a thread's min
    is often tied), a few NaN (five of variant 0 in the first block, pairs of
    them in one thread on either route) and +-inf, masked points, an
    all-masked second block, and ids in ``layout`` with -1 and ids past
    ``V`` strewn in: ``run`` (runs of 700, as K2 writes runs of a
    variant's points), ``interleaved`` (every point the next id) or
    ``single`` (one id), all of ``STATS_LAYOUTS``."""
    rng = np.random.default_rng(seed)
    vals = np.float32(np.round(np.clip(rng.normal(size=b), -3.9, 3.9) * 8)
                      / 8)
    vals[rng.uniform(size=b) < 0.3] = 0.5
    if ties:
        vals = rng.choice(np.float32([0.5, 1.25, 2.0]), size=b)
    odd = rng.choice(b, size=min(b, 3 * max(b // 300, 2)), replace=False)
    third = len(odd) // 3
    vals[odd[:third]] = np.nan
    vals[odd[third:2 * third]] = np.inf
    vals[odd[2 * third:]] = -np.inf
    mask = rng.uniform(size=b) > 0.25
    mask[bp:2 * bp] = False
    pos = np.arange(b)
    vid = {"run": (pos + 300) // 700 % (n_variants + 1),
           "interleaved": pos % (n_variants + 1),
           "single": np.full(b, n_variants - 1)}[layout].astype(np.int32)
    stray = rng.uniform(size=b)
    vid[stray < 0.02] = -1
    vid[stray > 0.98] = n_variants + 7
    nan_ties = [q for q in (3, 9, 131, 515, 643) if q < min(b, bp)]
    vals[nan_ties], mask[nan_ties], vid[nan_ties] = np.nan, True, 0
    return vals, mask, vid
