"""Synthetic PlanBank rows for parity checks of the physics and the kernel.

No shipped variant set lowers to linear-in-delay analog terms: Ed-Gaze,
Rhythmic and the toy pipeline all have ``n_lin == 0``, and their digital
DAGs are chains.  :func:`synthetic_bank` builds, from a numpy seed, a
one-variant fused row that reaches those branches: ``L = 2`` linear terms
scattering into the SAME analog slot (the scatter-add must sum them),
``D = 3`` digital stages with two incoming DAG edges on the last one, a
fixed-node stage, explicit memory energies beside computed ones, and a
stacked die.  The parity tests and ``chip_smoke.py`` feed this row to the
reference, the torch twin and the CUDA kernel alike.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .core.energy import CATEGORIES
from .core.plan_bank import BankDims, bank_layout

#: dims of the synthetic bank: V=1, A=3, L=2, F=1, D=3, M=2
SYNTHETIC_DIMS = BankDims(1, 3, 2, 1, 3, 2)


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
