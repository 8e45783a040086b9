"""PlanBank of the port: per-variant ``EnergyPlan`` coefficients as one
``(V, W)`` f32 tensor.

Torch-side counterpart of ``repro/core/plan_bank.py:37-225``: every
plan's ragged coefficient arrays are padded to the fleet-wide maxima and
packed into ONE fused row per variant (:func:`bank_layout`), so the
fused megakernel reads a chunk's whole coefficient set from a single
``(W,)`` row.  Padding is chosen so padded entries are exact no-ops in
the Eq. 1-17 arithmetic (zero energies/ops/traffic, unit divisors and
clocks, masked DAG edges, NaN explicit-energy sentinels).  The packing is
numpy, identical to the reference, so the banks of the two packages are
bit-equal (``tests/test_torch_bank.py``).

:func:`bank_from_reference` carries a reference bank across as is, so a
test can feed both packages the very same coefficients.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..kernels.runtime import resolve_device
from .energy import CATEGORIES
from .plan import EnergyPlan, ROLE_FIXED


class BankDims(NamedTuple):
    """Static (compile-defining) shape of a plan bank."""
    n_variants: int
    n_analog: int     # A: analog active-array slots
    n_lin: int        # L: linear-in-delay cell terms
    n_fom: int        # F: Walden-FoM cell terms
    n_digital: int    # D: digital stage slots
    n_mem: int        # M: memory slots

    @property
    def n_units(self) -> int:
        # fixed unit layout: [analog | digital | memory | utsv | mipi]
        return self.n_analog + self.n_digital + self.n_mem + 2


def bank_layout(dims: BankDims) -> Dict[str, tuple]:
    """``name -> (offset, shape)`` slots inside the fused ``(V, W)`` row.

    Every per-variant coefficient lives in ONE fused f32 matrix so a
    chunk reads its variant's whole coefficient set as one ``(W,)`` row
    (the CUDA kernel stages it in shared memory once per block).  Integers
    (scatter indices, roles, tech codes) are stored as exact small f32
    and cast/compared at use.  Derived statically from the dims, so the
    evaluator and the packer can never disagree.
    """
    shapes = _layout_shapes(dims)
    layout, off = {}, 0
    for name, shape in shapes:
        size = int(np.prod(shape)) if shape else 1
        layout[name] = (off, shape)
        off += size
    layout["__width__"] = (off, ())
    return layout


def _layout_shapes(dims: "BankDims") -> List[Tuple[str, tuple]]:
    """Ordered ``(name, shape)`` slots of the fused row.

    The ORDER is the one definition of the row layout: the CUDA kernel
    receives the offsets in :data:`LAYOUT_FIELDS` order and mirrors it
    with the ``Field`` enum in ``repro_torch/csrc/fused_sweep.cu``.
    """
    A, L, F, D, M = (dims.n_analog, dims.n_lin, dims.n_fom,
                     dims.n_digital, dims.n_mem)
    return [
        ("a_const", (A,)), ("a_pad_coeff", (A,)), ("a_ops", (A,)),
        ("lin_arr", (L,)), ("lin_coeff", (L,)), ("lin_inv", (L,)),
        ("fom_arr", (F,)), ("fom_scale", (F,)), ("fom_inv", (F,)),
        ("fom_bits", (F,)),
        ("d_valid", (D,)), ("d_is_sys", (D,)), ("d_dyn", (D,)),
        ("d_role", (D,)), ("d_node", (D,)), ("d_static", (D,)),
        ("d_clock", (D,)), ("d_cycles", (D,)), ("d_macs", (D,)),
        ("d_util", (D,)), ("d_edge_w", (D, D)), ("d_edge_mask", (D, D)),
        ("m_reads_fixed", (M,)), ("m_reads_dnn2", (M,)),
        ("m_writes", (M,)), ("m_bits_total", (M,)), ("m_bits_pa", (M,)),
        ("m_size_f", (M,)), ("m_alpha", (M,)), ("m_role", (M,)),
        ("m_node", (M,)), ("m_area_role", (M,)), ("m_tech", (M,)),
        ("m_read_x", (M,)), ("m_write_x", (M,)), ("m_leak_x", (M,)),
        ("n_phases", ()), ("stacked", ()), ("n_pixels", ()),
        ("utsv_bytes", ()), ("mipi_bytes", ()),
        ("weights", (dims.n_units, len(CATEGORIES) + 2)),
    ]


#: fused-row slot names in layout order (== the .cu ``Field`` enum)
LAYOUT_FIELDS: Tuple[str, ...] = tuple(
    name for name, _ in _layout_shapes(BankDims(1, 0, 0, 0, 0, 0)))


def layout_offsets(dims: "BankDims") -> np.ndarray:
    """Row offsets of every slot in :data:`LAYOUT_FIELDS` order (int32),
    the table the CUDA kernel reads its coefficients through."""
    layout = bank_layout(dims)
    return np.asarray([layout[name][0] for name in LAYOUT_FIELDS], np.int32)


@dataclasses.dataclass
class PlanBank:
    """A fleet of ``EnergyPlan`` variants as one traced-input pytree."""
    dims: BankDims
    plans: List[EnergyPlan]
    arrays: Dict[str, torch.Tensor]     # {"fused": (V, W)} f32, on device

    @property
    def n_variants(self) -> int:
        return self.dims.n_variants

    @property
    def fused(self) -> torch.Tensor:
        """The ``(V, W)`` f32 coefficient matrix."""
        return self.arrays["fused"]


def _pad1(rows: Sequence, width: int, fill, dtype) -> np.ndarray:
    out = np.full((len(rows), width), fill, dtype)
    for i, r in enumerate(rows):
        r = np.asarray(r).reshape(-1)
        out[i, : len(r)] = r
    return out


def _pad2(rows: Sequence, width: int, fill, dtype) -> np.ndarray:
    out = np.full((len(rows), width, width), fill, dtype)
    for i, r in enumerate(rows):
        r = np.asarray(r)
        out[i, : r.shape[0], : r.shape[1]] = r
    return out


def _weights(plans: List[EnergyPlan], dims: BankDims) -> np.ndarray:
    """(V, U, C+2) per-variant unit weights in the banked slot layout."""
    c = len(CATEGORIES)
    w = np.zeros((dims.n_variants, dims.n_units, c + 2), np.float32)
    for vi, plan in enumerate(plans):
        sections = (
            (0, len(plan.a_const)),
            (dims.n_analog, len(plan.d_is_sys)),
            (dims.n_analog + dims.n_digital, len(plan.m_reads_fixed)),
            (dims.n_analog + dims.n_digital + dims.n_mem,
             1 if plan.utsv_bytes else 0),
            (dims.n_analog + dims.n_digital + dims.n_mem + 1, 1),
        )
        pos = 0                       # cursor into the plan's flat unit list
        for base, count in sections:
            for j in range(count):
                w[vi, base + j, plan.unit_category[pos]] = 1.0
                w[vi, base + j, c] = 1.0
                w[vi, base + j, c + 1] = plan.unit_on_sensor[pos]
                pos += 1
        assert pos == plan.num_units, (plan.hw_name, pos, plan.num_units)
    return w


def build_plan_bank(plans: Sequence[EnergyPlan],
                    device="cuda") -> PlanBank:
    """Stack + pad the plans' coefficient arrays into one ``PlanBank``
    whose ``(V, W)`` f32 matrix lives on ``device`` (``cuda`` unless the
    caller asks for ``"cpu"``)."""
    device = resolve_device(device)
    plans = list(plans)
    assert plans, "plan bank needs at least one variant"
    dims = BankDims(
        n_variants=len(plans),
        n_analog=max(len(p.a_const) for p in plans),
        n_lin=max(len(p.lin_arr) for p in plans),
        n_fom=max(len(p.fom_arr) for p in plans),
        n_digital=max(len(p.d_is_sys) for p in plans),
        n_mem=max(len(p.m_reads_fixed) for p in plans),
    )
    A, L, F, D, M = (dims.n_analog, dims.n_lin, dims.n_fom, dims.n_digital,
                     dims.n_mem)
    f32, i32 = np.float32, np.int32
    nan = np.float32(np.nan)
    col = lambda name: [getattr(p, name) for p in plans]       # noqa: E731
    arrays = {
        # analog (Eqs. 2-13): zero ops/energies are inert rows
        "a_const": _pad1(col("a_const"), A, 0.0, f32),
        "a_pad_coeff": _pad1(col("a_pad_coeff"), A, 0.0, f32),
        "a_ops": _pad1(col("a_ops"), A, 0.0, f32),
        # linear / FoM terms: zero coeff, unit divisor, scatter to slot 0
        "lin_arr": _pad1(col("lin_arr"), L, 0, i32),
        "lin_coeff": _pad1(col("lin_coeff"), L, 0.0, f32),
        "lin_inv": _pad1(col("lin_inv_div"), L, 1.0, f32),
        "fom_arr": _pad1(col("fom_arr"), F, 0, i32),
        "fom_scale": _pad1(col("fom_scale"), F, 0.0, f32),
        "fom_inv": _pad1(col("fom_inv_div"), F, 1.0, f32),
        # reference resolution for the adc_bits axis; padding rides 1.0
        # (comparator-coded), which pins the modulation hook to 1
        "fom_bits": _pad1(col("fom_bits"), F, 1.0, f32),
        # digital stages (Eqs. 14-15 + Sec. 4.1): zero cycles on a unit
        # clock -> zero-duration stages outside the valid mask
        "d_valid": _pad1([np.ones(len(p.d_is_sys), bool) for p in plans],
                         D, False, bool),
        "d_is_sys": _pad1(col("d_is_sys"), D, False, bool),
        "d_dyn": _pad1(col("d_dyn_coeff"), D, 0.0, f32),
        "d_role": _pad1(col("d_role"), D, ROLE_FIXED, i32),
        "d_node": _pad1(col("d_declared_node"), D, 65.0, f32),
        "d_static": _pad1(col("d_static_power"), D, 0.0, f32),
        "d_clock": _pad1(col("d_clock_hz"), D, 1.0, f32),
        "d_cycles": _pad1(col("d_cycles_fixed"), D, 0.0, f32),
        "d_macs": _pad1(col("d_macs"), D, 0.0, f32),
        "d_util": _pad1(col("d_util"), D, 1.0, f32),
        "d_edge_w": _pad2(col("d_edge_w"), D, 0.0, f32),
        "d_edge_mask": _pad2(col("d_edge_mask"), D, False, bool),
        # memories (Eq. 16): zero traffic/bits; NaN explicit sentinels
        # defer to the computed path, which is itself zero at zero bits
        "m_reads_fixed": _pad1(col("m_reads_fixed"), M, 0.0, f32),
        "m_reads_dnn2": _pad1(col("m_reads_dnn2"), M, 0.0, f32),
        "m_writes": _pad1(col("m_writes"), M, 0.0, f32),
        "m_bits_total": _pad1(col("m_bits_total"), M, 0.0, f32),
        "m_bits_pa": _pad1(col("m_bits_per_access"), M, 0.0, f32),
        "m_size_f": _pad1(col("m_size_factor"), M, 0.0, f32),
        "m_alpha": _pad1(col("m_alpha"), M, 0.0, f32),
        "m_role": _pad1(col("m_role"), M, ROLE_FIXED, i32),
        "m_node": _pad1(col("m_declared_node"), M, 65.0, f32),
        "m_area_role": _pad1(col("m_area_role"), M, 0, i32),
        "m_tech": _pad1(col("m_tech"), M, 0, i32),
        "m_read_x": _pad1(col("m_read_explicit"), M, nan, f32),
        "m_write_x": _pad1(col("m_write_explicit"), M, nan, f32),
        "m_leak_x": _pad1(col("m_leak_explicit"), M, nan, f32),
        # per-variant scalars (communication, phasing, area model)
        "n_phases": np.asarray([p.n_phases for p in plans], f32),
        "stacked": np.asarray([1.0 if p.stacked else 0.0 for p in plans],
                              f32),
        "n_pixels": np.asarray([p.n_pixels for p in plans], f32),
        "utsv_bytes": np.asarray(col("utsv_bytes"), f32),
        "mipi_bytes": np.asarray(col("mipi_bytes"), f32),
        "weights": _weights(plans, dims),
    }
    layout = bank_layout(dims)
    fused = np.zeros((dims.n_variants, layout["__width__"][0]), f32)
    for name, arr in arrays.items():
        off, shape = layout[name]
        size = int(np.prod(shape)) if shape else 1
        fused[:, off:off + size] = np.asarray(
            arr, f32).reshape(dims.n_variants, size)
    return PlanBank(dims=dims, plans=plans,
                    arrays={"fused": torch.from_numpy(fused).to(device)})


def bank_from_reference(arrays: Dict[str, np.ndarray], dims,
                        device="cuda") -> PlanBank:
    """Carry a bank across from the JAX reference.

    ``arrays`` is the reference ``PlanBank.arrays`` as numpy (its
    ``{"fused": (V, W)}`` f32 matrix) and ``dims`` its ``BankDims`` (any
    6-sequence in BankDims order), so a test can feed both packages the
    very same coefficients.  The row layout of the two packages is the
    same by construction; the width is checked against it.  The matrix
    lands on ``device`` (``cuda`` unless the caller asks for ``"cpu"``).
    """
    device = resolve_device(device)
    dims = BankDims(*(int(d) for d in dims))
    fused = np.ascontiguousarray(np.asarray(arrays["fused"], np.float32))
    width = bank_layout(dims)["__width__"][0]
    if fused.shape != (dims.n_variants, width):
        raise ValueError(f"reference bank has shape {fused.shape}, but "
                         f"dims {tuple(dims)} lay out (V, W) = "
                         f"{(dims.n_variants, width)}")
    fused = torch.from_numpy(fused.copy()).to(device)
    return PlanBank(dims=dims, plans=[], arrays={"fused": fused})


def evaluate_bank(bank: PlanBank, variant_ids, points
                  ) -> Dict[str, np.ndarray]:
    """Host convenience: score ``points`` with per-point variant selection.

    ``points`` is a :class:`~repro_torch.core.batch.DesignPoints` on the
    bank's device; ``variant_ids`` picks each point's bank row.  The
    mixed-variant evaluator (``batch.banked_eval_fn``) runs once per
    distinct variant of the batch; the outputs come back as host numpy
    arrays, as the reference's ``evaluate_bank`` returns them.  A test
    and oracle entry point: sweeps go through ``repro_torch.explore``.
    """
    from .batch import banked_eval_fn
    out = banked_eval_fn(bank.dims)(bank, variant_ids, points)
    return {k: v.cpu().numpy() for k, v in out.items()}
