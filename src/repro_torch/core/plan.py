# Verbatim copy of src/repro/core/plan.py (jax-free model layer).
"""Lowering pass: compile ``(HWConfig, stages, Mapping)`` -> ``EnergyPlan``.

The scalar orchestrator (energy.py) walks Python ``Stage``/``AnalogArray``
objects per design point, so a design-space sweep is a Python loop.  This
module runs that walk ONCE per hardware *structure* and emits a flat
structure-of-arrays plan: per-unit coefficient vectors for the analog
Eqs. 2-13, digital Eqs. 14-16 and communication Eq. 17 terms, a memoized
topological order baked into a start-weight edge matrix for the Sec. 4.1
delay model, and precomputed memory-traffic / uTSV / MIPI byte counts.
``repro.core.batch`` evaluates a plan for thousands of design points in a
single ``jax.jit`` + ``vmap`` device call.

What stays symbolic (the swept axes) and what is folded:

* ``frame_rate``       -> T_FR; enters T_A, leakage, power.
* ``cis/soc process node`` -> dynamic-energy scale + SRAM leakage tables.
  Every digital coefficient is normalized to 65 nm at lowering using the
  unit's *declared* node and re-scaled per point (DeepScaleTool rule); the
  analog equations are node-free in CamJ.
* ``sys_rows/cols``    -> systolic cycle counts (T_D) and the
  weight-stationary SRAM reuse factor 2*MACs/rows.
* ``mem_tech``         -> selects SRAM / HP-SRAM / STT read, write and
  leakage models per memory (user-supplied energies stay fixed).
* ``active_fraction_scale`` -> multiplies each memory's alpha (Eq. 16).
* ``pixel_pitch_um``   -> analog area for the Sec. 6.2 power density.
* ``vdd_scale``        -> dynamic energies x vdd^2, static/leakage x vdd.
* ``adc_bits``         -> re-prices Walden-FoM terms vs their lowered
  resolution (``fom_bits``); see ``repro.core.axes``.

Everything else — access counts (Eq. 3/13), stencil geometry, DAG edges,
MIPI/uTSV bytes — is a constant of the structure and is folded here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

from .acell import DynamicCell, NonLinearCell, StaticCell
from .checks import run_design_checks
from .constants import (DIGITAL_MAC_ENERGY_65NM, DYNAMIC_ENERGY_SCALE,
                        _lookup_scale)
from .delay import _check_stalls, start_weight
from .digital import SystolicArray
from .energy import (CATEGORIES, _category_for_array, _sink_stages,
                     _unit_layer)
from .hw import HWConfig
from .mapping import Mapping
from .sw import DNNProcessStage, Stage, dag_signature, topological_order

_CAT_INDEX = {c: i for i, c in enumerate(CATEGORIES)}

TECH_INDEX = {"sram": 0, "sram_hp": 1, "stt": 2}

# node-scaling roles: which swept node a coefficient tracks
ROLE_SENSOR, ROLE_HOST, ROLE_FIXED = 0, 1, 2


@dataclasses.dataclass
class EnergyPlan:
    """Flat, batch-evaluable compilation of one CIS design structure."""
    key: tuple
    hw_name: str
    notes: List[str]                    # design-check advisories
    stall_notes: List[str]              # structural stall warnings (fixed)
    n_phases: int
    stacked: bool
    n_pixels: int                       # pixel-array components (area model)
    output_bits: int

    # reference design point (the values the structure was built with)
    default_cis_node: float
    default_soc_node: float
    default_frame_rate: float
    default_pixel_pitch: float
    default_sys_rows: float
    default_sys_cols: float

    # ---- unit matrix layout: [analog..., digital stages..., memories...,
    #      (utsv), mipi] --------------------------------------------------
    unit_names: List[str]
    unit_category: np.ndarray           # (U,) int, index into CATEGORIES
    unit_on_sensor: np.ndarray          # (U,) f32 mask, 1.0 = on-sensor

    # ---- analog section (A active arrays) -------------------------------
    a_const: np.ndarray                 # (A,) J/access, delay-independent
    a_pad_coeff: np.ndarray             # (A,) per-access delay = T_A * this
    a_ops: np.ndarray                   # (A,) = n_access * num_components
    lin_arr: np.ndarray                 # (L,) analog index of each term
    lin_coeff: np.ndarray               # (L,) J/s on the clipped cell delay
    lin_inv_div: np.ndarray             # (L,) 1/len(cells) of the component
    fom_arr: np.ndarray                 # (F,) analog index
    fom_scale: np.ndarray               # (F,) 2^bits * accesses_per_output
    fom_inv_div: np.ndarray             # (F,)
    fom_bits: np.ndarray                # (F,) lowered resolution (adc_bits
                                        #      axis re-prices vs this ref)

    # ---- digital stage section (D entries, topo order) -------------------
    d_is_sys: np.ndarray                # (D,) bool
    d_dyn_coeff: np.ndarray             # (D,) J at 65nm-equivalent scale 1.0
    d_role: np.ndarray                  # (D,) ROLE_*
    d_declared_node: np.ndarray         # (D,) nm, used when ROLE_FIXED
    d_static_power: np.ndarray          # (D,) W
    d_clock_hz: np.ndarray              # (D,)
    d_cycles_fixed: np.ndarray          # (D,) ComputeUnit cycle counts
    d_macs: np.ndarray                  # (D,) systolic MACs (0 for CUs)
    d_util: np.ndarray                  # (D,) systolic utilization
    d_edge_w: np.ndarray                # (D, D) start-weight matrix
    d_edge_mask: np.ndarray             # (D, D) bool

    # ---- memory section (M entries) --------------------------------------
    m_reads_fixed: np.ndarray           # (M,)
    m_reads_dnn2: np.ndarray            # (M,) divide by max(sys_rows,1)
    m_writes: np.ndarray                # (M,)
    m_bits_total: np.ndarray            # (M,) capacity * 8
    m_bits_per_access: np.ndarray       # (M,)
    m_size_factor: np.ndarray           # (M,) sqrt-capacity factor
    m_alpha: np.ndarray                 # (M,) declared active fraction
    m_role: np.ndarray                  # (M,) ROLE_* (energy scaling node)
    m_declared_node: np.ndarray         # (M,) nm, used when ROLE_FIXED
    m_area_role: np.ndarray             # (M,) ROLE_* (hw.node_for_layer)
    m_tech: np.ndarray                  # (M,) declared TECH_INDEX
    m_read_explicit: np.ndarray         # (M,) J or nan
    m_write_explicit: np.ndarray        # (M,) J or nan
    m_leak_explicit: np.ndarray         # (M,) W or nan

    # ---- communication (Eq. 17) ------------------------------------------
    utsv_bytes: float                   # 0.0 => no uTSV row
    mipi_bytes: float

    # compiled batch evaluator + AOT executables (keyed on batch size /
    # flags / mesh), attached lazily by repro.core.batch / shard_sweep
    _eval_fn: object = dataclasses.field(default=None, repr=False,
                                         compare=False)
    _exec_cache: object = dataclasses.field(default=None, repr=False,
                                            compare=False)

    @property
    def num_units(self) -> int:
        return len(self.unit_names)

    def category_onehot(self) -> np.ndarray:
        """(U, C) one-hot for the Pallas category reduction."""
        out = np.zeros((self.num_units, len(CATEGORIES)), np.float32)
        out[np.arange(self.num_units), self.unit_category] = 1.0
        return out


# ---------------------------------------------------------------------------
# Structural signatures (lowering cache keys)
# ---------------------------------------------------------------------------
def _sig(obj) -> tuple:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, _sig(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return tuple((k, _sig(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return tuple(_sig(v) for v in obj)
    if isinstance(obj, (str, int, float, bool, type(None))):
        return obj
    if isinstance(obj, type):
        return obj.__name__
    return str(obj)


def plan_key(hw: HWConfig, stages: List[Stage], mapping: Mapping) -> tuple:
    return (_sig(hw), dag_signature(stages), _sig(mapping))


# ---------------------------------------------------------------------------
# Cell lowering (Eqs. 4-13)
# ---------------------------------------------------------------------------
def _lower_component(comp, sink_const, sink_lin, sink_fom) -> None:
    """Split one A-Component's cells into constant / linear / FoM terms.

    Per A-Component output, ``component_energy`` allocates the access delay
    evenly: each cell sees ``delay / len(cells)``.  Cell energies fall into
    three shapes in that per-cell delay ``t`` (with ``t`` clipped at 1 ps):

    * delay-independent  — dynamic C*V^2 (Eq. 5), direct-drive static
      C*V*VDDA (Eq. 9), gm/Id static where the delay cancels (Eq. 7+10),
      and user-supplied ADC conversion energies (Eq. 12 expert path);
    * linear in ``t``    — static cells with a bias-current override (Eq. 7);
    * Walden FoM at 1/t  — default ADCs/comparators (Eq. 12, [53]).
    """
    cells = comp.cells
    if not cells:
        return
    inv_div = 1.0 / len(cells)
    for cell in cells:
        apo = float(cell.accesses_per_output)
        if isinstance(cell, DynamicCell):
            sink_const.append(cell.num_nodes * cell.node_capacitance()
                              * cell.v_swing ** 2 * apo)
        elif isinstance(cell, StaticCell):
            if cell.bias_current_override is not None:
                sink_lin.append((cell.vdda * cell.bias_current_override
                                 * cell.t_static_fraction * apo, inv_div))
            elif cell.drives_load:
                sink_const.append(cell.load_capacitance * cell.v_swing
                                  * cell.vdda * apo)
            else:
                sink_const.append(cell.vdda * 2.0 * math.pi
                                  * cell.load_capacitance * cell.gain
                                  / cell.gm_id * apo)
        elif isinstance(cell, NonLinearCell):
            if cell.energy_per_conversion is not None:
                sink_const.append(cell.energy_per_conversion * apo)
            else:
                sink_fom.append((2.0 ** cell.resolution_bits * apo, inv_div,
                                 float(cell.resolution_bits)))
        else:
            raise TypeError(f"cannot lower A-Cell {type(cell).__name__}; "
                            f"extend plan._lower_component")


def _node_role(node_nm: int, sensor_node: int, host_node: int,
               notes: List[str], what: str,
               prefer: int = ROLE_SENSOR) -> int:
    """Which swept node axis a unit's energy tracks.

    Roles normally resolve by matching the declared node against the two
    domains.  When the structure was built with ``sensor == host`` node
    (e.g. the reference structure for a ``soc_node=65`` sweep), the match
    is ambiguous — ``prefer`` breaks the tie from structural facts (die
    layer / off-sensor mapping), so a host-layer unit keeps tracking the
    ``soc_node`` axis instead of silently riding the ``cis_node`` sweep.
    """
    if sensor_node == host_node and node_nm == sensor_node:
        return prefer
    if node_nm == sensor_node:
        return ROLE_SENSOR
    if node_nm == host_node:
        return ROLE_HOST
    notes.append(f"{what}: declared node {node_nm}nm matches neither the "
                 f"sensor ({sensor_node}nm) nor host ({host_node}nm) domain; "
                 f"its energy will not track the node sweep")
    return ROLE_FIXED


def _dyn_scale(node_nm: int) -> float:
    return _lookup_scale(DYNAMIC_ENERGY_SCALE, node_nm)


# ---------------------------------------------------------------------------
# The lowering pass
# ---------------------------------------------------------------------------
_PLAN_CACHE: Dict[tuple, EnergyPlan] = {}
_CACHE_STATS = {"hits": 0, "misses": 0}
#: secondary plan caches (e.g. sweep's per-variant memo) cleared alongside
_EXTRA_CACHES: List[dict] = []


def lower_cache_info() -> Dict[str, int]:
    return dict(_CACHE_STATS, size=len(_PLAN_CACHE))


def lower_cache_clear() -> None:
    _PLAN_CACHE.clear()
    for cache in _EXTRA_CACHES:
        cache.clear()
    _CACHE_STATS["hits"] = 0
    _CACHE_STATS["misses"] = 0


def count_cache_hit() -> None:
    """Record a plan reuse that short-circuited before ``lower()``."""
    _CACHE_STATS["hits"] += 1


def lower(hw: HWConfig, stages: List[Stage], mapping: Mapping,
          use_cache: bool = True) -> EnergyPlan:
    """Compile one design structure; memoized on the structural signature."""
    key = plan_key(hw, stages, mapping)
    if use_cache:
        cached = _PLAN_CACHE.get(key)
        if cached is not None:
            _CACHE_STATS["hits"] += 1
            return cached
        _CACHE_STATS["misses"] += 1

    notes = run_design_checks(hw, stages, mapping)
    order = topological_order(stages)          # memoized into the plan
    bits = hw.output_bits_per_element

    sensor_node = hw.process_nodes[0]
    host_candidates = [u.unit.process_node_nm for u in hw.digital.values()
                       if u.unit.process_node_nm != sensor_node]
    host_candidates += [m.process_node_nm for m in hw.memories.values()
                        if m.process_node_nm != sensor_node]
    if len(hw.process_nodes) > 1:
        host_node = hw.process_nodes[1]
    elif host_candidates:
        host_node = host_candidates[0]
    else:
        host_node = sensor_node

    unit_names: List[str] = []
    unit_cat: List[int] = []
    unit_on: List[float] = []

    # ----- analog section (Eqs. 2-13) -------------------------------------
    ops_per_array: Dict[str, float] = {}
    analog_names = {a.name for a in hw.analog_arrays}
    for s in order:
        unit = mapping.unit_for(s)
        if unit in analog_names:
            ops_per_array[unit] = ops_per_array.get(unit, 0.0) + s.num_ops()

    a_const: List[float] = []
    a_pad_coeff: List[float] = []
    a_ops: List[float] = []
    lin_terms: List[Tuple[int, float, float]] = []
    fom_terms: List[Tuple[int, float, float, float]] = []
    for idx, arr in enumerate(hw.analog_arrays):
        ops = ops_per_array.get(arr.name, 0.0)
        if ops == 0.0:
            continue
        n_access = arr.accesses_per_component(ops)
        a_idx = len(a_const)
        consts: List[float] = []
        lins: List[Tuple[float, float]] = []
        foms: List[Tuple[float, float]] = []
        _lower_component(arr.component, consts, lins, foms)
        for extra in arr.extra_components:
            _lower_component(extra, consts, lins, foms)
        a_const.append(float(sum(consts)))
        a_pad_coeff.append(1.0 / max(n_access, 1.0))
        a_ops.append(ops)
        lin_terms += [(a_idx, c, d) for c, d in lins]
        fom_terms += [(a_idx, c, d, b) for c, d, b in foms]
        unit_names.append(arr.name)
        unit_cat.append(_CAT_INDEX[_category_for_array(arr, idx)])
        unit_on.append(1.0)

    # ----- digital stage section (Eqs. 14-15 + Sec. 4.1 timing) -----------
    digital_stages = [s for s in order
                      if mapping.stage_to_unit.get(s.name) in hw.digital]
    D = len(digital_stages)
    d_is_sys = np.zeros(D, bool)
    d_dyn = np.zeros(D, np.float64)
    d_role = np.zeros(D, np.int32)
    d_node = np.zeros(D, np.float64)
    d_static = np.zeros(D, np.float64)
    d_clock = np.ones(D, np.float64)
    d_cycles = np.zeros(D, np.float64)
    d_macs = np.zeros(D, np.float64)
    d_util = np.ones(D, np.float64)
    d_w = np.zeros((D, D), np.float64)
    d_mask = np.zeros((D, D), bool)
    stage_idx = {s.name: i for i, s in enumerate(digital_stages)}
    stall_notes: List[str] = []

    for i, s in enumerate(digital_stages):
        binding = hw.digital[mapping.unit_for(s)]
        unit = binding.unit
        off = mapping.is_off_sensor(s)
        role = _node_role(unit.process_node_nm, sensor_node, host_node,
                          notes, f"unit {unit.name!r}",
                          prefer=(ROLE_HOST
                                  if off or getattr(unit, "layer", 0) >= 1
                                  else ROLE_SENSOR))
        d_role[i] = role
        d_node[i] = unit.process_node_nm
        d_static[i] = unit.static_power
        d_clock[i] = unit.clock_mhz * 1e6
        # normalize dynamic energies to scale 1.0 using the declared node;
        # the evaluator re-scales with s(node[role]), where a ROLE_FIXED
        # unit's node is its declared node (so the round trip is exact)
        norm = _dyn_scale(unit.process_node_nm)
        if isinstance(unit, SystolicArray):
            macs = s.num_ops()
            d_is_sys[i] = True
            d_macs[i] = macs
            d_util[i] = unit.utilization
            mac_e = (unit.energy_per_mac if unit.energy_per_mac is not None
                     else DIGITAL_MAC_ENERGY_65NM * norm)
            d_dyn[i] = mac_e / norm * macs
        else:
            cycles = unit.cycles_for_outputs(s.num_outputs())
            d_cycles[i] = cycles
            d_dyn[i] = unit.energy_per_cycle / norm * cycles
        for dep in s.inputs:
            j = stage_idx.get(dep.name)
            if j is not None and j < i:
                d_mask[i, j] = True
                d_w[i, j] = start_weight(hw, binding, s, dep)
        _check_stalls(hw, s, binding, stall_notes)
        unit_names.append(unit.name)
        unit_cat.append(_CAT_INDEX["COMP-D"])
        unit_on.append(0.0 if off else 1.0)

    # ----- memory traffic (Eq. 16) ----------------------------------------
    mem_list = list(hw.memories.values())
    mem_pos = {m.name: k for k, m in enumerate(mem_list)}
    M = len(mem_list)
    m_reads_fixed = np.zeros(M, np.float64)
    m_reads_dnn2 = np.zeros(M, np.float64)
    m_writes = np.zeros(M, np.float64)
    m_off = np.zeros(M, bool)
    for s in digital_stages:
        binding = hw.digital[mapping.unit_for(s)]
        unit = binding.unit
        off = mapping.is_off_sensor(s)
        k_in = mem_pos.get(binding.input_memory)
        k_out = mem_pos.get(binding.output_memory)
        if k_in is not None:
            if isinstance(s, DNNProcessStage):
                if isinstance(unit, SystolicArray):
                    # weight-stationary reuse: 2*MACs / rows, rows swept
                    m_reads_dnn2[k_in] += 2.0 * s.num_ops()
                else:
                    m_reads_fixed[k_in] += 2.0 * s.num_ops()
            else:
                m_reads_fixed[k_in] += s.num_ops()
            m_off[k_in] |= off
        if k_out is not None:
            m_writes[k_out] += s.num_outputs()
            m_off[k_out] |= off
        if k_in is not None:
            for dep in s.inputs:
                m_writes[k_in] += dep.num_outputs()

    m_bits_total = np.array([m.capacity_bytes * 8 for m in mem_list])
    m_bits_pa = np.array([float(m.bits_per_access) for m in mem_list])
    m_size_f = np.array([max(m.capacity_bytes / 100e3, 1e-3) ** 0.5
                         for m in mem_list])
    m_alpha = np.array([m.active_fraction for m in mem_list])
    m_role = np.array(
        [_node_role(m.process_node_nm, sensor_node, host_node,
                    notes, f"memory {m.name!r}",
                    prefer=(ROLE_HOST
                            if m_off[k] or getattr(m, "layer", 0) >= 1
                            else ROLE_SENSOR))
         for k, m in enumerate(mem_list)], np.int32)
    m_node = np.array([float(m.process_node_nm) for m in mem_list])
    # area uses hw.node_for_layer (layer-indexed), not the declared node;
    # the layer decides the role even when both layers were built at the
    # same node (the soc_node==cis reference-structure case)
    m_area_role = np.array(
        [ROLE_HOST if (len(hw.process_nodes) > 1 and m.layer >= 1)
         else ROLE_SENSOR for m in mem_list], np.int32)
    m_tech = np.array([TECH_INDEX.get(m.technology, 0) for m in mem_list],
                      np.int32)
    nan = float("nan")
    m_read_x = np.array([nan if m.read_energy_per_access is None
                         else m.read_energy_per_access for m in mem_list])
    m_write_x = np.array([nan if m.write_energy_per_access is None
                          else m.write_energy_per_access for m in mem_list])
    m_leak_x = np.array([nan if m.leakage_power is None else m.leakage_power
                         for m in mem_list])
    for k, m in enumerate(mem_list):
        unit_names.append(m.name)
        unit_cat.append(_CAT_INDEX["MEM-D"])
        unit_on.append(0.0 if m_off[k] else 1.0)

    # ----- communication edge matrices (Eq. 17) ---------------------------
    utsv_bytes = 0.0
    if hw.stacked:
        for s in order:
            s_layer = _unit_layer(hw, mapping.unit_for(s))
            for dep in s.inputs:
                d_layer = _unit_layer(hw, mapping.unit_for(dep))
                if d_layer != s_layer and not mapping.is_off_sensor(s):
                    utsv_bytes += dep.output_bytes(bits)
    if utsv_bytes:
        unit_names.append("utsv")
        unit_cat.append(_CAT_INDEX["UTSV"])
        unit_on.append(1.0)

    mipi_bytes = 0.0
    off_stages = [s for s in order if mapping.is_off_sensor(s)]
    if off_stages:
        seen = set()
        for s in off_stages:
            for dep in s.inputs:
                if not mapping.is_off_sensor(dep) and id(dep) not in seen:
                    seen.add(id(dep))
                    mipi_bytes += dep.output_bytes(bits)
    else:
        mipi_bytes = sum(s.output_bytes(bits) for s in _sink_stages(order))
    unit_names.append("mipi")
    unit_cat.append(_CAT_INDEX["MIPI"])
    unit_on.append(1.0)

    # ----- defaults --------------------------------------------------------
    sys_units = [b.unit for b in hw.digital.values()
                 if isinstance(b.unit, SystolicArray)]
    def_rows = float(sys_units[0].rows) if sys_units else 1.0
    def_cols = float(sys_units[0].cols) if sys_units else 1.0

    lin_arr = np.array([t[0] for t in lin_terms], np.int32)
    fom_arr = np.array([t[0] for t in fom_terms], np.int32)

    plan = EnergyPlan(
        key=key, hw_name=hw.name, notes=list(notes),
        stall_notes=stall_notes,
        n_phases=max(len(hw.analog_arrays) + 1, 1),
        stacked=hw.stacked,
        n_pixels=(hw.analog_arrays[0].num_components
                  if hw.analog_arrays else 0),
        output_bits=bits,
        default_cis_node=float(sensor_node),
        default_soc_node=float(host_node),
        default_frame_rate=float(hw.frame_rate),
        default_pixel_pitch=float(hw.pixel_pitch_um),
        default_sys_rows=def_rows, default_sys_cols=def_cols,
        unit_names=unit_names,
        unit_category=np.array(unit_cat, np.int32),
        unit_on_sensor=np.array(unit_on, np.float32),
        a_const=np.array(a_const), a_pad_coeff=np.array(a_pad_coeff),
        a_ops=np.array(a_ops),
        lin_arr=lin_arr,
        lin_coeff=np.array([t[1] for t in lin_terms]),
        lin_inv_div=np.array([t[2] for t in lin_terms]),
        fom_arr=fom_arr,
        fom_scale=np.array([t[1] for t in fom_terms]),
        fom_inv_div=np.array([t[2] for t in fom_terms]),
        fom_bits=np.array([t[3] for t in fom_terms]),
        d_is_sys=d_is_sys, d_dyn_coeff=d_dyn, d_role=d_role,
        d_declared_node=d_node,
        d_static_power=d_static, d_clock_hz=d_clock,
        d_cycles_fixed=d_cycles, d_macs=d_macs, d_util=d_util,
        d_edge_w=d_w, d_edge_mask=d_mask,
        m_reads_fixed=m_reads_fixed, m_reads_dnn2=m_reads_dnn2,
        m_writes=m_writes, m_bits_total=m_bits_total,
        m_bits_per_access=m_bits_pa, m_size_factor=m_size_f,
        m_alpha=m_alpha, m_role=m_role, m_declared_node=m_node,
        m_area_role=m_area_role,
        m_tech=m_tech, m_read_explicit=m_read_x,
        m_write_explicit=m_write_x, m_leak_explicit=m_leak_x,
        utsv_bytes=float(utsv_bytes), mipi_bytes=float(mipi_bytes),
    )
    if use_cache:
        _PLAN_CACHE[key] = plan
    return plan
