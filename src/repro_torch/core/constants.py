# Verbatim copy of src/repro/core/constants.py (jax-free model layer).
"""Physical constants and default technology parameters for the CamJ core.

All values SI unless noted. References:
  [paper]  CamJ, ISCA'23 (Ma, Feng, Zhang, Zhu).
  [49]     Liu et al., ISSCC'22 — MIPI ~100 pJ/B, uTSV ~1 pJ/B.
  [53]     Murmann ADC survey — Walden FoM.
  [60,64]  DeepScaleTool / Stillmaker & Baas — CMOS scaling.
"""

BOLTZMANN = 1.380649e-23  # J/K
ROOM_TEMPERATURE = 300.0  # K

# Communication interface energies (Sec. 2.2 / Eq. 17).
MIPI_CSI2_ENERGY_PER_BYTE = 100e-12  # J/B, off-sensor
UTSV_ENERGY_PER_BYTE = 1e-12         # J/B, between stacked layers

# Default analog supply voltage.
DEFAULT_VDDA = 2.5  # V, typical CIS analog supply (180-65nm designs)
DEFAULT_VDD_DIGITAL = 1.0

# gm/Id technology-insensitive factor range (Eq. 10); default mid-inversion.
GM_ID_DEFAULT = 15.0

# ---------------------------------------------------------------------------
# CMOS process scaling (DeepScaleTool-style).  Dynamic energy per op relative
# to the 65 nm node; leakage power relative to 65 nm.  65 nm is the classic
# "leaky" bulk node [20]; FD-SOI/FinFET nodes below 28 nm leak far less per um.
# ---------------------------------------------------------------------------
DYNAMIC_ENERGY_SCALE = {
    250: 7.21, 180: 4.13, 150: 3.38, 130: 2.73, 110: 2.16, 90: 1.60,
    65: 1.00, 55: 0.87, 45: 0.74, 40: 0.63, 32: 0.54, 28: 0.447,
    22: 0.343, 16: 0.260, 14: 0.230, 10: 0.174, 7: 0.128,
}

# Leakage power per bit of SRAM, W/bit, at the given node (order-of-magnitude
# DESTINY-style defaults; 65 nm bulk is the local maximum [20]).
SRAM_LEAKAGE_PER_BIT = {
    250: 1.2e-12, 180: 1.5e-12, 130: 2.2e-12, 110: 2.8e-12, 90: 4.5e-12,
    65: 8.0e-12, 55: 6.0e-12, 45: 5.0e-12, 40: 4.5e-12, 32: 3.5e-12,
    28: 2.8e-12, 22: 2.0e-12, 16: 1.4e-12, 14: 1.2e-12, 10: 0.9e-12,
    7: 0.7e-12,
}

# High-performance 6T SRAM leakage (DESTINY-style standard cells, W/bit).
# This is what CamJ's validation used (the paper notes its Fig. 7j memory
# over-estimate comes from standard 6T cells being leakier than the chip's
# custom 8T design).  65 nm bulk HP cells are notoriously leaky [20].
SRAM_HP_LEAKAGE_PER_BIT = {
    250: 0.15e-9, 180: 0.20e-9, 130: 0.40e-9, 110: 0.55e-9, 90: 1.2e-9,
    65: 4.0e-9, 55: 2.6e-9, 45: 2.0e-9, 40: 1.7e-9, 32: 1.3e-9,
    28: 1.0e-9, 22: 0.8e-9, 16: 0.5e-9, 14: 0.45e-9, 10: 0.35e-9,
    7: 0.30e-9,
}

# STT-RAM (NVMExplorer-style defaults): ~zero leakage, higher write energy.
STT_LEAKAGE_PER_BIT = 1.0e-14   # W/bit
STT_READ_ENERGY_PER_BIT_65 = 0.20e-12   # J/bit @65nm-equivalent periphery
STT_WRITE_ENERGY_PER_BIT_65 = 1.0e-12   # J/bit

# SRAM dynamic access energy per bit at 65 nm (DESTINY-style; scales with node
# via DYNAMIC_ENERGY_SCALE and weakly with capacity).
SRAM_ACCESS_ENERGY_PER_BIT_65 = 50e-15  # J/bit for a ~100 KB macro

# Default per-MAC energy of a synthesized 65 nm digital MAC (8-bit) [5].
DIGITAL_MAC_ENERGY_65NM = 0.57e-12  # J/MAC


def scale_energy(energy_at_ref: float, node_nm: int, ref_node_nm: int = 65) -> float:
    """Scale a dynamic energy number between process nodes (DeepScaleTool)."""
    s_to = _lookup_scale(DYNAMIC_ENERGY_SCALE, node_nm)
    s_ref = _lookup_scale(DYNAMIC_ENERGY_SCALE, ref_node_nm)
    return energy_at_ref * s_to / s_ref


def sram_leakage_per_bit(node_nm: int, high_performance: bool = False) -> float:
    table = SRAM_HP_LEAKAGE_PER_BIT if high_performance else SRAM_LEAKAGE_PER_BIT
    return _lookup_scale(table, node_nm)


def _lookup_scale(table: dict, node_nm: int) -> float:
    if node_nm in table:
        return table[node_nm]
    # geometric interpolation between neighbouring nodes
    nodes = sorted(table)
    if node_nm <= nodes[0]:
        return table[nodes[0]]
    if node_nm >= nodes[-1]:
        return table[nodes[-1]]
    import bisect
    i = bisect.bisect_left(nodes, node_nm)
    lo, hi = nodes[i - 1], nodes[i]
    t = (node_nm - lo) / (hi - lo)
    return table[lo] ** (1 - t) * table[hi] ** t


def table_points(table: dict):
    """Sorted ``(nodes, values)`` tuples from a node->value scaling table.

    The batched energy engine vectorizes :func:`_lookup_scale`'s geometric
    interpolation as ``exp(interp(node, nodes, log(values)))`` — linear
    interpolation of the log-values over the node axis is exactly the
    ``lo**(1-t) * hi**t`` rule above, including the endpoint clamping.
    """
    nodes = sorted(table)
    return tuple(float(n) for n in nodes), tuple(float(table[n]) for n in nodes)


def sram_access_energy(size_bytes: float, bits_per_access: float,
                       node_nm: int = 65) -> float:
    """DESTINY-flavoured SRAM per-access dynamic energy.

    Energy grows ~sqrt(capacity) (bitline/wordline length) and linearly with
    the access width; scaled across nodes with the dynamic-energy table.
    """
    ref_size = 100e3  # 100 KB reference macro
    size_factor = max(size_bytes / ref_size, 1e-3) ** 0.5
    e65 = SRAM_ACCESS_ENERGY_PER_BIT_65 * bits_per_access * size_factor
    return scale_energy(e65, node_nm, 65)
