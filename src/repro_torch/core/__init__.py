"""CamJ core of the PyTorch port: model layer, lowering and sweep engine.

The model layer (``constants`` ... ``algorithms``, ``usecases``) is a
verbatim copy of the reference's jax-free modules; ``axes``, ``grid``,
``plan_bank``, ``batch`` and ``shard_sweep`` are the torch rewrites of
the reference's jax modules on the fused streaming sweep path.

The package exports the reference's names (``repro/core/__init__.py``):
the model layer eagerly, the batched engine lazily
(``evaluate_batch_sharded`` splits a batch across a
:class:`repro_torch.launch.BatchMesh`).  The reference's deprecated
``sweep`` and ``sweep_stream`` shims, left out of the port on purpose,
resolve to functions that raise ``NotImplementedError`` naming what to
use instead.
"""
from .acell import (ACell, DynamicCell, NonLinearCell, StaticCell,
                    component_energy, thermal_noise_capacitance)
from .acomponent import (AComponent, ActiveAnalogMemory, ActivePixelSensor,
                         AnalogAbs, AnalogAdder, AnalogLog, AnalogMax,
                         AnalogScaling, AnalogSubtractor,
                         AnalogToDigitalConverter, Comparator,
                         CurrentMirrorMAC, DigitalPixelSensor,
                         PassiveAnalogMemory, PassiveAverager,
                         PulseWidthModulationPixel, SwitchedCapacitorMAC)
from .afa import AnalogArray
from .checks import DesignCheckError, run_design_checks
from .constants import (MIPI_CSI2_ENERGY_PER_BYTE, UTSV_ENERGY_PER_BYTE,
                        scale_energy, sram_access_energy)
from .delay import DelayReport, estimate_delays
from .digital import (ComputeUnit, DoubleBuffer, FIFO, LineBuffer, MemoryBase,
                      SystolicArray)
from .domains import Domain, compatible
from .energy import (CATEGORIES, EnergyReport, UnitEnergy, estimate_energy,
                     reference_outputs)
from .fom import adc_energy_per_conversion, walden_fom
from .hw import DigitalBinding, HWConfig
from .mapping import Mapping
from .plan import (EnergyPlan, lower, lower_cache_clear, lower_cache_info)
from .sw import (DNNProcessStage, PixelInput, ProcessStage, Stage,
                 dag_signature, topological_order)

# The batched evaluator and the sweep engines load torch's tensor stack
# and the kernel wrappers; resolve them on first use, as the reference
# does.
_LAZY_EXPORTS = {
    "DesignPoints": ".batch", "evaluate_batch": ".batch",
    "make_points": ".batch", "point_defaults": ".batch",
    "ChunkedGrid": ".grid", "SweepResult": ".sweep",
    "scalar_point": ".sweep", "sweep": ".sweep",
    "StreamResult": ".shard_sweep", "evaluate_batch_sharded": ".shard_sweep",
    "sweep_stream": ".shard_sweep", "stream_cache_clear": ".shard_sweep",
    "stream_cache_info": ".shard_sweep",
    "BankDims": ".plan_bank", "PlanBank": ".plan_bank",
    "build_plan_bank": ".plan_bank", "evaluate_bank": ".plan_bank",
}


def __getattr__(name):
    target = _LAZY_EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(target, __name__), name)


__all__ = [
    "ACell", "DynamicCell", "StaticCell", "NonLinearCell", "component_energy",
    "thermal_noise_capacitance", "AComponent", "ActivePixelSensor",
    "DigitalPixelSensor", "PulseWidthModulationPixel",
    "AnalogToDigitalConverter", "Comparator", "SwitchedCapacitorMAC",
    "CurrentMirrorMAC", "PassiveAverager", "AnalogAdder", "AnalogSubtractor",
    "AnalogMax", "AnalogScaling", "AnalogLog", "AnalogAbs",
    "PassiveAnalogMemory", "ActiveAnalogMemory", "AnalogArray", "Domain",
    "compatible", "ComputeUnit", "SystolicArray", "FIFO", "LineBuffer",
    "DoubleBuffer", "MemoryBase", "HWConfig", "DigitalBinding", "Mapping",
    "PixelInput", "ProcessStage", "DNNProcessStage", "Stage",
    "topological_order", "estimate_delays", "DelayReport", "estimate_energy",
    "EnergyReport", "UnitEnergy", "run_design_checks", "DesignCheckError",
    "walden_fom", "adc_energy_per_conversion", "scale_energy",
    "sram_access_energy", "MIPI_CSI2_ENERGY_PER_BYTE", "UTSV_ENERGY_PER_BYTE",
    # batched design-space engine (batch/sweep symbols resolve lazily)
    "BankDims", "CATEGORIES", "ChunkedGrid", "DesignPoints", "EnergyPlan",
    "PlanBank", "StreamResult", "SweepResult", "build_plan_bank",
    "dag_signature", "evaluate_bank", "evaluate_batch",
    "evaluate_batch_sharded", "lower", "lower_cache_clear",
    "lower_cache_info", "make_points", "point_defaults",
    "reference_outputs", "scalar_point", "stream_cache_clear",
    "stream_cache_info", "sweep", "sweep_stream",
]
