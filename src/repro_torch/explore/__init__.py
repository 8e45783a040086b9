"""Front door of the PyTorch port: ``DesignSpace`` + ``explore()``.

    from repro_torch.explore import DesignSpace, explore

    space = DesignSpace(["edgaze", "rhythmic"],
                        {"cis_node": [130, 65, 28],
                         "frame_rate": [15, 30, 60],
                         "vdd_scale": [0.8, 1.0, 1.2],
                         "adc_bits": [-1, 8, 12]})
    res = explore(space, k=8)                 # CUDA megakernel on the GPU
    res = explore(space, k=8, device="cpu")   # plain-torch twin on the CPU
    res.best(), res.summaries, res.occupancy

Mirrors the reference's ``repro.explore`` surface on the fused streaming
sweep; the algorithm registry and axis registry are the port's own.
"""
from ..core.algorithms import (AlgorithmSpec, algorithm_names,
                               get_algorithm, register_algorithm,
                               unregister_algorithm)
from ..core.axes import Axis
from .api import ENGINES, ExploreResult, explore
from .space import DesignSpace, axis_names, axis_specs

__all__ = [
    "AlgorithmSpec",
    "Axis",
    "DesignSpace",
    "ENGINES",
    "ExploreResult",
    "algorithm_names",
    "axis_names",
    "axis_specs",
    "explore",
    "get_algorithm",
    "register_algorithm",
    "unregister_algorithm",
]
