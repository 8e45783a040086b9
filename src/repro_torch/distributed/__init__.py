"""Distributed substrate of the LM stack: the mesh context, the sharding
rules and the int8 cross-pod gradient reduction (torch counterpart of
``src/repro/distributed/``), on DTensor over a ``torch.distributed``
process group (gloo on the CPU, NCCL on CUDA)."""
from .compression import (compressed_psum_mean, cross_pod_grad_reduce,
                          dequantize_int8, quantize_int8)
from .shardctx import axis_size, constrain, current_mesh, use_mesh
from .sharding import (batch_spec, cache_shardings, input_shardings,
                       logical_to_sharding, param_shardings, spec_for_param)

__all__ = ["use_mesh", "current_mesh", "constrain", "axis_size",
           "param_shardings", "spec_for_param", "input_shardings",
           "batch_spec", "logical_to_sharding", "cache_shardings",
           "quantize_int8", "dequantize_int8", "compressed_psum_mean",
           "cross_pod_grad_reduce"]
