"""Collective accounting of a traced torch step (the counterpart of
:mod:`.hlo`'s, which parses a compiled XLA module).

:class:`CollectiveCounter` is a ``TorchDispatchMode`` that sizes the
result of every collective this rank issues while it is active: the
functional ops that DTensor's ``redistribute`` and ``full_tensor`` issue
(``_c10d_functional.all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single`` and their coalesced
forms) and the in-place ``c10d`` ops of ``torch.distributed``'s own calls
(``dist.all_reduce`` in ``distributed/compression.py``).  For an op on
DTensors it returns ``NotImplemented``, so DTensor runs first and the
mode sees the collectives and the local ops it issues (as
``torch.distributed.tensor.debug.CommDebugMode`` does).

The ops are keyed by the reference's HLO names (``all-reduce``,
``all-gather``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``; a broadcast or scatter, which the steps do not
issue, under its own name), and :meth:`CollectiveCounter.result`
weights them as :func:`.hlo.collective_bytes` does: all-reduce 2x its
payload, every other collective 1x its result bytes.  The bytes are this
rank's (the per-device program's, as the reference's).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast", "scatter_": "scatter",
}


def hlo_name(func) -> Optional[str]:
    """The reference's HLO name of a collective op, else ``None``."""
    packet = getattr(func, "_overloadpacket", None)
    if packet is None:
        return None
    ns = getattr(packet, "_qualified_op_name", "").split("::")[0]
    name = packet.__name__
    if ns == "_c10d_functional":
        return _FUNCTIONAL.get(name)
    if ns == "c10d":
        return _C10D.get(name)
    return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def result_bytes(func, args, out) -> int:
    """This rank's result bytes of one collective: its output tensors (an
    in-place ``c10d`` op writes, or sends, its first argument)."""
    if func._overloadpacket._qualified_op_name.startswith("c10d::"):
        out = args[0]
    return sum(_nbytes(t) for t in tree_leaves(out)
               if isinstance(t, torch.Tensor))


class CollectiveCounter(TorchDispatchMode):
    """Counts this rank's collectives while active (see the module's
    docstring).  ``per_op`` holds raw result bytes by HLO name, ``ops``
    the number of calls."""

    def __init__(self):
        super().__init__()
        self.per_op: Dict[str, int] = defaultdict(int)
        self.ops: Dict[str, int] = defaultdict(int)

    def record(self, func, args, out) -> Optional[str]:
        name = hlo_name(func)
        if name is not None:
            self.per_op[name] += result_bytes(func, args, out)
            self.ops[name] += 1
        return name

    def result(self) -> Tuple[float, Dict[str, int]]:
        """``(weighted, per_op)`` under :func:`.hlo.collective_bytes`'s
        weighting."""
        per_op = dict(self.per_op)
        weighted = 0.0
        for op, b in per_op.items():
            weighted += (2.0 if op == "all-reduce" else 1.0) * b
        return weighted, per_op

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        self.record(func, args, out)
        return out

