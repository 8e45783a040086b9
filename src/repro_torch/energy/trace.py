"""Costs of one traced torch step, per device (the counterpart of what
``src/repro/launch/dryrun.py::_compile`` reads from XLA:
``cost_analysis()``, ``memory_analysis()`` and the collectives of the
compiled SPMD module).

:class:`StepTrace` is a ``TorchDispatchMode``.  On an op over DTensors it
returns ``NotImplemented``, so DTensor runs first, and the mode sees what
this rank then runs: the op on its local shards, the collectives of any
redistribute, and the plain ops (the shard-local ops of
``distributed/ops.py``, plain tensors that meet DTensors).  So every count
is this rank's, as the reference's are the per-device program's, and an
unevenly sharded dimension counts this rank's share.  The tensor-metadata
propagation DTensor runs on global shapes (on a sharding-cache miss) is
not this rank's work and is skipped.  Under ``FakeTensorMode`` with a fake
process group (``launch/dryrun.py``), rank 0 of a 256- or 512-rank mesh
is traced in one process with no storage behind any tensor.

What it counts, per device:

* ``flops``: products by ``torch.utils.flop_counter``'s formulas (2 a
  multiply-add, as XLA's), plus the elementwise and reduction work as
  XLA's HLO cost analysis counts it on the CPU: one FLOP an output element
  of an elementwise arithmetic op, none for a transcendental (``exp``,
  ``log``, ``rsqrt``, ``tanh``: XLA counts those apart), a composite op as
  the ops XLA expands it into (``sigmoid`` 3, ``silu`` 4), a reduction its
  input elements less its output elements (:data:`EW_FLOPS`,
  :func:`elementwise_flops`);
* memory: the bytes of the arguments' local storages, the peak of live
  local storages during the step (every storage an op makes is followed
  until it is freed) and the bytes of the result's storages;
* ``bytes_hlo``: every op's operand and result bytes (views and
  allocations excluded), the counterpart of XLA's unfused "bytes
  accessed";
* collectives by :class:`.collectives.CollectiveCounter`.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from .collectives import CollectiveCounter

aten = torch.ops.aten

# XLA's CPU FLOPs an output element of ops that are not one HLO op each,
# or that count nothing (measured on jax 0.9's CPU backend, one op at a
# time: sigmoid = neg, add, divide and an exp; silu adds the multiply;
# logaddexp = max, subtract, abs, negate, add and a select;
# exp, log, sqrt, rsqrt, tanh, pow count as transcendentals, not FLOPs).
EW_FLOPS: Dict[Any, float] = {
    aten.sigmoid: 3.0, aten.silu: 4.0, aten.gelu: 8.0, aten.softplus: 6.0,
    aten.logaddexp: 6.0,
    aten.sigmoid_backward: 2.0, aten.silu_backward: 6.0,
    aten.tanh_backward: 2.0,
    aten.exp: 0.0, aten.exp2: 0.0, aten.expm1: 0.0, aten.log: 0.0,
    aten.log1p: 0.0, aten.log2: 0.0, aten.sqrt: 0.0, aten.rsqrt: 0.0,
    aten.tanh: 0.0, aten.sin: 0.0, aten.cos: 0.0, aten.erf: 0.0,
    aten.pow: 0.0,
}
# reductions: (FLOPs an input element, FLOPs an output element less one
# an output element): sum = in - out; mean adds a divide an output
_REDUCE: Dict[Any, Tuple[float, float]] = {
    aten.sum: (1.0, -1.0), aten.amax: (1.0, -1.0), aten.amin: (1.0, -1.0),
    aten.max: (1.0, -1.0), aten.min: (1.0, -1.0), aten.argmax: (1.0, -1.0),
    aten.argmin: (1.0, -1.0), aten.any: (1.0, -1.0), aten.all: (1.0, -1.0),
    aten.prod: (1.0, -1.0), aten.mean: (1.0, 0.0),
    aten.logsumexp: (3.0, 0.0),
}
# softmax-class ops, FLOPs an element of their input
_ROWWISE: Dict[Any, float] = {
    aten._softmax: 4.0, aten._log_softmax: 5.0,
    aten._softmax_backward_data: 4.0, aten._log_softmax_backward_data: 4.0,
}
# allocations, fills from nothing and metadata: no FLOPs, no bytes
_FREE = {aten.empty, aten.empty_strided, aten.empty_like, aten.detach,
         aten.lift_fresh, aten.alias, aten._local_scalar_dense}


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def elementwise_flops(func, args, out) -> float:
    """XLA's FLOPs for a non-product op (see :data:`EW_FLOPS`)."""
    packet = func._overloadpacket
    outs = _tensors(out)
    n_out = sum(t.numel() for t in outs)
    if packet in _ROWWISE:
        return _ROWWISE[packet] * _numel(args[0])
    if packet in _REDUCE:
        per_in, per_out = _REDUCE[packet]
        first = outs[0].numel() if outs else 0
        return max(per_in * _numel(args[0]) + per_out * first, 0.0)
    if packet is aten.cumsum:
        dim = args[1] % max(args[0].ndim, 1)
        n = args[0].shape[dim] if args[0].ndim else 1
        return min(n - 1, 17) * n_out
    if packet in (aten._to_copy, aten.copy_, aten.copy):
        src = args[1] if packet is aten.copy_ else args[0]
        dst = outs[0] if outs else None
        return float(n_out) if (dst is not None and isinstance(
            src, torch.Tensor) and src.dtype != dst.dtype) else 0.0
    if torch.Tag.pointwise not in func.tags:
        return 0.0
    return EW_FLOPS.get(packet, 1.0) * n_out


class _SkipMetaPropagation:
    """While DTensor derives an op's sharding and global output metadata
    (on a sharding-cache miss it runs the op, or its decomposition, on
    global-shape fake or meta tensors), the trace's counters pause: that
    is no rank's work."""

    NAMES = ("propagate_op_sharding_non_cached",
             "_propagate_tensor_meta_non_cached")

    def __init__(self):
        self.depth = threading.local()

    def active(self) -> bool:
        return getattr(self.depth, "n", 0) > 0

    @contextlib.contextmanager
    def installed(self):
        from torch.distributed.tensor import DTensor
        prop = DTensor._op_dispatcher.sharding_propagator
        names = [n for n in self.NAMES if hasattr(prop, n)]
        if len(names) != len(self.NAMES):
            raise RuntimeError(f"this torch's DTensor sharding propagator "
                               f"lacks {sorted(set(self.NAMES) - set(names))}"
                               f": the trace cannot tell its propagation "
                               f"from a rank's ops")

        def wrap(inner):
            def wrapped(*a, **k):
                self.depth.n = getattr(self.depth, "n", 0) + 1
                try:
                    return inner(*a, **k)
                finally:
                    self.depth.n -= 1
            return wrapped
        for n in names:
            setattr(prop, n, wrap(getattr(prop, n)))
        try:
            yield
        finally:
            for n in names:
                delattr(prop, n)


class StepTrace(TorchDispatchMode):
    """Counts one step's per-device costs while active (see the module's
    docstring).  :meth:`track_args` registers the step's arguments before
    the step runs; :meth:`result` gives the reference's keys."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0            # products (flop_counter's formulas)
        self.ew_flops = 0.0         # elementwise and reductions
        self.bytes_hlo = 0.0
        self.collectives = CollectiveCounter()
        self._skip = _SkipMetaPropagation()
        self._seen = WeakIdKeyDictionary()
        self.arg_bytes = 0
        self.out_bytes = 0
        self.live = 0
        self.peak = 0

    # ---- memory ----------------------------------------------------------
    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _track(self, t: torch.Tensor) -> int:
        """Follow ``t``'s local storage; its bytes if it is new."""
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        if st in self._seen:
            return 0
        n = st.nbytes()
        self._seen[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def track_args(self, args: Any) -> int:
        """Register the step's arguments (any tree of tensors) as live:
        their local bytes are ``arg_bytes``."""
        for t in _tensors(args):
            self.arg_bytes += self._track(t)
        return self.arg_bytes

    def track_result(self, out: Any) -> int:
        """The bytes of the result's local storages (each once)."""
        from torch.distributed.tensor import DTensor
        seen = set()
        for t in _tensors(out):
            local = t._local_tensor if isinstance(t, DTensor) else t
            st = local.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                self.out_bytes += st.nbytes()
        return self.out_bytes

    # ---- dispatch --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._skip.active() or any(
                t.device.type == "meta" for t in _tensors(out)):
            return out
        if self.collectives.record(func, args, out) is not None:
            for t in _tensors(out):
                self._track(t)
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        else:
            self.ew_flops += elementwise_flops(func, args, out)
        if packet not in _FREE and not func.is_view:
            self.bytes_hlo += sum(t.numel() * t.element_size() for t in
                                  _tensors((args, kwargs, out)))
        for t in _tensors(out):
            self._track(t)
        return out

    @contextlib.contextmanager
    def tracing(self):
        with self._skip.installed(), self:
            yield self

    # ---- the record --------------------------------------------------------
    def result(self, seconds: float = 0.0) -> Dict[str, Any]:
        """The reference's ``_compile`` keys, per device."""
        coll_w, coll_ops = self.collectives.result()
        temp = max(self.peak - self.arg_bytes, 0)
        return {
            "compile_s": seconds,
            "flops_dev": float(self.flops + self.ew_flops),
            "bytes_dev": float(2.0 * (self.arg_bytes + self.out_bytes
                                      + temp)),
            "bytes_hlo_dev": float(self.bytes_hlo),
            "coll_bytes_dev": coll_w,
            "coll_ops": coll_ops,
            "arg_gb_dev": self.arg_bytes / 1e9,
            "temp_gb_dev": temp / 1e9,
            "out_gb_dev": self.out_bytes / 1e9,
            "peak_gb_dev": (self.arg_bytes + temp) / 1e9,
        }


def trace_step(fn: Callable, args: Sequence, kwargs: Optional[Dict] = None
               ) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn(*args, **kwargs)`` once under a :class:`StepTrace`:
    ``(its result, the reference's cost keys)``.  ``args`` are registered
    as the arguments; ``compile_s`` is the time to trace."""
    tr = StepTrace()
    tr.track_args((args, kwargs))
    t0 = time.perf_counter()
    with tr.tracing():
        out = fn(*args, **(kwargs or {}))
    dt = time.perf_counter() - t0
    tr.track_result(out)
    return out, tr.result(dt)
