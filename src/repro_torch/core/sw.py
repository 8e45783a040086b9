# Verbatim copy of src/repro/core/sw.py (jax-free model layer).
"""Declarative software (algorithm) description: a DAG of stencil stages.

CamJ observes (Sec. 3.3) that in-sensor algorithms are stencil-regular: each
stage reads a local window (``kernel``) of its input at a given ``stride``
and produces one output element.  Users declare only input/output dimensions
and the stencil geometry; access counts are inferred (no arithmetic detail).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple


def _shape3(shape: Sequence[int]) -> Tuple[int, int, int]:
    s = tuple(int(x) for x in shape)
    if len(s) == 2:
        return (s[0], s[1], 1)
    if len(s) == 3:
        return s  # type: ignore[return-value]
    raise ValueError(f"stage shapes must be 2-D or 3-D, got {shape}")


@dataclasses.dataclass
class Stage:
    """Base node of the software DAG."""
    name: str
    output_size: Tuple[int, int, int] = (1, 1, 1)
    inputs: List["Stage"] = dataclasses.field(default_factory=list)

    def set_input_stage(self, stage: "Stage") -> "Stage":
        self.inputs.append(stage)
        return self

    # number of elementary operations this stage performs per frame
    def num_ops(self) -> float:
        raise NotImplementedError

    # number of output elements per frame
    def num_outputs(self) -> int:
        h, w, c = _shape3(self.output_size)
        return h * w * c

    def output_bytes(self, bits_per_element: int = 8) -> float:
        return self.num_outputs() * bits_per_element / 8.0


@dataclasses.dataclass
class PixelInput(Stage):
    """The raw pixel source: one op per pixel (exposure + readout)."""
    def __post_init__(self):
        self.output_size = _shape3(self.output_size)

    def num_ops(self) -> float:
        return float(self.num_outputs())


@dataclasses.dataclass
class ProcessStage(Stage):
    """Generic stencil stage: output[h,w] = f(window(kernel) @ stride).

    ``ops_per_output`` defaults to the stencil volume (one op per tap), e.g.
    a 3x3 convolution performs 9 MACs per output pixel.
    """
    input_size: Tuple[int, int, int] = (1, 1, 1)
    kernel_size: Tuple[int, ...] = (1, 1)
    stride: Tuple[int, ...] = (1, 1)
    ops_per_output: Optional[float] = None
    #: data-dependent stages (e.g. statistical ROI reduction) skip the
    #: stencil-geometry check; CamJ models them from average-case statistics
    #: (the paper's "memory trace" escape hatch for irregular algorithms).
    irregular: bool = False

    def __post_init__(self):
        self.input_size = _shape3(self.input_size)
        self.output_size = _shape3(self.output_size)

    def stencil_volume(self) -> int:
        v = 1
        for k in self.kernel_size:
            v *= int(k)
        return v

    def num_ops(self) -> float:
        per_out = (self.ops_per_output if self.ops_per_output is not None
                   else self.stencil_volume())
        return float(self.num_outputs()) * per_out

    def check_geometry(self) -> None:
        """Validate output = floor((in - k)/stride) + 1 per spatial dim."""
        if self.irregular:
            return
        ih, iw, _ = self.input_size
        oh, ow, _ = self.output_size
        kh = self.kernel_size[0]
        kw = self.kernel_size[1] if len(self.kernel_size) > 1 else kh
        sh = self.stride[0]
        sw = self.stride[1] if len(self.stride) > 1 else sh
        exp_h = math.floor((ih - kh) / sh) + 1
        exp_w = math.floor((iw - kw) / sw) + 1
        if (oh, ow) != (exp_h, exp_w):
            raise ValueError(
                f"stage {self.name!r}: declared output {(oh, ow)} != stencil "
                f"geometry {(exp_h, exp_w)} from in={self.input_size} "
                f"k={self.kernel_size} stride={self.stride}")


@dataclasses.dataclass
class DNNProcessStage(Stage):
    """A DNN layer stage (conv2d / depthwise / fc) with explicit MAC count."""
    op_type: str = "conv2d"           # conv2d | dwconv2d | fc
    input_size: Tuple[int, int, int] = (1, 1, 1)
    kernel_size: Tuple[int, ...] = (3, 3)
    stride: Tuple[int, ...] = (1, 1)

    def __post_init__(self):
        self.input_size = _shape3(self.input_size)
        self.output_size = _shape3(self.output_size)

    def num_ops(self) -> float:
        oh, ow, oc = self.output_size
        _, _, ic = self.input_size
        kh = self.kernel_size[0]
        kw = self.kernel_size[1] if len(self.kernel_size) > 1 else kh
        if self.op_type == "conv2d":
            return float(oh * ow * oc) * kh * kw * ic
        if self.op_type == "dwconv2d":
            return float(oh * ow * oc) * kh * kw
        if self.op_type == "fc":
            ih, iw, ic = self.input_size
            return float(ih * iw * ic) * oh * ow * oc
        raise ValueError(f"unknown op_type {self.op_type}")


def dag_signature(stages: Sequence[Stage]) -> tuple:
    """Hashable structural signature of a software DAG.

    Two DAGs with the same signature produce identical access counts in the
    energy model — the batched engine's lowering cache keys on this (plus
    the hardware/mapping signatures) so re-built but structurally identical
    studies reuse their compiled ``EnergyPlan``.
    """
    def one(s: Stage) -> tuple:
        fields = [type(s).__name__, s.name, tuple(s.output_size)]
        for attr in ("input_size", "kernel_size", "stride", "ops_per_output",
                     "irregular", "op_type"):
            if hasattr(s, attr):
                v = getattr(s, attr)
                fields.append(tuple(v) if isinstance(v, (list, tuple)) else v)
        fields.append(tuple(d.name for d in s.inputs))
        return tuple(fields)

    return tuple(one(s) for s in topological_order(stages))


def topological_order(stages: Sequence[Stage]) -> List[Stage]:
    """Topo-sort the DAG; raises on cycles (design check #3, Sec. 3.2)."""
    order: List[Stage] = []
    state: Dict[int, int] = {}  # 0 new, 1 visiting, 2 done

    def visit(s: Stage) -> None:
        st = state.get(id(s), 0)
        if st == 1:
            raise ValueError(f"software DAG has a cycle through {s.name!r}")
        if st == 2:
            return
        state[id(s)] = 1
        for dep in s.inputs:
            visit(dep)
        state[id(s)] = 2
        order.append(s)

    for s in stages:
        visit(s)
    return order
