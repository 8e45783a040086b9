"""Training traffic: a closed loop of the program's training step
(``repro_torch.train.build_train_step``) on token batches from the seed.

Set-up builds the step, its parameters (the benchmark's weights) and
AdamW's state, and drives that same object through the first
``compared_steps`` steps, which warm every shape up and are what the
reference follows.  The window then goes on with the same object.  A
traced run calls the same step, with the two calls it makes,
``value_and_grad`` and ``adamw_update``, wrapped where the step looks
them up: each in a host span and timed with CUDA events.

Traffic keys: ``batch``, ``seq``, ``distinct_batches``, ``tokens`` (the
id distribution), ``base_lr``, ``warmup_steps``, ``total_steps``,
``vocab_chunk``, ``adamw`` (the optimizer settings the reference takes;
set-up refuses a mix whose settings are not those the program's step
runs with), ``compared_steps``, ``in_flight``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional
from unittest import mock

import torch

from ..harness import compare, inputs, program
from ..harness.device import span, summarize, traced
from ..harness.loop import Spans, Window, closed_loop, seconds_since
from ..harness.manifest import Cell
from ..reference import lm
from ..reference.train import follow

E2E = ("train_tokens_per_s", "setup_s")


@dataclasses.dataclass
class State:
    cell: Cell
    seed: int
    device: torch.device
    cfg: object = None
    params: Optional[Dict] = None
    opt: Optional[Dict] = None
    step_fn: object = None
    batches: Optional[torch.Tensor] = None
    next_step: int = 0
    readings: Optional[Dict] = None
    setup_s: Optional[float] = None


def _float(tree: Dict) -> Dict[str, float]:
    return {k: float(v) for k, v in tree.items()}


def setup(cell: Cell, seed: int, device: torch.device,
          t_start: Optional[float] = None) -> State:
    """Builds and warms the step; ``setup_s`` counts from ``t_start``
    (the process's start) to the end of the compared steps."""
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    arch, tr = cell.arch, cell.traffic
    program.check_adamw(tr["adamw"])
    st = State(cell, seed, device)
    st.cfg = program.model_config(cell.entry["config"], arch)
    program.check_layout(st.cfg, arch)
    weights = inputs.make_weights(arch, seed, device)
    st.batches = inputs.make_tokens(arch, tr, seed, device)
    start = {k: w.clone() for k, w in weights.items()}
    st.params = program.nest(weights)
    del weights
    st.opt = adamw_init(st.params)
    st.step_fn = build_train_step(
        st.cfg, base_lr=tr["base_lr"], warmup_steps=tr["warmup_steps"],
        total_steps=tr["total_steps"], vocab_chunk=tr["vocab_chunk"])
    losses, first, grad_norm = [], {}, None
    b1 = tr["adamw"]["b1"]
    for s in range(tr["compared_steps"]):
        st.params, st.opt, m = st.step_fn(st.params, st.opt,
                                          {"tokens": st.batches[s]}, s)
        losses.append(m["loss"])
        if s == 0:
            grad_norm = m["grad_norm"]
            # AdamW's first moment after one step is (1 - b1) g
            first = {k: torch.linalg.vector_norm(v) / (1 - b1)
                     for k, v in program.flat(st.opt["m"]).items()}
    update = {k: torch.linalg.vector_norm(p.float() - start[k].float())
              for k, p in program.flat(st.params).items()}
    del start
    st.readings = {"loss": [float(x) for x in losses],
                   "grad_norm": float(grad_norm), "first_grad": _float(first),
                   "update": _float(update)}
    st.next_step = tr["compared_steps"]
    st.setup_s = seconds_since(t_start, device)
    return st


def window(st: State, seconds: float, trace: bool) -> Window:
    from repro_torch.train import steps as S
    tr = st.cell.traffic
    B, L = tr["batch"], tr["seq"]
    P = st.batches.shape[0]
    spans = Spans(trace and st.device.type == "cuda")
    losses = []

    def timed(name: str, fn):
        def call(*args, **kwargs):
            with span(name):
                t = spans.begin()
                out = fn(*args, **kwargs)
                spans.end(name, t)
            return out
        return call

    def step(n: int) -> None:
        i = st.next_step
        st.params, st.opt, m = st.step_fn(
            st.params, st.opt, {"tokens": st.batches[i % P]}, i)
        losses.append(m["loss"])
        st.next_step += 1

    if st.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(st.device)
    with contextlib.ExitStack() as wrapped:
        if trace:
            for attr, name in (("value_and_grad", "grads"),
                               ("adamw_update", "adamw")):
                wrapped.enter_context(mock.patch.object(
                    S, attr, timed(name, getattr(S, attr))))
        with traced(trace) as prof:
            n, sec = closed_loop(step, seconds, tr["in_flight"], st.device)
    profile = summarize(prof, sec) if prof is not None else None
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    return Window(units=n, seconds=sec, attempted=n,
                  failed=failed, spans=spans.ms(), profile=profile,
                  e2e={"train_tokens_per_s": n * B * L / sec,
                       "setup_s": st.setup_s})


def release(st: State) -> None:
    """Frees the program's state; the inputs stay for the reference."""
    st.params = st.opt = st.step_fn = None
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def reference(st: State, cast=lm.identity, fault: Optional[str] = None
              ) -> Dict:
    """The reference's readings of the compared steps (``cast`` and
    ``fault`` give the control and planted faults)."""
    tr = st.cell.traffic
    n = tr["compared_steps"]
    weights = inputs.make_weights(st.cell.arch, st.seed, st.device)
    with lm.exact_f32():
        return follow(weights, [st.batches[s] for s in range(n)],
                      st.cell.arch, tr, n, cast=cast, fault=fault)


def judge(st: State, cast=None) -> Dict[str, float]:
    """The numbers of :mod:`portbench.harness.compare`; with ``cast``, of
    the reference computed with it in the program's place (the
    control)."""
    prog = st.readings if cast is None else reference(st, cast=cast)
    return compare.train_numbers(prog, reference(st))
