"""Prefill traffic: a closed loop of the program's prefill call
(``repro_torch.train.build_prefill``), each call ``batch`` prompts of
``seq`` tokens from the seed into a fresh KV cache of ``cache_len``
positions, with no decode (log-likelihood scoring, reranking).

Every call's last-position logits are kept, and one call's cache,
chosen from the seed as the calls go (a reservoir of one).  After the
window, ``compared_calls`` calls drawn from the seed, the kept one among
them, are computed again by the reference: their logits, and every
layer's K and V of the kept call's cache.

Traffic keys: ``batch``, ``seq``, ``cache_len``, ``distinct_batches``,
``tokens``, ``warmup_calls``, ``compared_calls``, ``in_flight``.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional

import torch

from ..harness import compare, inputs, program
from ..harness.device import span, summarize, traced
from ..harness.loop import Window, closed_loop, seconds_since
from ..harness.manifest import Cell
from ..reference import lm

E2E = ("prefill_tokens_per_s", "setup_s")


@dataclasses.dataclass
class State:
    cell: Cell
    seed: int
    device: torch.device
    cfg: object = None
    params: Optional[Dict] = None
    cache0: Optional[Dict] = None
    fn: object = None
    batches: Optional[torch.Tensor] = None
    logits: List[torch.Tensor] = dataclasses.field(default_factory=list)
    kept: Optional[tuple] = None       # (call, kv_k, kv_v)
    setup_s: Optional[float] = None


def setup(cell: Cell, seed: int, device: torch.device,
          t_start: Optional[float] = None) -> State:
    """Builds the call and warms it up; ``setup_s`` counts from
    ``t_start`` (the process's start) to the end of the warm-up."""
    from repro_torch.models import model as M
    from repro_torch.train import build_prefill
    arch, tr = cell.arch, cell.traffic
    st = State(cell, seed, device)
    st.cfg = program.model_config(cell.entry["config"], arch)
    program.check_layout(st.cfg, arch)
    st.params = program.nest(inputs.make_weights(arch, seed, device))
    st.batches = inputs.make_tokens(arch, tr, seed, device)
    st.cache0 = M.init_cache(st.cfg, tr["batch"], tr["cache_len"],
                             device=device)
    st.fn = build_prefill(st.cfg)
    for i in range(tr["warmup_calls"]):
        st.fn(st.params, {"tokens": st.batches[i]}, st.cache0)
    st.setup_s = seconds_since(t_start, device)
    return st


def window(st: State, seconds: float, trace: bool) -> Window:
    tr = st.cell.traffic
    B, L = tr["batch"], tr["seq"]
    P = st.batches.shape[0]
    pick = random.Random(inputs.sub_seeds(st.seed, 3)[2])

    def call(n: int) -> None:
        with span("prefill"):
            logits, cache = st.fn(st.params, {"tokens": st.batches[n % P]},
                                  st.cache0)
        st.logits.append(logits)
        if pick.random() * (n + 1) < 1.0:
            st.kept = (n, cache["kv_k"], cache["kv_v"])

    if st.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(st.device)
    with traced(trace) as prof:
        n, sec = closed_loop(call, seconds, tr["in_flight"], st.device)
    profile = summarize(prof, sec) if prof is not None else None
    rows = torch.stack([x.reshape(B, -1) for x in st.logits])
    failed = int((~torch.isfinite(rows).all(-1)).sum())
    return Window(units=n, seconds=sec, attempted=n * B,
                  failed=failed, spans={}, profile=profile,
                  e2e={"prefill_tokens_per_s": n * B * L / sec,
                       "setup_s": st.setup_s})


def release(st: State) -> None:
    """Frees the program's weights and cache; the outputs to judge, and
    the inputs, stay."""
    st.params = st.cache0 = st.fn = None
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def sampled(st: State) -> List[int]:
    """The calls the reference computes again: the kept call and others
    drawn from the seed."""
    n, k = len(st.logits), st.cell.traffic["compared_calls"]
    rest = [i for i in range(n) if i != st.kept[0]]
    pick = random.Random(inputs.sub_seeds(st.seed, 4)[3])
    return sorted([st.kept[0]] + pick.sample(rest, min(k - 1, len(rest))))


def judge(st: State, cast=None) -> Dict[str, float]:
    """The numbers of :mod:`portbench.harness.compare` for the sampled
    calls; with ``cast``, of the reference computed with it in the
    program's place (the control)."""
    arch, P = st.cell.arch, st.batches.shape[0]
    w32 = {k: v.float() for k, v in
           inputs.make_weights(arch, st.seed, st.device).items()}
    out = {"kv_gap": 0.0, "logit_gap": 0.0}
    with lm.exact_f32():
        for i in sampled(st):
            tokens = st.batches[i % P]
            kept = i == st.kept[0]
            ref_kv: List = []
            ref = lm.prefill(w32, tokens, arch, on_layer=_keep(ref_kv, kept))
            if cast is None:
                prog = st.logits[i].reshape(ref.shape)
                prog_kv = list(zip(st.kept[1], st.kept[2])) if kept else []
            else:
                prog_kv = []
                prog = lm.prefill(w32, tokens, arch, cast,
                                  on_layer=_keep(prog_kv, kept))
            for (pk, pv), (rk, rv) in zip(prog_kv, ref_kv):
                out["kv_gap"] = max(out["kv_gap"], compare.kv_gap(pk, rk),
                                    compare.kv_gap(pv, rv))
            out["logit_gap"] = max(out["logit_gap"],
                                   compare.logit_gap(prog, ref))
            del ref_kv, prog_kv
    return out


def _keep(into: List, keep: bool):
    """An ``on_layer`` that appends each layer's (K, V) when ``keep``."""
    def on_layer(layer, k, v):
        if keep:
            into.append((k, v))
    return on_layer
