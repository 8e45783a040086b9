# Port of src/repro/analysis/hotpath.py: the host-sync and branch rules
# on the re-aimed taint engine, and the invariant-transform rule on the
# dispatch loops.
"""Hot-path purity rules.

The two event rules share one :class:`~repro_torch.analysis.astutil.
TaintEngine` run per module (cached on the context): the declared hot
roots (and checkpointed functions, autograd ``forward``/``backward``)
have their tensor parameters tainted, taint is propagated to a fixed
point, and the engine records host syncs and Python control flow on
tensors as events.  The invariant-transform rule is structural: a
layout transform of a loop-invariant tensor re-done inside a dispatch
loop (:mod:`~repro_torch.analysis.dispatchloop`).

The reference's ``hot-kernel-array`` and ``hot-nonstatic-pallas-shape``
have no torch target (see :data:`repro_torch.analysis.RULE_MAP`).
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Set

from . import astutil
from .astutil import TRANSFORM_OPS, canonical, dotted
from .dispatchloop import dispatch_loops
from .framework import Finding, ModuleContext, register_rule


def _event_findings(ctx: ModuleContext, kind: str, rule: str
                    ) -> Iterable[Finding]:
    eng = astutil.get_engine(ctx)
    for ev in sorted(eng.events, key=lambda e: (e.line, e.message)):
        if ev.kind == kind:
            yield Finding(rule=rule, path=ctx.path, line=ev.line,
                          message=ev.message)


@register_rule(
    "hot-host-sync",
    description="device->host copy or wait (.item()/.tolist()/.cpu()/"
                ".numpy()/.to('cpu'), float()/int()/bool() of a tensor, "
                "synchronize, nonzero/unique/masked_select, boolean-mask "
                "indexing) inside a hot root")
def hot_host_sync(ctx: ModuleContext) -> Iterable[Finding]:
    return _event_findings(ctx, "host-sync", "hot-host-sync")


@register_rule(
    "hot-tracer-branch",
    description="Python control flow (if/while/assert/conditional "
                "expression/min/max/range) on a tensor inside a hot root "
                "(a host sync on CUDA)")
def hot_tracer_branch(ctx: ModuleContext) -> Iterable[Finding]:
    return _event_findings(ctx, "tracer-branch", "hot-tracer-branch")


def _transform_chain_base(aliases, expr: ast.AST):
    """Peel ``torch.transpose(x, ..).reshape(..).contiguous()``-style
    chains; returns (ops, base_expr)."""
    ops: List[str] = []
    node = expr
    while isinstance(node, ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute):
            fname = canonical(aliases, dotted(func))
            if fname and fname.startswith("torch.") \
                    and func.attr in TRANSFORM_OPS and node.args:
                ops.append(func.attr)
                node = node.args[0]
                continue
            if func.attr in TRANSFORM_OPS:
                ops.append(func.attr)
                node = func.value
                continue
        break
    return ops, node


def _stores(nodes) -> Set[str]:
    out: Set[str] = set()
    for n in nodes:
        for m in ast.walk(n):
            if isinstance(m, ast.Name) and isinstance(m.ctx, ast.Store):
                out.add(m.id)
    return out


def _loop_statements(loop) -> List[ast.stmt]:
    """The statements a loop runs (nested blocks included, nested defs
    not)."""
    out: List[ast.stmt] = []
    stack = list(loop.body)
    while stack:
        s = stack.pop()
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        out.append(s)
        for name in ("body", "orelse", "finalbody"):
            stack.extend(getattr(s, name, []) or [])
        for h in getattr(s, "handlers", []) or []:
            stack.extend(h.body)
    return sorted(out, key=lambda s: s.lineno)


@register_rule(
    "hot-invariant-transform",
    description="layout transform (transpose/permute/reshape/view/"
                "contiguous/to chain) of a loop-invariant tensor re-done "
                "inside a dispatch loop on every dispatch")
def hot_invariant_transform(ctx: ModuleContext) -> Iterable[Finding]:
    aliases = astutil.get_engine(ctx).aliases
    out: List[Finding] = []
    seen: Set[int] = set()
    for fn, loop in dispatch_loops(ctx):
        rebound = _stores(loop.body) | _stores([loop.target]) \
            if isinstance(loop, ast.For) else _stores(loop.body)
        for stmt in _loop_statements(loop):
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)) \
                    or stmt.value is None or stmt.lineno in seen:
                continue
            ops, base = _transform_chain_base(aliases, stmt.value)
            if len(ops) >= 2 and isinstance(base, ast.Name) \
                    and base.id not in rebound:
                seen.add(stmt.lineno)
                chain = ".".join(reversed(ops))
                out.append(Finding(
                    rule="hot-invariant-transform", path=ctx.path,
                    line=stmt.lineno,
                    message=f"`{base.id}` is re-laid-out ({chain}) inside "
                            f"the dispatch loop of `{fn.name}` on every "
                            "dispatch; hoist the transform out of the loop "
                            "and pass the transformed tensor in"))
    return out
