# Port of src/repro/analysis/dispatchloop.py: the pacing rule on the
# port's dispatch loops (a step from `_step`/`_fused_step` in place of a
# `*_exec` executable, torch's syncs in place of jax's).
"""Dispatch-loop pacing rule.

A streaming driver that makes the host wait for the device
UNCONDITIONALLY inside its dispatch loop (``torch.cuda.synchronize()``,
``.synchronize()`` on an event or stream, or a copy to the host:
``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``)
serializes host and device: every iteration drains the stream before
the next launch is enqueued, and the sweep runs at host-roundtrip
cadence.  The port's drivers pace with a bounded in-flight window
instead (``core/shard_sweep.py::_Pacer``: the host waits on the oldest
dispatch's events only under ``if len(self.inflight) > self.depth:``)
and copy to the host once, after the loop.

The rule engages on loops that launch a prepared step: a name bound
from a step factory (``step = _step(...)``; ``_fused_step(...)``) and
the names derived from it (``launches = tuple(zip(step.launches, ...))``
and a loop target iterating it, ``launch(...)``'s results), called or
handed to a call inside the loop (``_staged_chunk(prep,
step.eval_uniform, ...)``).  It flags sync calls reached on every
iteration: the scan descends through the loop body and into the
module's own functions and methods it calls (``pace.dispatched()``), and
prunes at ``if`` statements (a guarded block is pacing, not
serialization) and at nested defs and lambdas (deferred code); syncs
before the loop and after it pass.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from . import astutil
from .astutil import canonical, dotted
from .framework import Finding, ModuleContext, register_rule

#: calls that build a prepared step (the counterpart of `*_exec`)
STEP_FACTORIES = {"_step", "_fused_step"}

#: host-sync entry points that drain the device stream
_SYNC_FNS = {"torch.cuda.synchronize"}
_SYNC_METHODS = {"synchronize", "item", "tolist", "cpu", "numpy"}

#: how deep the scan follows the module's own calls
_CALL_DEPTH = 3


def _root_name(node) -> Optional[str]:
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call,
                            ast.Starred)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _loads(node) -> Set[str]:
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _targets(node) -> Set[str]:
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}


def _step_names(fn: ast.AST) -> Set[str]:
    """Names bound from a step factory in ``fn`` and the names derived
    from them by assignment or iteration."""
    names: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            fname = dotted(node.value.func) or ""
            if fname.rsplit(".", 1)[-1] in STEP_FACTORIES:
                for tgt in node.targets:
                    names |= _targets(tgt)
    if not names:
        return names
    for _ in range(4):
        before = len(names)
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AnnAssign)) \
                    and node.value is not None \
                    and _loads(node.value) & names:
                tgts = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in tgts:
                    names |= _targets(tgt)
            elif isinstance(node, (ast.For, ast.comprehension)) \
                    and _loads(node.iter) & names:
                names |= _targets(node.target)
        if len(names) == before:
            break
    return names


def _launches_step(loop: ast.AST, names: Set[str]) -> bool:
    for node in ast.walk(loop):
        if not isinstance(node, ast.Call):
            continue
        if _root_name(node.func) in names:
            return True
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if _root_name(arg) in names:
                return True
    return False


def _functions(tree: ast.Module) -> List[ast.AST]:
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def dispatch_loops(ctx: ModuleContext) -> Iterator[Tuple[ast.AST, ast.AST]]:
    """``(function, loop)`` for every loop that launches a prepared step
    (cached on the context)."""
    cached = ctx.cache.get("dispatch_loops")
    if cached is None:
        cached = []
        for fn in _functions(ctx.tree):
            names = _step_names(fn)
            if not names:
                continue
            stack = list(fn.body)
            while stack:
                node = stack.pop()
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda, ast.ClassDef)):
                    continue
                if isinstance(node, (ast.For, ast.While)) \
                        and _launches_step(node, names):
                    cached.append((fn, node))
                stack.extend(ast.iter_child_nodes(node))
        cached.sort(key=lambda p: p[1].lineno)
        ctx.cache["dispatch_loops"] = cached
    return iter(cached)


def _is_sync(call: ast.Call, aliases) -> Optional[str]:
    fname = canonical(aliases, dotted(call.func))
    if fname in _SYNC_FNS:
        return fname.rsplit(".", 1)[-1]
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr in _SYNC_METHODS:
            return attr
        if attr == "to" and any(isinstance(a, ast.Constant)
                                and a.value == "cpu" for a in call.args):
            return 'to("cpu")'
    return None


class _Callees:
    """The module's own functions and methods, by name."""

    def __init__(self, tree: ast.Module):
        self.functions: Dict[str, ast.AST] = {}
        methods: Dict[str, List[ast.AST]] = {}
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        methods.setdefault(item.name, []).append(item)
        # a method name defined once in the module resolves
        self.methods = {k: v[0] for k, v in methods.items() if len(v) == 1}

    def resolve(self, call: ast.Call, local: Dict[str, ast.AST]):
        func = call.func
        if isinstance(func, ast.Name):
            return local.get(func.id) or self.functions.get(func.id)
        if isinstance(func, ast.Attribute):
            return self.methods.get(func.attr)
        return None


def _local_defs(fn: ast.AST) -> Dict[str, ast.AST]:
    return {n.name: n for n in ast.walk(fn)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n is not fn}


def _unconditional_syncs(body: List[ast.stmt], aliases, callees: _Callees,
                         local: Dict[str, ast.AST], depth: int,
                         seen: Set[int]) -> List[Tuple[ast.Call, str]]:
    """Sync calls reached on EVERY pass through ``body``: the scan prunes
    at ``if`` statements and nested defs/lambdas, and follows calls of
    the module's own functions and methods ``depth`` levels deep."""
    out: List[Tuple[ast.Call, str]] = []
    stack: List[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.If, ast.IfExp, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.Lambda,
                             ast.ClassDef)):
            continue
        if isinstance(node, ast.Call):
            what = _is_sync(node, aliases)
            if what is not None:
                out.append((node, what))
            elif depth > 0:
                callee = callees.resolve(node, local)
                if callee is not None and id(callee) not in seen:
                    seen.add(id(callee))
                    out += _unconditional_syncs(
                        callee.body, aliases, callees, local, depth - 1,
                        seen)
        stack.extend(ast.iter_child_nodes(node))
    return out


@register_rule(
    "dispatch-loop-sync",
    description="unconditional host wait (torch.cuda.synchronize, "
                ".synchronize(), .item()/.tolist()/.cpu()/.numpy()) inside "
                "a loop launching a prepared step (serializes host and "
                "device; pace with a bounded in-flight window)")
def dispatch_loop_sync(ctx: ModuleContext) -> Iterable[Finding]:
    aliases = astutil.get_engine(ctx).aliases
    callees = _Callees(ctx.tree)
    out: List[Finding] = []
    emitted: Set[int] = set()
    for fn, loop in dispatch_loops(ctx):
        local = _local_defs(fn)
        for call, what in _unconditional_syncs(
                loop.body, aliases, callees, local, _CALL_DEPTH, set()):
            if call.lineno in emitted:
                continue
            emitted.add(call.lineno)
            out.append(Finding(
                rule="dispatch-loop-sync", path=ctx.path, line=call.lineno,
                message=f"`{what}` runs on EVERY iteration of the dispatch "
                        f"loop at line {loop.lineno} of `{fn.name}`, "
                        "draining the device before the next launch is "
                        "enqueued; pace with a bounded in-flight window "
                        "(wait only when the window is full) and copy to "
                        "the host after the loop"))
    return sorted(out, key=lambda f: f.line)
