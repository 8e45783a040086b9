# Port of src/repro/analysis/recompile.py: `jit-donated-reuse` becomes
# `inplace-reuse`; the two trace-time rules have no torch target.
"""In-place reuse rule.

The reference's donation hazard has an eager counterpart: a call that
writes a tensor (or a dict of tensors) in place changes every other
handle on it.  A tensor that was bound to a second name, appended to a
container or handed to a thread BEFORE such a call, and read through
that handle AFTER it, sees the written values, not the ones it was
taken for (an async checkpoint meets this hazard: a snapshot handed to
a writer thread before the in-place AdamW step).  The rule
scans each function's statements in order, as the reference's donation
scan does: after an in-place write of ``x``, a read of a handle taken on
``x`` before the write, before the handle is rebound, is a finding; a
handle handed to a thread is flagged at the write itself (the thread
may read it at any time).  ``.clone()`` (or any call) makes a new
tensor, so a cloned snapshot is not a handle.

The in-place writers are :data:`INPLACE_CALLS` (positional argument
indices a function writes) and :data:`INPLACE_METHODS` on a name.

The reference's ``jit-unhashable-static`` and ``jit-mutable-global``
have no torch target (see :data:`repro_torch.analysis.RULE_MAP`).
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .astutil import dotted
from .framework import Finding, ModuleContext, register_rule

#: functions that write positional arguments in place, by name: the
#: sweep's running-state merge writes `state` (`core/shard_sweep.py`)
INPLACE_CALLS: Dict[str, Tuple[int, ...]] = {
    "_merge_candidates": (2,),
}

#: tensor methods that write their receiver in place
INPLACE_METHODS = {"index_copy_", "copy_", "add_", "index_add_",
                   "index_put_", "masked_fill_", "fill_", "zero_", "mul_",
                   "sub_", "div_", "scatter_", "scatter_add_", "clamp_"}

#: container methods that store their arguments (the container becomes a
#: handle on them)
_ADDS = {"append", "extend", "insert", "add"}

#: calls that hand their arguments to another thread
_THREAD_CALLS = {"Thread", "submit", "apply_async", "start_new_thread"}


def _base(node) -> Optional[str]:
    """The name a handle expression reads through (``x``, ``x[k]``,
    ``x.attr``); None for anything that computes a new value."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _loads(node) -> List[ast.Name]:
    return [n for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)]


def _stores(node) -> Set[str]:
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}


class _InplaceScan:
    """Linear statement scan of one function body."""

    def __init__(self, ctx: ModuleContext):
        self.ctx = ctx
        self.handles: Dict[str, str] = {}   # handle name -> base name
        self.threaded: Set[str] = set()     # bases handed to a thread
        self.stale: Dict[str, Tuple[str, int]] = {}  # handle -> (base, line)
        self.findings: List[Finding] = []
        self._emitted: Set[Tuple[str, int]] = set()

    # -- events ------------------------------------------------------------

    def _emit(self, name: str, line: int, message: str) -> None:
        if (name, line) not in self._emitted:
            self._emitted.add((name, line))
            self.findings.append(Finding(rule="inplace-reuse",
                                         path=self.ctx.path, line=line,
                                         message=message))

    def _writes(self, node) -> List[Tuple[str, int, str]]:
        """(base written, line, writer) for each in-place write in
        ``node`` (nested defs excluded)."""
        out = []
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)) and n is not node:
                continue
            if isinstance(n, ast.Call):
                fname = (dotted(n.func) or "").rsplit(".", 1)[-1]
                if isinstance(n.func, ast.Name) and fname in INPLACE_CALLS:
                    for i in INPLACE_CALLS[fname]:
                        if i < len(n.args):
                            b = _base(n.args[i])
                            if b:
                                out.append((b, n.lineno, fname))
                elif isinstance(n.func, ast.Attribute) \
                        and n.func.attr in INPLACE_METHODS:
                    b = _base(n.func.value)
                    if b:
                        out.append((b, n.lineno, n.func.attr))
            stack.extend(ast.iter_child_nodes(n))
        return out

    def _thread_args(self, node) -> Set[str]:
        out: Set[str] = set()
        for n in ast.walk(node):
            name = (dotted(n.func) or "").rsplit(".", 1)[-1] \
                if isinstance(n, ast.Call) else ""
            if name in _THREAD_CALLS:
                # the data handed over, not the callable that runs it
                vals = [kw.value for kw in n.keywords
                        if kw.arg in ("args", "kwargs", "kwds")]
                if name != "Thread":
                    vals += list(n.args[1:])
                for v in vals:
                    elts = v.elts if isinstance(v, (ast.Tuple, ast.List)) \
                        else [v]
                    for e in elts:
                        b = _base(e)
                        if b:
                            out.add(b)
        return out

    def _new_handles(self, s) -> None:
        """``y = x`` / ``y = x[k]`` / ``y = x.attr`` binds a handle;
        ``c.append(x)`` / ``c.extend([x])`` / ``c[k] = x`` makes ``c``
        one."""
        if isinstance(s, ast.Assign) and len(s.targets) == 1:
            tgt, val = s.targets[0], s.value
            b = _base(val)
            if isinstance(tgt, ast.Name) and b and b != tgt.id:
                self.handles[tgt.id] = self.handles.get(b, b)
            elif isinstance(tgt, ast.Subscript) and b \
                    and isinstance(val, (ast.Name, ast.Subscript,
                                         ast.Attribute)):
                c = _base(tgt)
                if c and c != b:
                    self.handles[c] = self.handles.get(b, b)
        for n in ast.walk(s):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in _ADDS:
                c = _base(n.func.value)
                for arg in n.args:
                    elts = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) \
                        else [arg]
                    for e in elts:
                        b = _base(e)
                        if c and b and c != b:
                            self.handles[c] = self.handles.get(b, b)

    # -- statements -------------------------------------------------------

    def stmt(self, s) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            return
        if isinstance(s, (ast.If, ast.While)):
            self.reads(s.test)
            passes = 2 if isinstance(s, ast.While) else 1
            for _ in range(passes):
                self.block(s.body)
            self.block(s.orelse)
            return
        if isinstance(s, ast.For):
            self.reads(s.iter)
            for _ in range(2):
                self.block(s.body)
            self.block(s.orelse)
            return
        if isinstance(s, ast.With):
            for item in s.items:
                self.reads(item.context_expr)
            self.block(s.body)
            return
        if isinstance(s, ast.Try):
            self.block(s.body)
            for h in s.handlers:
                self.block(h.body)
            self.block(s.orelse)
            self.block(s.finalbody)
            return
        # 1) reads of stale handles
        self.reads(s)
        # 2) handles taken and thread hand-offs
        self._new_handles(s)
        self.threaded |= self._thread_args(s)
        # 3) in-place writes make the handles on their base stale
        for base, line, writer in self._writes(s):
            for h, b in self.handles.items():
                if b == base and h != base:
                    self.stale[h] = (base, line)
            if base in self.threaded or any(
                    self.handles.get(t, t) == base for t in self.threaded):
                self._emit(base, line,
                           f"`{base}` was handed to a thread before "
                           f"`{writer}` writes it in place here; the thread "
                           "may read the written values: hand it a clone")
        # 4) rebinding a handle makes it fresh again
        for name in _stores(s):
            self.stale.pop(name, None)
            if not (isinstance(s, ast.Assign) and _base(s.value)):
                self.handles.pop(name, None)

    def reads(self, node) -> None:
        # adding to a container is no read of what it holds
        adds = {id(n.func.value) for n in ast.walk(node)
                if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in _ADDS}
        for n in _loads(node):
            if n.id in self.stale and id(n) not in adds:
                base, line = self.stale[n.id]
                self._emit(n.id, n.lineno,
                           f"`{n.id}` is a handle on `{base}` taken before "
                           f"the in-place write at line {line}; it reads "
                           "the written values now: take a .clone() before "
                           "the write, or read it before")

    def block(self, stmts) -> None:
        for s in stmts:
            self.stmt(s)


@register_rule(
    "inplace-reuse",
    description="a tensor bound to a second name, appended or handed to a "
                "thread before a call that writes it in place, and read "
                "through that handle after the call")
def inplace_reuse(ctx: ModuleContext) -> Iterable[Finding]:
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan = _InplaceScan(ctx)
            scan.block(node.body)
            out.extend(scan.findings)
    return sorted(out, key=lambda f: (f.line, f.message))
