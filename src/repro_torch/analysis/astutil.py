# Port of src/repro/analysis/astutil.py: the alias, scope and taint
# layers, with the taint engine's roots and events re-aimed at eager torch.
"""Shared AST infrastructure for the rule families.

Three layers:

* :func:`build_aliases` / :func:`dotted` / canonical names — resolve
  ``F.pad`` to ``torch.nn.functional.pad`` regardless of how the module
  spelled its imports;
* :class:`ScopeIndex` — every ``def``/``lambda`` in the module with its
  enclosing-function chain, so closures resolve;
* :class:`TaintEngine` — discovers *hot roots*, taints the tensors that
  reach them, and propagates taint through assignments, local calls
  (union over call sites, iterated to a fixed point, a call's result
  tainted when the callee returns a tainted value) and closure reads.
  While walking it records raw events — host syncs and Python control
  flow on tensors — that the rule modules turn into findings.

Eager torch has no tracing root (no ``jit``, ``scan`` or ``pallas_call``
to hand a function to), so the hot roots are declared by name
(:data:`HOT_ROOTS`, keyed by file name, as ``units.py`` names its
evaluators); functions handed to ``torch.utils.checkpoint.checkpoint``
and the ``forward``/``backward`` methods of a ``torch.autograd.Function``
are roots wherever they appear.  A root's parameters are tainted except
those the code uses only as ints, strings, devices, dtypes or shapes:
parameters annotated with no tensor type (:data:`TENSOR_TYPES`), or
unannotated and defaulting to such a constant.  Results of
``torch.*`` calls and of tensor methods are tainted; shape and device
reads are not.

On a CUDA tensor every event is a host sync: ``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``float``/``int``/``bool`` of
a tensor, ``torch.cuda.synchronize()``, ``.synchronize()`` on an event
or stream, the ops whose output shape depends on values
(``torch.nonzero``, ``torch.unique``, ``masked_select``, boolean-mask
indexing), and Python ``if``/``while``/``assert``/``min``/``max``/
``range`` on a tensor (its truth value or its integer value must reach
the host).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .framework import ModuleContext

#: declared hot roots, keyed by file name: ``"name"`` roots that
#: function (``"Class.method"`` a method), ``"name.*"`` the closures the
#: factory ``name`` returns
HOT_ROOTS: Dict[str, Tuple[str, ...]] = {
    # the sweep's device-side chunk work: a fused step's launches, the
    # fold, the shard merge, the running-state merge and a staged chunk
    "shard_sweep.py": ("_fused_step", "_fold_chunk", "_combine_shards",
                       "_merge_candidates", "_staged_chunk"),
    # the three parity-locked evaluators' closures
    "batch.py": ("build_coeff_compute.*", "_build_eval.*",
                 "build_banked_eval.*"),
    # the service's coalesced dispatch
    "coalesce.py": ("_dispatch_segment", "run_group"),
    # the launch path every wrapper shares, and each wrapper's launch
    "cuda_build.py": ("launch",),
    "fused_sweep.py": ("fused_sweep_block", "run"),
    "grid_decode.py": ("grid_decode",),
    "stream_reduce.py": ("block_stats", "block_stats_banked", "run",
                         "run_banked"),
    "category_reduce.py": ("category_reduce",),
    "binning.py": ("binning",),
    "stencil_conv.py": ("stencil_conv", "_launch"),
    "frame_event.py": ("frame_event",),
    "matmul.py": ("matmul", "run"),
    "flash_attention.py": ("flash_attention",),
}

# Attribute reads that never yield a tensor even on a tensor.
STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout",
                "itemsize", "nbytes", "requires_grad"}

# Tensor methods whose results are host metadata, read without a sync.
STATIC_METHODS = {"numel", "dim", "size", "data_ptr", "is_contiguous",
                  "element_size", "stride", "storage_offset", "get_device",
                  "is_floating_point", "is_complex", "nelement"}

# torch.* calls whose results are host metadata or handles, not tensors.
TRANSPARENT_CALLS = {
    "torch.device", "torch.Size", "torch.finfo", "torch.iinfo",
    "torch.is_tensor", "torch.is_floating_point", "torch.promote_types",
    "torch.get_default_dtype", "torch.result_type",
    "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.current_device", "torch.cuda.get_device_properties",
    "torch.cuda.get_device_name", "torch.cuda.current_stream",
    "torch.cuda.Event", "torch.cuda.Stream", "torch.cuda.device",
    "torch.cuda.stream", "torch._C._cuda_getCurrentRawStream",
    "torch._C._cuda_getDevice",
}

# Methods that copy the receiver to the host.
HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

# Calls that wait for the device whatever their arguments.
SYNC_CALLS = {"torch.cuda.synchronize"}

# Ops whose output shape depends on the values: on CUDA they copy a count
# to the host before they can allocate their result.
VALUE_SHAPE_OPS = {"nonzero", "argwhere", "unique", "unique_consecutive",
                   "masked_select"}

# Builtins that concretize a tensor argument on the host.
HOST_SYNC_BUILTINS = {"float", "int", "bool", "complex"}

# Builtins that compare or iterate a tensor's values on the host.
BRANCH_BUILTINS = {"min", "max", "range", "any", "all", "sorted"}

# Builtins returning host containers; result taint = taint of contents.
CONTAINER_BUILTINS = {"tuple", "list", "dict", "set", "zip", "enumerate",
                      "reversed", "map", "filter", "frozenset"}

# Builtins that never return a tensor.
NEUTRAL_BUILTINS = {"len", "print", "repr", "str", "format", "isinstance",
                    "issubclass", "hasattr", "callable", "id", "type",
                    "hash", "sum"}

# Layout transforms (method or torch.* spelling) for the
# hot-invariant-transform rule.
TRANSFORM_OPS = {"transpose", "permute", "reshape", "view", "contiguous",
                 "to", "flatten", "movedim", "swapaxes", "t"}

# Annotations that name tensors or the port's containers of tensors: a
# parameter annotated with none of them holds host values only.
TENSOR_TYPES = {"torch.Tensor", "Tensor", "DesignPoints", "PlanBank",
                "_StreamPrep"}

# Names of parameters that are never tensors (methods, autograd ctx).
STATIC_PARAM_NAMES = {"self", "cls", "ctx"}


def build_aliases(tree: ast.Module) -> Dict[str, str]:
    """Map local names to canonical dotted module paths."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    head = a.name.split(".")[0]
                    aliases[head] = head
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def dotted(node: ast.AST) -> Optional[str]:
    """Render a Name/Attribute chain as ``a.b.c`` (None otherwise)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def canonical(aliases: Dict[str, str], name: Optional[str]) -> Optional[str]:
    if not name:
        return None
    head, _, rest = name.partition(".")
    base = aliases.get(head, head)
    return f"{base}.{rest}" if rest else base


@dataclass
class FnInfo:
    node: ast.AST  # FunctionDef | AsyncFunctionDef | Lambda
    name: str
    parent: Optional["FnInfo"]
    pos_params: List[str]
    kwonly_params: List[str]
    depth: int = 0
    owner: Optional[str] = None  # enclosing class of a method

    @property
    def all_params(self) -> List[str]:
        return self.pos_params + self.kwonly_params


class ScopeIndex(ast.NodeVisitor):
    """Every def/lambda with its enclosing chain + name lookup tables."""

    def __init__(self, tree: ast.Module):
        self.by_node: Dict[int, FnInfo] = {}
        self.defs_in_scope: Dict[Optional[int], Dict[str, FnInfo]] = {None: {}}
        self.by_name: Dict[str, List[FnInfo]] = {}
        self._stack: List[FnInfo] = []
        self._classes: List[str] = []
        self.visit(tree)

    def _register(self, name: str, node: ast.AST) -> FnInfo:
        args = node.args
        pos = [a.arg for a in getattr(args, "posonlyargs", []) + args.args]
        kwonly = [a.arg for a in args.kwonlyargs]
        parent = self._stack[-1] if self._stack else None
        info = FnInfo(node=node, name=name, parent=parent, pos_params=pos,
                      kwonly_params=kwonly, depth=len(self._stack),
                      owner=self._classes[-1] if self._classes
                      and not isinstance(node, ast.Lambda) else None)
        self.by_node[id(node)] = info
        scope_key = id(parent.node) if parent else None
        self.defs_in_scope.setdefault(scope_key, {})[name] = info
        self.by_name.setdefault(name, []).append(info)
        return info

    def _visit_fn(self, node, name):
        info = self._register(name, node)
        self._stack.append(info)
        saved, self._classes = self._classes, []
        self.generic_visit(node)
        self._classes = saved
        self._stack.pop()

    def visit_ClassDef(self, node):
        self._classes.append(node.name)
        self.generic_visit(node)
        self._classes.pop()

    def visit_FunctionDef(self, node):
        self._visit_fn(node, node.name)

    def visit_AsyncFunctionDef(self, node):
        self._visit_fn(node, node.name)

    def visit_Lambda(self, node):
        self._visit_fn(node, "<lambda>")

    def visit_Assign(self, node):
        # `f = lambda ...:` acts as a named local function definition.
        if (isinstance(node.value, ast.Lambda)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            info = self.by_node.get(id(node.value))
            if info is None:
                info = self._register(node.targets[0].id, node.value)
                self._stack.append(info)
                self.generic_visit(node.value)
                self._stack.pop()
            else:
                info.name = node.targets[0].id
            scope_key = id(info.parent.node) if info.parent else None
            self.defs_in_scope.setdefault(scope_key, {})[info.name] = info
            self.by_name.setdefault(info.name, []).append(info)
            for t in node.targets:
                self.visit(t)
        else:
            self.generic_visit(node)

    def resolve(self, name: str, within: Optional[FnInfo]) -> Optional[FnInfo]:
        """Look ``name`` up along the enclosing-scope chain, falling back
        to a unique module-wide match (covers functions passed around as
        values)."""
        info = within
        while True:
            scope_key = id(info.node) if info else None
            hit = self.defs_in_scope.get(scope_key, {}).get(name)
            if hit is not None:
                return hit
            if info is None:
                break
            info = info.parent
        cands = self.by_name.get(name, [])
        return cands[0] if len(cands) == 1 else None


@dataclass
class FnState:
    info: FnInfo
    tainted: Set[str] = field(default_factory=set)
    returns_tainted: bool = False
    masks: Set[str] = field(default_factory=set)  # boolean-tensor names
    dicts: Set[str] = field(default_factory=set)  # names bound to dicts


@dataclass(frozen=True)
class Event:
    kind: str  # "host-sync" | "tracer-branch"
    line: int
    message: str


def _ann_names(node) -> Set[str]:
    """Every dotted name an annotation mentions (strings parsed)."""
    if node is None:
        return set()
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return {node.value}
    if isinstance(node, ast.Constant) and node.value is None:
        return {"None"}
    out: Set[str] = set()
    if isinstance(node, (ast.Name, ast.Attribute)):
        name = dotted(node)
        if name:
            out.add(name)
        return out
    if isinstance(node, ast.Subscript):
        out |= _ann_names(node.value)
        sl = node.slice
        elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        for e in elts:
            out |= _ann_names(e)
        return out
    if isinstance(node, ast.BinOp):               # int | None
        return _ann_names(node.left) | _ann_names(node.right)
    if isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            out |= _ann_names(e)
        return out
    if isinstance(node, ast.Constant) and node.value is Ellipsis:
        return set()
    return {"<unknown>"}


def _static_param(arg: ast.arg, default) -> bool:
    """A parameter the code uses only as a host value: annotated with no
    tensor type, or (unannotated) defaulting to a host constant or a
    ``torch.<dtype>``."""
    if arg.arg in STATIC_PARAM_NAMES:
        return True
    if arg.annotation is not None:
        return not _ann_names(arg.annotation) & TENSOR_TYPES
    if isinstance(default, ast.Constant):
        return isinstance(default.value, (bool, int, float, str))
    return isinstance(default, ast.Attribute) \
        and (dotted(default) or "").startswith("torch.")


def tensor_params(info: FnInfo) -> List[str]:
    """The parameters of ``info`` that a root taints."""
    node = info.node
    args = node.args
    pos = list(getattr(args, "posonlyargs", [])) + list(args.args)
    defaults = [None] * (len(pos) - len(args.defaults)) + list(args.defaults)
    out = [a.arg for a, d in zip(pos, defaults) if not _static_param(a, d)]
    out += [a.arg for a, d in zip(args.kwonlyargs, args.kw_defaults)
            if not _static_param(a, d)]
    if args.vararg is not None and not _static_param(args.vararg, None):
        out.append(args.vararg.arg)
    return out


class TaintEngine:
    """Hot-root discovery + fixed-point taint propagation for one module."""

    def __init__(self, ctx: ModuleContext):
        self.ctx = ctx
        self.aliases = build_aliases(ctx.tree)
        self.scopes = ScopeIndex(ctx.tree)
        self.states: Dict[int, FnState] = {}
        self.events: Set[Event] = set()
        self._enclosing_of: Dict[int, Optional[FnInfo]] = {}
        self._index_enclosing(ctx.tree, None)
        self._discover_roots()
        self._fixed_point()

    # -- setup -----------------------------------------------------------

    def canon(self, node: ast.AST) -> Optional[str]:
        return canonical(self.aliases, dotted(node))

    def _index_enclosing(self, node, current):
        for child in ast.iter_child_nodes(node):
            self._enclosing_of[id(child)] = current
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                info = self.scopes.by_node.get(id(child))
                self._index_enclosing(child, info or current)
            else:
                self._index_enclosing(child, current)

    def state_for(self, info: FnInfo) -> FnState:
        st = self.states.get(id(info.node))
        if st is None:
            st = FnState(info=info)
            self.states[id(info.node)] = st
        return st

    def _mark_root(self, info: Optional[FnInfo]) -> None:
        if info is not None:
            self.state_for(info).tainted |= set(tensor_params(info))

    def _declared(self) -> Tuple[str, ...]:
        base = self.ctx.path.replace("\\", "/").rsplit("/", 1)[-1]
        return HOT_ROOTS.get(base, ())

    def _returned_closures(self, factory: FnInfo) -> List[FnInfo]:
        """The nested defs a factory returns (``return fn`` or ``return
        f, g`` at its top level)."""
        out: List[FnInfo] = []
        for stmt in factory.node.body:
            if not isinstance(stmt, ast.Return) or stmt.value is None:
                continue
            elts = (stmt.value.elts if isinstance(stmt.value, ast.Tuple)
                    else [stmt.value])
            for e in elts:
                if isinstance(e, ast.Name):
                    hit = self.scopes.defs_in_scope.get(
                        id(factory.node), {}).get(e.id)
                    if hit is not None:
                        out.append(hit)
        return out

    def _discover_roots(self) -> None:
        declared = self._declared()
        for info in list(self.scopes.by_node.values()):
            if info.depth != 0 and info.owner is None:
                continue
            qual = f"{info.owner}.{info.name}" if info.owner else info.name
            if qual in declared:
                self._mark_root(info)
            if f"{qual}.*" in declared:
                for closure in self._returned_closures(info):
                    self._mark_root(closure)
        for node in ast.walk(self.ctx.tree):
            if isinstance(node, ast.Call):
                self._root_from_call(node)
            elif isinstance(node, ast.ClassDef):
                self._root_from_class(node)

    def _root_from_call(self, call: ast.Call) -> None:
        fname = self.canon(call.func)
        if fname == "torch.utils.checkpoint.checkpoint" and call.args:
            within = self._enclosing_of.get(id(call))
            node = call.args[0]
            if (isinstance(node, ast.Call)
                    and self.canon(node.func) == "functools.partial"
                    and node.args):
                node = node.args[0]
            info = None
            if isinstance(node, ast.Lambda):
                info = self.scopes.by_node.get(id(node))
            elif isinstance(node, ast.Name):
                info = self.scopes.resolve(node.id, within)
            self._mark_root(info)

    def _root_from_class(self, cls: ast.ClassDef) -> None:
        bases = {self.canon(b) for b in cls.bases}
        if not bases & {"torch.autograd.Function",
                        "torch.autograd.function.Function"}:
            return
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt.name in ("forward", "backward"):
                self._mark_root(self.scopes.by_node.get(id(stmt)))

    # -- fixed point -----------------------------------------------------

    def _snapshot(self):
        return tuple(sorted(
            (k, frozenset(v.tainted), frozenset(v.masks),
             frozenset(v.dicts), v.returns_tainted)
            for k, v in self.states.items()))

    def _fixed_point(self) -> None:
        for _ in range(12):
            before = self._snapshot()
            for st in sorted(list(self.states.values()),
                             key=lambda s: s.info.depth):
                _FnWalker(self, st).run()
            if self._snapshot() == before:
                break

    # -- events ----------------------------------------------------------

    def emit(self, kind: str, line: int, message: str) -> None:
        self.events.add(Event(kind=kind, line=line, message=message))


def _is_cpu_target(node) -> bool:
    """``"cpu"``, ``torch.device("cpu")`` or ``device="cpu"``-style
    arguments of ``.to(...)``."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    if isinstance(node, ast.Call) and node.args \
            and (dotted(node.func) or "").endswith("device"):
        return _is_cpu_target(node.args[0])
    return False


class _FnWalker:
    """Walk one hot function's body in statement order, propagating taint
    and emitting events."""

    def __init__(self, engine: TaintEngine, st: FnState):
        self.e = engine
        self.st = st

    def run(self) -> None:
        node = self.st.info.node
        if isinstance(node, ast.Lambda):
            if self.taint(node.body):
                self.st.returns_tainted = True
        else:
            self.block(node.body)

    # -- statements ------------------------------------------------------

    def block(self, stmts) -> None:
        for s in stmts:
            self.stmt(s)

    def bind(self, target, tainted: bool, mask: bool = False) -> None:
        if isinstance(target, ast.Name):
            if tainted:
                self.st.tainted.add(target.id)
            if mask:
                self.st.masks.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self.bind(e, tainted)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, tainted)
        elif isinstance(target, (ast.Subscript, ast.Attribute)):
            # mutating a slot of a container taints the container
            base = target
            while isinstance(base, (ast.Subscript, ast.Attribute)):
                base = base.value
            if tainted and isinstance(base, ast.Name):
                self.st.tainted.add(base.id)

    def stmt(self, s) -> None:
        if isinstance(s, ast.Assign):
            t = self.taint(s.value)
            m = t and self.is_mask(s.value)
            for tgt in s.targets:
                self.bind(tgt, t, m)
                if isinstance(tgt, ast.Name) and (
                        isinstance(s.value, (ast.Dict, ast.DictComp))
                        or isinstance(s.value, ast.Call)
                        and dotted(s.value.func) == "dict"):
                    self.st.dicts.add(tgt.id)
        elif isinstance(s, ast.AnnAssign):
            if s.value is not None:
                t = self.taint(s.value)
                self.bind(s.target, t, t and self.is_mask(s.value))
        elif isinstance(s, ast.AugAssign):
            t = self.taint(s.value) or self.taint(s.target)
            self.bind(s.target, t)
        elif isinstance(s, ast.Return):
            if s.value is not None and self.taint(s.value):
                self.st.returns_tainted = True
        elif isinstance(s, ast.Expr):
            self.taint(s.value)
        elif isinstance(s, (ast.If, ast.While)):
            if self.taint(s.test):
                kw = "while" if isinstance(s, ast.While) else "if"
                self.e.emit("tracer-branch", s.lineno,
                            f"Python `{kw}` condition reads a tensor's "
                            "value on the host (a sync on CUDA); use "
                            "torch.where or keep the decision on the host")
            body_passes = 2 if isinstance(s, ast.While) else 1
            for _ in range(body_passes):
                self.block(s.body)
            self.block(s.orelse)
        elif isinstance(s, ast.Assert):
            if self.taint(s.test):
                self.e.emit("tracer-branch", s.lineno,
                            "assert on a tensor reads its value on the "
                            "host (a sync on CUDA); check on the host "
                            "values instead")
        elif isinstance(s, ast.For):
            self.bind_for(s.target, s.iter)
            for _ in range(2):
                self.block(s.body)
            self.block(s.orelse)
        elif isinstance(s, ast.With):
            for item in s.items:
                self.taint(item.context_expr)
                if item.optional_vars is not None:
                    self.bind(item.optional_vars, False)
            self.block(s.body)
        elif isinstance(s, ast.Try):
            self.block(s.body)
            for h in s.handlers:
                self.block(h.body)
            self.block(s.orelse)
            self.block(s.finalbody)
        elif isinstance(s, ast.Raise):
            if s.exc is not None:
                self.taint(s.exc)
        # nested FunctionDef/ClassDef bodies are separate scopes: they are
        # analyzed when discovered as roots or reached through a call.

    def bind_for(self, target, it) -> None:
        """``for k, v in d.items()`` binds the key untainted (iterating a
        dict of tensors yields host keys), and a loop over a literal table
        of rows binds each target its column's taint."""
        if (isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute)
                and it.func.attr == "items"
                and isinstance(target, ast.Tuple) and len(target.elts) == 2):
            t = self.taint(it)
            self.bind(target.elts[1], t)
            return
        if (isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute)
                and it.func.attr == "keys"):
            self.taint(it)
            return
        if (isinstance(target, ast.Tuple) and isinstance(it, (ast.Tuple,
                                                              ast.List))
                and it.elts and all(isinstance(r, ast.Tuple)
                                    and len(r.elts) == len(target.elts)
                                    for r in it.elts)):
            # a literal table of rows: each target takes its column
            for i, tgt in enumerate(target.elts):
                self.bind(tgt, any([self.taint(r.elts[i]) for r in it.elts]))
            return
        self.bind(target, self.taint(it))

    # -- expressions -----------------------------------------------------

    def _name_taint(self, name: str) -> bool:
        if name in self.st.tainted:
            return True
        info = self.st.info.parent
        while info is not None:
            parent_st = self.e.states.get(id(info.node))
            if parent_st is not None and name in parent_st.tainted:
                return True
            info = info.parent
        return False

    def is_mask(self, node) -> bool:
        """A boolean tensor: a comparison, ``~``, ``&``/``|`` of one, or a
        name bound from one."""
        if isinstance(node, ast.Compare):
            return not any(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                           ast.NotIn)) for op in node.ops)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self.is_mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(node.left) or self.is_mask(node.right)
        if isinstance(node, ast.Name):
            return node.id in self.st.masks
        if isinstance(node, ast.Call):
            fname = self.e.canon(node.func) or ""
            last = fname.rsplit(".", 1)[-1]
            return last in ("isnan", "isinf", "isfinite", "logical_and",
                            "logical_or", "logical_not", "eq", "ne", "lt",
                            "le", "gt", "ge", "isin")
        return False

    def taint(self, node) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return self._name_taint(node.id)
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                self.taint(node.value)
                return False
            return self.taint(node.value)
        if isinstance(node, ast.Subscript):
            base = self.taint(node.value)
            sl = self.taint(node.slice)
            if base and sl and self.is_mask(node.slice) \
                    and isinstance(node.ctx, ast.Load):
                self.e.emit("host-sync", node.lineno,
                            "boolean-mask indexing of a tensor sizes its "
                            "result from the values (a host sync on "
                            "CUDA); use torch.where or a fixed-size "
                            "index")
            return base or sl
        if isinstance(node, ast.Slice):
            return any([self.taint(x) for x in
                        (node.lower, node.upper, node.step)])
        if isinstance(node, ast.BinOp):
            return self.taint(node.left) | self.taint(node.right)
        if isinstance(node, ast.UnaryOp):
            t = self.taint(node.operand)
            if isinstance(node.op, ast.Not) and t:
                self.e.emit("tracer-branch", node.lineno,
                            "`not` of a tensor reads its truth value on "
                            "the host (a sync on CUDA)")
                return False
            return t
        if isinstance(node, ast.BoolOp):
            ts = [self.taint(v) for v in node.values]
            if any(ts[:-1]):
                self.e.emit("tracer-branch", node.lineno,
                            "`and`/`or` on a tensor reads its truth value "
                            "on the host (a sync on CUDA); use & / |")
            return any(ts)
        if isinstance(node, ast.Compare):
            # identity tests, key membership and dtype comparisons never
            # read a tensor's values
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                self.taint(node.left)
                return False
            if (isinstance(node.ops[0], (ast.In, ast.NotIn))
                    and isinstance(node.left, ast.Constant)):
                return False
            if any(isinstance(x, ast.Attribute)
                   and (self.e.canon(x) or "").startswith("torch.")
                   for x in [node.left, *node.comparators]):
                return False
            t = self.taint(node.left)
            for c in node.comparators:
                t |= self.taint(c)
            return t
        if isinstance(node, ast.Call):
            return self.call_taint(node)
        if isinstance(node, ast.IfExp):
            if self.taint(node.test):
                self.e.emit("tracer-branch", node.lineno,
                            "conditional expression on a tensor reads its "
                            "value on the host (a sync on CUDA); use "
                            "torch.where instead")
            return self.taint(node.body) | self.taint(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any([self.taint(e) for e in node.elts])
        if isinstance(node, ast.Dict):
            return (any([self.taint(k) for k in node.keys if k is not None])
                    | any([self.taint(v) for v in node.values]))
        if isinstance(node, ast.Starred):
            return self.taint(node.value)
        if isinstance(node, ast.Lambda):
            return False
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            for gen in node.generators:
                self.bind_for(gen.target, gen.iter)
            if isinstance(node, ast.DictComp):
                return self.taint(node.key) | self.taint(node.value)
            return self.taint(node.elt)
        if isinstance(node, (ast.JoinedStr, ast.FormattedValue)):
            return False
        if isinstance(node, ast.NamedExpr):
            t = self.taint(node.value)
            self.bind(node.target, t)
            return t
        return False

    def call_taint(self, call: ast.Call) -> bool:
        arg_taints = [self.taint(a) for a in call.args]
        kw_taints = {kw.arg: self.taint(kw.value) for kw in call.keywords}
        any_arg = any(arg_taints) or any(kw_taints.values())
        func = call.func

        # method call on a receiver that is not a module path
        if isinstance(func, ast.Attribute):
            fname = canonical(self.e.aliases, dotted(func))
            if fname is None or not self._is_module_path(fname):
                if func.attr == "synchronize":
                    self.taint(func.value)
                    self.e.emit("host-sync", call.lineno,
                                ".synchronize() makes the host wait for the "
                                "device inside the hot path")
                    return False
                recv_tainted = self.taint(func.value)
                if recv_tainted:
                    if func.attr in HOST_SYNC_METHODS or (
                            func.attr == "to" and (
                                any(_is_cpu_target(a) for a in call.args)
                                or any(kw.arg == "device"
                                       and _is_cpu_target(kw.value)
                                       for kw in call.keywords))):
                        what = ('.to("cpu")' if func.attr == "to"
                                else f".{func.attr}()")
                        self.e.emit(
                            "host-sync", call.lineno,
                            f"{what} on a tensor copies it to the host "
                            "(a sync on CUDA) inside the hot path")
                        return False
                    if func.attr in VALUE_SHAPE_OPS:
                        self.e.emit(
                            "host-sync", call.lineno,
                            f".{func.attr}() sizes its result from the "
                            "values (a host sync on CUDA) inside the hot "
                            "path")
                        return True
                    if func.attr in STATIC_METHODS:
                        return False
                    if func.attr in ("keys",):
                        return False
                    return True
                return any_arg
        else:
            fname = canonical(self.e.aliases, dotted(func))

        if fname is None:
            return any_arg
        if fname in TRANSPARENT_CALLS:
            return False
        if fname in SYNC_CALLS:
            self.e.emit("host-sync", call.lineno,
                        f"{fname}() makes the host wait for the device "
                        "inside the hot path")
            return False
        if fname.startswith("torch."):
            last = fname.rsplit(".", 1)[-1]
            if last in VALUE_SHAPE_OPS or (
                    last == "where" and len(call.args) == 1
                    and not call.keywords):
                self.e.emit(
                    "host-sync", call.lineno,
                    f"{fname} sizes its result from the values (a host "
                    "sync on CUDA) inside the hot path")
            return True
        if fname.startswith("numpy."):
            if any_arg:
                self.e.emit(
                    "host-sync", call.lineno,
                    f"{fname} called on a tensor pulls it to the host; use "
                    "the torch equivalent")
            return False
        if fname in HOST_SYNC_BUILTINS:
            if any_arg:
                self.e.emit(
                    "host-sync", call.lineno,
                    f"{fname}() of a tensor copies its value to the host "
                    "(a sync on CUDA) inside the hot path")
            return False
        if fname in BRANCH_BUILTINS:
            if any_arg:
                self.e.emit(
                    "tracer-branch", call.lineno,
                    f"{fname}() compares or counts a tensor's values on "
                    "the host (a sync on CUDA); use the torch reduction")
            return False
        if fname in NEUTRAL_BUILTINS:
            return False
        if fname in CONTAINER_BUILTINS:
            if len(call.args) == 1 and isinstance(call.args[0], ast.Name) \
                    and call.args[0].id in self.st.dicts:
                return False          # a dict's keys
            return any_arg
        if fname in ("abs", "divmod", "round", "getattr", "pow"):
            return any_arg

        # local call: propagate taint into the callee's parameters
        info = None
        if isinstance(func, ast.Name):
            info = self.e.scopes.resolve(func.id, self.st.info)
        if info is not None:
            callee = self.e.state_for(info)
            # a parameter annotated with host types only takes no taint:
            # the annotation is the callee's contract
            takes = set(tensor_params(info)) if not isinstance(
                info.node, ast.Lambda) else set(info.all_params)
            for i, t in enumerate(arg_taints):
                if t and i < len(info.pos_params) \
                        and info.pos_params[i] in takes:
                    callee.tainted.add(info.pos_params[i])
            for name, t in kw_taints.items():
                if t and name in takes:
                    callee.tainted.add(name)
            return callee.returns_tainted
        return any_arg

    @staticmethod
    def _is_module_path(fname: str) -> bool:
        head = fname.split(".")[0]
        return head in ("torch", "numpy", "math", "functools", "itertools",
                        "operator", "os", "collections", "ctypes", "time",
                        "threading")


def get_engine(ctx: ModuleContext) -> TaintEngine:
    eng = ctx.cache.get("taint_engine")
    if eng is None:
        eng = TaintEngine(ctx)
        ctx.cache["taint_engine"] = eng
    return eng
