# Port of src/repro/analysis/units.py: the same three rules; an
# evaluator that calls another of the three inherits its references.
"""Axis/unit consistency rules.

Two coverage rules pin the repo's parity contract at the source level:
every ``Axis.coeff_hook`` term group and every ``Axis.coeff_cols``
column declared in ``core/axes.py`` must be referenced by **all three**
evaluators in ``core/batch.py`` (per-plan ``_build_eval``, banked
``build_banked_eval``, kernel-coefficient ``build_coeff_compute``) — a
new axis that only patches two of three fails analysis instead of
failing rel-1e-6 parity after an expensive sweep.  An evaluator that
calls another of the three in the same module inherits that one's
references (the port's banked evaluator runs ``build_coeff_compute``'s
physics), so a hook dropped from ``build_coeff_compute`` is flagged for
both.

One dimensional rule runs a lightweight exponent lattice over the base
units (V, A, s, bit) across ``core/plan.py``'s ``_lower_component``:
expressions appended to the constant-energy sink must be Joules, the
linear-in-delay sink Watts, and the FoM sink dimensionless.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .framework import Finding, ModuleContext, register_rule

_EVALUATORS = ("_build_eval", "build_banked_eval", "build_coeff_compute")

# ---------------------------------------------------------------------------
# axes.py introspection (purely syntactic: Axis(...) keyword literals)
# ---------------------------------------------------------------------------


def _axis_contracts(axes_path: str) -> Dict[str, Dict[str, Tuple[str, ...]]]:
    """{axis_name: {"groups": hook group names, "cols": coeff columns}}."""
    try:
        with open(axes_path, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=axes_path)
    except (OSError, SyntaxError):
        return {}
    out: Dict[str, Dict[str, Tuple[str, ...]]] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "Axis"):
            continue
        name = None
        groups: Tuple[str, ...] = ()
        cols: Tuple[str, ...] = ()
        if node.args and isinstance(node.args[0], ast.Constant):
            name = node.args[0].value
        for kw in node.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                name = kw.value.value
            elif kw.arg == "coeff_hook" and isinstance(kw.value, ast.Dict):
                groups = tuple(k.value for k in kw.value.keys
                               if isinstance(k, ast.Constant))
            elif kw.arg == "coeff_cols" and isinstance(
                    kw.value, (ast.Tuple, ast.List)):
                cols = tuple(e.value for e in kw.value.elts
                             if isinstance(e, ast.Constant))
        if name and (groups or cols):
            out[name] = {"groups": groups, "cols": cols}
    return out


def _hook_aliases(tree: ast.Module, contracts) -> Dict[str, Tuple]:
    """Resolve module-level aliases of axis hooks/cols.

    Recognized shapes (the repo's idiom in core/batch.py):
      X = AXIS_BY_NAME["vdd_scale"].coeff_hook        -> ("hookdict", axis)
      Y = AXIS_BY_NAME["adc_bits"].coeff_hook["fom"]  -> ("hook", axis, "fom")
      Z = AXIS_BY_NAME["adc_bits"].coeff_cols[0]      -> ("col", axis, col)
    """
    out: Dict[str, Tuple] = {}

    def axis_of(node) -> Optional[str]:
        # AXIS_BY_NAME["<axis>"]
        if (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id == "AXIS_BY_NAME"
                and isinstance(node.slice, ast.Constant)):
            return node.slice.value
        return None

    for stmt in tree.body:
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            continue
        tgt = stmt.targets[0].id
        v = stmt.value
        if isinstance(v, ast.Attribute):
            axis = axis_of(v.value)
            if axis and v.attr == "coeff_hook":
                out[tgt] = ("hookdict", axis)
        elif isinstance(v, ast.Subscript) and isinstance(v.value,
                                                         ast.Attribute):
            axis = axis_of(v.value.value)
            if axis is None or not isinstance(v.slice, ast.Constant):
                continue
            if v.value.attr == "coeff_hook":
                out[tgt] = ("hook", axis, v.slice.value)
            elif v.value.attr == "coeff_cols":
                cols = contracts.get(axis, {}).get("cols", ())
                idx = v.slice.value
                if isinstance(idx, int) and 0 <= idx < len(cols):
                    out[tgt] = ("col", axis, cols[idx])
    return out


def _evaluator_refs(fn_node, aliases) -> Tuple[Set[Tuple[str, str]],
                                               Set[str]]:
    """(referenced (axis, group) pairs, referenced column names) inside
    one evaluator's full subtree."""
    groups: Set[Tuple[str, str]] = set()
    cols: Set[str] = set()
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Subscript) and isinstance(node.value,
                                                          ast.Name):
            a = aliases.get(node.value.id)
            if a and a[0] == "hookdict" and isinstance(node.slice,
                                                       ast.Constant):
                groups.add((a[1], node.slice.value))
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            a = aliases.get(node.id)
            if a:
                if a[0] == "hook":
                    groups.add((a[1], a[2]))
                elif a[0] == "col":
                    cols.add(a[2])
        elif isinstance(node, ast.Attribute):
            cols.add(node.attr)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            cols.add(node.value)
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.slice, ast.Constant) \
                and isinstance(node.slice.value, str):
            cols.add(node.slice.value)
        # direct AXIS_BY_NAME["a"].coeff_hook["g"] use
        if (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr == "coeff_hook"
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.value.value, ast.Subscript)
                and isinstance(node.value.value.slice, ast.Constant)):
            groups.add((node.value.value.slice.value, node.slice.value))
    return groups, cols


def _calls(fn_node, names) -> Set[str]:
    """The evaluators among ``names`` that ``fn_node`` calls by name."""
    return {n.func.id for n in ast.walk(fn_node)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
            and n.func.id in names and n.func.id != fn_node.name}


def _inherit(defined, refs):
    """Each evaluator's references joined with those of every evaluator
    it calls, transitively."""
    calls = {name: _calls(fn, set(defined)) for name, fn in defined.items()}
    out = {}
    for name in defined:
        groups, cols = set(refs[name][0]), set(refs[name][1])
        seen, todo = {name}, list(calls[name])
        while todo:
            callee = todo.pop()
            if callee in seen:
                continue
            seen.add(callee)
            groups |= refs[callee][0]
            cols |= refs[callee][1]
            todo.extend(calls[callee])
        out[name] = (groups, cols)
    return out


def _coverage(ctx: ModuleContext):
    cached = ctx.cache.get("axis_coverage")
    if cached is not None:
        return cached
    defined = {}
    for node in ctx.tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in _EVALUATORS:
            defined[node.name] = node
    result = None
    if len(defined) >= 2:
        contracts = _axis_contracts(
            os.path.join(os.path.dirname(os.path.abspath(ctx.path)),
                         "axes.py"))
        if contracts:
            aliases = _hook_aliases(ctx.tree, contracts)
            refs = {name: _evaluator_refs(fn, aliases)
                    for name, fn in defined.items()}
            refs = _inherit(defined, refs)
            result = (contracts, defined, refs)
    ctx.cache["axis_coverage"] = result or False
    return result or False


@register_rule(
    "axis-hook-coverage",
    description="an Axis.coeff_hook term group is not referenced by every "
                "evaluator in core/batch.py — parity will break at runtime")
def axis_hook_coverage(ctx: ModuleContext) -> Iterable[Finding]:
    cov = _coverage(ctx)
    if not cov:
        return []
    contracts, defined, refs = cov
    out: List[Finding] = []
    for ev_name, fn in sorted(defined.items()):
        groups, _cols = refs[ev_name]
        for axis, contract in sorted(contracts.items()):
            for g in contract["groups"]:
                if (axis, g) not in groups:
                    out.append(Finding(
                        rule="axis-hook-coverage", path=ctx.path,
                        line=fn.lineno,
                        message=f"evaluator `{ev_name}` never applies "
                                f"coeff_hook group '{g}' of axis "
                                f"'{axis}'; all "
                                f"{len(defined)} evaluators must apply "
                                "every hook or fused/staged/monolithic "
                                "parity breaks"))
    return out


@register_rule(
    "axis-col-coverage",
    description="an Axis.coeff_cols column is not referenced by every "
                "evaluator in core/batch.py")
def axis_col_coverage(ctx: ModuleContext) -> Iterable[Finding]:
    cov = _coverage(ctx)
    if not cov:
        return []
    contracts, defined, refs = cov
    out: List[Finding] = []
    for ev_name, fn in sorted(defined.items()):
        _groups, cols = refs[ev_name]
        for axis, contract in sorted(contracts.items()):
            for col in contract["cols"]:
                if col not in cols:
                    out.append(Finding(
                        rule="axis-col-coverage", path=ctx.path,
                        line=fn.lineno,
                        message=f"evaluator `{ev_name}` never reads "
                                f"coeff column '{col}' of axis '{axis}'"))
    return out


# ---------------------------------------------------------------------------
# dimensional lattice over plan.py term constructors
# ---------------------------------------------------------------------------

# exponent vectors over the base units (V, A, s, bit)
NONE = (0, 0, 0, 0)
V = (1, 0, 0, 0)
A = (0, 1, 0, 0)
S = (0, 0, 1, 0)
BIT = (0, 0, 0, 1)
J = (1, 1, 1, 0)       # V * A * s
W = (1, 1, 0, 0)       # V * A
F = (-1, 1, 1, 0)      # A * s / V
HZ = (0, 0, -1, 0)
UNKNOWN = None

_DIM_NAMES = {J: "J", W: "W", F: "F", HZ: "Hz", V: "V", A: "A", S: "s",
              BIT: "bit", NONE: "dimensionless"}

# identifier -> dimension (exact match on the trailing name segment)
_IDENT_DIMS = {
    "num_nodes": NONE, "accesses_per_output": NONE, "apo": NONE,
    "inv_div": NONE, "gain": NONE, "t_static_fraction": NONE,
    "resolution_bits": NONE, "pi": NONE,
    "v_swing": V, "vdda": V, "vdd": V,
    "bias_current_override": A, "bias_current": A,
    "energy_per_conversion": J,
    "gm_id": (-1, 0, 0, 0),  # transconductance efficiency: 1/V
    "load_capacitance": F, "node_capacitance": F,
}

_SUFFIX_DIMS = (
    ("capacitance", F), ("_cap_f", F), ("_farad", F),
    ("_current", A), ("_amp", A),
    ("_hz", HZ), ("frequency", HZ),
    ("_power", W), ("power_w", W),
    ("energy", J), ("_joule", J), ("_j", J),
    ("voltage", V), ("_volt", V), ("_v", V),
    ("_seconds", S), ("_sec", S),
    ("_bits", NONE),
)


def _ident_dim(name: str):
    if name in _IDENT_DIMS:
        return _IDENT_DIMS[name]
    low = name.lower()
    for suffix, dim in _SUFFIX_DIMS:
        if low.endswith(suffix):
            return dim
    return UNKNOWN


def _dim_name(dim) -> str:
    if dim in _DIM_NAMES:
        return _DIM_NAMES[dim]
    units = ("V", "A", "s", "bit")
    parts = [f"{u}^{e}" for u, e in zip(units, dim) if e]
    return "*".join(parts) if parts else "dimensionless"


def _combine(a, b, sign: int):
    if a is UNKNOWN or b is UNKNOWN:
        return UNKNOWN
    return tuple(x + sign * y for x, y in zip(a, b))


class _DimChecker:
    def __init__(self, ctx: ModuleContext):
        self.ctx = ctx
        self.env: Dict[str, tuple] = {}
        self.findings: List[Finding] = []

    def dim(self, node):
        if isinstance(node, ast.Constant):
            return NONE if isinstance(node.value, (int, float)) else UNKNOWN
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            return _ident_dim(node.id)
        if isinstance(node, ast.Attribute):
            return _ident_dim(node.attr)
        if isinstance(node, ast.UnaryOp):
            return self.dim(node.operand)
        if isinstance(node, ast.Call):
            fname = None
            if isinstance(node.func, ast.Name):
                fname = node.func.id
            elif isinstance(node.func, ast.Attribute):
                fname = node.func.attr
            if fname == "float" and node.args:
                return self.dim(node.args[0])
            if fname == "len":
                return NONE
            if fname is not None:
                d = _ident_dim(fname)
                if d is not UNKNOWN:
                    return d
            return UNKNOWN
        if isinstance(node, ast.BinOp):
            left, right = self.dim(node.left), self.dim(node.right)
            if isinstance(node.op, ast.Mult):
                return _combine(left, right, +1)
            if isinstance(node.op, (ast.Div, ast.FloorDiv)):
                return _combine(left, right, -1)
            if isinstance(node.op, ast.Pow):
                if left is UNKNOWN:
                    return UNKNOWN
                if left == NONE:
                    return NONE
                if isinstance(node.right, ast.Constant) \
                        and isinstance(node.right.value, (int, float)):
                    k = node.right.value
                    if float(k).is_integer():
                        return tuple(int(x * k) for x in left)
                return UNKNOWN
            if isinstance(node.op, (ast.Add, ast.Sub)):
                if left is not UNKNOWN and right is not UNKNOWN \
                        and left != right:
                    self.findings.append(Finding(
                        rule="unit-dim", path=self.ctx.path,
                        line=node.lineno,
                        message=f"adding {_dim_name(left)} to "
                                f"{_dim_name(right)} in an energy term"))
                return left if left is not UNKNOWN else right
        return UNKNOWN


# sink name -> (expected dim of the energy element, which tuple slot)
_SINK_CONTRACTS = {
    "sink_const": (J, "a constant energy term"),
    "sink_lin": (W, "a delay-linear power term"),
    "sink_fom": (NONE, "a dimensionless FoM count"),
}


@register_rule(
    "unit-dim",
    description="an energy-term expression appended by _lower_component "
                "has inconsistent physical dimensions (V/A/s/bit lattice)")
def unit_dim(ctx: ModuleContext) -> Iterable[Finding]:
    target = None
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.FunctionDef) \
                and node.name == "_lower_component":
            target = node
            break
    if target is None:
        return []
    chk = _DimChecker(ctx)
    # local simple assignments (apo = float(cell.accesses_per_output), ...)
    for n in ast.walk(target):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name):
            d = chk.dim(n.value)
            if d is not UNKNOWN:
                chk.env[n.targets[0].id] = d
    for n in ast.walk(target):
        if not (isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "append"
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id in _SINK_CONTRACTS
                and n.args):
            continue
        expected, label = _SINK_CONTRACTS[n.func.value.id]
        arg = n.args[0]
        if isinstance(arg, (ast.Tuple, ast.List)) and arg.elts:
            arg = arg.elts[0]  # (term, inv_div[, bits]): term leads
        got = chk.dim(arg)
        if got is not UNKNOWN and got != expected:
            chk.findings.append(Finding(
                rule="unit-dim", path=ctx.path, line=arg.lineno,
                message=f"expression appended to "
                        f"`{n.func.value.id}` has dimension "
                        f"{_dim_name(got)} but should be "
                        f"{_dim_name(expected)} ({label})"))
    return chk.findings
