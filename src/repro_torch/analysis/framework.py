# Port of src/repro/analysis/framework.py: the same registry, noqa,
# fingerprints and baseline; the default scope is the port's packages.
"""Rule registry, noqa suppression, baseline, and the analysis runner.

A *rule* is a callable ``(ModuleContext) -> Iterable[Finding]`` registered
via :func:`register_rule`.  The runner parses each target file once,
builds a :class:`ModuleContext` (source, AST, noqa map, shared cache),
applies every rule, drops suppressed findings, and fingerprint-matches
the survivors against the checked-in baseline so only *new* findings
fail the build.

Fingerprints are content-addressed, not line-addressed: sha1 over the
path normalized past the last ``src/`` segment, the rule name, the
stripped source snippet of the flagged line, and an occurrence index —
so unrelated edits above a baselined finding don't invalidate it, while
moving a file out of ``src/`` or editing the flagged line does.
"""
from __future__ import annotations

import ast
import hashlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# Scope of a bare `python -m repro_torch.analysis` run: the packages that
# hold the sweep hot path (its loops, folds and kernel launches) and the
# axis/unit definition sites, as the reference's scope.  The LM packages
# stay outside it, as they do in the reference.
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_PATHS: Tuple[str, ...] = (
    os.path.join(_PKG_ROOT, "core"),
    os.path.join(_PKG_ROOT, "kernels"),
    os.path.join(_PKG_ROOT, "explore"),
    os.path.join(_PKG_ROOT, "serve"),
)

_NOQA_RE = re.compile(
    r"#\s*repro:\s*noqa(?:\[([A-Za-z0-9_\-, ]+)\])?")


@dataclass(frozen=True)
class Rule:
    name: str
    severity: str  # "error" | "warning"
    description: str
    check: Callable[["ModuleContext"], Iterable["Finding"]]


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    message: str
    severity: str = "error"
    snippet: str = ""
    fingerprint: str = ""

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] "
                f"{self.severity}: {self.message}")


@dataclass
class ModuleContext:
    """One parsed file plus everything rules share (AST, noqa, cache)."""

    path: str
    source: str
    tree: ast.Module
    lines: List[str]
    noqa: Dict[int, Optional[frozenset]]  # line -> rules (None = all)
    cache: dict = field(default_factory=dict)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def suppressed(self, rule: str, lineno: int) -> bool:
        rules = self.noqa.get(lineno, False)
        if rules is False:
            return False
        return rules is None or rule in rules


_RULES: Dict[str, Rule] = {}


def register_rule(name: str, *, severity: str = "error",
                  description: str = ""):
    """Decorator: register ``fn(ctx) -> Iterable[Finding]`` as a rule."""

    def deco(fn):
        if name in _RULES:
            raise ValueError(f"duplicate rule name {name!r}")
        _RULES[name] = Rule(name=name, severity=severity,
                            description=description, check=fn)
        return fn

    return deco


def _load_rule_modules() -> None:
    # Late import: rule modules import this one for register_rule.
    from . import dispatchloop, hotpath, recompile, units  # noqa: F401


def all_rules() -> Dict[str, Rule]:
    _load_rule_modules()
    return dict(_RULES)


def rule_names() -> List[str]:
    return sorted(all_rules())


def _parse_noqa(source: str) -> Dict[int, Optional[frozenset]]:
    out: Dict[int, Optional[frozenset]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        if "repro" not in line or "noqa" not in line:
            continue
        m = _NOQA_RE.search(line)
        if not m:
            continue
        if m.group(1) is None:
            out[i] = None  # bare form: suppress every rule on this line
        else:
            names = frozenset(
                s.strip() for s in m.group(1).split(",") if s.strip())
            prev = out.get(i, False)
            if prev is None:
                continue
            out[i] = names if prev is False else prev | names
    return out


def build_context(path: str, source: Optional[str] = None) -> ModuleContext:
    if source is None:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
    tree = ast.parse(source, filename=path)
    return ModuleContext(path=path, source=source, tree=tree,
                         lines=source.splitlines(),
                         noqa=_parse_noqa(source))


def norm_path(path: str) -> str:
    """Stable cross-checkout path key: everything after the last ``src/``."""
    p = path.replace(os.sep, "/")
    marker = "/src/"
    idx = p.rfind(marker)
    if idx >= 0:
        return p[idx + len(marker):]
    if p.startswith("src/"):
        return p[len("src/"):]
    return p.rsplit("/", 1)[-1]


def fingerprint_findings(findings: List[Finding]) -> None:
    """Assign content-addressed fingerprints in place.

    Identical (path, rule, snippet) triples are disambiguated with an
    occurrence index in source order, so two `.item()` calls on textually
    identical lines get distinct, stable fingerprints.
    """
    seen: Dict[Tuple[str, str, str], int] = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        key = (norm_path(f.path), f.rule, f.snippet.strip())
        n = seen.get(key, 0)
        seen[key] = n + 1
        h = hashlib.sha1(
            "\x1f".join([key[0], key[1], key[2], str(n)]).encode("utf-8"))
        f.fingerprint = h.hexdigest()[:16]


def _iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for name in sorted(files):
                    if name.endswith(".py"):
                        out.append(os.path.join(root, name))
        elif p.endswith(".py"):
            out.append(p)
    return sorted(dict.fromkeys(out))


def analyze_paths(paths: Optional[Sequence[str]] = None,
                  rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the (selected) rules over ``paths`` and return live findings.

    noqa-suppressed findings are dropped here; baseline filtering is the
    caller's job (see :func:`partition_findings`).
    """
    registry = all_rules()
    if rules is not None:
        unknown = sorted(set(rules) - set(registry))
        if unknown:
            raise ValueError(
                f"unknown rule(s) {unknown}; valid: {sorted(registry)}")
        registry = {k: v for k, v in registry.items() if k in rules}

    findings: List[Finding] = []
    for path in _iter_py_files(paths if paths is not None else DEFAULT_PATHS):
        try:
            ctx = build_context(path)
        except (SyntaxError, UnicodeDecodeError) as e:
            findings.append(Finding(
                rule="parse-error", path=path,
                line=getattr(e, "lineno", 1) or 1,
                message=f"could not parse file: {e}", severity="error"))
            continue
        for rule in registry.values():
            for f in rule.check(ctx):
                f.severity = rule.severity
                if not f.snippet:
                    f.snippet = ctx.line_text(f.line)
                if not ctx.suppressed(rule.name, f.line):
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    fingerprint_findings(findings)
    return findings


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def load_baseline(path: Optional[str] = None) -> Dict[str, dict]:
    path = path or default_baseline_path()
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict) or "entries" not in data:
        raise ValueError(
            f"baseline {path}: expected an object with an 'entries' list")
    return {e["fingerprint"]: e for e in data["entries"]}


def save_baseline(findings: Sequence[Finding],
                  path: Optional[str] = None) -> str:
    path = path or default_baseline_path()
    entries = [{
        "fingerprint": f.fingerprint,
        "rule": f.rule,
        "path": norm_path(f.path),
        "snippet": f.snippet.strip(),
        "message": f.message,
    } for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule))]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "entries": entries}, f, indent=2,
                  sort_keys=False)
        f.write("\n")
    return path


def partition_findings(findings: Sequence[Finding],
                       baseline: Dict[str, dict]):
    """Split findings into (new, baselined) against a loaded baseline."""
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        (old if f.fingerprint in baseline else new).append(f)
    return new, old
