# Port of src/repro/analysis/__init__.py, re-aimed at eager torch.
"""``repro_torch.analysis`` — static invariant checker for the port's
sweep hot path.

The port's hard invariants (ROADMAP: one host sync a sweep, fused ==
staged == monolithic parity, one definition site per axis's physics)
are enforced dynamically by the tests and the card run — *after* an
expensive sweep runs.  This package checks the classes of silent
corruption those miss, straight off the AST, in milliseconds:

* **hot-path purity** (``repro_torch.analysis.hotpath``) — host syncs
  and Python control flow on tensors (each a sync on CUDA) in every
  function reachable from a declared hot root (the sweep's chunk work,
  the evaluators' closures, the service's dispatch, the kernels' launch
  routes), a checkpointed function or an autograd ``Function``, and
  layout transforms of loop-invariant tensors re-done in a dispatch
  loop;
* **dispatch pacing** (``repro_torch.analysis.dispatchloop``) — an
  unconditional host wait inside a loop launching a prepared step;
* **in-place reuse** (``repro_torch.analysis.recompile``) — a handle on
  a tensor taken before a call writes it in place and read after;
* **axis/unit consistency** (``repro_torch.analysis.units``) — every
  ``Axis.coeff_hook`` term group and ``coeff_cols`` column referenced by
  all three parity-locked evaluators in ``repro_torch.core.batch``, and
  dimensionally consistent energy terms in ``repro_torch.core.plan``.

Findings can be suppressed per line with ``# repro: noqa[rule-name]``
(or a bare ``# repro: noqa``) and pre-existing findings live in a
checked-in baseline (``baseline.json``, empty).  The CLI — ``python -m
repro_torch.analysis [paths]`` — exits non-zero on any finding not in
the baseline; ``--list-rules`` also prints :data:`RULE_MAP`.
"""
from .framework import (DEFAULT_PATHS, Finding, Rule, all_rules,
                        analyze_paths, default_baseline_path,
                        load_baseline, partition_findings, register_rule,
                        rule_names, save_baseline)

#: each of the reference's 12 rules: ``(port rule, None)``, or ``(None,
#: reason)`` where it has no torch target
RULE_MAP = {
    "hot-host-sync": ("hot-host-sync", None),
    "hot-tracer-branch": ("hot-tracer-branch", None),
    "hot-invariant-transform": ("hot-invariant-transform", None),
    "dispatch-loop-sync": ("dispatch-loop-sync", None),
    "jit-donated-reuse": ("inplace-reuse", None),
    "axis-hook-coverage": ("axis-hook-coverage", None),
    "axis-col-coverage": ("axis-col-coverage", None),
    "unit-dim": ("unit-dim", None),
    "hot-kernel-array": (
        None, "the port's kernels are CUDA C++ under csrc/, with no Pallas "
              "kernel body in Python to build an array in"),
    "hot-nonstatic-pallas-shape": (
        None, "there is no pallas_call: each wrapper sizes its grid from "
              "shapes and host ints, and a tensor there is a host sync, "
              "which hot-host-sync flags"),
    "jit-unhashable-static": (
        None, "eager torch has no trace-time static argument; the step "
              "cache (core/shard_sweep.py::_step) raises TypeError at once "
              "on an unhashable key"),
    "jit-mutable-global": (
        None, "eager code reads module globals live at each call, so a "
              "mutation takes effect; nothing is captured at trace time"),
}

__all__ = [
    "DEFAULT_PATHS", "Finding", "RULE_MAP", "Rule", "all_rules",
    "analyze_paths", "default_baseline_path", "load_baseline",
    "partition_findings", "register_rule", "rule_names", "save_baseline",
]
