"""`repro_torch.analysis`, the static checker re-aimed at the port.

Each test of ``tests/test_analysis.py`` has a counterpart here (by name
where the rule carries over; the reference's rules with no torch target
assert their reason in ``RULE_MAP``):

* the port is clean — ``python -m repro_torch.analysis`` over its default
  scope (core/, kernels/, explore/, serve/) reports nothing, with an
  empty baseline; the coverage rules no longer misread the banked
  evaluator, which runs ``build_coeff_compute``'s physics;
* mutation detection on copies of the port's own files — a dropped
  ``vdd_scale`` hook or a severed ``fom_bits`` read in
  ``build_coeff_compute`` (flagged for it and for the banked evaluator
  that inherits it), a ``.item()`` in ``_staged_chunk`` and in
  ``_fold_chunk``, an unconditional ``torch.cuda.synchronize()`` in the
  fused loop or an unguarded ``_Pacer`` wait, a loop-invariant re-layout
  in the dispatch loop, a state handle read after ``_merge_candidates``,
  a dimensionally wrong energy term in ``core/plan.py``: each gives
  exactly the expected rule, and the unmutated file none;
* the framework contract — noqa, fingerprints, the baseline, the CLI;
* ``unit-dim`` gives the reference's findings on the verbatim
  ``core/plan.py``, mutated or not;
* the repair the default scope led to: the mixed-variant banked
  evaluator reads nothing back to the host.
"""
import json
import shutil
import textwrap

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.analysis import (DEFAULT_PATHS, RULE_MAP, analyze_paths,
                                  default_baseline_path, load_baseline,
                                  partition_findings, rule_names,
                                  save_baseline)
from repro_torch.analysis.__main__ import main as cli_main

SRC = __file__.rsplit("/tests/", 1)[0] + "/src/repro_torch"
REF = __file__.rsplit("/tests/", 1)[0] + "/src/repro"

PORT_RULES = {"hot-host-sync", "hot-tracer-branch", "hot-invariant-transform",
              "inplace-reuse", "axis-hook-coverage", "axis-col-coverage",
              "unit-dim", "dispatch-loop-sync"}


def _write(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


def _mutate(tmp_path, rel, needle, replacement, name=None):
    """A copy of the port's ``rel`` under ``tmp_path`` with ``needle``
    (which must occur once) replaced; returns (path, original source)."""
    src = open(f"{SRC}/{rel}").read()
    assert src.count(needle) == 1, needle
    path = tmp_path / (name or rel.rsplit("/", 1)[-1])
    path.write_text(src.replace(needle, replacement))
    return str(path), src


# a hot root in a snippet: the forward of a torch.autograd.Function
ROOT = """\
    import torch

    class Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            {body}
    """


def _root_case(tmp_path, body, name="mod.py"):
    return _write(tmp_path, name, ROOT.format(body=body))


# ---------------------------------------------------------------------------
# the port is clean
# ---------------------------------------------------------------------------
def test_repo_default_scope_is_clean():
    findings = analyze_paths()
    baseline = load_baseline()
    new, _old = partition_findings(findings, baseline)
    assert new == [], "\n".join(f.render() for f in new)
    assert findings == []
    with open(default_baseline_path()) as f:
        assert json.load(f)["entries"] == []


def test_default_paths_cover_the_hot_packages():
    tails = {p.rsplit("/", 1)[-1] for p in DEFAULT_PATHS}
    assert tails == {"core", "kernels", "explore", "serve"}
    assert all("/repro_torch/" in p for p in DEFAULT_PATHS)


def test_all_rule_families_registered():
    assert set(rule_names()) == PORT_RULES
    assert len(RULE_MAP) == 12
    for ref_name, (port, reason) in RULE_MAP.items():
        assert (port in PORT_RULES) != bool(reason), ref_name


def test_banked_evaluator_inherits_coeff_compute_coverage():
    """The reference's coverage rules read the port's banked evaluator
    as missing every hook (4 findings at ``build_banked_eval``); it runs
    ``build_coeff_compute``, which applies them."""
    findings = analyze_paths([f"{SRC}/core/batch.py"],
                             rules=["axis-hook-coverage",
                                    "axis-col-coverage"])
    assert findings == [], "\n".join(f.render() for f in findings)


# ---------------------------------------------------------------------------
# mutation: build_coeff_compute drops the vdd_scale hook -> coverage, for
# it and for the banked evaluator that inherits it
# ---------------------------------------------------------------------------
def test_mutated_vdd_hook_fails_coverage(tmp_path):
    shutil.copy(f"{SRC}/core/axes.py", tmp_path / "axes.py")
    needle = '_VDD_HOOKS["dynamic"](pt["vdd_scale"])'
    batch, src = _mutate(tmp_path, "core/batch.py", needle,
                         '(pt["vdd_scale"] * 0.0 + 1.0)')
    findings = analyze_paths([batch], rules=["axis-hook-coverage"])
    assert [f.rule for f in findings] == ["axis-hook-coverage"] * 2
    assert sorted(f.message.split("`")[1] for f in findings) == [
        "build_banked_eval", "build_coeff_compute"]
    for f in findings:
        assert "'dynamic'" in f.message and "vdd_scale" in f.message

    # the untouched copy passes the same rule
    (tmp_path / "batch.py").write_text(src)
    assert analyze_paths([batch], rules=["axis-hook-coverage"]) == []


def test_mutated_adc_col_fails_coverage(tmp_path):
    shutil.copy(f"{SRC}/core/axes.py", tmp_path / "axes.py")
    batch, _src = _mutate(tmp_path, "core/batch.py",
                          "g(_ADC_REF_COL)[:, None]",
                          '(pt["adc_bits"][None, :] * 0.0 + 10.0)')
    findings = analyze_paths([batch], rules=["axis-col-coverage"])
    assert [f.rule for f in findings] == ["axis-col-coverage"] * 2
    assert all("fom_bits" in f.message for f in findings)
    assert sorted(f.message.split("`")[1] for f in findings) == [
        "build_banked_eval", "build_coeff_compute"]


# ---------------------------------------------------------------------------
# mutation: .item() in a staged chunk and in the fused fold -> hot-host-sync
# ---------------------------------------------------------------------------
def test_mutated_scan_body_item_is_flagged(tmp_path):
    """``_staged_chunk`` (the staged engine's chunk body)."""
    sweep, _src = _mutate(
        tmp_path, "core/shard_sweep.py",
        "    pos = pos[:kk]\n    return dict(\n        cand_v=cand_v[:kk],",
        "    pos = pos[:pos[0].item() * 0 + kk]\n    return dict(\n"
        "        cand_v=cand_v[:kk],")
    findings = analyze_paths([sweep], rules=["hot-host-sync"])
    assert [f.rule for f in findings] == ["hot-host-sync"]
    assert ".item()" in findings[0].message
    assert "pos[0].item()" in findings[0].snippet

    # the shipped file is clean under the same rule
    assert analyze_paths([f"{SRC}/core/shard_sweep.py"],
                         rules=["hot-host-sync"]) == []


def test_mutated_xla_lane_item_is_flagged(tmp_path):
    """``_fold_chunk`` (the fused lane's fold of K1's block candidates)."""
    sweep, _src = _mutate(
        tmp_path, "core/shard_sweep.py",
        "    mins, g = torch.min(cv[:, 0], dim=0)\n",
        "    mins, g = torch.min(cv[:, 0], dim=0)\n"
        "    s0 = s0 + g.item() * 0\n")
    findings = analyze_paths([sweep], rules=["hot-host-sync"])
    assert [f.rule for f in findings] == ["hot-host-sync"]
    assert ".item()" in findings[0].message
    assert "g.item()" in findings[0].snippet


@pytest.mark.parametrize("body,what", [
    ("return x.tolist()", ".tolist()"),
    ("return x.cpu()", ".cpu()"),
    ("return x.numpy()", ".numpy()"),
    ('return x.to("cpu")', '.to("cpu")'),
    ("return int(x)", "int()"),
    ("return bool(x)", "bool()"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize"),
    ("torch.cuda.current_stream().synchronize()", ".synchronize()"),
    ("return torch.nonzero(x)", "torch.nonzero"),
    ("return torch.unique(x)", "torch.unique"),
    ("return x.masked_select(x > 0)", ".masked_select()"),
    ("return x[x > 0]", "boolean-mask indexing"),
])
def test_each_torch_host_sync_is_flagged(tmp_path, body, what):
    mod = _root_case(tmp_path, body)
    findings = analyze_paths([mod], rules=["hot-host-sync"])
    assert [f.rule for f in findings] == ["hot-host-sync"], findings
    assert what in findings[0].message


def test_checkpointed_function_is_a_root(tmp_path):
    mod = _write(tmp_path, "mod.py", """\
        import torch
        from torch.utils.checkpoint import checkpoint

        def layer(x, w):
            return x * w.item()

        def run(x, w):
            return checkpoint(layer, x, w, use_reentrant=False)
        """)
    findings = analyze_paths([mod], rules=["hot-host-sync"])
    assert [(f.rule, f.line) for f in findings] == [("hot-host-sync", 5)]


# ---------------------------------------------------------------------------
# mutation: a loop-invariant re-layout in the fused dispatch loop
# ---------------------------------------------------------------------------
def test_relayout_inside_scan_driver_is_flagged(tmp_path):
    needle = ("                    cv, cl, sums, counts = launch(t2, "
              "bk.fused[vi], s0, lo,\n")
    sweep, _src = _mutate(
        tmp_path, "core/shard_sweep.py", needle,
        "                    t2 = table2.transpose(0, 1).contiguous()\n"
        + needle)
    findings = analyze_paths([sweep], rules=["hot-invariant-transform"])
    assert [f.rule for f in findings] == ["hot-invariant-transform"]
    assert "table2" in findings[0].message
    assert "_stream_impl" in findings[0].message
    assert "hoist" in findings[0].message
    assert analyze_paths([f"{SRC}/core/shard_sweep.py"],
                         rules=["hot-invariant-transform"]) == []


# ---------------------------------------------------------------------------
# rules with no torch target: their reason, and what stands in their place
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ref_name,needle", [
    ("hot-kernel-array", "CUDA C++"),
    ("hot-nonstatic-pallas-shape", "no pallas_call"),
    ("jit-unhashable-static", "TypeError"),
    ("jit-mutable-global", "live"),
])
def test_rules_without_a_torch_target_state_why(ref_name, needle):
    port, reason = RULE_MAP[ref_name]
    assert port is None and needle in reason
    assert ref_name not in rule_names()


def test_unhashable_static_argument_is_flagged():
    """``jit-unhashable-static`` has no target: the port's one
    shape-keyed cache, the step cache, refuses an unhashable key at the
    first call instead of rebuilding per call."""
    from repro_torch.core.shard_sweep import _step
    assert RULE_MAP["jit-unhashable-static"][0] is None
    with pytest.raises(TypeError, match="unhashable"):
        _step(("fused", [4, 2]), lambda: None)


def test_unhashable_static_argname_direct_invocation(tmp_path):
    """The reference flags ``jax.jit(f, static_argnames=...)``; torch has
    no such argument, so the port's checker finds nothing in it."""
    mod = _write(tmp_path, "mod.py", """\
        import torch

        def f(x, *, opts):
            return x

        def run(x):
            return f(x, opts={"a": 1})
        """)
    assert analyze_paths([mod]) == []


def test_mutable_global_capture_is_flagged(tmp_path):
    """``jit-mutable-global`` has no target: a hot root reading a mutable
    global reads it live, and the checker finds nothing."""
    assert RULE_MAP["jit-mutable-global"][0] is None
    mod = _root_case(tmp_path, 'return x * SCALES["gain"]')
    (tmp_path / "mod.py").write_text(
        'SCALES = {"gain": 2.0}\n' + open(mod).read())
    assert analyze_paths([mod]) == []


# ---------------------------------------------------------------------------
# mutation: dimensionally wrong energy term -> unit-dim (and the reference
# gives the same findings)
# ---------------------------------------------------------------------------
UNIT_NEEDLE = "sink_const.append(cell.energy_per_conversion * apo)"
UNIT_MUTANT = "sink_const.append(cell.energy_per_conversion * cell.vdda * apo)"


def test_mutated_energy_term_dimension_is_flagged(tmp_path):
    plan, src = _mutate(tmp_path, "core/plan.py", UNIT_NEEDLE, UNIT_MUTANT)
    findings = analyze_paths([plan], rules=["unit-dim"])
    assert [f.rule for f in findings] == ["unit-dim"]
    assert "sink_const" in findings[0].message
    assert "J" in findings[0].message

    (tmp_path / "plan.py").write_text(src)
    assert analyze_paths([plan], rules=["unit-dim"]) == []


@pytest.mark.parametrize("mutated", [False, True])
def test_unit_dim_matches_the_reference(tmp_path, mutated):
    from repro.analysis import analyze_paths as ref_analyze
    port_src = open(f"{SRC}/core/plan.py").read()
    ref_src = open(f"{REF}/core/plan.py").read()
    assert port_src.split("\n", 1)[1] == ref_src     # a verbatim copy
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    for sub, text in (("port", port_src), ("ref", ref_src)):
        if mutated:
            text = text.replace(UNIT_NEEDLE, UNIT_MUTANT)
        (tmp_path / sub / "plan.py").write_text(text)
    port = analyze_paths([str(tmp_path / "port" / "plan.py")],
                         rules=["unit-dim"])
    ref = ref_analyze([str(tmp_path / "ref" / "plan.py")], rules=["unit-dim"])
    # the port's copy has one line more (the line naming what it copies)
    assert [(f.rule, f.line - 1, f.message, f.snippet) for f in port] == \
        [(f.rule, f.line, f.message, f.snippet) for f in ref]
    assert len(port) == (1 if mutated else 0)


# ---------------------------------------------------------------------------
# remaining hot-path rules on focused snippets
# ---------------------------------------------------------------------------
def test_tracer_branch_in_jitted_function(tmp_path):
    mod = _root_case(tmp_path, "if x > 0:\n                return x\n"
                               "            return -x")
    findings = analyze_paths([mod], rules=["hot-tracer-branch"])
    assert [f.rule for f in findings] == ["hot-tracer-branch"]


@pytest.mark.parametrize("body", [
    "return min(x, 1.0)", "return max(x.sum(), 0.0)",
    "return list(range(x))", "assert x.sum() > 0",
    "return x if x.any() else -x"])
def test_each_tensor_branch_is_flagged(tmp_path, body):
    mod = _root_case(tmp_path, body)
    findings = analyze_paths([mod], rules=["hot-tracer-branch"])
    assert [f.rule for f in findings] == ["hot-tracer-branch"], findings


def test_static_shape_reads_are_not_tainted(tmp_path):
    mod = _write(tmp_path, "mod.py", """\
        import torch

        class Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, n: int, dtype=torch.float32):
                if x.ndim > 1 and x.dim() > 1:
                    x = x.reshape(-1)
                for _ in range(x.shape[0] // 4 + n):
                    x = x * 2.0
                if x.is_cuda and x.device.type == "cuda" and x is not None:
                    x = x + 1.0
                parts = {"a": x, "b": x}
                assert set(parts) == {"a", "b"} and "a" in parts
                aligned = x.data_ptr() % 16 == 0 and x.is_contiguous()
                if aligned and dtype == torch.float32:
                    x = x.to(dtype)
                return float(x.numel()) * torch.sum(x) + int(n)
        """)
    assert analyze_paths([mod], rules=["hot-tracer-branch",
                                       "hot-host-sync"]) == []


def test_kernel_array_construction_is_flagged():
    """``hot-kernel-array`` has no target: no kernel body is Python."""
    port, reason = RULE_MAP["hot-kernel-array"]
    assert port is None and "csrc/" in reason


def test_nonstatic_pallas_grid_is_flagged(tmp_path):
    """``hot-nonstatic-pallas-shape`` has no target; a wrapper that sizes
    its launch from a tensor's value is a host sync, which hot-host-sync
    flags in its place."""
    assert RULE_MAP["hot-nonstatic-pallas-shape"][0] is None
    mod = _root_case(tmp_path, "n = int(x.max())\n"
                               "            return torch.empty((n,))")
    assert [f.rule for f in analyze_paths([mod])] == ["hot-host-sync"]


# ---------------------------------------------------------------------------
# in-place reuse: handles read after a write in place
# ---------------------------------------------------------------------------
def test_donated_buffer_reuse_is_flagged(tmp_path):
    mod = _write(tmp_path, "mod.py", """\
        def drive(state, c):
            snap = state["metric_sum"]
            _merge_candidates(c, 0, state, 3)
            return snap
        """)
    findings = analyze_paths([mod], rules=["inplace-reuse"])
    assert [(f.rule, f.line) for f in findings] == [("inplace-reuse", 4)]
    assert "snap" in findings[0].message and "state" in findings[0].message

    # a clone taken before the write is the sanctioned shape
    clean = _write(tmp_path, "clean.py", """\
        def drive(state, c):
            snap = state["metric_sum"].clone()
            _merge_candidates(c, 0, state, 3)
            return snap
        """)
    assert analyze_paths([clean], rules=["inplace-reuse"]) == []


def test_donated_reuse_across_loop_iterations(tmp_path):
    mod = _write(tmp_path, "mod.py", """\
        def drive(state, parts):
            seen = []
            for c in parts:
                seen.append(state["topk_v"])
                _merge_candidates(c, 0, state, 3)
            return seen
        """)
    findings = analyze_paths([mod], rules=["inplace-reuse"])
    assert [f.rule for f in findings] == ["inplace-reuse"]
    assert "seen" in findings[0].message


def test_inplace_method_and_thread_handoff_are_flagged(tmp_path):
    mod = _write(tmp_path, "mod.py", """\
        import threading

        def save(buf, x, writer):
            view = buf
            buf.copy_(x)
            return view

        def snapshot(params, grads, writer):
            threading.Thread(target=writer, args=(params,)).start()
            params.add_(grads)
        """)
    findings = analyze_paths([mod], rules=["inplace-reuse"])
    assert [(f.rule, f.line) for f in findings] == [("inplace-reuse", 6),
                                                     ("inplace-reuse", 10)]
    assert "thread" in findings[1].message


def test_mutated_state_alias_after_merge_is_flagged(tmp_path):
    needle = ("                _merge_candidates(_combine_shards(parts, "
              "device), vi, state,\n                                  k)\n"
              "            dispatches += 1\n")
    sweep, _src = _mutate(
        tmp_path, "core/shard_sweep.py", needle,
        '                prev_sum = state["metric_sum"]\n'
        + needle.replace("            dispatches",
                         '                delta = state["metric_sum"] - '
                         'prev_sum\n            dispatches'))
    findings = analyze_paths([sweep], rules=["inplace-reuse"])
    assert [f.rule for f in findings] == ["inplace-reuse"]
    assert "prev_sum" in findings[0].message
    assert analyze_paths([f"{SRC}/core/shard_sweep.py"],
                         rules=["inplace-reuse"]) == []


# ---------------------------------------------------------------------------
# framework: noqa, baseline fingerprints, CLI
# ---------------------------------------------------------------------------
def test_noqa_suppresses_named_rule(tmp_path):
    mod = _root_case(tmp_path, "return float(x)  # repro: noqa[hot-host-sync]")
    assert analyze_paths([mod], rules=["hot-host-sync"]) == []


def test_noqa_bare_and_wrong_rule(tmp_path):
    bare = _root_case(tmp_path, "return float(x)  # repro: noqa", "bare.py")
    assert analyze_paths([bare], rules=["hot-host-sync"]) == []

    wrong = _root_case(tmp_path, "return float(x)  # repro: noqa[unit-dim]",
                       "wrong.py")
    findings = analyze_paths([wrong], rules=["hot-host-sync"])
    assert [f.rule for f in findings] == ["hot-host-sync"]


def test_unknown_rule_selection_raises():
    with pytest.raises(ValueError, match="no-such-rule"):
        analyze_paths([], rules=["no-such-rule"])


def test_fingerprints_survive_unrelated_edits(tmp_path):
    mod = _root_case(tmp_path, "return float(x)")
    (before,) = analyze_paths([mod], rules=["hot-host-sync"])
    body = open(mod).read()
    (tmp_path / "mod.py").write_text("# a new leading comment\n" + body)
    (after,) = analyze_paths([mod], rules=["hot-host-sync"])
    assert before.line != after.line
    assert before.fingerprint == after.fingerprint


def test_fingerprints_key_past_src(tmp_path):
    from repro_torch.analysis.framework import norm_path
    assert norm_path(f"{SRC}/core/batch.py") == "repro_torch/core/batch.py"


def test_baseline_roundtrip(tmp_path):
    mod = _root_case(tmp_path, "return float(x)")
    findings = analyze_paths([mod], rules=["hot-host-sync"])
    assert len(findings) == 1
    bl_path = str(tmp_path / "baseline.json")
    save_baseline(findings, bl_path)
    baseline = load_baseline(bl_path)
    new, old = partition_findings(findings, baseline)
    assert new == [] and len(old) == 1


def test_cli_exit_codes_and_report(tmp_path, capsys):
    mod = _root_case(tmp_path, "return float(x)")
    bl = str(tmp_path / "bl.json")
    report = str(tmp_path / "report.json")

    # new finding -> non-zero, rendered with rule name
    rc = cli_main([mod, "--baseline", bl, "--fail-on-new",
                   "--report", report])
    assert rc == 1
    out = capsys.readouterr().out
    assert "hot-host-sync" in out and "1 new" in out
    data = json.load(open(report))
    assert data["counts"]["new"] == 1
    assert data["findings"][0]["rule"] == "hot-host-sync"

    # --no-fail reports and exits 0
    assert cli_main([mod, "--baseline", bl, "--no-fail"]) == 0

    # accept into the baseline -> clean run exits 0
    assert cli_main([mod, "--baseline", bl, "--write-baseline"]) == 0
    assert cli_main([mod, "--baseline", bl, "--fail-on-new"]) == 0

    # clean file -> 0 without any baseline
    clean = _write(tmp_path, "clean.py", "x = 1\n")
    assert cli_main([clean, "--baseline",
                     str(tmp_path / "none.json")]) == 0


def test_cli_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for name in PORT_RULES:
        assert name in out
    for ref_name, (port, reason) in RULE_MAP.items():
        want = port if port is not None else f"not applicable: {reason}"
        assert any(line.startswith(ref_name) and line.endswith(want)
                   for line in out.splitlines()), ref_name
    assert "inplace-reuse" in out and "jit-donated-reuse" in out


def test_cli_rules_subset(tmp_path, capsys):
    mod = _root_case(tmp_path, "return float(x)")
    assert cli_main([mod, "--rules", "unit-dim",
                     "--baseline", str(tmp_path / "none.json")]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_parse_error_is_reported(tmp_path):
    bad = _write(tmp_path, "bad.py", "def f(:\n")
    findings = analyze_paths([bad])
    assert [f.rule for f in findings] == ["parse-error"]


# ---------------------------------------------------------------------------
# dispatch-loop-sync: unconditional drains inside a dispatch loop
# ---------------------------------------------------------------------------
DISPATCH_LOOP = """
    import torch

    def sweep(key, build, state, chunks, pipeline_depth):
        step = _step(key, build)
        inflight = []
        for d0 in chunks:
            state, counts = step.launches[0](d0, state)
            ev = torch.cuda.Event()
            ev.record()
            inflight.append(ev)
            {pacing}
        torch.cuda.synchronize()              # post-loop barrier: fine
        return state.cpu()                    # outside the loop: fine
"""


def _dispatch_case(tmp_path, pacing):
    path = _write(tmp_path, "drv.py", DISPATCH_LOOP.format(pacing=pacing))
    return analyze_paths([path], rules=["dispatch-loop-sync"])


def test_unconditional_loop_sync_is_flagged(tmp_path):
    findings = _dispatch_case(tmp_path, "inflight.pop(0).synchronize()")
    assert [f.rule for f in findings] == ["dispatch-loop-sync"]
    assert "EVERY iteration" in findings[0].message
    # a copy to the host in the loop body is the same serialization
    findings = _dispatch_case(tmp_path, "host = counts.cpu()")
    assert [f.rule for f in findings] == ["dispatch-loop-sync"]
    findings = _dispatch_case(tmp_path, "torch.cuda.synchronize()")
    assert [f.rule for f in findings] == ["dispatch-loop-sync"]


def test_depth_guarded_pacing_passes(tmp_path):
    findings = _dispatch_case(
        tmp_path,
        "if len(inflight) > pipeline_depth:\n"
        "                inflight.pop(0).synchronize()")
    assert findings == []


def test_loop_without_executable_dispatch_passes(tmp_path):
    # draining a results list is not a dispatch loop
    path = _write(tmp_path, "drain.py", """
        import torch

        def drain(results):
            for r in results:
                r.synchronize()
    """)
    assert analyze_paths([path], rules=["dispatch-loop-sync"]) == []


def test_shipped_drivers_pass_dispatch_loop_sync():
    findings = analyze_paths([f"{SRC}/core/shard_sweep.py"],
                             rules=["dispatch-loop-sync"])
    assert findings == [], "\n".join(f.render() for f in findings)


def test_mutated_fused_loop_sync_is_flagged(tmp_path):
    needle = ("            dispatches += 1\n            _bump(\"dispatches\")\n"
              "            pace.dispatched()\n            if progress")
    sweep, _src = _mutate(
        tmp_path, "core/shard_sweep.py", needle,
        needle.replace("pace.dispatched()\n",
                       "pace.dispatched()\n"
                       "            torch.cuda.synchronize()\n"))
    findings = analyze_paths([sweep], rules=["dispatch-loop-sync"])
    assert [f.rule for f in findings] == ["dispatch-loop-sync"]
    assert "synchronize" in findings[0].message
    assert "torch.cuda.synchronize()" in findings[0].snippet


def test_unguarded_pacer_wait_is_flagged(tmp_path):
    """The driver's ``_Pacer`` waits only past its depth; the same wait
    made unconditional is reached through ``pace.dispatched()`` on every
    dispatch of both loops."""
    sweep, _src = _mutate(
        tmp_path, "core/shard_sweep.py",
        "        if len(self.inflight) > self.depth:\n"
        "            for ev in self.inflight.pop(0):\n"
        "                ev.synchronize()\n",
        "        for ev in self.inflight.pop(0):\n"
        "            ev.synchronize()\n")
    findings = analyze_paths([sweep], rules=["dispatch-loop-sync"])
    assert [f.rule for f in findings] == ["dispatch-loop-sync"]
    assert "ev.synchronize()" in findings[0].snippet


# ---------------------------------------------------------------------------
# the repair: the mixed-variant banked evaluator reads nothing back
# ---------------------------------------------------------------------------
class _HostReads(TorchFunctionMode):
    """Records the torch calls that read a tensor back to the host (on a
    CUDA tensor each one is a sync)."""

    READS = {"item", "tolist", "cpu", "numpy", "__float__", "__int__",
             "__bool__", "nonzero", "unique", "unique_consecutive",
             "masked_select", "argwhere"}

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.READS:
            self.reads.append(name)
        return func(*args, **(kwargs or {}))


def test_mixed_variant_banked_eval_reads_nothing_back():
    from repro_torch.core import build_plan_bank, make_points
    from repro_torch.core.batch import banked_eval_fn
    from repro_torch.core.grid import lower_variant
    variants = ("2d_in", "3d_in", "2d_off")
    plans = [lower_variant("edgaze", v) for v in variants]
    bank = build_plan_bank(plans, device="cpu")
    n = 48
    rng = np.random.default_rng(3)
    pts = make_points(plans[0], n, device="cpu",
                      cis_node=rng.choice([130.0, 65.0], n),
                      frame_rate=rng.choice([15.0, 60.0], n))
    ids = torch.from_numpy(rng.integers(0, len(variants), n))
    fn = banked_eval_fn(bank.dims)
    with _HostReads() as probe:
        mixed = fn(bank, ids, pts)
    assert probe.reads == []
    # each point equals its own variant's uniform evaluation, bit for bit
    for v in range(len(variants)):
        solo = fn(bank, torch.full((n,), v), pts)
        pick = ids == v
        for key in mixed:
            assert torch.equal(mixed[key][pick], solo[key][pick]), (v, key)
    # a negative id picks a row from the end, as indexing the bank does
    last = fn(bank, torch.full((n,), -1), pts)
    want = fn(bank, torch.full((n,), len(variants) - 1), pts)
    assert all(torch.equal(last[k], want[k]) for k in last)
