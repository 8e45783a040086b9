"""The port's examples (``repro_torch.examples``) on the CPU.

Each runs in a subprocess with ``--device cpu``, all five processes
started together:

* ``quickstart`` and ``explore_design_space`` print the result lines of
  the reference's scripts (``examples/quickstart.py``,
  ``examples/explore_design_space.py``, run with ``JAX_PLATFORMS=cpu``):
  every table row (the Sec. 6 tables, the top-5, the registry and
  mega-sweep bests), the flat index and the feasible counts, and the
  campaign and serve verdicts.  Numbers match to the printed digits,
  within one unit of the last; no time is compared;
* ``train_lm`` at its defaults prints ``LEARNED``.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

#: a number as the scripts print it: 27,648 / 0.423 / 3.034e-05
_NUM = re.compile(r"-?\d[\d,]*(?:\.\d+)?(?:e[+-]?\d+)?")

#: lines that report times, the machine or a lane's name, not results
_SKIP = ("backend ", "compile ", "per-worker ", "new step ")

#: masks for the time and path fields inside result lines
_MASKS = ((re.compile(r" in [\d.]+s warm \(\+[\d.]+s compile, "), " ("),
          (re.compile(r" wait=\d+ms"), ""),
          (re.compile(r"checkpointed in \S+\)"), "checkpointed)"),
          (re.compile(r"\(\d+ variants, \d+ step \w+\)"), ""),
          (re.compile(r"checkpoints in \S+"), ""))


def _start(args, env_extra, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(SRC), **env_extra)
    return subprocess.Popen(args, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The five processes, started together; {name: stdout}."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    port = [sys.executable, "-m"]
    one_thread = {"OMP_NUM_THREADS": "1"}
    procs = {
        "ref_quickstart": _start([sys.executable, "quickstart.py"],
                                 {"JAX_PLATFORMS": "cpu"}, ROOT / "examples"),
        "ref_explore": _start([sys.executable, "explore_design_space.py"],
                              {"JAX_PLATFORMS": "cpu"}, ROOT / "examples"),
        "quickstart": _start(port + ["repro_torch.examples.quickstart",
                                     "--device", "cpu"], one_thread),
        "explore": _start(port + ["repro_torch.examples."
                                  "explore_design_space", "--device", "cpu"],
                          one_thread),
        "train_lm": _start(port + ["repro_torch.examples.train_lm",
                                   "--device", "cpu", "--ckpt-dir",
                                   str(ckpt)], one_thread),
    }
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, stdout, stderr)
        out[name] = stdout
    return out


def _result_lines(text):
    lines = []
    for line in text.splitlines():
        if not line.strip() or line.startswith(_SKIP):
            continue
        for pat, rep in _MASKS:
            line = pat.sub(rep, line)
        lines.append(line.rstrip())
    # the two tenants finish in either order
    tenants = sorted(ln for ln in lines if ln.startswith("tenant "))
    it = iter(tenants)
    return [next(it) if ln.startswith("tenant ") else ln for ln in lines]


def _unit(token):
    """One unit of a printed number's last digit."""
    mant, _, exp = token.replace(",", "").partition("e")
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** (-decimals) * 10.0 ** int(exp or 0)


def _same_line(got, want):
    if _NUM.sub("#", got) != _NUM.sub("#", want):
        return False
    for g, w in zip(_NUM.findall(got), _NUM.findall(want)):
        if _unit(g) != _unit(w):
            return False
        gv, wv = float(g.replace(",", "")), float(w.replace(",", ""))
        if abs(gv - wv) > 1.0000001 * _unit(w):
            return False
    return True


def _assert_same_results(got_text, want_text):
    got, want = _result_lines(got_text), _result_lines(want_text)
    assert len(got) == len(want), (got, want)
    bad = [(g, w) for g, w in zip(got, want) if not _same_line(g, w)]
    assert not bad, bad


def test_quickstart_prints_the_references_results(runs):
    _assert_same_results(runs["quickstart"], runs["ref_quickstart"])
    assert "functional sim: input (32, 32) -> edge map (14, 14)" \
        in runs["quickstart"]


def test_explore_design_space_prints_the_references_results(runs):
    _assert_same_results(runs["explore"], runs["ref_explore"])
    out = runs["explore"]
    for verdict in ("kill-and-resume top-4 identical to uninterrupted "
                    "run: True",
                    "workers=2 top-4 identical to the serial sweep: True",
                    "replayed request: cache_hit=True dispatches=0"):
        assert verdict in out
    assert out.count("group=2 ") == 2
    assert "27,648 points x 8 variants" in out


def test_result_line_comparison_catches_a_changed_digit(runs):
    """The comparison is not vacuous: a table row off by two units of its
    last digit, or a flipped verdict, fails it."""
    text = runs["explore"]
    row = next(ln for ln in text.splitlines() if ln.startswith("  130n "))
    nums = _NUM.findall(row)
    bumped = row.replace(nums[-1], f"{float(nums[-1]) + 0.002:.3f}")
    with pytest.raises(AssertionError):
        _assert_same_results(text.replace(row, bumped), runs["ref_explore"])
    with pytest.raises(AssertionError):
        _assert_same_results(
            text.replace("serial sweep: True", "serial sweep: False"),
            runs["ref_explore"])


def test_train_lm_learns_at_its_defaults(runs):
    out = runs["train_lm"]
    assert "(LEARNED)" in out.strip().splitlines()[-1], out
    assert "step   200  loss" in out
