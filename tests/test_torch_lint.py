"""Port's static analyser (repro_torch.lint) vs the JAX package's repro.lint.

Twins of tests/test_lint.py: the fixtures under
``tests/data/lint_fixtures/`` (read in place) give the same (rule, line)
sets in both packages and match their ``# EXPECT:`` markers; both
analysers give equal findings on ``src/repro`` and on all of ``src/``;
the port's own source is clean; the port's CLI keeps the original's exit
codes, reports and baseline round trip.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.lint import RULE_IDS as J_RULE_IDS
from repro.lint import baseline as jbl
from repro.lint.rules import analyze as j_analyze
from repro_torch.lint import RULE_IDS, run_analysis
from repro_torch.lint import baseline as bl
from repro_torch.lint.rules import analyze

FIXTURES = Path(__file__).parent / "data" / "lint_fixtures"
REPO = Path(__file__).resolve().parents[1]
_EXPECT_RE = re.compile(r"#\s*EXPECT:\s*([a-z-]+)")
ALL_FIXTURES = sorted(p.name for p in FIXTURES.glob("*.py"))


def _expected(path: Path):
    return {(m.group(1), n) for n, line in enumerate(path.read_text().splitlines(), start=1)
            for m in [_EXPECT_RE.search(line)] if m}


def _full(findings):
    return [(f.rule, f.path, f.line, f.symbol, f.message) for f in findings]


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_fixture_findings_match_jax_and_the_markers(name):
    path = str(FIXTURES / name)
    got, want = analyze(path), j_analyze(path)
    assert _full(got) == _full(want)
    hits = {(f.rule, f.line) for f in got}
    if name.endswith("_bad.py"):
        assert hits and hits == _expected(FIXTURES / name)
    elif name.endswith("_good.py") or name == "suppress_fixture.py":
        assert hits == set()


def test_rule_ids_filter_and_lazy_package():
    assert RULE_IDS == J_RULE_IDS
    only = analyze(str(FIXTURES / "det_bad.py"), rules=["det-wallclock"])
    assert [f.rule for f in only] == ["det-wallclock"]
    assert _full(run_analysis(str(FIXTURES / "det_bad.py"))) == \
        _full(analyze(str(FIXTURES / "det_bad.py")))
    (f,) = analyze(str(FIXTURES / "loop_sleep_bad.py"))
    assert (f.symbol, f.path) == ("PacedServer._tick", "loop_sleep_bad.py")
    assert "time.sleep" in f.message
    # importing the package (as net/server.py does for the runtime half)
    # loads no analysis module
    r = subprocess.run(
        [sys.executable, "-c", "import sys, repro_torch.lint.runtime; "
         "print(sorted(m for m in sys.modules if m.startswith('repro_torch.lint')))"],
        capture_output=True, text=True, timeout=60,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert r.stdout.strip() == "['repro_torch.lint', 'repro_torch.lint.runtime']", r.stderr


def test_suppression_is_rule_scoped(tmp_path):
    text = (FIXTURES / "loop_sleep_bad.py").read_text()
    patched = text.replace("time.sleep(0.01)  # EXPECT: loop-blocking-sleep",
                           "time.sleep(0.01)  # lint: ignore[det-wallclock]")
    assert patched != text
    tmp = tmp_path / "scoped.py"
    tmp.write_text(patched)
    assert {f.rule for f in analyze(str(tmp))} == {"loop-blocking-sleep"}
    assert _full(analyze(str(tmp))) == _full(j_analyze(str(tmp)))


@pytest.mark.parametrize("target", ["src/repro", "src"])
def test_both_analysers_agree_on_the_source_tree(target):
    """On all of ``src/`` the 14 findings are the JAX package's own: the
    port's copies keep the originals' line suppressions, and its new code
    raises none."""
    got = analyze(str(REPO / target))
    assert _full(got) == _full(j_analyze(str(REPO / target)))
    if target == "src":
        assert len(got) == 14 and all(f.path.startswith("repro/") for f in got)


def test_committed_baseline_covers_src_in_both_packages():
    findings = analyze(str(REPO / "src"))
    base = bl.load(str(REPO / "tools" / "lint_baseline.json"))
    assert base == jbl.load(str(REPO / "tools" / "lint_baseline.json"))
    assert bl.apply(findings, base) == ([], [])


def test_baseline_requires_justification_and_counts(tmp_path):
    p = tmp_path / "b.json"
    p.write_text(json.dumps({"version": 1, "entries": [
        {"rule": "lockset-mixed", "path": "x.py", "symbol": "C.m", "count": 1,
         "justification": "  "}]}))
    with pytest.raises(bl.BaselineError):
        bl.load(str(p))
    findings = analyze(str(FIXTURES / "lockset_bad.py"))
    entries = [{"rule": f.rule, "path": f.path, "symbol": f.symbol, "count": 1,
                "justification": "fixture"} for f in findings]
    entries.append({"rule": "det-random", "path": "gone.py", "symbol": "f", "count": 1,
                    "justification": "fixture"})
    p.write_text(json.dumps({"version": bl.VERSION, "entries": entries}))
    loaded = bl.load(str(p))
    new, stale = bl.apply(findings, loaded)
    assert new == [] and [(e["rule"], e["path"]) for e in stale] == [("det-random", "gone.py")]
    new2, _ = bl.apply(list(findings) + [findings[0]], loaded)
    assert [f.key() for f in new2] == [findings[0].key()]
    assert bl.render(findings) == jbl.render(j_analyze(str(FIXTURES / "lockset_bad.py")))


# ------------------------------------------------------------------- CLI
def _run_cli(*args, pkg="repro_torch"):
    return subprocess.run([sys.executable, "-m", f"{pkg}.lint", *args], capture_output=True,
                          text=True, cwd=str(REPO), timeout=120,
                          env={**os.environ, "PYTHONPATH": str(REPO / "src")})


def test_cli_on_the_port_source_exits_zero():
    proc = _run_cli("src/repro_torch", "--baseline", "none")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "repro_torch.lint: 0 finding(s)" in proc.stderr


def test_cli_gate_on_src_is_green():
    proc = _run_cli("src/")
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_cli_exit_codes_and_reports_match_jax(tmp_path):
    assert _run_cli(str(FIXTURES / "loop_sleep_good.py"), "--baseline", "none").returncode == 0
    assert _run_cli(str(tmp_path / "nope_does_not_exist")).returncode == 3
    text = _run_cli(str(FIXTURES / "loop_sleep_bad.py"), "--baseline", "none")
    assert text.returncode == 2
    assert re.search(r"loop_sleep_bad\.py:\d+: loop-blocking-sleep:", text.stdout)
    assert text.stdout == _run_cli(str(FIXTURES / "loop_sleep_bad.py"), "--baseline", "none",
                                   pkg="repro").stdout
    reports = {}
    for pkg in ("repro_torch", "repro"):
        report = tmp_path / f"{pkg}.json"
        proc = _run_cli(str(FIXTURES / "det_bad.py"), "--baseline", "none", "--format", "json",
                        "--report", str(report), pkg=pkg)
        assert proc.returncode == 2
        payload = json.loads(proc.stdout)
        assert json.loads(report.read_text())["findings"] == payload["findings"]
        reports[pkg] = payload["findings"]
    assert reports["repro_torch"] == reports["repro"]
    assert {f["rule"] for f in reports["repro"]} == {"det-unordered-iter", "det-wallclock",
                                                      "det-random"}


def test_cli_write_baseline_roundtrip(tmp_path):
    out = tmp_path / "baseline.json"
    proc = _run_cli(str(FIXTURES / "lockset_bad.py"), "--baseline", "none",
                    "--write-baseline", str(out))
    assert proc.returncode == 0
    skeleton = json.loads(out.read_text())
    assert skeleton["entries"] and all("TODO" in e["justification"]
                                       for e in skeleton["entries"])
    for e in skeleton["entries"]:
        e["justification"] = "fixture: intentional"
    out.write_text(json.dumps(skeleton))
    proc2 = _run_cli(str(FIXTURES / "lockset_bad.py"), "--baseline", str(out))
    assert proc2.returncode == 0, proc2.stderr + proc2.stdout
