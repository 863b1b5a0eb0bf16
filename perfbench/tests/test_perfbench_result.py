"""The result line and the run's refusals."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, run_tiny

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def test_result_has_the_five_keys_and_ends_with_the_checks(bench_root):
    res = run_tiny(bench_root, "tiny-mamba.tiny")
    assert all(k in res for k in KEYS)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"tok_per_s", "ttft_p90_ms", "setup_s"}
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    assert set(res["checks"]) == {"gap", "logit_err", "ad_labels", "ad_stats"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    json.dumps(res)


def test_traced_run_reports_per_layer_metrics_and_the_window(bench_root):
    res = run_tiny(bench_root, "tiny-jamba.tiny", trace=True)
    assert res["correct"] is True
    # the CPU has no CUDA events and no kernels: only the host-clock readers find something
    assert set(res["metrics"]) == {"decode_step_p90_ms", "monitor_ms_per_wave",
                                   "label_lag_p90_ms"}
    assert res["device"]["window_s"] > 0 and "busy_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "checks"


def _run_py(cwd, *args):
    return subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_run_exits_without_a_result_where_there_is_no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run_py(ROOT, "--workload", "falcon-mamba-7b.score-1k", "--seed", str(2**31 + 5),
                "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "needs 1 CUDA device" in p.stderr


def test_run_exits_without_a_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path, "--workload", "jamba-v0.1-1p.doc-4k", "--seed", "1",
                "--seconds", "1", "--trace", "1")
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["falcon-mamba-7b.score-1k", "jamba-v0.1-1p.doc-4k"])
def test_cell_runs_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = _run_py(ROOT, "--workload", workload, "--seed", str(2**31 + 77), "--seconds", "3",
                "--trace", "0")
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
