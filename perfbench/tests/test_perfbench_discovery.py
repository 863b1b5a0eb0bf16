"""A configuration, a traffic mix and a metric added as files of their own
are found by name, with no edit to a file the benchmark has."""
from __future__ import annotations

import json

from conftest import make_bench_root, run_tiny
from perfbench.harness import spec as SP


def test_new_files_are_picked_up(tmp_path):
    root = make_bench_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*.py")}
    conf = json.loads((root / "perfbench/configs/tiny-mamba.json").read_text())
    conf["name"] = "tiny-mamba-wide"
    conf["port"]["replace"]["d_model"] = conf["model"]["d_model"] = 96
    (root / "perfbench/configs/tiny-mamba-wide.json").write_text(json.dumps(conf))
    (root / "perfbench/traffic/tiny-three.json").write_text(json.dumps(
        {"loop": "closed", "clients": 3, "prompt_len": 24, "max_new": 3, "check_tokens": 9,
         "trace_waves": 1}))
    (root / "perfbench/limits/tiny-mamba-wide.tiny-three.json").write_text(json.dumps(
        {"gap": 0.5, "logit_err": 0.5, "ad_labels": 0, "ad_stats": 1e-9}))
    (root / "perfbench/metrics/waves_per_s.py").write_text(
        "def read(run):\n    return len(run.waves) / (run.t_close - run.t0)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-mamba-wide", "source": "x", "reduced": [],
                             "file": "perfbench/configs/tiny-mamba-wide.json", "why": "x"})
    bench["workloads"].append({"name": "tiny-mamba-wide.tiny-three", "config": "tiny-mamba-wide",
                               "traffic": "tiny-three", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "waves_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["tiny-mamba-wide.tiny-three"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = SP.load_cell("tiny-mamba-wide.tiny-three", root)
    assert cell.model["d_model"] == 96 and cell.traffic["clients"] == 3
    res = run_tiny(root, "tiny-mamba-wide.tiny-three")
    assert res["correct"] is True
    assert {"tok_per_s", "ttft_p90_ms", "setup_s", "waves_per_s"} == set(res["metrics"])
    assert res["attempted"] % 3 == 0
    # the metric lists its cell: the other cells do not report it
    assert "waves_per_s" not in run_tiny(root, "tiny-mamba.tiny")["metrics"]
    assert before == {p: p.read_bytes() for p in before}
