"""A CPU-sized cut of the DeepSeek-V2-Lite cell for the benchmark's tests:
``conftest.make_bench_root``'s copy of the benchmark with one more cell,
``tiny-deepseek.tiny``, whose configuration is deepseek-v2-lite's with
every layer kept (one dense and 26 MoE) at d_model 64, 4 heads, a latent of
32, nope 8 + rope 8, v 16, the 64 experts top-6 at width 32 with 2 shared,
a 512-token vocabulary and YaRN's original length 8, below the 32-token
prompts of the tiny traffic, served by 4 clients."""
from __future__ import annotations

import json
from pathlib import Path

from conftest import ROOT, make_bench_root

CELL = "tiny-deepseek.tiny"
CUT = {"d_model": 64, "n_heads": 4, "d_ff": 128, "vocab": 512, "kv_lora_rank": 32,
       "qk_nope_dim": 8, "qk_rope_dim": 8, "v_head_dim": 16, "moe_dff": 32,
       "yarn_original_max_pos": 8}
# Set as the cells' limits are (PERF.md), from CPU readings over seeds 1-12,
# the float8 control on seeds 1-3: the program reads gap_p90 <= 0.012 and
# logit_err_p50 <= 0.135, the control gap_p90 >= 0.515 and logit_err_p50 >= 0.808.
LIMITS = {"gap_p90": 0.25, "logit_err_p50": 0.45, "ad_labels": 0, "ad_stats": 1e-9}


def tiny_config(root: Path) -> dict:
    conf = json.loads((ROOT / "perfbench/configs/deepseek-v2-lite.json").read_text())
    conf["name"] = "tiny-deepseek"
    conf["port"]["replace"] = dict(CUT)
    conf["model"].update(CUT)
    return conf


def make_deepseek_root(dest: Path) -> Path:
    root = make_bench_root(dest)
    conf = tiny_config(root)
    path = "perfbench/configs/tiny-deepseek.json"
    (root / path).write_text(json.dumps(conf))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": conf["name"], "source": conf["source"], "file": path,
                             "reduced": [], "why": "a CPU-sized cut"})
    bench["workloads"].append({"name": CELL, "config": conf["name"], "traffic": "tiny",
                               "chips": 1, "why": "CPU test"})
    for metric in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in metric and "deepseek-v2-lite.doc-16k" in metric["workloads"]:
            metric["workloads"].append(CELL)
    (root / f"perfbench/limits/{CELL}.json").write_text(json.dumps(LIMITS))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
