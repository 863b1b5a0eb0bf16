"""Shared set-up of the benchmark's CPU tests.

They run from the checkout's root:  python -m pytest -q perfbench/tests
(the repository's own suite collects ``tests/`` only).  ``bench_root``
is a copy of the benchmark with two cells of its own at a size the CPU
holds: the two configurations cut to d_model 64 and a 512-token vocabulary
(the Jamba one to 4 experts), served by 4 clients with 32-token prompts.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY_CELLS = ("tiny-mamba.tiny", "tiny-jamba.tiny")
TINY_TRAFFIC = {"loop": "closed", "clients": 4, "prompt_len": 32, "max_new": 6,
                "check_tokens": 48, "trace_waves": 1}
# Limits at this size, set as the cells' are (PERF.md), from CPU readings over
# seeds 1-12, the float8 control on seeds 1-3: the Mamba cut reads gap <= 0.026
# and logit_err <= 0.062 (control: gap >= 0.209, logit_err >= 0.479); the
# Jamba cut, whose routing flips between bf16 and float32 as the full cell's
# does, gap_p90 <= 0.042 and logit_err_p50 <= 0.126 (control >= 0.685 and
# >= 0.978).
TINY_LIMITS = {
    "tiny-mamba.tiny": {"gap": 0.12, "logit_err": 0.2, "ad_labels": 0, "ad_stats": 1e-9},
    "tiny-jamba.tiny": {"gap_p90": 0.3, "logit_err_p50": 0.4, "ad_labels": 0,
                        "ad_stats": 1e-9},
}


def tiny_configs(root: Path):
    falcon = json.loads((root / "perfbench/configs/falcon-mamba-7b.json").read_text())
    falcon["name"] = "tiny-mamba"
    cut = {"n_layers": 2, "d_model": 64, "vocab": 512, "ssm_d_state": 8}
    falcon["port"]["replace"].update(cut, ssm_dt_rank=8)
    falcon["model"].update(cut, dt_rank=8)
    jamba = json.loads((root / "perfbench/configs/jamba-v0.1-1p.json").read_text())
    jamba["name"] = "tiny-jamba"
    cut = {"d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_ff": 128,
           "vocab": 512, "moe_experts": 4, "moe_dff": 32, "ssm_d_state": 8}
    jamba["port"]["replace"] = dict(cut, n_layers=8, ssm_dt_rank=8)
    jamba["model"].update(cut, dt_rank=8)
    return falcon, jamba


def make_bench_root(dest: Path) -> Path:
    """A copy of BENCHMARK.json and perfbench/ with the two tiny cells added."""
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for conf in tiny_configs(dest):
        path = f"perfbench/configs/{conf['name']}.json"
        (dest / path).write_text(json.dumps(conf))
        bench["configs"].append({"name": conf["name"], "source": conf["source"], "file": path,
                                 "reduced": [], "why": "a CPU-sized cut"})
    (dest / "perfbench/traffic/tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    for cell in TINY_CELLS:
        bench["workloads"].append({"name": cell, "config": cell.split(".")[0],
                                   "traffic": "tiny", "chips": 1, "why": "CPU test"})
        (dest / f"perfbench/limits/{cell}.json").write_text(json.dumps(TINY_LIMITS[cell]))
    for metric in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in metric:
            metric["workloads"] += list(TINY_CELLS)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="session")
def bench_root(tmp_path_factory) -> Path:
    return make_bench_root(tmp_path_factory.mktemp("bench"))


def run_tiny(root: Path, name: str, seed: int = 7, seconds: float = 0.3, trace: bool = False):
    """One run of a tiny cell on the CPU, past the harness's look for a card."""
    import time

    import torch

    from perfbench.harness import cli
    from perfbench.harness import spec as SP

    return cli.run_cell(SP.load_cell(name, root), seed, seconds, trace, torch.device("cpu"),
                        time.perf_counter())
