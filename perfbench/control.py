"""Readings that set a cell's correctness limits: the program's numbers
over many seeds, and the control's.

    python3 perfbench/control.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--out readings.jsonl]

One process, for its set-up: per seed, the weights are made anew, the
program serves as many waves at the cell's own load as a run's check
compares, and the check's numbers are read as a run reads them.  On a
control seed the plain reference is also computed in float8 (e4m3, scaled
per tensor and per row) in the program's place, the step below the
bfloat16 that the configuration computes in: its numbers (``fp8_...``) are
those of the token it puts first and of its logits, each against the
float32 reference over the same prompts and served tokens.  A line of JSON
per seed; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness import check as CK  # noqa: E402
from perfbench.harness import model as MD  # noqa: E402
from perfbench.harness import serve as SV  # noqa: E402
from perfbench.harness import spec as SP  # noqa: E402


def readings(cell: SP.Cell, seeds, control_seeds, device, out=None):
    import torch

    cfg = MD.port_config(cell.conf)
    t = cell.traffic
    n_waves = math.ceil(t["check_tokens"] / (t["clients"] * t["max_new"]))
    rows = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        weights = MD.make_weights(cell.conf, seed, device)
        traffic = SV.Traffic(t, cfg.vocab, seed)
        server = SV.Server(cfg, weights, traffic, device)
        if i == 0:
            server.wave(traffic.next_prompts(), SV.now())  # builds the kernels
            server.close()
            server.new_monitor()
        waves = [server.wave(traffic.next_prompts(), SV.now()) for _ in range(n_waves)]
        server.close()
        quant = "fp8" if seed in control_seeds else None
        numbers = CK.model_numbers(cell, weights, waves, list(range(n_waves)), device, quant)
        numbers.update(CK.monitor_numbers(waves, server.monitor, SV.MONITOR["min_samples"],
                                          SV.MONITOR_ALPHA))
        row = {"workload": cell.name, "seed": seed, **numbers,
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        if out is not None:
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
        rows.append(row)
        del server, weights, waves
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control readings are taken on the card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    rows = readings(SP.load_cell(args.workload), seeds, control, torch.device("cuda", 0),
                    args.out)
    for key in ("gap", "gap_p90", "logit_err", "logit_err_p50", "ad_labels", "ad_stats"):
        print(f"{key}: program max {max(r[key] for r in rows)!r}", file=sys.stderr)
        got = [r[f"fp8_{key}"] for r in rows if f"fp8_{key}" in r]
        if got:
            print(f"fp8_{key}: control min {min(got)!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
