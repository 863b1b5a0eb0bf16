"""Measure what a site of the program's self-tracer costs on a CUDA card.

    python3 tools/span_probe.py

Prints, as JSON with the card's name and power limit, the host ns per span
site with the recorder off, on (self-tracing, host clock only), on with a
CUDA event pair (``timed_on`` a CUDA tensor), and under a recording
``torch.profiler`` (a ``record_function`` range each).
"""
from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src")]

REPEATS = 5


def _ns_per_call(tracer, n: int, **kw) -> float:
    """Median over REPEATS of the host ns one span site takes, the buffer
    drained between repeats so that no repeat drops spans."""
    got = []
    for _ in range(REPEATS):
        t0 = time.perf_counter_ns()
        for _ in itertools.repeat(None, n):
            with tracer.span("mamba/decode", **kw):
                pass
        got.append((time.perf_counter_ns() - t0) / n)
        tracer.drain()
    return statistics.median(got)


def cost() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.telemetry.selftrace import SelfTracer

    dev = torch.zeros(1, device="cuda:0")
    off, on = SelfTracer(enabled=False), SelfTracer(enabled=True)
    out = {"off_ns": _ns_per_call(off, 200_000),
           "on_host_ns": _ns_per_call(on, 20_000),
           "on_cuda_events_ns": _ns_per_call(on, 20_000, timed_on=dev)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["profiler_ns"] = _ns_per_call(off, 5_000)
    return out


def main() -> int:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"torch": torch.__version__, "cuda": torch.version.cuda, "card": smi.strip(),
           "cost": cost()}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
