"""One run of one cell:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``): the program's configuration held to the
configuration file, the weights made on the card from the seed, the
program's kernels built (nvcc, on a checkout's first run only; timed apart
as ``build_s`` in the result line), the serving steps built, and one
warm-up wave of the cell's shapes on a monitor of its own.
Then the window (``serve.window``); with ``--trace 1`` the window's host
clock and CUDA events give the per-layer metrics, and a traced segment
after it (``profile.traced_waves``) the device's.  Then the peak memory is
read, the program's caches are gone, and the correctness check runs.

The last line of standard output is the result, one JSON object whose last
key, ``checks``, gives each number compared with its limit; the same
numbers end standard error.  A run exits non-zero and prints no result
without CUDA, with fewer cards than the cell asks for, without the
program, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
from typing import Optional

import numpy as np

from . import spec as SP
from .guard import forbidden_modules


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: SP.Cell
    waves: list  # the window's
    t0: float
    t_close: float
    setup_s: float
    trace: Optional[object] = None  # profile.Trace of the traced segment

    @property
    def model(self) -> dict:
        return self.cell.model

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


def run_cell(cell: SP.Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             ) -> dict:
    """The run's result (see the module); ``device`` may be the CPU in tests."""
    import torch

    from . import check as CK
    from . import model as MD
    from . import serve as SV

    cuda = torch.device(device).type == "cuda"
    marks = [("imports", SV.now())]
    cfg = MD.port_config(cell.conf)
    MD.check_layout(cfg, MD.weight_leaves(cell.conf))
    weights = MD.make_weights(cell.conf, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    marks.append(("weights", SV.now()))
    build_s = 0.0
    if cuda:  # the program's kernels built with nvcc where the checkout has none yet
        from repro_torch.kernels import _build

        _build.build_all()
        build_s = SV.now() - marks[-1][1]
        marks.append(("kernels built or found", SV.now()))
    traffic = SV.Traffic(cell.traffic, cfg.vocab, seed)
    server = SV.Server(cfg, weights, traffic, device, timed_events=trace)
    warm = SV.Traffic(cell.traffic, cfg.vocab, seed, stream=3)
    server.wave(warm.next_prompts(), SV.now())  # builds and warms every shape
    server.close()
    server.new_monitor()
    if cuda:
        torch.cuda.synchronize(device)
    gc.collect()
    marks.append(("warm-up wave", SV.now()))
    log("set-up: " + ", ".join(f"{name} {t - t_prev:.2f} s" for (name, t), (_, t_prev)
                                in zip(marks, [("start", t_start)] + marks[:-1])))
    t0, waves = SV.window(server, seconds)
    t_close = waves[-1].t_end
    log(f"window: {len(waves)} waves in {t_close - t0:.3f} s, set-up {t0 - t_start:.3f} s")
    log(f"build_s {build_s:.3f} of setup_s {t0 - t_start:.3f}: nvcc on a checkout's first "
        f"run only")
    run = Run(cell, waves, t0, t_close, t0 - t_start)
    served = list(waves)
    if trace:
        from .profile import traced_waves

        t = SV.now()
        tail, run.trace = traced_waves(server, int(cell.traffic["trace_waves"]), t)
        served += tail
        log(f"traced {run.trace.n_waves} waves: window {run.trace.window_s:.4f} s, "
            f"busy {run.trace.busy_s:.4f} s; {SV.now() - t:.1f} s with the reduction")
    metrics = SP.read_metrics(cell, run, trace)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": int(cell.workload["chips"]),
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if cuda
                   else 0}
    if trace:
        device_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    server.close()
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    if cuda:
        torch.cuda.empty_cache()
    t = SV.now()
    numbers = CK.check(cell, weights, served, server.monitor, seed, device,
                       SV.MONITOR["min_samples"], SV.MONITOR_ALPHA)
    log(f"checked {numbers['tokens']} served tokens of {numbers['waves_checked']} waves "
        f"in {SV.now() - t:.1f} s")
    result = {"correct": CK.verdict(numbers, cell.limits),
              "attempted": sum(len(w.prompts) for w in served), "failed": 0,
              "metrics": metrics, "device": device_info, "build_s": build_s}
    if trace:
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = CK.report(numbers, cell.limits)
    return result


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__(f"the run loaded {', '.join(found)}: the benchmark measures the "
                         f"PyTorch port alone")


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = SP.load_cell(args.workload)
    try:
        import repro_torch  # noqa: F401  the program under test
    except ImportError as e:
        log(f"the program (repro_torch under src/) is not here: {e}")
        return 3
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), t_start)
    except ForbiddenModules as e:
        log(str(e))
        return 4
    found = forbidden_modules()
    if found:
        log(str(ForbiddenModules(found)))
        return 4
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result, default=_plain))
    return 0


def _plain(x):
    if isinstance(x, np.generic):
        return x.item()
    raise TypeError(f"{type(x)} is not JSON")
