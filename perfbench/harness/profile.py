"""The traced segment: waves under ``torch.profiler``, reduced to what the
device did and what the host was doing while it idled.

The profiler takes one wave to warm up (a profile without it has lost
launches on the H100) and records the next ``active`` waves.  From the
recording: the window (the recorded ``ProfilerStep*`` ranges, on the
trace's clock), the device's busy time (the union of its kernels, copies
and fills), device time and launches by kernel name, and the device's idle
gaps, each put down to the benchmark's host range (``bench/...``) that
holds its middle.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

HOST_RANGES = ("bench/prefill", "bench/decode_step", "bench/record_step_times",
               "bench/monitor_ingest")
OUTSIDE = "bench/between_phases"  # the host in none of the ranges


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    by_kernel: Dict[str, Tuple[float, int]]  # name -> (device seconds, launches)
    idle_by_range: Dict[str, float]  # host range -> idle device seconds in it
    n_waves: int

    def device_ops(self, n: int = 10) -> List[list]:
        top = sorted(self.by_kernel.items(), key=lambda kv: -kv[1][0])[:n]
        return [[name[:120], s] for name, (s, _) in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        top = sorted(self.idle_by_range.items(), key=lambda kv: -kv[1])[:n]
        return [[name, s] for name, s in top]

    def kernel(self, part: str) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds ``part``."""
        hits = [v for k, v in self.by_kernel.items() if part in k]
        return sum(s for s, _ in hits), sum(n for _, n in hits)


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
        return False
    return not (e.name.startswith("ProfilerStep") or e.name.startswith("bench/"))


def reduce_events(events) -> Trace:
    """A :class:`Trace` from the profiler's ``events()``."""
    from torch.autograd import DeviceType

    steps = [e for e in events if e.name.startswith("ProfilerStep")
             and e.device_type == DeviceType.CPU]
    host = [e for e in events if e.name in HOST_RANGES and e.device_type == DeviceType.CPU]
    dev = sorted((e for e in events if _is_device(e)), key=lambda e: e.time_range.start)
    if not steps:
        raise RuntimeError("the profile holds no ProfilerStep range: no traced window")
    w0 = min(e.time_range.start for e in steps)
    w1 = max(e.time_range.end for e in steps)
    by_kernel: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    busy, gaps = 0.0, []
    cur = w0  # the end of the device's busy time so far
    for e in dev:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        rec = by_kernel[e.name]
        rec[0] += (e.time_range.end - e.time_range.start) / 1e6
        rec[1] += 1
        if s > cur:
            gaps.append((cur, s))
        busy += max(0.0, t - max(s, cur))
        cur = max(cur, t)
    if w1 > cur:
        gaps.append((cur, w1))
    host.sort(key=lambda e: e.time_range.start)
    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        inside = [e.name for e in host if e.time_range.start <= mid <= e.time_range.end]
        idle[inside[-1] if inside else OUTSIDE] += (g1 - g0) / 1e6
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6,
                 by_kernel={k: (v[0], int(v[1])) for k, v in by_kernel.items()},
                 idle_by_range=dict(idle), n_waves=len(steps))


def traced_waves(server, active: int, submit: float):
    """``1 + active`` waves under the profiler -> (the waves, their Trace)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    waves = []
    server.ranges = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=active, repeat=1)) as prof:
            for _ in range(1 + active):
                waves.append(server.wave(server.traffic.next_prompts(), submit))
                submit = waves[-1].t_done
                prof.step()
    finally:
        server.ranges = False
    return waves, reduce_events(prof.events())
