"""Offline mode (paper §II-B): replay archived runs, compare across runs.

"All Chimbuko components can be run both in on- and off-line modes, allowing
users to reinvestigate and compare performance data across a number of runs."
Offline replay re-drives the exact in-situ pipeline from a FrameStore
archive; cross-run comparison diffs per-function profiles and anomaly
geography between two provenance/profile captures — the paper's co-design
use case (same workflow, different configuration, what changed?).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

import numpy as np

from .events import FunctionRegistry
from .stats import StatsTable
from repro_torch.trace.monitor import ChimbukoMonitor
from repro_torch.trace.stream import FrameStore


def replay(
    store: FrameStore,
    registry: Optional[FunctionRegistry] = None,
    num_funcs: int = 64,
    prov_path: Optional[str] = None,
    **monitor_kw,
) -> ChimbukoMonitor:
    """Re-run the full AD pipeline over an archived run (offline mode)."""
    monitor = ChimbukoMonitor(
        num_funcs=num_funcs, registry=registry, prov_path=prov_path, **monitor_kw
    )
    # interleave ranks step-by-step, as the live system would have seen them
    ranks = store.ranks()
    steps = sorted({s for r in ranks for s in store.steps(r)})
    for step in steps:
        for rank in ranks:
            try:
                frame = store.read(rank, step)
            except FileNotFoundError:
                continue
            monitor.ingest(frame)
    return monitor


@dataclasses.dataclass
class RunProfile:
    """Per-function runtime profile + anomaly census of one run."""

    name: str
    stats: StatsTable
    registry: FunctionRegistry
    anomalies_by_func: Dict[int, int]
    anomalies_by_rank: Dict[int, int]

    @classmethod
    def from_monitor(cls, name: str, mon: ChimbukoMonitor) -> "RunProfile":
        table = mon.ps.snapshot()
        by_func: Dict[int, int] = {}
        by_rank: Dict[int, int] = {}
        for doc in mon.provdb.records:
            by_func[doc["anomaly"]["fid"]] = by_func.get(doc["anomaly"]["fid"], 0) + 1
            by_rank[doc["rank"]] = by_rank.get(doc["rank"], 0) + 1
        return cls(name, table, mon.registry, by_func, by_rank)


def compare_runs(a: RunProfile, b: RunProfile, min_count: int = 8) -> List[Dict[str, Any]]:
    """Per-function diff between two runs of the same workflow.

    Returns rows sorted by |relative mean-runtime change|, flagging
    regressions — the 'document the effectiveness of performance
    optimization efforts' use case (paper §VI-A).
    """
    rows = []
    F = min(a.stats.num_funcs, b.stats.num_funcs)
    for fid in range(F):
        na, nb = a.stats.counts()[fid], b.stats.counts()[fid]
        if na < min_count or nb < min_count:
            continue
        ma, mb = a.stats.means()[fid], b.stats.means()[fid]
        rows.append(
            {
                "fid": fid,
                "func": a.registry.name_of(fid),
                "mean_us_a": ma,
                "mean_us_b": mb,
                "rel_change": (mb - ma) / max(ma, 1e-9),
                "anomalies_a": a.anomalies_by_func.get(fid, 0),
                "anomalies_b": b.anomalies_by_func.get(fid, 0),
                "calls_a": int(na),
                "calls_b": int(nb),
            }
        )
    rows.sort(key=lambda r: -abs(r["rel_change"]))
    return rows


def report(rows: List[Dict[str, Any]], top: int = 10) -> str:
    lines = [f"{'function':16s} {'mean A us':>10s} {'mean B us':>10s} "
             f"{'change':>8s} {'anomA':>6s} {'anomB':>6s}"]
    for r in rows[:top]:
        lines.append(
            f"{r['func'][:16]:16s} {r['mean_us_a']:10.0f} {r['mean_us_b']:10.0f} "
            f"{r['rel_change']*100:+7.1f}% {r['anomalies_a']:6d} {r['anomalies_b']:6d}"
        )
    return "\n".join(lines)
