"""Plain reference of Chimbuko's on-node anomaly detection (Xu et al.,
"Chimbuko: A Workflow-Level Scalable Performance Trace Analysis Tool",
section III-B1) over the frames a monitor ingested.

A completed call's runtime is its exit stamp less its entry stamp, the
ENTRY and EXIT events paired per thread and function in stamp order.  After
each frame, a function's statistics are the count, mean and population
standard deviation of every runtime of it seen so far, this frame's
included; a call of the frame is anomalous when there are at least
``min_samples`` runtimes and its own lies outside mean +- alpha * std.
Computed from all the runtimes at once with numpy, not by merging moments.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

import numpy as np

ENTRY, EXIT = 0, 1  # the func_events etype values

Call = Tuple[int, int, int]  # (fid, entry stamp, exit stamp)


def calls(func_events: np.ndarray) -> List[Call]:
    """The frame's completed calls, in the order they complete."""
    open_: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    out = []
    for e in np.sort(func_events, order="ts", kind="stable"):
        key = (int(e["tid"]), int(e["fid"]))
        if int(e["etype"]) == ENTRY:
            open_[key].append(int(e["ts"]))
        elif open_[key]:
            out.append((key[1], open_[key].pop(), int(e["ts"])))
    return out


def replay(frames: Iterable, min_samples: int, alpha: float):
    """-> ({call: label}, {fid: (count, mean, std)}) after every frame."""
    history: Dict[int, List[int]] = defaultdict(list)
    labels: Dict[Call, int] = {}
    for frame in frames:
        done = calls(frame.func_events)
        for fid, t0, t1 in done:
            history[fid].append(t1 - t0)
        for fid, t0, t1 in done:
            v = np.asarray(history[fid], dtype=np.float64)
            mu, sd = v.mean(), v.std()
            x = float(t1 - t0)
            labels[(fid, t0, t1)] = int(len(v) >= min_samples and
                                        (x > mu + alpha * sd or x < mu - alpha * sd))
    stats = {fid: (float(len(v)), float(np.mean(v)), float(np.std(v)))
             for fid, v in history.items()}
    return labels, stats


def label_mismatches(labels: Dict[Call, int], records: Iterable[np.ndarray]) -> int:
    """Calls labelled otherwise by the monitor, plus calls only one side has."""
    got = {}
    for recs in records:
        for r in recs:
            got[(int(r["fid"]), int(r["entry"]), int(r["exit"]))] = int(r["label"])
    return (len(set(got) ^ set(labels))
            + sum(got[k] != v for k, v in labels.items() if k in got))


def stats_gap(stats: Dict[int, tuple], table: np.ndarray) -> float:
    """The largest relative gap between ``stats`` and the monitor's table
    (columns count, mean, M2, ...): 1 for a function only one side has."""
    worst = 0.0
    seen = {int(f) for f in np.nonzero(table[:, 0] > 0)[0]}
    if seen != set(stats):
        return 1.0
    for fid, want in stats.items():
        n, mean, m2 = table[fid, 0], table[fid, 1], table[fid, 2]
        got = (n, mean, np.sqrt(max(m2, 0.0) / n) if n > 1 else 0.0)
        for g, w in zip(got, want):
            worst = max(worst, abs(g - w) / max(abs(w), 1e-300))
    return float(worst)
