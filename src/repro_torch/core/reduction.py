"""Data reduction by anomaly selection (paper §III-B1, Figs. 8/9).

"This is where significant data reduction occurs because we only save the
anomalies and a few nearby normal function calls of the anomalies" — we keep
each anomaly plus up to k (=5 in the paper) completed calls of the *same
function* before and after it, fold everything else into profile statistics,
and account raw-vs-reduced bytes so benchmarks can reproduce the paper's
14×/148× reduction factors.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np

from .ad import ADFrameResult

DEFAULT_K_NEIGHBORS = 5

# Serialized size of one call record on the reduced stream.  We account the
# same binary width the raw stream uses per record (struct bytes), which is
# conservative vs. the paper's JSON dumps.
_RECORD_BYTES = 57  # EXEC_RECORD_DTYPE itemsize


@dataclasses.dataclass
class ReductionStats:
    raw_bytes: int = 0
    reduced_bytes: int = 0
    n_records: int = 0
    n_kept: int = 0
    n_anomalies: int = 0

    @property
    def factor(self) -> float:
        return self.raw_bytes / self.reduced_bytes if self.reduced_bytes else float("inf")

    def to_dict(self) -> Dict[str, float]:
        return {
            "raw_bytes": self.raw_bytes,
            "reduced_bytes": self.reduced_bytes,
            "n_records": self.n_records,
            "n_kept": self.n_kept,
            "n_anomalies": self.n_anomalies,
            "reduction_factor": self.factor,
        }


def select_kept_records(
    records: np.ndarray, anomaly_idx: np.ndarray, k: int = DEFAULT_K_NEIGHBORS
) -> np.ndarray:
    """Indices of records to keep: anomalies + k same-fid neighbors each side.

    Records are in completion order (the stream order the AD observes).
    """
    if len(anomaly_idx) == 0:
        return np.zeros(0, np.int64)
    keep = np.zeros(len(records), bool)
    keep[anomaly_idx] = True
    fids = records["fid"]
    # For each fid with an anomaly, mark the k nearest same-fid records on
    # both sides of each anomalous occurrence.
    for fid in np.unique(fids[anomaly_idx]):
        pos = np.nonzero(fids == fid)[0]  # stream positions of this fid
        within = np.nonzero(np.isin(pos, anomaly_idx))[0]
        for w in within:
            lo = max(0, w - k)
            hi = min(len(pos), w + k + 1)
            keep[pos[lo:hi]] = True
    return np.nonzero(keep)[0]


class Reducer:
    """Per-rank reduction accounting + reduced-stream assembly."""

    def __init__(self, k: int = DEFAULT_K_NEIGHBORS, filtered: bool = True):
        self.k = k
        # 'filtered' mirrors the paper's compile/runtime event filtering of
        # high-frequency short functions; the workload generator marks
        # filterable functions, and unfiltered runs keep them all.
        self.filtered = filtered
        self.stats = ReductionStats()

    def reduce(self, result: ADFrameResult) -> np.ndarray:
        kept_idx = select_kept_records(result.records, result.anomaly_idx, self.k)
        self.stats.raw_bytes += result.raw_bytes
        self.stats.reduced_bytes += int(len(kept_idx)) * _RECORD_BYTES
        self.stats.n_records += len(result.records)
        self.stats.n_kept += int(len(kept_idx))
        self.stats.n_anomalies += result.n_anomalies
        return kept_idx


def merge_stats(parts: List[ReductionStats]) -> ReductionStats:
    out = ReductionStats()
    for p in parts:
        out.raw_bytes += p.raw_bytes
        out.reduced_bytes += p.reduced_bytes
        out.n_records += p.n_records
        out.n_kept += p.n_kept
        out.n_anomalies += p.n_anomalies
    return out
