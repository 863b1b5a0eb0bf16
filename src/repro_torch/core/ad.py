"""On-node anomaly detection (paper §III-B1).

A completed call is anomalous when its runtime falls outside
[μ_i − ασ_i, μ_i + ασ_i] for function i, α = 6 (paper's setting), where the
(μ, σ) come from the *global* statistics table — the local table merged with
the parameter server's view.  Each on-node AD module:

  1. builds/maintains the call stack from the frame's events,
  2. folds completed-call runtimes into its local StatsTable,
  3. pushes the per-frame delta to the PS and pulls the global snapshot,
  4. labels calls against the freshest global statistics,
  5. hands anomalies + k-neighbor context to the reducer/provenance.

An alternative HBOS (histogram-based outlier score) detector is included as
the "more advanced AD algorithm" the paper lists as future work.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .callstack import CallStackBuilder, FrameContext
from .events import Frame
from .stats import StatsTable

DEFAULT_ALPHA = 6.0


@dataclasses.dataclass
class ADFrameResult:
    """Everything the reducer/viz need from one analyzed frame."""

    step: int
    rank: int
    records: np.ndarray  # EXEC_RECORD_DTYPE with label filled
    ctx: FrameContext
    anomaly_idx: np.ndarray  # indices into records
    n_events: int
    raw_bytes: int

    @property
    def n_anomalies(self) -> int:
        return int(len(self.anomaly_idx))


class SstdDetector:
    """μ ± ασ thresholding on per-function runtime (the paper's detector)."""

    def __init__(self, alpha: float = DEFAULT_ALPHA, min_samples: int = 10):
        self.alpha = alpha
        self.min_samples = min_samples

    def label(self, table: StatsTable, fids: np.ndarray, runtimes: np.ndarray) -> np.ndarray:
        if len(fids) == 0:
            return np.zeros(0, np.int8)
        mu = table.means()[fids]
        sd = table.stds()[fids]
        n = table.counts()[fids]
        hi = mu + self.alpha * sd
        lo = mu - self.alpha * sd
        x = runtimes.astype(np.float64)
        lab = ((x > hi) | (x < lo)) & (n >= self.min_samples)
        return lab.astype(np.int8)


class HbosDetector:
    """Histogram-based outlier score (static-bin HBOS) per function.

    Score(x) = −log(p_bin(x)); anomalous when score exceeds ``threshold``.
    Histograms are built streamingly from min/max + counts kept per fid.
    """

    def __init__(self, n_bins: int = 32, threshold: float = 6.0, min_samples: int = 32):
        self.n_bins = n_bins
        self.threshold = threshold
        self.min_samples = min_samples
        self.hists: Dict[int, np.ndarray] = {}
        self.edges: Dict[int, Tuple[float, float]] = {}

    def update(self, fids: np.ndarray, runtimes: np.ndarray) -> None:
        for fid in np.unique(fids):
            x = runtimes[fids == fid].astype(np.float64)
            lo, hi = self.edges.get(int(fid), (np.inf, -np.inf))
            lo, hi = min(lo, x.min()), max(hi, x.max())
            if int(fid) not in self.hists:
                self.hists[int(fid)] = np.zeros(self.n_bins)
            elif (lo, hi) != self.edges[int(fid)]:
                # Range grew: rebin old mass approximately (uniform within bin).
                old = self.hists[int(fid)]
                olo, ohi = self.edges[int(fid)]
                centers = np.linspace(olo, ohi, self.n_bins, endpoint=False) + (
                    (ohi - olo) / self.n_bins / 2 if ohi > olo else 0.0
                )
                newh = np.zeros(self.n_bins)
                idx = self._bin_of(centers, lo, hi)
                np.add.at(newh, idx, old)
                self.hists[int(fid)] = newh
            self.edges[int(fid)] = (lo, hi)
            idx = self._bin_of(x, lo, hi)
            np.add.at(self.hists[int(fid)], idx, 1.0)

    def _bin_of(self, x: np.ndarray, lo: float, hi: float) -> np.ndarray:
        if hi <= lo:
            return np.zeros(len(x), np.int64)
        idx = ((x - lo) / (hi - lo) * self.n_bins).astype(np.int64)
        return np.clip(idx, 0, self.n_bins - 1)

    def label(self, table: StatsTable, fids: np.ndarray, runtimes: np.ndarray) -> np.ndarray:
        lab = np.zeros(len(fids), np.int8)
        for i, (fid, x) in enumerate(zip(fids, runtimes)):
            h = self.hists.get(int(fid))
            if h is None or h.sum() < self.min_samples:
                continue
            lo, hi = self.edges[int(fid)]
            p = h[self._bin_of(np.asarray([float(x)]), lo, hi)[0]] / h.sum()
            score = -np.log(max(p, 1e-12))
            lab[i] = np.int8(score > self.threshold)
        return lab


class OnNodeAD:
    """One per rank: call-stack building, local stats, PS sync, labeling."""

    def __init__(
        self,
        num_funcs: int,
        rank: int = 0,
        app: int = 0,
        alpha: float = DEFAULT_ALPHA,
        min_samples: int = 10,
        ps_client: Optional[object] = None,
        algorithm: str = "sstd",
    ):
        self.rank = rank
        self.app = app
        self.builder = CallStackBuilder(app=app, rank=rank)
        self.local = StatsTable(num_funcs)
        self.global_view = StatsTable(num_funcs)
        self.ps_client = ps_client
        self.detector = (
            SstdDetector(alpha=alpha, min_samples=min_samples)
            if algorithm == "sstd"
            else HbosDetector()
        )
        self.algorithm = algorithm
        self.n_anomalies_total = 0
        self.frames_seen = 0

    def process_frame(self, frame: Frame) -> ADFrameResult:
        records, ctx = self.builder.process(frame)
        fids = records["fid"].astype(np.int64)
        runtimes = records["runtime"].astype(np.float64)

        # 1. fold into local stats; the delta is what travels to the PS.
        if int(fids.max(initial=-1)) >= self.local.num_funcs:
            self.local.grow(int(fids.max()) + 1)
            self.global_view.grow(int(fids.max()) + 1)
        delta = self.local.update_batch(fids, runtimes)
        if isinstance(self.detector, HbosDetector):
            self.detector.update(fids, runtimes)

        # 2. async PS exchange: push delta, pull global snapshot.
        if self.ps_client is not None:
            snapshot = self.ps_client.update_and_fetch(self.rank, frame.step, delta)
            if snapshot is not None:
                if snapshot.shape[0] > self.global_view.num_funcs:
                    self.global_view.grow(snapshot.shape[0])
                self.global_view.table = snapshot.copy()
        else:
            self.global_view.merge_array(delta)

        # 3. label against the freshest (global if available) statistics.
        table = self.global_view if self.ps_client is not None else self.local
        labels = self.detector.label(table, fids, runtimes)
        records["label"] = labels
        anomaly_idx = np.nonzero(labels == 1)[0]
        self.n_anomalies_total += len(anomaly_idx)
        self.frames_seen += 1

        return ADFrameResult(
            step=frame.step,
            rank=self.rank,
            records=records,
            ctx=ctx,
            anomaly_idx=anomaly_idx,
            n_events=len(frame.func_events) + len(frame.comm_events),
            raw_bytes=frame.nbytes_raw(),
        )
