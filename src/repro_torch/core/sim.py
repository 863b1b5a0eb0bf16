"""Synthetic workflow trace generator with ground-truth anomalies.

A copy of ``repro.core.sim``: the port keeps its own so that it imports
nothing of ``repro``; the same seed gives byte-identical frames.

The paper's experiments run NWChem on Summit; offline we reproduce the *shape*
of that workload: a per-rank call tree (MD_NEWTON → MD_FORCES → SP_GETXBL …)
with configurable duration distributions, message traffic, filterable
high-frequency functions, and injected anomalies (delays with known ground
truth).  Ground truth enables precision/recall measurements the paper could
not make on real traces, plus the Fig. 7 accuracy comparison and the Fig. 9
reduction-factor benchmarks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .events import (
    COMM_EVENT_DTYPE,
    ENTRY,
    EXIT,
    FUNC_EVENT_DTYPE,
    Frame,
    FunctionRegistry,
    empty_comm_events,
    empty_func_events,
)

TRUTH_DTYPE = np.dtype(
    [("fid", np.uint32), ("entry", np.uint64), ("exit", np.uint64), ("label", np.int8)]
)


@dataclasses.dataclass
class FuncSpec:
    name: str
    mean_us: float
    std_us: float
    children: Sequence[Tuple[str, int]] = ()
    n_msgs: int = 0
    filterable: bool = False  # high-frequency/short — dropped by TAU filtering
    anomaly_rate: float = 0.0  # chance a call is delayed
    anomaly_scale: float = 4.0  # delay multiplier on own compute time
    rank_bias: Optional[int] = None  # anomalies concentrated on this rank


@dataclasses.dataclass
class WorkloadSpec:
    funcs: Dict[str, FuncSpec]
    root: str
    roots_per_frame: int = 4

    def registry(self) -> FunctionRegistry:
        reg = FunctionRegistry()
        for name in self.funcs:
            reg.register(name)
        return reg


def nwchem_like(anomaly_rate: float = 0.02, roots_per_frame: int = 4) -> WorkloadSpec:
    """The §VI-C case-study workload shape."""
    f = {}
    f["MD_NEWTON"] = FuncSpec(
        "MD_NEWTON", 2000, 100, children=[("MD_FINIT", 1), ("MD_FORCES", 1)]
    )
    f["MD_FINIT"] = FuncSpec(
        "MD_FINIT", 400, 30, children=[("CF_CMS", 1)], anomaly_rate=anomaly_rate,
        rank_bias=0,
    )
    f["CF_CMS"] = FuncSpec(
        "CF_CMS", 300, 25, n_msgs=2, anomaly_rate=anomaly_rate, rank_bias=0
    )
    f["MD_FORCES"] = FuncSpec(
        "MD_FORCES", 900, 60, children=[("SP_GETXBL", 2), ("UTIL_TIMER", 6)],
        anomaly_rate=anomaly_rate,
    )
    f["SP_GETXBL"] = FuncSpec(
        "SP_GETXBL", 250, 20, children=[("SP_GTXPBL", 1)], anomaly_rate=anomaly_rate * 2
    )
    f["SP_GTXPBL"] = FuncSpec("SP_GTXPBL", 180, 15, n_msgs=3, anomaly_rate=anomaly_rate * 2)
    f["UTIL_TIMER"] = FuncSpec("UTIL_TIMER", 4, 1, filterable=True)
    return WorkloadSpec(funcs=f, root="MD_NEWTON", roots_per_frame=roots_per_frame)


def uniform_workload(
    n_funcs: int = 16,
    depth: int = 3,
    fanout: int = 2,
    mean_us: float = 200.0,
    anomaly_rate: float = 0.01,
    roots_per_frame: int = 8,
    filterable_frac: float = 0.5,
    seed: int = 0,
) -> WorkloadSpec:
    """Random layered call tree for property/scale tests."""
    rng = np.random.default_rng(seed)
    names = [f"F{i}" for i in range(n_funcs)]
    funcs: Dict[str, FuncSpec] = {}
    layers: List[List[str]] = []
    per = max(1, n_funcs // depth)
    for d in range(depth):
        layers.append(names[d * per : (d + 1) * per] or [names[-1]])
    for d, layer in enumerate(layers):
        for name in layer:
            children: List[Tuple[str, int]] = []
            if d + 1 < len(layers):
                picks = rng.choice(layers[d + 1], size=min(fanout, len(layers[d + 1])), replace=False)
                children = [(str(p), int(rng.integers(1, 3))) for p in picks]
            funcs[name] = FuncSpec(
                name=name,
                mean_us=float(mean_us * (0.5 + rng.random())),
                std_us=float(mean_us * 0.08),
                children=children,
                n_msgs=int(rng.integers(0, 3)),
                filterable=bool(rng.random() < filterable_frac and d == depth - 1),
                anomaly_rate=anomaly_rate,
            )
    return WorkloadSpec(funcs=funcs, root=layers[0][0], roots_per_frame=roots_per_frame)


class WorkloadGenerator:
    """Per-rank streaming frame generator (one frame per step per rank)."""

    def __init__(
        self,
        spec: WorkloadSpec,
        n_ranks: int,
        app: int = 0,
        seed: int = 0,
        filtered: bool = True,
    ):
        self.spec = spec
        self.n_ranks = n_ranks
        self.app = app
        self.seed = seed
        self.filtered = filtered
        self.registry = spec.registry()
        self._clock = np.zeros(n_ranks, dtype=np.uint64)

    def frame(self, rank: int, step: int) -> Tuple[Frame, np.ndarray]:
        """Generate (frame, ground_truth) for one rank/step."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + rank * 7919 + step * 104729) % (2**63)
        )
        fe_rows: List[Tuple[int, int, int]] = []  # (fid, etype, ts)
        ce_rows: List[Tuple[int, int, int]] = []  # (tag, partner, ts)
        truth: List[Tuple[int, int, int, int]] = []
        t = int(self._clock[rank])
        for _ in range(self.spec.roots_per_frame):
            t = self._gen_call(self.spec.root, t, rank, rng, fe_rows, ce_rows, truth)
            t += int(rng.integers(1, 20))
        self._clock[rank] = t

        fe = empty_func_events(len(fe_rows))
        fe["app"] = self.app
        fe["rank"] = rank
        fe["tid"] = 0
        if fe_rows:
            arr = np.asarray(fe_rows, dtype=np.int64)
            fe["fid"], fe["etype"], fe["ts"] = arr[:, 0], arr[:, 1], arr[:, 2]
            order = np.argsort(fe["ts"], kind="stable")
            fe = fe[order]
        ce = empty_comm_events(len(ce_rows))
        ce["app"] = self.app
        ce["rank"] = rank
        ce["tid"] = 0
        if ce_rows:
            arr = np.asarray(ce_rows, dtype=np.int64)
            ce["tag"], ce["partner"], ce["ts"] = arr[:, 0], arr[:, 1], arr[:, 2]
            ce["nbytes"] = 8192
            ce["ctype"] = arr[:, 0] % 2
            ce = ce[np.argsort(ce["ts"], kind="stable")]
        tr = np.zeros(len(truth), dtype=TRUTH_DTYPE)
        if truth:
            arr = np.asarray(truth, dtype=np.int64)
            tr["fid"], tr["entry"], tr["exit"], tr["label"] = (
                arr[:, 0],
                arr[:, 1],
                arr[:, 2],
                arr[:, 3],
            )
            tr = tr[np.argsort(tr["exit"], kind="stable")]
        return Frame(self.app, rank, step, fe, ce), tr

    def step_frames(self, step: int) -> List[Tuple[Frame, np.ndarray]]:
        return [self.frame(rank, step) for rank in range(self.n_ranks)]

    # ------------------------------------------------------------------
    def _gen_call(
        self,
        name: str,
        t: int,
        rank: int,
        rng: np.random.Generator,
        fe: List[Tuple[int, int, int]],
        ce: List[Tuple[int, int, int]],
        truth: List[Tuple[int, int, int, int]],
    ) -> int:
        spec = self.spec.funcs[name]
        if self.filtered and spec.filterable:
            # TAU selective instrumentation: function never emits events.
            return t + max(1, int(rng.normal(spec.mean_us, spec.std_us)))
        fid = self.registry.id_of(name)
        own = max(1.0, rng.normal(spec.mean_us, spec.std_us))
        label = 0
        rate = spec.anomaly_rate
        if spec.rank_bias is not None and rank != spec.rank_bias:
            rate *= 0.25
        if rate > 0 and rng.random() < rate:
            own *= spec.anomaly_scale * (1.0 + rng.random())
            label = 1
        entry = t
        fe.append((fid, int(ENTRY), t))
        # messages happen inside the call body
        n_msgs = spec.n_msgs and int(rng.integers(0, spec.n_msgs + 1))
        children = [
            (cname, 1) for (cname, cnt) in spec.children for _ in range(cnt)
        ]
        n_slices = len(children) + max(n_msgs, 0) + 1
        slice_us = max(1, int(own / n_slices))
        t += slice_us
        for k in range(max(n_msgs, 0)):
            ce.append((k, int(rng.integers(0, self.n_ranks)), t))
            t += 1
        for cname, _ in children:
            t = self._gen_call(cname, t, rank, rng, fe, ce, truth)
            t += slice_us
        t = max(t, entry + int(own))
        fe.append((fid, int(EXIT), t))
        truth.append((fid, entry, t, label))
        return t + 1


def accuracy(
    predicted: np.ndarray, truth: np.ndarray
) -> Dict[str, float]:
    """Compare AD labels with ground truth, keyed on (fid, entry, exit).

    Returns agreement (paper's 'accuracy'), precision, recall, f1.
    """
    def key(a):
        return {(int(r["fid"]), int(r["entry"]), int(r["exit"])) for r in a}

    pred_pos = key(predicted[predicted["label"] == 1])
    true_pos = key(truth[truth["label"] == 1])
    all_calls = key(truth)
    tp = len(pred_pos & true_pos)
    fp = len(pred_pos - true_pos)
    fn = len(true_pos - pred_pos)
    tn = len(all_calls) - tp - fp - fn
    prec = tp / (tp + fp) if tp + fp else 1.0
    rec = tp / (tp + fn) if tp + fn else 1.0
    return {
        "agreement": (tp + tn) / max(len(all_calls), 1),
        "precision": prec,
        "recall": rec,
        "f1": 2 * prec * rec / (prec + rec) if prec + rec else 0.0,
        "n_true_anomalies": float(len(true_pos)),
        "n_pred_anomalies": float(len(pred_pos)),
    }
