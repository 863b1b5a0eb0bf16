"""Trace event model — the TAU/ADIOS2 data schema, adapted.

A copy of ``repro.core.events``: the port keeps its own so that it imports
nothing of ``repro``.

Two event families (paper §III-A):
  * function events: (app, rank, tid, fid, type ENTRY|EXIT, timestamp_us)
  * communication events: (app, rank, tid, tag, partner, bytes, SEND|RECV, ts)

Events arrive in *frames* (the ADIOS2-SST step analogue, ~1/second in the
paper). Within a frame, events are timestamp-sorted per (rank, tid).

Everything is numpy structured arrays so the on-node AD module can process
hundreds of thousands of events per frame without Python-loop overhead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np

ENTRY = np.uint8(0)
EXIT = np.uint8(1)
SEND = np.uint8(0)
RECV = np.uint8(1)

FUNC_EVENT_DTYPE = np.dtype(
    [
        ("app", np.uint32),
        ("rank", np.uint32),
        ("tid", np.uint32),
        ("fid", np.uint32),
        ("etype", np.uint8),  # ENTRY | EXIT
        ("ts", np.uint64),  # microseconds
    ]
)

COMM_EVENT_DTYPE = np.dtype(
    [
        ("app", np.uint32),
        ("rank", np.uint32),
        ("tid", np.uint32),
        ("tag", np.uint32),
        ("partner", np.uint32),  # partner rank
        ("nbytes", np.uint64),
        ("ctype", np.uint8),  # SEND | RECV
        ("ts", np.uint64),
    ]
)

# A completed function call, produced by the call-stack builder.  ``label``
# is filled in by the AD module: 0 = normal, 1 = anomaly, -1 = unlabeled.
EXEC_RECORD_DTYPE = np.dtype(
    [
        ("app", np.uint32),
        ("rank", np.uint32),
        ("tid", np.uint32),
        ("fid", np.uint32),
        ("entry", np.uint64),
        ("exit", np.uint64),
        ("runtime", np.uint64),  # exclusive of nothing: inclusive runtime, us
        ("parent_fid", np.int64),  # -1 when the call is a stack root
        ("depth", np.uint32),
        ("n_children", np.uint32),
        ("n_msgs", np.uint32),
        ("label", np.int8),
    ]
)


def empty_func_events(n: int = 0) -> np.ndarray:
    return np.zeros(n, dtype=FUNC_EVENT_DTYPE)


def empty_comm_events(n: int = 0) -> np.ndarray:
    return np.zeros(n, dtype=COMM_EVENT_DTYPE)


def empty_exec_records(n: int = 0) -> np.ndarray:
    rec = np.zeros(n, dtype=EXEC_RECORD_DTYPE)
    if n:
        rec["label"][:] = -1
        rec["parent_fid"][:] = -1
    return rec


@dataclasses.dataclass
class Frame:
    """One streamed step of trace data for a single rank (SST step analogue)."""

    app: int
    rank: int
    step: int
    func_events: np.ndarray  # FUNC_EVENT_DTYPE, ts-sorted per tid
    comm_events: np.ndarray  # COMM_EVENT_DTYPE, ts-sorted per tid

    def nbytes_raw(self) -> int:
        """Wire size of the unreduced frame — the Fig. 9 'raw trace' baseline."""
        return int(self.func_events.nbytes + self.comm_events.nbytes)

    def __post_init__(self) -> None:
        if self.func_events.dtype != FUNC_EVENT_DTYPE:
            raise TypeError("func_events must use FUNC_EVENT_DTYPE")
        if self.comm_events.dtype != COMM_EVENT_DTYPE:
            raise TypeError("comm_events must use COMM_EVENT_DTYPE")


@dataclasses.dataclass
class FunctionRegistry:
    """fid <-> name mapping shared across the workflow (TAU event table)."""

    names: Dict[int, str] = dataclasses.field(default_factory=dict)
    _ids: Dict[str, int] = dataclasses.field(default_factory=dict)

    def register(self, name: str) -> int:
        if name in self._ids:
            return self._ids[name]
        fid = len(self.names)
        self.names[fid] = name
        self._ids[name] = fid
        return fid

    def name_of(self, fid: int) -> str:
        return self.names.get(int(fid), f"func_{int(fid)}")

    def id_of(self, name: str) -> Optional[int]:
        return self._ids.get(name)

    def __len__(self) -> int:
        return len(self.names)


def make_func_events(
    rows: Iterable[tuple], app: int = 0, rank: int = 0, tid: int = 0
) -> np.ndarray:
    """Convenience builder from (fid, etype, ts) tuples (tests/examples)."""
    rows = list(rows)
    ev = empty_func_events(len(rows))
    ev["app"] = app
    ev["rank"] = rank
    ev["tid"] = tid
    for i, (fid, etype, ts) in enumerate(rows):
        ev["fid"][i] = fid
        ev["etype"][i] = etype
        ev["ts"][i] = ts
    return ev


def concat_frames(frames: List[Frame]) -> Frame:
    """Merge frames of the *same rank* into one (used by offline mode)."""
    assert frames, "need at least one frame"
    rank = frames[0].rank
    app = frames[0].app
    assert all(f.rank == rank for f in frames)
    return Frame(
        app=app,
        rank=rank,
        step=frames[-1].step,
        func_events=np.concatenate([f.func_events for f in frames]),
        comm_events=np.concatenate([f.comm_events for f in frames]),
    )
