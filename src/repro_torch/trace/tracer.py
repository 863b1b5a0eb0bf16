"""TAU-analogue instrumentation: first-person, per-thread trace events.

``Tracer`` collects ENTRY/EXIT function events (μs timestamps) and
communication events into per-step frames — the same schema the paper's TAU
+ ADIOS2 plugin streams (§II-C).  Instrumentation is explicit (context
managers / decorators): interrupt-based sampling does not port, which
DESIGN.md §2 records as an assumption change.

Filtering: functions registered with ``filterable=True`` model TAU's
selective instrumentation of high-frequency/short functions; an unfiltered
tracer keeps them (the Fig. 9 'full' series).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.events import (
    COMM_EVENT_DTYPE,
    ENTRY,
    EXIT,
    FUNC_EVENT_DTYPE,
    Frame,
    FunctionRegistry,
    empty_comm_events,
    empty_func_events,
)


def now_us() -> int:
    return time.perf_counter_ns() // 1000


class Tracer:
    """One per (app, rank); thread-safe; drained once per step into a Frame."""

    def __init__(
        self,
        registry: Optional[FunctionRegistry] = None,
        app: int = 0,
        rank: int = 0,
        filtered: bool = True,
    ):
        self.registry = registry or FunctionRegistry()
        self.app = app
        self.rank = rank
        self.filtered = filtered
        self._filterable: Set[int] = set()
        self._func_rows: List[Tuple[int, int, int, int]] = []  # tid, fid, etype, ts
        self._comm_rows: List[Tuple[int, int, int, int, int, int]] = []
        self._lock = threading.Lock()
        self.n_dropped = 0  # filtered-out event count (reduction accounting)

    def register(self, name: str, filterable: bool = False) -> int:
        fid = self.registry.register(name)
        if filterable:
            self._filterable.add(fid)
        return fid

    @contextlib.contextmanager
    def span(self, name: str, filterable: bool = False):
        fid = self.register(name, filterable)
        if self.filtered and fid in self._filterable:
            self.n_dropped += 2
            yield
            return
        tid = threading.get_ident() % 2**31
        with self._lock:
            self._func_rows.append((tid, fid, int(ENTRY), now_us()))
        try:
            yield
        finally:
            with self._lock:
                self._func_rows.append((tid, fid, int(EXIT), now_us()))

    def fn(self, name: str, filterable: bool = False):
        """Decorator form of span()."""

        def deco(f):
            def wrapper(*a, **kw):
                with self.span(name, filterable):
                    return f(*a, **kw)

            return wrapper

        return deco

    def comm(self, partner: int, nbytes: int, kind: int = 0, tag: int = 0) -> None:
        tid = threading.get_ident() % 2**31
        with self._lock:
            self._comm_rows.append((tid, tag, partner, nbytes, kind, now_us()))

    def drain(self, step: int) -> Frame:
        """Cut a frame (the once-per-second ADIOS2 step in the paper)."""
        with self._lock:
            frows, crows = self._func_rows, self._comm_rows
            self._func_rows, self._comm_rows = [], []
        fe = empty_func_events(len(frows))
        for i, (tid, fid, etype, ts) in enumerate(frows):
            fe["tid"][i], fe["fid"][i], fe["etype"][i], fe["ts"][i] = tid, fid, etype, ts
        fe["app"], fe["rank"] = self.app, self.rank
        ce = empty_comm_events(len(crows))
        for i, (tid, tag, partner, nbytes, kind, ts) in enumerate(crows):
            ce["tid"][i], ce["tag"][i], ce["partner"][i] = tid, tag, partner
            ce["nbytes"][i], ce["ctype"][i], ce["ts"][i] = nbytes, kind, ts
        ce["app"], ce["rank"] = self.app, self.rank
        fe = fe[np.argsort(fe["ts"], kind="stable")]
        ce = ce[np.argsort(ce["ts"], kind="stable")]
        return Frame(self.app, self.rank, step, fe, ce)
