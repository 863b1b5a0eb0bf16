"""Opt-in self-tracing: the analyzer's own spans on the workload timeline.

When enabled (``REPRO_SELF_TRACE=1`` or ``SelfTracer.set_enabled(True)``),
instrumented regions -- RPC dispatch, heavy offload jobs, per-stage frame
ingest -- record ``(name, tid, t0_us, dur_us, args)`` spans.  The monitor
drains them each frame and appends them to the live Chrome-trace export
as complete events (``ph: "X"``) in a dedicated process group, so
Perfetto shows the analyzer's overhead on the same timeline as the
workload it analyzes.

Timebase: ``time.perf_counter_ns() // 1000``, deliberately the same
clock as ``repro.trace.tracer.now_us`` (not imported to avoid a package
cycle -- ``repro.trace`` imports the monitor which imports telemetry).
Off by default; when disabled, ``span()`` yields without recording.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["SelfTracer", "get_self_tracer", "SELF_TRACE_PID"]

# Chrome-trace pid for the analyzer's own process group.  Workload pids
# are small rank numbers; 1 << 20 can never collide with them.
SELF_TRACE_PID = 1 << 20


def _now_us() -> int:
    return time.perf_counter_ns() // 1000


class SelfTracer:
    """Thread-safe span recorder.  All state private and lock-guarded."""

    def __init__(self, enabled: Optional[bool] = None) -> None:
        if enabled is None:
            enabled = os.environ.get("REPRO_SELF_TRACE", "0") == "1"
        self._lock = threading.Lock()
        self._enabled = bool(enabled)
        self._spans: List[Tuple[str, int, int, int, Optional[dict]]] = []
        self._tids: Dict[int, int] = {}

    def set_enabled(self, value: bool) -> None:
        with self._lock:
            self._enabled = bool(value)

    @property
    def enabled(self) -> bool:
        with self._lock:
            return self._enabled

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[ident] = tid
        return tid

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Record the enclosed region as a complete event.  Cheap no-op
        when self-tracing is disabled."""
        if not self.enabled:
            yield
            return
        t0 = _now_us()
        try:
            yield
        finally:
            dur = _now_us() - t0
            with self._lock:
                if self._enabled:
                    self._spans.append(
                        (name, self._tid(), t0, dur, args or None)
                    )

    def record(self, name: str, t0_us: int, dur_us: int,
               args: Optional[dict] = None) -> None:
        """Record a span with explicit timestamps (for callers that timed
        the region themselves)."""
        if not self.enabled:
            return
        with self._lock:
            if self._enabled:
                self._spans.append((name, self._tid(), t0_us, dur_us, args))

    def drain(self) -> List[Tuple[str, int, int, int, Optional[dict]]]:
        """Return all recorded spans and clear the buffer."""
        with self._lock:
            spans = self._spans
            self._spans = []
        return spans

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


_tracer_lock = threading.Lock()
_tracer: Optional[SelfTracer] = None


def get_self_tracer() -> SelfTracer:
    """The process-wide self-tracer singleton."""
    global _tracer
    with _tracer_lock:
        if _tracer is None:
            _tracer = SelfTracer()
        return _tracer
