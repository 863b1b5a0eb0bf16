"""Bounded span ring buffer: the per-process flight recorder.

Every process in the analysis fleet (monitor, gateway, shard workers)
keeps its most recent spans in one :class:`SpanRing` — a lock-disciplined
``deque(maxlen=capacity)`` that is always recording while the tracing
layer (:mod:`repro.telemetry.spans`) is enabled.  Recording is one lock
acquire + one deque append; when the ring wraps, the oldest spans fall
off and ``dropped`` counts them.

A *dump* freezes the ring's current contents into a bounded archive
(keyed by ``(trace_id, span_id)``, so re-dumping is idempotent) and logs
the trigger.  Dumps fire on high-severity anomalies, fault-health
transitions, and the reserved ``spans.dump`` RPC verb — the flight
recorder's whole point is that when something goes wrong the recent past
is already captured before the ring wraps past it.

``collect()`` is the export/federation view: archive first (insertion
order), then any ring spans not already archived — deduplicated by
``(trace_id, span_id)``, which is also what makes ``repro.fault`` replay
safe: a resent write records the *same* deterministic span ids, so the
tree stays single no matter how many times the frame crossed the wire.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = ["SpanRing", "get_ring", "prefer_recording", "DEFAULT_CAPACITY"]

# Ring capacity (spans per process).  A span dict is ~200 bytes; the
# default bounds the recorder around a few MiB.  Override with
# REPRO_SPANS_RING (inherited by spawned shard workers).
DEFAULT_CAPACITY = 16384

# The archive holds at most this many dumped spans (oldest evicted).
ARCHIVE_FACTOR = 4

# Trigger log length: enough to see *why* the recorder dumped recently.
TRIGGER_LOG = 64


def prefer_recording(old: Optional[dict], new: dict) -> dict:
    """Dedup preference for two recordings of the same (trace, span) id:
    a successful recording supersedes an err'd one — the err marks a
    failed delivery *attempt* (recorded so the flight recorder shows
    it), not the logical operation, which a replay then completed.  An
    err'd recording never displaces a successful one, so a crash-replay
    run's collected view matches the no-fault run's span for span."""
    if old is not None and old.get("err") and not new.get("err"):
        return new
    if old is not None and not old.get("err") and new.get("err"):
        return old
    return new


class SpanRing:
    """Thread-safe bounded span buffer + dump archive.  All state is
    private and guarded by the ring's own lock; every method is a short
    critical section safe to call from the event-loop thread."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        if capacity is None:
            capacity = int(os.environ.get("REPRO_SPANS_RING", DEFAULT_CAPACITY))
        self._lock = threading.Lock()
        self._capacity = max(int(capacity), 1)
        self._ring: deque = deque(maxlen=self._capacity)
        self._archive: Dict[Tuple[int, int], dict] = {}
        self._archive_max = self._capacity * ARCHIVE_FACTOR
        self._triggers: deque = deque(maxlen=TRIGGER_LOG)
        self._recorded = 0
        self._archive_dropped = 0

    @property
    def capacity(self) -> int:
        return self._capacity

    # ------------------------------------------------------------ recording
    def record(self, span: dict) -> None:
        """Append one span (the hot path: one lock + one deque append)."""
        with self._lock:
            self._ring.append(span)
            self._recorded += 1

    # -------------------------------------------------------------- dumping
    def dump(self, reason: str) -> int:
        """Freeze the ring's current contents into the archive.

        Idempotent per span: re-dumping the same (trace, span) ids
        overwrites in place.  Returns the number of spans archived."""
        with self._lock:
            spans = list(self._ring)
            n = 0
            for span in spans:
                key = (span["trace"], span["span"])
                if key not in self._archive:
                    n += 1
                self._archive[key] = prefer_recording(self._archive.get(key), span)
            while len(self._archive) > self._archive_max:
                self._archive.pop(next(iter(self._archive)))
                self._archive_dropped += 1
            self._triggers.append({"reason": reason, "spans": len(spans)})
            return n

    def absorb(self, spans: List[dict]) -> int:
        """Merge externally-fetched spans (a remote ring's dump) into the
        archive — the federation path.  Same dedup key, same bound."""
        with self._lock:
            n = 0
            for span in spans:
                key = (span["trace"], span["span"])
                if key not in self._archive:
                    n += 1
                self._archive[key] = prefer_recording(self._archive.get(key), span)
            while len(self._archive) > self._archive_max:
                self._archive.pop(next(iter(self._archive)))
                self._archive_dropped += 1
            return n

    # -------------------------------------------------------------- queries
    def snapshot(self) -> List[dict]:
        """The live ring's contents, oldest first (no archive)."""
        with self._lock:
            return list(self._ring)

    def collect(self) -> List[dict]:
        """Archive + live ring, deduplicated by (trace, span) ids, in
        insertion order (archive first).  This is what ``spans.dump``
        returns and what the export renders."""
        with self._lock:
            out: Dict[Tuple[int, int], dict] = dict(self._archive)
            for span in self._ring:
                key = (span["trace"], span["span"])
                out[key] = prefer_recording(out.get(key), span)
            return list(out.values())

    def triggers(self) -> List[dict]:
        with self._lock:
            return list(self._triggers)

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self._capacity,
                "live": len(self._ring),
                "archived": len(self._archive),
                "recorded": self._recorded,
                "archive_dropped": self._archive_dropped,
            }

    def clear(self) -> None:
        """Drop everything (tests and per-run isolation)."""
        with self._lock:
            self._ring.clear()
            self._archive.clear()
            self._triggers.clear()
            self._recorded = 0
            self._archive_dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


_ring_lock = threading.Lock()
_ring: Optional[SpanRing] = None


def get_ring() -> SpanRing:
    """The process-wide span ring singleton."""
    global _ring
    with _ring_lock:
        if _ring is None:
            _ring = SpanRing()
        return _ring
