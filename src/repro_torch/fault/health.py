"""Process-wide degraded-endpoint board: the fleet's health word.

The recovery windows in :mod:`repro.net.shards` mark an endpoint degraded
when it stops answering and recovered when its replay completes.  Everything
that reports health reads this one board: the ``/metrics`` gauges
(``repro_fault_degraded_endpoints``, ``repro_fault_spooled_entries``), the
``health`` field the viz gateway rides on every ``/ws`` frame, and
``ChimbukoMonitor.summary()``.  One lock, tiny critical sections — the
board sits on the push hot path only as a set lookup.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List

from ..telemetry import registry as telemetry

__all__ = ["HealthBoard", "get_health"]


class HealthBoard:
    """Thread-safe registry of degraded endpoints + spooled-entry counts."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._degraded: Dict[str, int] = {}  # endpoint -> spooled entries
        self._listeners: List[Callable[[str, str], None]] = []
        reg = telemetry.get_registry()
        self._m_degraded = reg.gauge(
            "repro_fault_degraded_endpoints",
            "Shard endpoints currently unreachable (writes spooling locally).",
        )
        self._m_spooled = reg.gauge(
            "repro_fault_spooled_entries",
            "Unacked write batches spooled for replay across all endpoints.",
        )
        self._m_recoveries = reg.counter(
            "repro_fault_recoveries_total",
            "Successful shard recoveries (reconfigure + spool replay).",
        )
        self._m_replayed = reg.counter(
            "repro_fault_replayed_total",
            "Write batches re-sent to a recovered shard (dedup'd server-side).",
        )

    # ------------------------------------------------------------- mutation
    def mark_degraded(self, endpoint: str, spooled: int = 0) -> None:
        with self._lock:
            transition = endpoint not in self._degraded
            self._degraded[endpoint] = int(spooled)
            self._publish_locked()
        if transition:
            self._notify("degraded", endpoint)

    def mark_recovered(self, endpoint: str, replayed: int = 0) -> None:
        with self._lock:
            was = self._degraded.pop(endpoint, None)
            self._publish_locked()
        if was is not None:
            self._m_recoveries.inc()
            self._notify("recovered", endpoint)
        if replayed:
            self._m_replayed.inc(replayed)

    # ------------------------------------------------------------ listeners
    def add_listener(self, fn: Callable[[str, str], None]) -> None:
        """Register ``fn(event, endpoint)`` for degraded/recovered
        transitions (the spans flight recorder dumps on these).  Called
        outside the board's lock, on the thread that flipped the state."""
        with self._lock:
            self._listeners.append(fn)

    def _notify(self, event: str, endpoint: str) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            fn(event, endpoint)

    def _publish_locked(self) -> None:  # lint: ignore[lockset-mixed] — caller holds self._lock
        self._m_degraded.set(len(self._degraded))
        self._m_spooled.set(sum(self._degraded.values()))

    # -------------------------------------------------------------- queries
    def degraded(self) -> List[str]:
        with self._lock:
            return sorted(self._degraded)

    def snapshot(self) -> dict:
        """The ``/ws`` health field: ok flag + who is down + spool depth."""
        with self._lock:
            return {
                "ok": not self._degraded,
                "degraded": sorted(self._degraded),
                "spooled": sum(self._degraded.values()),
            }


_board: HealthBoard = None
_board_lock = threading.Lock()


def get_health() -> HealthBoard:
    """The process-wide board (created lazily: gauges register on first use)."""
    global _board
    if _board is None:
        with _board_lock:
            if _board is None:
                _board = HealthBoard()
    return _board
