"""The port's copy of ``repro.fault.health``, the degraded-endpoint board
that ``ChimbukoMonitor.summary()`` reads.  The write-ahead log, the retry
policy and chaos injection are not ported yet (ROADMAP.md queue 1, item 2).
"""
from .health import HealthBoard, get_health

__all__ = ["HealthBoard", "get_health"]
