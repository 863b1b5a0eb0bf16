"""The program's own spans of a traced run, for the ``program_span`` metrics.

The program records its spans (``repro_torch.telemetry.selftrace``) while
a ``torch.profiler`` records, so in a run's traced segment
(``profile.traced_waves``) and nowhere else; the segment follows the
window, so a run's spans are those that start after the window closed.
A program without the recorder's ``snapshot`` gives none, and every
reader then returns None.  So does a run whose ``model/prefill`` spans
carry no device time, as on the CPU: there the work runs as it is
enqueued, so a span's host time is the compute and not a dispatch, and
the metrics are the card's, like those of the device trace.
"""
from __future__ import annotations

from typing import List, Optional

PREFILL = "model/prefill"  # one a wave: the count every prefill metric divides by


def spans(run) -> List:
    """The resolved spans of ``run``'s traced segment, in the order they ended."""
    try:
        from repro_torch.telemetry.selftrace import get_self_tracer
    except ImportError:
        return []
    snapshot = getattr(get_self_tracer(), "snapshot", None)
    if snapshot is None:
        return []
    t0_us = run.t_close * 1e6  # the window's close, on the spans' clock
    got = [s for s in snapshot() if s.t0_us >= t0_us]
    return got if _on_card(got) else []


def _on_card(spans_: List) -> bool:
    """Whether the segment's prefills were timed on a CUDA card."""
    return any(s.name == PREFILL and s.device_ms is not None for s in spans_)


def under_prefill(spans_: List, name: str) -> List:
    """The spans called ``name`` with a ``model/prefill`` among their ancestors."""
    by_id = {s.id: s for s in spans_}

    def in_prefill(s) -> bool:
        while s.parent in by_id:
            s = by_id[s.parent]
            if s.name == PREFILL:
                return True
        return False

    return [s for s in spans_ if s.name == name and in_prefill(s)]


def device_ms_per_wave(run, name: str) -> Optional[float]:
    """Device ms of the ``name`` spans under ``model/prefill``, summed over
    the traced waves, over the number of waves (``model/prefill`` spans)."""
    got = spans(run)
    waves = [s for s in got if s.name == PREFILL]
    hits = under_prefill(got, name)
    if not waves or not hits or any(s.device_ms is None for s in hits):
        return None
    return sum(s.device_ms for s in hits) / len(waves)
