"""Tracing substrate: TAU-analogue tracer and the Chimbuko monitor (copies
of ``repro.trace.tracer`` and ``repro.trace.monitor``)."""
from . import tracer, monitor  # noqa: F401
