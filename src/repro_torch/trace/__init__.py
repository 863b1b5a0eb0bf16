"""Tracing substrate: TAU-analogue tracer, SST-analogue streams, monitor
(the port's copies of ``repro.trace``)."""
from . import tracer, stream, monitor  # noqa: F401
