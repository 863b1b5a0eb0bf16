"""repro_torch.telemetry -- the port's copies of the monitor's telemetry.

The metrics registry, the span flight recorder, distributed request
tracing and the opt-in self-tracer, copied from ``repro.telemetry``
because the monitor runs through them.  Exposition, build info and
``metrics.snapshot`` / ``spans.dump`` federation are not ported yet
(ROADMAP.md queue 1, item 2).
"""

from . import registry as registry  # noqa: F401  (modules, for `tm.registry`)
from . import ring as ring  # noqa: F401
from . import selftrace as selftrace  # noqa: F401
from . import spans as spans  # noqa: F401
from .registry import (  # noqa: F401
    BUCKET_COUNT,
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    bucket_bounds,
    bucket_index,
    get_registry,
    is_enabled,
    merge_snapshots,
    set_enabled,
)
from .ring import SpanRing, get_ring  # noqa: F401
from .selftrace import SELF_TRACE_PID, SelfTracer, get_self_tracer  # noqa: F401

__all__ = [
    "BUCKET_COUNT",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "SELF_TRACE_PID",
    "SelfTracer",
    "SpanRing",
    "bucket_bounds",
    "bucket_index",
    "get_registry",
    "get_ring",
    "get_self_tracer",
    "is_enabled",
    "merge_snapshots",
    "set_enabled",
]
