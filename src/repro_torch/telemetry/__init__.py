"""repro_torch.telemetry -- self-observability for the analysis fleet.

Metrics registry (Counter / Gauge / log2-bucket Histogram, deterministic
and bitwise-mergeable across shards), Prometheus text exposition,
``metrics.snapshot`` / ``spans.dump`` federation, opt-in self-tracing
into the Chrome-trace export, and distributed request tracing with a
per-process span flight recorder.  See ``docs/telemetry.md``.
"""

from . import registry as registry  # noqa: F401  (modules, for `tm.registry`)
from . import ring as ring  # noqa: F401
from . import selftrace as selftrace  # noqa: F401
from . import spans as spans  # noqa: F401
from .buildinfo import build_info, register_build_info  # noqa: F401
from .exposition import CONTENT_TYPE, parse_exposition, render_exposition  # noqa: F401
from .federate import (  # noqa: F401
    METRICS_SNAPSHOT_VERB,
    SPANS_DUMP_VERB,
    federated_snapshot,
    federated_spans,
    fetch_shard_snapshot,
    fetch_shard_spans,
)
from .ring import SpanRing, get_ring  # noqa: F401
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
from .selftrace import SELF_TRACE_PID, SelfTracer, get_self_tracer  # noqa: F401

__all__ = [
    "BUCKET_COUNT",
    "CONTENT_TYPE",
    "Counter",
    "Gauge",
    "Histogram",
    "METRICS_SNAPSHOT_VERB",
    "MetricRegistry",
    "SELF_TRACE_PID",
    "SPANS_DUMP_VERB",
    "SelfTracer",
    "SpanRing",
    "bucket_bounds",
    "bucket_index",
    "build_info",
    "federated_snapshot",
    "federated_spans",
    "fetch_shard_snapshot",
    "fetch_shard_spans",
    "get_registry",
    "get_ring",
    "get_self_tracer",
    "register_build_info",
    "is_enabled",
    "merge_snapshots",
    "parse_exposition",
    "render_exposition",
    "set_enabled",
]
