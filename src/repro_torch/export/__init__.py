"""``repro_torch.export`` — streaming Perfetto / Chrome-trace export (the
port's copy of ``repro.export``; a trace written here is byte-identical to
the JAX package's for the same frames).

The paper's visualization module presents call stacks and timelines online
(§IV, Figs. 5/6); this package gives the reduced record stream and the
provenance windows a *standard* rendering surface instead: Trace Event
Format JSON that loads directly into ``ui.perfetto.dev`` or
``chrome://tracing`` with zero custom UI work.

  * :mod:`repro_torch.export.chrome_trace` — :class:`ChromeTraceWriter`, a
    streaming Trace Event Format writer (B/E duration events reconstructed
    from the call-stack builder's records, one track per (rank, tid),
    counter tracks for the AD statistics stream, anomaly instants linking
    back to provenance doc ids) plus :func:`validate_trace`, the schema /
    stack-well-formedness checker tests and CI run.
  * :mod:`repro_torch.export.record_stream` — the persisted reduced record
    stream (``stream.jsonl`` in a monitor output dir) and
    :func:`export_stream`, the offline replay of that stream through the
    writer.
  * :mod:`repro_torch.export.provenance_export` — render a federated provenance
    query result (from shard JSONL files or live shard endpoints) as a
    self-contained trace of each anomaly's provenance window.
  * :mod:`repro_torch.export.cli` — ``python -m repro_torch.export``.

See ``docs/export.md`` for the event mapping table and conventions.
"""
from .chrome_trace import ChromeTraceWriter, validate_trace
from .provenance_export import (
    load_provenance_docs,
    query_live_endpoints,
    render_provenance_trace,
)
from .record_stream import RecordStreamWriter, export_stream, iter_stream_frames

__all__ = [
    "ChromeTraceWriter",
    "RecordStreamWriter",
    "export_stream",
    "iter_stream_frames",
    "load_provenance_docs",
    "query_live_endpoints",
    "render_provenance_trace",
    "validate_trace",
]
