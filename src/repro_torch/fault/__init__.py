"""Crash tolerance for the shard federation (paper §VI at Summit scale).

The analysis fleet must outlive the faults it is supposed to diagnose: a
node-level trace monitor that dies with the first killed helper process is
useless for diagnosing exactly the runs where things go wrong.  This
package hardens the PR 3-8 transport/federation stack end to end:

* :mod:`repro_torch.fault.policy` — one retry/timeout/backoff policy shared by
  the dial loop, the federation stubs, and the supervisor.  Deterministic
  capped exponential backoff (no wallclock reads, no randomness — the
  ``repro_torch.lint`` det rules apply to recovery too).
* :mod:`repro_torch.fault.wal` — a length-prefixed binary write-ahead log of
  applied ``push_rows`` deltas with periodic snapshot compaction, so a
  restarted :class:`~repro_torch.core.ps.PSShard` replays to a **bit-exact**
  table — the PS twin of the provenance JSONL durability story.
* :mod:`repro_torch.fault.health` — process-wide degraded-endpoint board feeding
  the ``/metrics`` gauges and the ``/ws`` health field.
* :mod:`repro_torch.fault.chaos` — deterministic, seed-driven fault injection
  (frame-level flaky proxy, process kills at chosen frame counts, torn
  WAL tails) powering ``tests/test_fault.py`` and
  ``benchmarks/bench_fault.py``.

The supervisor itself lives in :class:`repro_torch.launch.shard_server.
ShardServerPool` (``supervise=True``); the client-side recovery window
lives in :mod:`repro_torch.net.shards`.  ``docs/fault.md`` has the WAL format,
the supervisor lifecycle, and the verb-by-verb retry matrix.
"""
from .health import HealthBoard, get_health
from .policy import RetryPolicy, backoff_delay
from .wal import PSWal, WalCorrupt, read_wal_records

__all__ = [
    "HealthBoard",
    "PSWal",
    "RetryPolicy",
    "WalCorrupt",
    "backoff_delay",
    "get_health",
    "read_wal_records",
]
