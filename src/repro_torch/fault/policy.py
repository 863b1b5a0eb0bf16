"""The federation's one retry/timeout/backoff policy.

Every layer that survives a fault does it through this object: the
:class:`~repro_torch.net.client.RPCClient` dial loop, the recovery window in
:mod:`repro_torch.net.shards`, and the :class:`~repro_torch.launch.shard_server.
ShardServerPool` supervisor.  Centralizing it keeps the failure story
auditable — docs/fault.md's retry matrix is a table over these knobs,
not a scavenger hunt through call sites.

Backoff is *deterministic*: delay ``k`` is ``min(cap, base * 2**k)`` —
a pure function of the attempt index, no wallclock reads and no jitter
(``repro_torch.lint``'s det rules ban both, and reproducible chaos tests need
sleep schedules that are a function of the seed alone).  Jitter's usual
job (decorrelating a reconnect storm) is done here by the *cap*: after
a few doublings every client polls at the cap period, so a restarted
server sees at most ``1/cap`` dials per client per second instead of a
``1/fixed_delay`` hammering.

Only **idempotent** verbs are ever retried.  ``prov.add_many`` carries
per-doc seqs and ``ps.push_rows`` a per-shard push seq, so a replayed
batch whose first delivery *was* applied (the kill landed between apply
and reply) is skipped server-side — ambiguous retries never double-merge
a delta or duplicate a JSONL line.  Non-idempotent or non-replayable
calls (``ps.push`` dense, anything mid-handshake) surface their
:class:`~repro_torch.net.framing.ConnectionLost` to the caller unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator


def backoff_delay(attempt: int, base: float, cap: float) -> float:
    """Deterministic capped exponential backoff: ``min(cap, base * 2**k)``.

    Guarded against overflow for absurd attempt counts; attempt 0 is the
    delay after the *first* failure.
    """
    if base <= 0.0:
        return 0.0
    k = min(max(int(attempt), 0), 63)
    return min(float(cap), float(base) * float(1 << k))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded-retry schedule shared by every recovery path.

    ``retries``     — recovery rounds before the error surfaces.
    ``base_delay``  — backoff after the first failed round (seconds).
    ``max_delay``   — backoff cap (seconds).
    ``probe_every`` — degraded mode: max admissions between reconnect
                      probes (probe spacing doubles 1, 2, 4, ... up to
                      this, so a down shard costs O(log) probes early
                      and a bounded rate after).
    ``spool``       — degraded mode: bounded local queue of unacked
                      deltas/doc batches held for replay on recovery.
                      A full spool escalates to a blocking recovery
                      attempt (backpressure), then surfaces the error.
    """

    retries: int = 4
    base_delay: float = 0.05
    max_delay: float = 2.0
    probe_every: int = 64
    spool: int = 2048

    def delays(self) -> Iterator[float]:
        """The (bounded) sleep schedule between recovery rounds."""
        for attempt in range(max(int(self.retries), 1)):
            yield backoff_delay(attempt, self.base_delay, self.max_delay)


#: Default policy for federations that opt into fault tolerance.
DEFAULT_POLICY = RetryPolicy()
