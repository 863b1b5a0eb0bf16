"""PS and provenance shards behind the RPC transport.

Server side, :class:`PSShardService` / :class:`ProvenanceShardService` host
one :class:`~repro_torch.core.ps.PSShard` / :class:`~repro_torch.core.provenance.\
ProvenanceShard` each behind a registered method table (``ps.*`` / ``prov.*``
namespaces — one worker process can host both).  Shards are created lazily by
a ``*.configure`` call from the federation front-end, so worker processes are
generic "shard hosts" that need no topology knowledge at spawn time.  Bulk
read methods (``prov.query``, ``prov.dump``, ``ps.peek_table``, ...) are
registered ``heavy=True`` so the event-loop server runs them on worker
threads while the ``ps.push`` / ``prov.add_many`` hot path stays inline on
the loop.

Client side, :class:`RemotePSShard` / :class:`RemoteProvenanceShard` satisfy
the exact method/attribute surface :class:`~repro_torch.core.ps.FederatedPS` and
:class:`~repro_torch.core.provenance.FederatedProvenanceDB` consume from their
local counterparts, so ``transport="socket"`` is a drop-in shard swap with
zero behavioral drift:

  * stats rows travel as raw float64 ndarray bytes (never through text), so
    the server-side ``merge_moments`` sees bit-identical operands and the
    federation's PS bit-match guarantee survives the wire.  The hot path
    (``push_nowait``) ships only the delta's *non-empty* rows plus their
    indices — merging an empty row is a bitwise no-op (stats.py), so the
    sparse push is bit-identical to the full slice at a fraction of the
    bytes and merge work;
  * provenance docs travel as the same JSON objects the local shard would
    have indexed, and the server assigns/persists the same global ``seq``,
    so federated query results and shard JSONL files are byte-identical to
    local mode.  Small doc adds are coalesced client-side and shipped as
    single ``prov.add_many`` frames.

Stubs talking to the same endpoint share one multiplexed connection
(:meth:`RPCClient.shared`).  The ``*_nowait`` methods are the asynchronous
hot path: they put a request on the wire and return, tracking the future in
a bounded in-flight window.  Because the server executes a connection's
requests strictly in order, any later *call* (query, peek_table, stats,
dump) observes every ``nowait`` write that preceded it — reads need no
explicit barrier.  Errors from fire-and-forget writes are surfaced loudly
on the next operation or on :meth:`drain`; the window cap turns a
persistently slow shard into caller backpressure instead of unbounded
client memory.
"""
from __future__ import annotations

import collections
import concurrent.futures
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.provenance import ProvenanceShard
from repro_torch.core.ps import PSShard
from repro_torch.fault.health import get_health
from repro_torch.fault.policy import RetryPolicy, backoff_delay
from repro_torch.telemetry import spans

from .client import RPCClient
from .framing import ConnectionLost, RemoteError, RPCError
from .server import MethodTable


def _require(shard, what: str):
    if shard is None:
        raise RPCError(f"{what} shard not configured (call {what}.configure first)")
    return shard


# --------------------------------------------------------------------- server
class PSShardService:
    """Hosts one PSShard; registers the ``ps.*`` method namespace."""

    def __init__(self) -> None:
        self._shard: Optional[PSShard] = None

    def register(self, table: MethodTable) -> "PSShardService":
        # configure may open + replay a write-ahead log (filesystem work):
        # heavy, like prov.configure — per-connection FIFO still guarantees
        # pushes sent after it execute after it.
        table.register("ps.configure", self._configure, heavy=True)
        table.register("ps.push", self._push)
        table.register("ps.push_rows", self._push_rows)
        table.register("ps.grow", self._grow)
        table.register("ps.peek_table", self._peek_table, heavy=True)
        table.register("ps.peek_rows", self._peek_rows, heavy=True)
        table.register("ps.stats", self._stats)
        table.register_closer(self._close)
        return self

    def _close(self) -> None:
        if self._shard is not None:
            self._shard.close()
            self._shard = None

    def _configure(self, env, arrays):
        # (Re)configure resets the shard: each federation front-end owns the
        # worker's PS state for its lifetime.  With ``wal`` set the shard
        # logs applied deltas to that path; ``wal_reset=False`` (the crash
        # -recovery reconfigure) replays an existing log instead of starting
        # fresh, restoring a bit-exact table + push count + dedup seq.
        wal = None
        if env.get("wal"):
            from repro_torch.fault.wal import PSWal  # lazy: fault is optional here

            wal = PSWal(
                env["wal"],
                compact_every=int(env.get("wal_compact_every", 1024)),
                reset=bool(env.get("wal_reset", True)),
            )
        if self._shard is not None:
            self._shard.close()
        self._shard = PSShard(
            int(env["shard_id"]), int(env["num_shards"]), int(env["num_funcs"]),
            wal=wal,
        )
        return {"last_push_seq": self._shard.last_push_seq}, ()

    # Handlers bind the shard through an annotated local: the annotation is
    # what lets repro_torch.lint resolve `shard.push(...)` to PSShard (not the
    # same-named client wrappers) when classifying thread contexts.
    def _push(self, env, arrays):
        shard: PSShard = _require(self._shard, "ps")
        shard.push(np.asarray(arrays[0], dtype=np.float64))
        return {}, ()

    def _push_rows(self, env, arrays):
        # Sparse push: only the delta's non-empty rows travel; rows_total
        # carries the full slice length so growth matches the dense path.
        # ``seq`` (when the stub assigns one) makes the verb idempotent: a
        # replayed batch whose first delivery was applied is skipped.
        shard: PSShard = _require(self._shard, "ps")
        seq = env.get("seq")
        # The apply span nests under the server span _run_traced armed (a
        # no-op otherwise), so the PS merge shows up as its own region in
        # the cross-process trace tree.
        with spans.span("ps.apply"):
            shard.push_rows(
                np.asarray(arrays[0], dtype=np.int64),
                np.asarray(arrays[1], dtype=np.float64),
                int(env["rows_total"]),
                seq=None if seq is None else int(seq),
            )
        return {}, ()

    def _grow(self, env, arrays):
        shard: PSShard = _require(self._shard, "ps")
        shard.grow(int(env["num_rows"]))
        return {}, ()

    def _peek_table(self, env, arrays):
        # Locked copy: push_rows mutates the table in place, and this
        # handler runs on a worker thread concurrent with inline pushes.
        shard: PSShard = _require(self._shard, "ps")
        return {}, (shard.peek_table_locked(),)

    def _peek_rows(self, env, arrays):
        # Dirty-row delta peek (federation aggregate refresh): ships only
        # the rows pushes touched since the last peek — O(changed) bytes.
        # PSShard.peek_rows takes the shard lock, so the worker-thread read
        # is consistent with inline pushes; connection FIFO guarantees it
        # reflects every push that preceded it on the caller's connection.
        shard: PSShard = _require(self._shard, "ps")
        idx, rows = shard.peek_rows()
        return {}, (idx, rows)

    def _stats(self, env, arrays):
        shard: PSShard = _require(self._shard, "ps")
        return {
            "n_pushes": shard.n_pushes,
            "num_funcs": shard.stats.num_funcs,
            "shard_id": shard.shard_id,
            "num_shards": shard.num_shards,
            "last_push_seq": shard.last_push_seq,
            "wal_bytes": shard.wal.size_bytes() if shard.wal is not None else 0,
        }, ()


class ProvenanceShardService:
    """Hosts one ProvenanceShard; registers the ``prov.*`` method namespace.

    The event-loop server runs heavy reads (query/dump/take_resumed) on
    worker threads concurrently with inline adds on the loop thread.
    *Mutations* serialize on the service lock (they are all fast, so the
    loop never blocks long); *reads* run lock-free against the shard's
    append-only structures (see the ProvenanceShard concurrency contract) —
    a long query scan must never make the loop thread wait, or one slow
    viz drill-down would stall every connection on the worker.
    """

    def __init__(self) -> None:
        self._shard: Optional[ProvenanceShard] = None
        self._durable = False
        self._lock = threading.Lock()

    def register(self, table: MethodTable) -> "ProvenanceShardService":
        # configure/flush/close hit the filesystem (mkdir/open/flush/close)
        # and so must not run inline on the event-loop thread: one slow disk
        # would stall every connection (repro_torch.lint: loop-blocking-io).
        # Heavy offload is safe because _drain_pending keeps per-connection
        # FIFO across light/heavy handlers — a connection's add after its
        # configure still executes after it.
        table.register("prov.configure", self._configure, heavy=True)
        table.register("prov.add", self._add)
        table.register("prov.add_many", self._add_many)
        table.register("prov.query", self._query, heavy=True)
        table.register("prov.take_resumed", self._take_resumed, heavy=True)
        table.register("prov.dump", self._dump, heavy=True)
        table.register("prov.len", self._len)
        table.register("prov.flush", self._flush, heavy=True)
        table.register("prov.close", self._close, heavy=True)
        table.register_closer(self._shutdown)
        return self

    def _shutdown(self) -> None:
        with self._lock:
            if self._shard is not None:
                self._shard.close()
                self._shard = None

    def _configure(self, env, arrays):
        # ``recover=True`` is the crash-recovery reconfigure: the shard
        # re-reads its own JSONL file (truncating a torn tail first) and
        # rebuilds its indexes *and* its seq dedup horizon in place, so
        # batches the front-end replays afterwards extend the file instead
        # of duplicating lines.  ``durable=True`` flushes the file after
        # every applied write, making acked docs SIGKILL-safe.
        with self._lock:
            if self._shard is not None:
                self._shard.close()
            self._shard = ProvenanceShard(
                path=env.get("path"),
                append=bool(env.get("append", False)),
                header=env.get("header"),
                recover=bool(env.get("recover", False)),
            )
            self._durable = bool(env.get("durable", False))
            return {"n": len(self._shard)}, ()

    def _add(self, env, arrays):
        with self._lock:
            shard: ProvenanceShard = _require(self._shard, "prov")
            shard.add(
                env["doc"], int(env["seq"]), write=bool(env.get("write", True))
            )
            if self._durable:
                shard.flush()
        return {}, ()

    def _add_many(self, env, arrays):
        """One frame, many docs: the client-side coalescing endpoint.

        Docs are applied in order; ``ProvenanceShard.add`` skips seqs it has
        already applied, so a retried batch (connection killed between the
        server applying it and the client seeing the response) never
        duplicates a doc or a JSONL line.
        """
        with spans.span("prov.ingest"):
            with self._lock:
                shard: ProvenanceShard = _require(self._shard, "prov")
                write = bool(env.get("write", True))
                for doc, seq in zip(env["docs"], env["seqs"]):
                    shard.add(doc, int(seq), write=write)
                if self._durable:
                    # Durable ack: the response must imply OS-visible bytes.
                    # One small buffered-file flush per *batch*, same cost
                    # class as the inline writes above.
                    shard.flush()
        return {"n": len(env["docs"])}, ()

    def _query(self, env, arrays):
        # Lock-free read: shard structures are append-only and positions are
        # published only after their doc/seq are in place.
        shard: ProvenanceShard = _require(self._shard, "prov")  # lint: ignore[lockset-mixed] — deliberate lock-free reference read; see contract above
        hits = shard.query(
            rank=env.get("rank"), fid=env.get("fid"), step=env.get("step"),
            t0=env.get("t0"), t1=env.get("t1"), func=env.get("func"),
            severity=env.get("severity"), min_severity=env.get("min_severity"),
        )
        return {"hits": [[seq, doc] for seq, doc in hits]}, ()

    def _take_resumed(self, env, arrays):
        with self._lock:  # mutation (swaps the resumed list), but O(1)
            shard: ProvenanceShard = _require(self._shard, "prov")
            return {"docs": shard.take_resumed()}, ()

    def _dump(self, env, arrays):
        # Lock-free read; zip truncates to the shorter list, so a racing
        # add can only make the dump a consistent prefix.
        shard: ProvenanceShard = _require(self._shard, "prov")  # lint: ignore[lockset-mixed] — deliberate lock-free reference read; see contract above
        return {"hits": [[seq, doc] for seq, doc in zip(shard.seqs, shard.docs)]}, ()

    def _len(self, env, arrays):
        with self._lock:
            shard: ProvenanceShard = _require(self._shard, "prov")
            return {"n": len(shard)}, ()

    def _flush(self, env, arrays):
        with self._lock:
            shard: ProvenanceShard = _require(self._shard, "prov")
            shard.flush()
        return {}, ()

    def _close(self, env, arrays):
        with self._lock:
            if self._shard is not None:
                self._shard.close()
        return {}, ()


def _metrics_snapshot(env, arrays):
    """Reserved ``metrics.snapshot`` verb: this process's registry state.

    The front-end federates these (``repro_torch.telemetry.federate``) the same
    way ``FederatedPS`` federates rows — histogram vectors are integers,
    so the merge is exact regardless of arrival order.
    """
    from ..telemetry.registry import get_registry

    return {"snapshot": get_registry().snapshot()}, ()


def _spans_dump(env, arrays):
    """Reserved ``spans.dump`` verb: this process's span flight recorder.

    With ``dump`` set the ring is frozen into the archive first (the
    on-demand flight-recorder trigger); either way the reply carries the
    deduplicated archive+ring view, the recent trigger log, and the ring
    stats.  Spans federate like metrics do — ids are deterministic, so
    the front-end's merge is order-independent.
    """
    from ..telemetry.ring import get_ring

    ring = get_ring()
    if env.get("dump"):
        ring.dump(str(env.get("reason", "rpc:spans.dump")))
    return {
        "spans": ring.collect(),
        "triggers": ring.triggers(),
        "stats": ring.stats(),
    }, ()


def build_shard_table(kind: str = "both") -> MethodTable:
    """Method table for one shard-host worker: ``ps``, ``prov``, or ``both``."""
    if kind not in ("ps", "prov", "both"):
        raise ValueError(f"kind must be 'ps', 'prov', or 'both', got {kind!r}")
    table = MethodTable()
    if kind in ("ps", "both"):
        PSShardService().register(table)
    if kind in ("prov", "both"):
        ProvenanceShardService().register(table)
    # Every shard host is self-observable: snapshot serialization walks the
    # whole registry, so it runs heavy (off the event loop) like the other
    # bulk reads.
    table.register("metrics.snapshot", _metrics_snapshot, heavy=True)
    table.register("spans.dump", _spans_dump, heavy=True)
    return table


# --------------------------------------------------------------------- client
class _Entry:
    """One tracked fire-and-forget write: its live future (None while the
    write is spooled during an outage) and, in fault-tolerant mode, the
    closure that puts an identical frame back on the wire after recovery."""

    __slots__ = ("fut", "resend")

    def __init__(
        self,
        fut: Optional[concurrent.futures.Future] = None,
        resend: Optional[Callable[[], concurrent.futures.Future]] = None,
    ):
        self.fut = fut
        self.resend = resend


class _InflightWindow:
    """Bounded fire-and-forget bookkeeping shared by the remote stubs — and,
    when a :class:`~repro_torch.fault.policy.RetryPolicy` is attached, the shard's
    recovery window.

    Plain mode (``policy=None``, the pre-fault behavior): ``admit`` tracks a
    future, ``reap`` pops completed ones from the head and rethrows their
    errors, ``admit`` blocks when the window is full (client-side
    backpressure), ``drain`` waits everything out.

    Fault-tolerant mode adds three behaviors, all keyed on
    :class:`ConnectionLost` (every other error stays loud in both modes):

    * entries are held until their future *succeeds*, each with a resend
      closure — an acked-by-the-OS-but-unprocessed write is never the only
      copy;
    * :meth:`recover_blocking` runs bounded recovery rounds (deterministic
      capped-exponential pauses between rounds): one dial attempt, the
      stub's re-configure (WAL / JSONL replay server-side), then an ordered
      re-send of every unacked entry.  Duplicates are impossible — both
      shard kinds dedup by per-entry seq;
    * if recovery rounds exhaust, the window goes *degraded*: ``submit``
      spools closures locally (bounded by ``policy.spool``) and probes the
      endpoint at count-doubling admission intervals, so the caller keeps
      analyzing through the outage and the backlog replays on the first
      successful probe.  A full spool forces blocking recovery — surfacing
      the outage rather than growing without bound.
    """

    def __init__(
        self,
        client: RPCClient,
        limit: int,
        policy: Optional[RetryPolicy] = None,
        reconfigure: Optional[Callable[[], None]] = None,
        label: str = "",
    ):
        self._client = client
        self._limit = max(int(limit), 1)
        self._entries: Deque[_Entry] = collections.deque()
        self._lock = threading.Lock()
        self._policy = policy
        self._reconfigure = reconfigure
        self._label = label
        self._degraded = False
        # Probe pacing is admission-count based (1, 2, 4, ... capped at
        # policy.probe_every), not wallclock based: deterministic for a
        # deterministic caller, and it needs no timer thread.
        self._probe_gap = 1
        self._probe_in = 1
        self._recover_lock = threading.RLock()
        # Connection generation the stub last configured on: lets submit
        # notice a connection that bounced while the window was empty (the
        # client redials transparently — possibly to a blank respawned
        # worker that needs its recovery reconfigure before any write).
        self._conf_gen = 0

    # ------------------------------------------------------------ primitives
    def _recoverable(self, exc: BaseException) -> bool:
        if self._policy is None:
            return False
        if isinstance(exc, ConnectionLost):
            return True
        # "shard not configured": the request reached a *blank* respawned
        # worker (it raised before mutating anything) — exactly the state
        # the recovery reconfigure + replay repairs.
        return isinstance(exc, RemoteError) and "not configured" in str(exc)

    def note_configured(self) -> None:
        """Stub callback after a successful configure: remember the
        connection generation it ran on."""
        with self._lock:
            self._conf_gen = self._client.generation

    def _pop_if_head(self, entry: _Entry) -> None:
        with self._lock:
            if self._entries and self._entries[0] is entry:
                self._entries.popleft()

    def reap(self) -> None:
        """Pop acked writes from the head; rethrow non-recoverable errors.

        A recoverable (ConnectionLost) completion triggers blocking
        recovery instead of popping — the entry's payload is about to be
        replayed, not discarded."""
        while True:
            with self._lock:
                if not self._entries:
                    return
                head = self._entries[0]
            fut = head.fut
            if fut is None or not fut.done():
                return
            exc = fut.exception()
            if exc is None:
                self._pop_if_head(head)
                continue
            if self._recoverable(exc):
                self.recover_blocking()
                continue
            self._pop_if_head(head)
            raise exc

    # -------------------------------------------------------------- recovery
    def recover_blocking(self) -> None:
        """Reconnect + re-configure + ordered replay, retried with
        deterministic capped-exponential pauses; raises :class:`ConnectionLost`
        (and leaves the window degraded) when every round fails."""
        with self._recover_lock:
            last: Optional[ConnectionLost] = None
            for attempt in range(max(self._policy.retries, 1)):
                if attempt:
                    time.sleep(
                        backoff_delay(
                            attempt - 1, self._policy.base_delay, self._policy.max_delay
                        )
                    )
                try:
                    self._do_recover()
                    return
                except ConnectionLost as exc:
                    last = exc
            self._enter_degraded()
            if last is None:
                last = ConnectionLost(f"shard {self._label} unrecoverable")
            raise last

    def _do_recover(self) -> None:
        """One recovery round: the stub's reconfigure (raises ConnectionLost
        while the endpoint is down), then re-send every unacked entry in
        order on the fresh connection.  Entries keep their closures until
        acked, so a round that dies mid-replay just leaves them for the
        next round; server-side seq dedup absorbs the repeats."""
        self._reconfigure()
        with self._lock:
            self._conf_gen = self._client.generation
            entries = list(self._entries)
        replayed = 0
        for entry in entries:
            entry.fut = entry.resend()
            replayed += 1
        self._client.flush_sends()
        with self._lock:
            was_degraded = self._degraded
            self._degraded = False
            self._probe_gap = self._probe_in = 1
        if was_degraded or replayed:
            get_health().mark_recovered(self._label, replayed)

    def _enter_degraded(self) -> None:
        with self._lock:
            already = self._degraded
            self._degraded = True
            self._probe_gap = self._probe_in = 1
            n = len(self._entries)
        if not already:
            get_health().mark_degraded(self._label, n)

    def _maybe_probe(self) -> None:
        with self._lock:
            self._probe_in -= 1
            if self._probe_in > 0:
                return
            self._probe_gap = min(self._probe_gap * 2, max(self._policy.probe_every, 1))
            self._probe_in = self._probe_gap
        if not self._client.try_dial():
            return  # still down; keep spooling
        try:
            with self._recover_lock:
                self._do_recover()
        except ConnectionLost:
            pass  # came up and died again; stay degraded

    # ------------------------------------------------------------- admission
    def admit(self, fut: concurrent.futures.Future) -> None:
        """Plain-mode admission: track an already-sent future."""
        self.reap()
        self._append_with_backpressure(_Entry(fut=fut))

    def submit(self, resend: Callable[[], concurrent.futures.Future]) -> None:
        """Fault-tolerant admission: send via ``resend()`` (or spool it when
        degraded) and keep the closure until the write is acked."""
        entry = _Entry(resend=resend)
        with self._lock:
            degraded = self._degraded
        if degraded:
            self._spool(entry)
            return
        try:
            self.reap()
            if self._stale_generation():
                # The connection bounced while the window was empty: the
                # worker may be a blank respawn — reconfigure (+ replay)
                # before this write, or it lands on unconfigured state.
                with self._recover_lock:
                    if self._stale_generation():
                        self._do_recover()
            entry.fut = resend()
        except ConnectionLost:
            self._enter_degraded()
            self._spool(entry)
            return
        self._append_with_backpressure(entry)

    def _stale_generation(self) -> bool:
        with self._lock:
            return self._client.generation != self._conf_gen

    def _spool(self, entry: _Entry) -> None:
        with self._lock:
            self._entries.append(entry)
            n = len(self._entries)
        get_health().mark_degraded(self._label, n)
        if n > max(self._policy.spool, 1):
            # Bounded local queue is full: stop absorbing the outage and
            # block on recovery (the entry is already spooled, so success
            # replays it; failure surfaces ConnectionLost to the caller).
            self.recover_blocking()
            return
        self._maybe_probe()

    def _append_with_backpressure(self, entry: _Entry) -> None:
        while True:
            with self._lock:
                if len(self._entries) < self._limit:
                    self._entries.append(entry)
                    return
                head = self._entries[0]
            self._wait_head(head)  # window full: wait for the head

    def _wait_head(self, head: _Entry) -> None:
        fut = head.fut
        if fut is None:
            # Spooled during an outage: only a successful recovery can put
            # it on the wire.
            self.recover_blocking()
            return
        try:
            self._client.wait(fut)
        except BaseException as exc:
            if self._recoverable(exc):
                self.recover_blocking()
                return
            self._pop_if_head(head)
            raise
        self._pop_if_head(head)

    def drain(self) -> None:
        try:
            self._client.flush_sends()  # buffered frames must reach the wire
        except ConnectionLost:
            if self._policy is None:
                raise
            # Recovery below re-sends whatever the flush failed to ship.
        while True:
            with self._lock:
                if not self._entries:
                    return
                head = self._entries[0]
            self._wait_head(head)


class RemotePSShard:
    """Drop-in for :class:`~repro_torch.core.ps.PSShard` over the RPC transport.

    ``push_nowait`` is the asynchronous hot path: one sparse-row frame on
    the wire, no response wait.  Reads (``peek_table``, ``n_pushes``) are
    ordinary calls and therefore observe every prior push on the same
    connection (server-side FIFO) without an explicit barrier.
    """

    def __init__(
        self,
        endpoint: Tuple[str, int],
        shard_id: int,
        num_shards: int,
        num_funcs: int,
        timeout: float = 30.0,
        max_inflight: int = 64,
        wal_dir: Optional[str] = None,
        policy: Optional[RetryPolicy] = None,
    ):
        # The window is deliberately shallower than the provenance stub's:
        # a PS federation takes a periodic FIFO barrier (the aggregate
        # refresh), and every queued push ahead of it is barrier latency.
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.endpoint = endpoint
        self._client = RPCClient.shared(endpoint, timeout=timeout)
        self._policy = policy
        # Crash recovery resets the worker's table to whatever its WAL
        # replays; without a WAL a reconfigure would replay *nothing* and
        # silently drop every acked push — refuse the combination.
        if policy is not None and wal_dir is None:
            raise ValueError("RemotePSShard: a retry policy requires wal_dir")
        wal = None
        if wal_dir is not None:
            from repro_torch.fault.wal import wal_path  # local: fault is optional here

            wal = wal_path(wal_dir, shard_id)
        self._conf_env = {
            "shard_id": shard_id,
            "num_shards": num_shards,
            "num_funcs": num_funcs,
            "wal": wal,
        }
        # Per-shard push seq: assigned under _send_lock so wire order ==
        # seq order; the server skips seqs it already applied, which is
        # what makes post-crash replay of unacked pushes exactly-once.
        self._seq = 0
        self._send_lock = threading.Lock()
        self._window = _InflightWindow(
            self._client,
            max_inflight,
            policy=policy,
            reconfigure=self._reconfigure if policy is not None else None,
            label=f"{endpoint[0]}:{endpoint[1]}",
        )
        self._closed = False
        self._client.call("ps.configure", dict(self._conf_env, wal_reset=True))
        self._window.note_configured()

    def _reconfigure(self) -> None:
        """Recovery half-step: one dial attempt (the window's rounds pace
        the retries, not the client's full dial budget), then re-configure
        with ``wal_reset=False`` so the respawned worker replays its WAL
        back to the exact pre-crash table before any replayed push lands."""
        if not self._client.try_dial():
            raise ConnectionLost(f"ps shard {self.endpoint} still unreachable")
        self._client.call("ps.configure", dict(self._conf_env, wal_reset=False))

    def _call(self, name: str, env: Optional[dict] = None):
        """Sync call with one recover-and-retry round in fault mode.  Only
        used for idempotent verbs (grow / stats / peek_table)."""
        try:
            return self._client.call(name, env)
        except (ConnectionLost, RemoteError) as exc:
            if not self._window._recoverable(exc):
                raise
            self._window.recover_blocking()
            return self._client.call(name, env)

    def push(self, rows: np.ndarray) -> None:
        self.finish(self.push_async(rows))

    def push_async(self, rows: np.ndarray) -> concurrent.futures.Future:
        """Pipeline a dense push; pair with :meth:`finish`.  (Kept for API
        parity with the local shard surface; the federation's hot path is
        :meth:`push_sparse_nowait`.)"""
        return self._client.call_async(
            "ps.push", arrays=(np.ascontiguousarray(rows, dtype=np.float64),)
        )

    def push_nowait(self, rows: np.ndarray) -> None:
        """Fire-and-forget sparse push: ship only the non-empty rows.

        Bit-identical to pushing the full slice — merging an empty row is
        an exact no-op (``merge_moments``) — at a fraction of the wire
        bytes and server merge work.  Errors surface on the next operation
        or on :meth:`drain`.
        """
        from repro_torch.core.stats import N  # local: keep module import light

        rows = np.asarray(rows, dtype=np.float64)
        nz = np.nonzero(rows[:, N] > 0)[0]
        self.push_sparse_nowait(nz, rows[nz], int(rows.shape[0]))

    def push_sparse_nowait(
        self, idx: np.ndarray, rows: np.ndarray, rows_total: int
    ) -> None:
        """Fire-and-forget push of pre-gathered non-empty rows.

        ``idx`` are shard-local row indices; the caller (FederatedPS) has
        already gathered the rows, so no per-shard strided slice or nonzero
        pass happens here.  The frame rides the client's send buffer —
        syscalls, the dominant socket-mode cost, are amortized over many
        pushes.
        """
        idx = np.ascontiguousarray(idx)
        rows = np.ascontiguousarray(rows)
        env: Dict[str, Any] = {"rows_total": int(rows_total)}
        if self._policy is None:
            tc = None
            if spans.ENABLED:
                # Same stable per-shard ordinal the fault path uses as its
                # idempotence seq — just not shipped in the envelope, since
                # plain mode has no replay to dedup.
                with self._send_lock:
                    tc = spans.wire_context("ps.push_rows", self._seq)
                    self._seq += 1
            self._window.admit(
                self._client.call_async(
                    "ps.push_rows", env, arrays=(idx, rows), buffered=True, tc=tc
                )
            )
            return
        # Fault-tolerant path: assign the idempotence seq and enqueue under
        # the send lock, so the order seqs hit the wire matches the order
        # they were assigned (the dedup horizon is a high-water mark).
        with self._send_lock:
            env["seq"] = self._seq
            self._seq += 1
            # Trace context derives from the idempotence seq and is captured
            # in the closure: a post-crash replay puts the *identical*
            # context back on the wire, so the span tree stays single.
            tc = spans.wire_context("ps.push_rows", env["seq"])

            def resend(env=env, idx=idx, rows=rows, tc=tc):
                return self._client.call_async(
                    "ps.push_rows", env, arrays=(idx, rows), buffered=True, tc=tc
                )

            self._window.submit(resend)

    def finish(self, fut: concurrent.futures.Future) -> None:
        self._client.wait(fut, name="ps.push")

    def drain(self) -> None:
        """Barrier: wait out (and error-check) every fire-and-forget push."""
        self._window.drain()

    def grow(self, num_rows: int) -> None:
        # Idempotent (growing to a size already reached is a no-op), so the
        # recovering call is safe; an acked grow is in the WAL and replays.
        self._call("ps.grow", {"num_rows": int(num_rows)})

    def peek_table(self) -> np.ndarray:
        return self.finish_peek(self.peek_table_async())

    def peek_table_async(self) -> concurrent.futures.Future:
        return self._client.call_async("ps.peek_table")

    def finish_peek(self, fut: concurrent.futures.Future) -> np.ndarray:
        """Resolve a :meth:`peek_table_async` future to its table.

        The full-table peek is a non-consuming (idempotent) read, so in
        fault mode a lost connection recovers and retries transparently —
        snapshots survive a mid-run shard restart."""
        try:
            return self._client.wait(fut)[1][0]
        except (ConnectionLost, RemoteError) as exc:
            if not self._window._recoverable(exc):
                raise
            self._window.recover_blocking()
            return self._client.call("ps.peek_table")[1][0]

    def peek_rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """Dirty-row delta peek (see :meth:`PSShard.peek_rows`)."""
        return self.finish_peek_rows(self.peek_rows_async())

    def peek_rows_async(self) -> concurrent.futures.Future:
        return self._client.call_async("ps.peek_rows")

    def finish_peek_rows(
        self, fut: concurrent.futures.Future
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Resolve a :meth:`peek_rows_async` future to its (idx, rows).

        The delta peek is a *consuming* read and cannot be retried
        transparently: if the server executed it and only the reply was
        lost, the dirty set is gone.  In fault mode we heal the connection
        (after a true crash the WAL replay re-marks every live row dirty)
        and then re-raise, so the federation falls back to its full-rebuild
        refresh — exact by construction."""
        try:
            _env, arrays = self._client.wait(fut)
        except (ConnectionLost, RemoteError) as exc:
            if self._window._recoverable(exc):
                try:
                    self._window.recover_blocking()
                except ConnectionLost:
                    pass  # still down; the original error below says so
                if isinstance(exc, RemoteError):
                    # Reached a blank respawn (nothing executed, nothing
                    # consumed) and the worker is now reconfigured: signal
                    # the degraded-refresh path, not a remote failure.
                    raise ConnectionLost(str(exc)) from exc
            raise
        return arrays[0].astype(np.int64, copy=False), arrays[1]

    @property
    def n_pushes(self) -> int:
        return int(self._call("ps.stats")[0]["n_pushes"])

    def stats(self) -> Dict[str, Any]:
        """The worker's ``ps.stats`` env (push count, dedup horizon, WAL
        size) — observability for tests and the fault benchmarks."""
        return dict(self._call("ps.stats")[0])

    def close(self) -> None:
        if self._closed:
            return  # idempotent: the shared client's refcount drops once
        self._closed = True
        try:
            self.drain()
        except ConnectionLost:
            pass  # workers already gone; RemoteError etc. stay loud
        finally:
            self._client.close()


class RemoteProvenanceShard:
    """Drop-in for :class:`~repro_torch.core.provenance.ProvenanceShard` over RPC.

    The shard's JSONL file lives in the *server* process (``path`` must be
    meaningful there — same-host workers or a shared filesystem).  ``close``
    is teardown-path best-effort: it swallows :class:`ConnectionLost` so a
    federation can always be closed after its workers died, while the data
    path (``add``/``add_many``/``query``) stays loud.

    ``add_many*`` is the coalescing hot path: a frame's docs for one shard
    travel as ONE request frame; the worker applies (and JSONL-appends)
    them in order, skipping seqs it already holds so a retried batch after
    a mid-batch connection loss never drops or duplicates a doc.
    """

    def __init__(
        self,
        endpoint: Tuple[str, int],
        path: Optional[str] = None,
        append: bool = False,
        header: Optional[Dict[str, Any]] = None,
        timeout: float = 30.0,
        max_inflight: int = 512,
        policy: Optional[RetryPolicy] = None,
    ):
        self.path = path
        self.endpoint = endpoint
        self._client = RPCClient.shared(endpoint, timeout=timeout)
        self._policy = policy
        # Crash recovery re-reads the shard's own JSONL file; an in-memory
        # shard has nothing to re-read, so fault tolerance requires a path.
        if policy is not None and path is None:
            raise ValueError("RemoteProvenanceShard: a retry policy requires path")
        # durable: the worker flushes its file after every applied batch,
        # so an *acked* doc survives a SIGKILL of the worker.
        self._conf_env = {
            "path": path,
            "append": append,
            "header": header,
            "durable": policy is not None,
        }
        self._window = _InflightWindow(
            self._client,
            max_inflight,
            policy=policy,
            reconfigure=self._reconfigure if policy is not None else None,
            label=f"{endpoint[0]}:{endpoint[1]}",
        )
        self._closed = False
        self._client.call("prov.configure", self._conf_env)
        self._window.note_configured()

    def _reconfigure(self) -> None:
        """Recovery half-step: one dial attempt, then re-configure with
        ``append+recover`` — the respawned worker re-reads its own JSONL
        (truncating any torn tail), rebuilding its indexes *and* the seq
        dedup horizon, so replayed batches extend the file exactly where
        the crash left it."""
        if not self._client.try_dial():
            raise ConnectionLost(f"prov shard {self.endpoint} still unreachable")
        self._client.call(
            "prov.configure", dict(self._conf_env, append=True, recover=True)
        )

    def _call(self, name: str, env: Optional[dict] = None):
        """Sync call with one recover-and-retry round in fault mode.  Safe
        for every ``prov.*`` verb: reads are non-consuming and writes are
        seq-deduped server-side."""
        try:
            return self._client.call(name, env)
        except (ConnectionLost, RemoteError) as exc:
            if not self._window._recoverable(exc):
                raise
            self._window.recover_blocking()
            return self._client.call(name, env)

    # -------------------------------------------------------------- mutation
    def add(self, doc: Dict[str, Any], seq: int, write: bool = True) -> None:
        self._call("prov.add", {"doc": doc, "seq": int(seq), "write": bool(write)})

    def add_async(
        self, doc: Dict[str, Any], seq: int, write: bool = True
    ) -> concurrent.futures.Future:
        return self._client.call_async(
            "prov.add", {"doc": doc, "seq": int(seq), "write": bool(write)}
        )

    def add_many(
        self, docs: Sequence[Dict[str, Any]], seqs: Sequence[int], write: bool = True
    ) -> None:
        self._call(
            "prov.add_many",
            {"docs": list(docs), "seqs": [int(s) for s in seqs], "write": bool(write)},
        )

    def add_many_async(
        self, docs: Sequence[Dict[str, Any]], seqs: Sequence[int], write: bool = True
    ) -> concurrent.futures.Future:
        return self._client.call_async(
            "prov.add_many",
            {"docs": list(docs), "seqs": [int(s) for s in seqs], "write": bool(write)},
        )

    def add_many_nowait(
        self, docs: Sequence[Dict[str, Any]], seqs: Sequence[int], write: bool = True
    ) -> None:
        """Fire-and-forget batch add; errors surface on the next operation
        or :meth:`drain`.  Later calls on this connection (query/dump/len)
        observe the batch — the server executes per-connection in order."""
        env = {"docs": list(docs), "seqs": [int(s) for s in seqs],
               "write": bool(write)}
        # Keyed on the batch's first global doc seq (monitor-assigned, so
        # replay-stable); in fault mode it is captured in the resend
        # closure so replays carry the identical context.
        tc = spans.wire_context(
            "prov.add_many", env["seqs"][0] if env["seqs"] else -1
        )
        if self._policy is None:
            self._window.admit(
                self._client.call_async("prov.add_many", env, buffered=True, tc=tc)
            )
            return

        def resend(env=env, tc=tc):
            return self._client.call_async("prov.add_many", env, buffered=True, tc=tc)

        self._window.submit(resend)

    def finish(self, fut: concurrent.futures.Future) -> None:
        """Resolve any pipelined call (add/add_many/flush) future."""
        self._client.wait(fut, name="prov")

    def drain(self) -> None:
        """Barrier: wait out (and error-check) every fire-and-forget write."""
        self._window.drain()

    # --------------------------------------------------------------- queries
    def query(
        self,
        rank: Optional[int] = None,
        fid: Optional[int] = None,
        step: Optional[int] = None,
        t0: Optional[int] = None,
        t1: Optional[int] = None,
        func: Optional[str] = None,
        severity: Optional[int] = None,
        min_severity: Optional[int] = None,
    ) -> List[Tuple[int, Dict[str, Any]]]:
        return self.finish_query(
            self.query_async(rank, fid, step, t0, t1, func, severity, min_severity)
        )

    def query_async(
        self,
        rank: Optional[int] = None,
        fid: Optional[int] = None,
        step: Optional[int] = None,
        t0: Optional[int] = None,
        t1: Optional[int] = None,
        func: Optional[str] = None,
        severity: Optional[int] = None,
        min_severity: Optional[int] = None,
    ) -> concurrent.futures.Future:
        """Pipeline a query; lets the federation fan one query out to all
        owning shards concurrently instead of serializing round-trips."""
        env = {"rank": rank, "fid": fid, "step": step, "t0": t0, "t1": t1,
               "func": func, "severity": severity, "min_severity": min_severity}
        fut = self._client.call_async("prov.query", env)
        fut._rpc_retry = ("prov.query", env)  # finish_query re-issues after recovery
        return fut

    def finish_query(
        self, fut: concurrent.futures.Future
    ) -> List[Tuple[int, Dict[str, Any]]]:
        """Resolve a query_async/dump_async future to its (seq, doc) hits —
        the public half of the fan-out read API (used by the federation).

        Queries are non-consuming reads, so in fault mode a lost connection
        recovers (replaying unacked writes first — FIFO keeps the read
        after them) and retries the same request transparently."""
        try:
            env, _ = self._client.wait(fut)
        except (ConnectionLost, RemoteError) as exc:
            retry = getattr(fut, "_rpc_retry", None)
            if retry is None or not self._window._recoverable(exc):
                raise
            self._window.recover_blocking()
            env, _ = self._client.call(retry[0], retry[1])
        return [(seq, doc) for seq, doc in env["hits"]]

    def take_resumed(self) -> List[Dict[str, Any]]:
        return self._call("prov.take_resumed")[0]["docs"]

    def dump(self) -> List[Tuple[int, Dict[str, Any]]]:
        return self.finish_query(self.dump_async())

    def dump_async(self) -> concurrent.futures.Future:
        fut = self._client.call_async("prov.dump")
        fut._rpc_retry = ("prov.dump", None)
        return fut

    # ------------------------------------------------------------- lifecycle
    def flush(self) -> None:
        self._call("prov.flush")

    def flush_async(self) -> concurrent.futures.Future:
        return self._client.call_async("prov.flush")

    def flush_nowait(self) -> None:
        if self._policy is None:
            self._window.admit(self._client.call_async("prov.flush", buffered=True))
            return
        self._window.submit(
            lambda: self._client.call_async("prov.flush", buffered=True)
        )

    def close(self) -> None:
        if self._closed:
            return  # idempotent: the shared client's refcount drops once
        self._closed = True
        try:
            self.drain()
            self._client.call("prov.close")
        except ConnectionLost:
            pass  # workers already gone; nothing left to close remotely
        self._client.close()

    def __len__(self) -> int:
        return int(self._call("prov.len")[0]["n"])
