"""Online AD parameter-server federation (paper §III-B2).

Maintains the global, workflow-level view: per-function runtime moments and
per-(rank, frame) anomaly counts. Updates are *asynchronous* — clients push
local deltas and immediately receive the current global snapshot; there are no
synchronization barriers (Pébay merges are order-independent, see stats.py).

Three layers, mirroring how the paper scales the PS on Summit by running
multiple server instances so per-update PS work stays independent of rank
count (§III-B2):

  * :class:`ParameterServer` — the single-instance server (one lock, one
    table).  Unchanged client API; the Fig. 7 staleness knob lives here.
  * :class:`FederatedPS` — N :class:`PSShard` instances partitioned over
    function-id space (cyclic slicing, see ``stats.partition_table``) behind
    a front-end with the *same* client API.  A client push is routed to the
    shards owning its non-empty rows, each guarded by its own lock, so
    concurrent ranks rarely contend.  A periodic aggregation pass stitches
    shard tables into the snapshot clients/viz read — lock-free, because
    every shard mutation *replaces* its table array (``merge_moments``
    allocates) and the aggregator only reads the atomically-swapped refs.
  * :class:`BatchedPSClient` — client-side coalescing: several frame deltas
    are merged locally (``stats.coalesce_deltas``) and pushed as one,
    amortizing routing + lock acquisitions.  Between flushes the client sees
    its own pending delta merged onto the last global snapshot, which keeps
    labeling semantics close to the unbatched path (staleness < batch size).

The federation also runs cross-process: ``transport="socket"`` swaps each
:class:`PSShard` for a :mod:`repro.net` remote stub hosted by a
``repro.launch.shard_server`` worker process, bit-matched against local mode
(docs/net.md) — the paper's actual multi-instance PS deployment shape.

Threading model: many producer threads (one per simulated rank) may call
``update_and_fetch`` concurrently; locks guard only O(F/S) numpy work. A
``staleness`` knob on the single server lets tests emulate delayed snapshots
(clients seeing slightly-old global state), which is the regime the
97.6%-accuracy comparison in Fig. 7 exercises; ``aggregate_every`` plays the
same role for the federation.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import defaultdict, deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..telemetry import registry as telemetry
from .stats import (
    N,
    StatsTable,
    assemble_shards,
    coalesce_deltas,
    empty_table,
    merge_moments,
    pad_table,
    shard_rows,
)


@dataclasses.dataclass
class RankFrameStat:
    rank: int
    step: int
    n_anomalies: int
    ts: float


class AnomalyFeed:
    """Per-(rank, frame) anomaly bookkeeping + viz subscriptions.

    Shared by the single server and the federation front-end; guarded by its
    own lock so stats-table traffic never contends with viz queries.
    """

    def __init__(self) -> None:
        self._feed_lock = threading.Lock()
        self.anomaly_series: Dict[int, List[RankFrameStat]] = defaultdict(list)
        self._subscribers: List[Callable[[dict], None]] = []

    def report_anomalies(self, rank: int, step: int, n_anomalies: int) -> None:
        stat = RankFrameStat(rank, step, n_anomalies, time.time())
        with self._feed_lock:
            self.anomaly_series[rank].append(stat)
            subs = list(self._subscribers)
        for cb in subs:  # viz broadcast (paper: periodic push to viz server)
            cb({"rank": rank, "step": step, "n_anomalies": n_anomalies})

    def subscribe(self, cb: Callable[[dict], None]) -> None:
        # Under _feed_lock: report_anomalies snapshots this list from the
        # feed thread concurrently with subscribers arriving from the
        # main/viz threads (repro.lint: lockset-mixed).
        with self._feed_lock:
            self._subscribers.append(cb)

    # ------------------------------------------------------------------ viz
    def rank_dashboard(self) -> Dict[int, Dict[str, float]]:
        """Fig. 3 data: per-rank {avg, std, max, min, total} anomaly counts."""
        out = {}
        with self._feed_lock:
            for rank, series in self.anomaly_series.items():
                xs = np.asarray([s.n_anomalies for s in series], np.float64)
                if xs.size == 0:
                    continue
                out[rank] = {
                    "average": float(xs.mean()),
                    "stddev": float(xs.std()),
                    "maximum": float(xs.max()),
                    "minimum": float(xs.min()),
                    "total": float(xs.sum()),
                }
        return out

    def frame_series(self, rank: int) -> List[Tuple[int, int]]:
        """Fig. 4 data: (step, n_anomalies) stream for one rank."""
        with self._feed_lock:
            return [(s.step, s.n_anomalies) for s in self.anomaly_series[rank]]


class ParameterServer(AnomalyFeed):
    """Thread-safe single-instance stats store (the degenerate 1-shard PS)."""

    def __init__(self, num_funcs: int, staleness: int = 0):
        super().__init__()
        self.global_stats = StatsTable(num_funcs)
        self._lock = threading.Lock()
        self._staleness = staleness
        self._snapshots: Deque[np.ndarray] = deque(maxlen=max(staleness, 1))
        self._snapshots.append(self.global_stats.table.copy())
        self.n_updates = 0

    # --------------------------------------------------------------- client
    def update_and_fetch(
        self, rank: int, step: int, delta: np.ndarray
    ) -> Optional[np.ndarray]:
        """Merge a local delta; return a (possibly stale) global snapshot."""
        with self._lock:
            if delta.shape[0] > self.global_stats.num_funcs:
                self.global_stats.grow(delta.shape[0])
            self.global_stats.merge_array(self._pad(delta))
            self.n_updates += 1
            snap = self.global_stats.table.copy()
            self._snapshots.append(snap)
            out = self._snapshots[0] if self._staleness > 0 else snap
        return out

    def snapshot(self) -> StatsTable:
        with self._lock:
            return StatsTable(self.global_stats.num_funcs, self.global_stats.table.copy())

    def _pad(self, delta: np.ndarray) -> np.ndarray:
        return pad_table(delta, self.global_stats.num_funcs)


class PSShard:
    """One PS instance owning the cyclic fid slice ``{shard, shard+S, ...}``.

    Holds ``shard_rows(F, shard, S)`` rows of the global table behind its own
    lock.  Mutations go through ``merge_moments``, which allocates a fresh
    array — so ``self.stats.table`` is an atomically-swapped immutable-by-
    convention ref that the federation's aggregation pass may read without
    taking the lock.

    Durability (``wal=``): every applied mutation is appended to a
    :class:`repro.fault.wal.PSWal` *before* the merge, so a killed shard
    restarted on the same log replays — through this class's own merge
    code — to a bit-exact table, push count, and dedup seq.  Sparse pushes
    carry an optional strictly-increasing per-shard ``seq`` (assigned by
    the remote stub), making ``push_rows`` idempotent exactly like
    ``ProvenanceShard.add``: an ambiguous post-kill retry whose first
    delivery *was* applied is skipped, never double-merged.
    """

    def __init__(self, shard_id: int, num_shards: int, num_funcs: int, wal=None):
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.stats = StatsTable(shard_rows(num_funcs, shard_id, num_shards))
        self.lock = threading.Lock()
        self.n_pushes = 0
        self.last_push_seq = -1  # highest applied push_rows seq (dedup)
        # Dirty-row bookkeeping for the federation's incremental aggregate
        # refresh: every row a push touches since the last delta peek.
        self._dirty = np.zeros(self.stats.num_funcs, bool)
        self.wal = wal
        self._conf_funcs = num_funcs  # global F at configure time (WAL CONF)
        if wal is not None:
            self._wal_open(num_funcs)

    # ------------------------------------------------------------ durability
    def _wal_open(self, num_funcs: int) -> None:  # lint: ignore[lockset-mixed] — runs inside __init__ before the shard is published to any other thread
        """Replay an existing log (bit-exact restore) or start a fresh one."""
        from repro_torch.fault import wal as _w  # lazy: core must not need fault

        records, resumed = self.wal.load()
        if not resumed:
            self.wal.append_conf(self.shard_id, self.num_shards, num_funcs)
            return
        for rtype, payload in records:
            if rtype == _w.CONF:
                sid, S, F = _w.decode_conf(payload)
                if (sid, S) != (self.shard_id, self.num_shards):
                    raise _w.WalCorrupt(
                        f"WAL {self.wal.path} belongs to shard {sid}/{S}, "
                        f"not {self.shard_id}/{self.num_shards}"
                    )
                self.stats = StatsTable(shard_rows(F, self.shard_id, self.num_shards))
                self._dirty = np.zeros(self.stats.num_funcs, bool)
                self._conf_funcs = F
            elif rtype == _w.SNAP:
                table, n_pushes, last_seq = _w.decode_snap(payload)
                self.stats = StatsTable(table.shape[0], table.copy())
                self._dirty = np.zeros(self.stats.num_funcs, bool)
                self.n_pushes = n_pushes
                self.last_push_seq = last_seq
            elif rtype == _w.ROWS:
                seq, idx, rows, rows_total = _w.decode_rows(payload)
                self._apply_rows_locked(idx, rows, rows_total)
                if seq >= 0:
                    self.last_push_seq = seq
            elif rtype == _w.PUSH:
                self._apply_push_locked(_w.decode_push(payload))
            elif rtype == _w.GROW:
                self._grow_locked(_w.decode_grow(payload))
        # The front-end's incremental refresh state died with the old
        # process: mark every live row dirty so the next delta peek re-ships
        # them all — over-inclusive (same values rewritten) but exact.
        self._dirty[:] = self.stats.table[:, N] > 0

    def _grow_locked(self, num_rows: int) -> None:  # lint: ignore[lockset-mixed] — caller holds self.lock (grow/push* take it before dispatching here)
        self.stats.grow(num_rows)
        if self.stats.num_funcs > len(self._dirty):
            grown = np.zeros(self.stats.num_funcs, bool)
            grown[: len(self._dirty)] = self._dirty
            self._dirty = grown

    def _apply_push_locked(self, rows: np.ndarray) -> None:  # lint: ignore[lockset-mixed,lockset-counter] — caller holds self.lock (push / WAL replay in __init__)
        if rows.shape[0] > self.stats.num_funcs:
            self._grow_locked(rows.shape[0])
        self.stats.merge_array(pad_table(rows, self.stats.num_funcs))
        self._dirty[np.nonzero(rows[:, N] > 0)[0]] = True
        self.n_pushes += 1

    def _apply_rows_locked(  # lint: ignore[lockset-mixed,lockset-counter] — caller holds self.lock (push_rows / WAL replay in __init__)
        self, idx: np.ndarray, rows: np.ndarray, rows_total: int
    ) -> None:
        if rows_total > self.stats.num_funcs:
            self._grow_locked(rows_total)
        table = self.stats.table
        table[idx] = merge_moments(table[idx], rows)
        self._dirty[idx] = True
        self.n_pushes += 1

    def push(self, rows: np.ndarray) -> None:
        """Merge a (rows_s, 7) delta block (already shard-local rows)."""
        with self.lock:
            if self.wal is not None:
                self.wal.append_push(rows)
            self._apply_push_locked(rows)
            self._maybe_compact_locked()

    def push_rows(
        self,
        idx: np.ndarray,
        rows: np.ndarray,
        rows_total: int,
        seq: Optional[int] = None,
    ) -> None:
        """Merge only the delta's non-empty rows (sparse push), in place.

        ``idx`` are shard-local row indices into a ``rows_total``-row slice.
        Bit-identical to :meth:`push` of the dense slice: merging an empty
        row is an exact bitwise no-op (``merge_moments``), so skipping the
        empty rows changes nothing but the work.  Unlike :meth:`push`, the
        table is mutated *in place* (no copy-on-write): this is the RPC
        shard host's hot path, where the only readers are the ``ps.*``
        handlers, which take :attr:`lock` — use :meth:`peek_table_locked`
        there, never the lock-free :meth:`peek_table`.

        ``seq``: strictly-increasing per-shard push sequence (the remote
        stub assigns it).  A seq at or below the highest applied one is a
        duplicate delivery — a replayed batch whose first delivery landed
        before the connection died — and is skipped, keeping retries
        exactly-once.  Logged in the WAL record so a restart restores the
        dedup horizon along with the table.
        """
        with self.lock:
            if seq is not None and seq <= self.last_push_seq:
                return  # duplicate delivery (post-kill replay): already applied
            if self.wal is not None:
                self.wal.append_rows(-1 if seq is None else seq, idx, rows, rows_total)
            self._apply_rows_locked(idx, rows, rows_total)
            if seq is not None:
                self.last_push_seq = seq
            self._maybe_compact_locked()

    def _maybe_compact_locked(self) -> None:  # lint: ignore[lockset-mixed] — caller holds self.lock
        if self.wal is not None and self.wal.should_compact():
            self.wal.compact(
                (self.shard_id, self.num_shards, self._conf_funcs),
                self.stats.table, self.n_pushes, self.last_push_seq,
            )

    def peek_table_locked(self) -> np.ndarray:
        """Copy of the table, consistent under concurrent in-place
        :meth:`push_rows` mutation (the RPC shard-host read path)."""
        with self.lock:
            return self.stats.table.copy()

    def peek_rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """Dirty-row delta peek: ``(idx, rows)`` of every shard-local row a
        push touched since the previous :meth:`peek_rows`, then reset.

        This is the federation's incremental aggregate-refresh read: the
        shard knows exactly which rows changed, so refresh cost (wire bytes
        and scatter work) is O(changed), not O(F/S) — while staying
        bit-identical to a full :meth:`peek_table` stitch, because an
        untouched row cannot have changed since the value the aggregate
        already holds for it.  One consumer owns the dirty set (the
        federation front-end); full peeks don't reset it.
        """
        with self.lock:
            idx = np.nonzero(self._dirty)[0]
            rows = self.stats.table[idx]  # fancy indexing: already a copy
            self._dirty[idx] = False
            return idx, rows

    def grow(self, num_rows: int) -> None:
        with self.lock:
            if self.wal is not None and num_rows > self.stats.num_funcs:
                self.wal.append_grow(num_rows)
            self._grow_locked(num_rows)

    def peek_table(self) -> np.ndarray:
        """Lock-free read of the current shard table (atomic ref load)."""
        return self.stats.table

    def close(self) -> None:
        if self.wal is not None:
            self.wal.close()


class FederatedPS(AnomalyFeed):
    """Front-end over N fid-sharded PS instances — same client API.

    ``update_and_fetch`` routes the rows of a client's (F, 7) delta to the
    owning shards (strided views, no copies) and returns the *aggregated*
    global snapshot.  The aggregate is refreshed at most every
    ``aggregate_every`` pushes by whichever client crosses the threshold —
    a lock-free stitch over the shards' published tables — so fetches are
    O(1) in the common case instead of O(F) copies per update.  Clients
    therefore see snapshots up to ``aggregate_every`` pushes stale, which is
    exactly the asynchronous-updates regime the paper runs (§III-B2, Fig. 7).

    ``snapshot()`` always forces a fresh aggregation: offline consumers (viz
    dumps, equivalence tests) get the exact union of all pushed deltas,
    bit-matching a single :class:`ParameterServer` fed the same stream.

    ``transport="socket"`` swaps every :class:`PSShard` for a
    :class:`repro.net.shards.RemotePSShard` stub over one of ``endpoints``
    (``host:port`` pairs of ``repro.launch.shard_server`` workers), so shard
    merges run in separate processes — same routing, same aggregation, same
    bit-match guarantee (stats rows travel as raw float64 bytes), but the
    per-shard work escapes this process's GIL.  Socket pushes are
    *asynchronous*: ``update_and_fetch`` puts one sparse-row frame on the
    wire per touched shard and returns without waiting — the RPC round-trip
    leaves the hot path entirely.  Reads (``snapshot``, ``shard_load``)
    stay exact without barriers because the server executes a connection's
    requests in order, so a ``peek_table`` response reflects every push
    that preceded it; write errors surface loudly on the next push or on
    :meth:`close`.  (The PR 3 ``io_mode="sync"`` wait-per-update fallback
    is gone; its measured numbers are frozen in ``BENCH_net.json`` as the
    permanent benchmark denominator.)

    The periodic aggregate refresh is *incremental*: each shard serves a
    dirty-row delta peek (:meth:`PSShard.peek_rows` / ``ps.peek_rows``) of
    only the rows pushes touched since the previous refresh, and the
    front-end scatters those rows over a copy of the cached aggregate —
    O(changed) wire bytes and scatter work instead of shipping every
    shard's full table, and bit-identical to the full stitch (an untouched
    row cannot differ from the value the aggregate already holds).
    ``snapshot()`` still does the full-peek stitch, so tests can bit-match
    the incremental cache against it.
    """

    def __init__(
        self,
        num_funcs: int,
        num_shards: int = 4,
        aggregate_every: int = 16,
        transport: str = "local",
        endpoints=None,
        wal_dir: Optional[str] = None,
        fault_policy=None,
    ):
        super().__init__()
        self._conn_lost: tuple = ()  # except () catches nothing (non-fault modes)
        if transport not in ("local", "socket"):
            raise ValueError(f"transport must be 'local' or 'socket', got {transport!r}")
        if transport == "socket":
            if not endpoints:
                raise ValueError("transport='socket' requires endpoints")
            from repro_torch.net.shards import RemotePSShard  # lazy: core must not need net

            num_shards = len(endpoints)
            # wal_dir makes the federation crash-tolerant: each worker logs
            # its applied deltas to ``wal_dir/ps_shard<k>.wal`` (write-ahead,
            # docs/fault.md) and a killed+respawned worker replays to a
            # bit-exact table; the stubs get a recovery policy so pushes in
            # flight across the kill are replayed (seq-dedup'd) instead of
            # surfacing ConnectionLost to the monitor.
            if wal_dir is not None and fault_policy is None:
                from repro_torch.fault.policy import DEFAULT_POLICY

                fault_policy = DEFAULT_POLICY
            if fault_policy is not None:
                from repro_torch.net.framing import ConnectionLost

                # Exceptions the aggregate refresh absorbs (stale-but-alive
                # degraded mode) instead of surfacing to the monitor.
                self._conn_lost = (ConnectionLost,)
            self.shards = [
                RemotePSShard(
                    ep, s, num_shards, num_funcs,
                    wal_dir=wal_dir, policy=fault_policy,
                )
                for s, ep in enumerate(endpoints)
            ]
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.transport = transport
        self.num_shards = num_shards
        self._num_funcs = num_funcs
        if transport == "local":
            if wal_dir is not None:
                from repro_torch.fault.wal import PSWal, wal_path

                self.shards = [
                    PSShard(s, num_shards, num_funcs,
                            wal=PSWal(wal_path(wal_dir, s), reset=True))
                    for s in range(num_shards)
                ]
            else:
                self.shards = [
                    PSShard(s, num_shards, num_funcs) for s in range(num_shards)
                ]
        self._aggregate_every = max(int(aggregate_every), 1)
        self._size_lock = threading.Lock()  # guards _num_funcs growth
        self._count_lock = threading.Lock()  # guards n_updates / refresh decision
        # Serializes delta-peek refreshes: the dirty sets are consumed, so
        # two concurrent refreshes must not interleave (one would publish
        # an aggregate missing the rows the other consumed).
        self._refresh_lock = threading.Lock()
        self._refresh_full = False  # a failed delta refresh consumed dirty
        # state it never published: rebuild from full peeks next time
        self.n_updates = 0
        self._agg_at = 0  # n_updates value the cached aggregate reflects
        self._agg = empty_table(num_funcs)  # cached global snapshot (COW ref)
        # The PS update path is the overhead-gated hot path: the bench
        # sources its p50/p95 from this histogram and asserts instrumented
        # vs REPRO_TELEMETRY=0 cost stays within budget.
        self._m_update = telemetry.get_registry().histogram(
            "repro_ps_update_us",
            "FederatedPS.update_and_fetch latency in microseconds.",
            ["transport"],
        ).labels(transport=transport)

    # --------------------------------------------------------------- sizing
    @property
    def num_funcs(self) -> int:
        return self._num_funcs  # lint: ignore[lockset-mixed] — _num_funcs only grows, under _size_lock; a bare read can only see a smaller, stale value, which callers tolerate

    def _ensure_capacity(self, num_funcs: int) -> None:
        if num_funcs <= self._num_funcs:  # lint: ignore[lockset-mixed] — double-checked: the grow path re-reads _num_funcs under _size_lock
            return
        with self._size_lock:
            if num_funcs <= self._num_funcs:
                return
            for shard in self.shards:
                shard.grow(shard_rows(num_funcs, shard.shard_id, self.num_shards))
            self._num_funcs = num_funcs

    # --------------------------------------------------------------- client
    def update_and_fetch(
        self, rank: int, step: int, delta: np.ndarray
    ) -> Optional[np.ndarray]:
        """Route a delta's rows to their shards; return the cached aggregate."""
        t0_ns = time.perf_counter_ns() if telemetry.ENABLED else 0
        self._ensure_capacity(delta.shape[0])
        S = self.num_shards
        # One O(F) pass finds the non-empty rows (n > 0); the shards those
        # rows map to are the only ones that see a lock acquisition, merge,
        # or frame.
        nz = np.nonzero(delta[:, N] > 0)[0]
        touched = np.unique(nz % S) if S > 1 else (0,)
        if self.transport == "socket":
            # Fire-and-forget: one sparse-row frame per touched shard, no
            # response wait — the merge happens in the worker while this
            # rank moves on, and the frame rides the client's send buffer
            # so syscalls amortize over many updates.  Connection FIFO
            # keeps later reads exact; failed pushes fail the next
            # operation loudly.  The gather happens here, once over the
            # global nonzero set, instead of a strided slice + nonzero
            # pass per shard.
            for s in touched:
                shard = self.shards[s]
                g = nz[nz % S == s] if S > 1 else nz
                shard.push_sparse_nowait(
                    g // S, delta[g], shard_rows(delta.shape[0], s, S)
                )
        else:
            for s in touched:
                shard = self.shards[s]
                rows = delta[shard.shard_id :: S]
                if rows.shape[0]:
                    shard.push(rows)
        with self._count_lock:
            self.n_updates += 1
            refresh = self.n_updates - self._agg_at >= self._aggregate_every
            if refresh:
                # Reserve the refresh window so concurrent pushes don't all
                # start their own O(F) aggregation while this one runs.
                self._agg_at = self.n_updates
        if refresh:
            try:
                self._refresh_aggregate()
            except self._conn_lost:
                # Fault-tolerant federation mid-outage: keep analyzing on a
                # stale aggregate rather than dying with the shard.
                # _refresh_full is already set, so the first refresh after
                # recovery rebuilds from full peeks — exact by construction.
                pass
        # Pad at read time: clients copy the snapshot over their global view
        # and index it by fid, so it must never have fewer rows than the
        # delta they just pushed (the cached aggregate may predate a grow).
        # Returned read-only: the incremental refresh scatters only dirty
        # rows over this cached array's copy, so a caller writing into the
        # returned snapshot would poison every future aggregate (full
        # rebuilds used to heal that; delta refreshes never would).
        out = pad_table(self._agg, self._num_funcs).view()  # lint: ignore[lockset-mixed] — _num_funcs only grows, under _size_lock; a bare read can only see a smaller, stale value; _ensure_capacity ran first for this delta
        out.flags.writeable = False
        if t0_ns:
            self._m_update.observe((time.perf_counter_ns() - t0_ns) // 1000)
        return out

    # ---------------------------------------------------------- aggregation
    def _build_aggregate(self) -> np.ndarray:
        """Lock-free global pass: stitch shard tables into one (F, 7) table.

        Reads each shard's atomically-published table ref without taking
        shard locks; concurrent pushes land in the *next* refresh.  The
        stitch itself is ``assemble_shards`` — per-row ``merge_moments``
        against empty rows, bitwise-exact.  Remote shards are read with one
        fanned-out async call per shard (one round-trip total, not S), and
        each response already reflects every push that preceded it on its
        connection.
        """
        if self.transport == "socket":
            futs = [(shard, shard.peek_table_async()) for shard in self.shards]
            tables = [shard.finish_peek(fut) for shard, fut in futs]
        else:
            tables = [shard.peek_table() for shard in self.shards]
        return assemble_shards(tables, self._num_funcs)  # lint: ignore[lockset-mixed] — _num_funcs only grows, under _size_lock; a bare read can only see a smaller, stale value; rows past it are rebuilt on the next peek

    def _refresh_aggregate(self) -> None:
        """Incremental aggregate refresh: dirty-row delta peeks.

        Each shard returns only the rows its pushes touched since the last
        refresh (O(changed) wire bytes + scatter work, the ROADMAP item);
        scattering them over a copy of the cached aggregate is bit-identical
        to the full ``assemble_shards`` stitch because assembly is a pure
        interleave and untouched rows cannot have changed.  Copy-on-write
        keeps published aggregates immutable for readers.  Refreshes are
        serialized (the peeks *consume* dirty state); a refresh that finds
        one already running simply skips — its rows stay dirty and land in
        the next one.
        """
        if not self._refresh_lock.acquire(blocking=False):
            return
        try:
            if self._refresh_full:
                # A previous delta refresh failed after consuming some
                # shards' dirty state without publishing; a delta peek now
                # would silently omit those rows forever.  One stateless
                # full-peek rebuild restores the bit-match (leftover dirty
                # bits only cause harmless over-inclusion later).
                self._agg = self._build_aggregate()
                self._refresh_full = False
                return
            S = self.num_shards
            try:
                if self.transport == "socket":
                    futs = [(shard, shard.peek_rows_async()) for shard in self.shards]
                    parts = [shard.finish_peek_rows(fut) for shard, fut in futs]
                else:
                    parts = [shard.peek_rows() for shard in self.shards]
                F = self._num_funcs  # lint: ignore[lockset-mixed] — _num_funcs only grows, under _size_lock; a bare read can only see a smaller, stale value; rows past it arrive with the next dirty-row peek
                for s, (idx, _rows) in enumerate(parts):
                    if len(idx):  # a shard may have grown past our size read
                        F = max(F, int(idx[-1]) * S + s + 1)
                agg = pad_table(self._agg, F).copy()
                for s, (idx, rows) in enumerate(parts):
                    if len(idx):
                        agg[idx * S + s] = rows
            except BaseException as exc:
                self._refresh_full = True  # dirty state may be half-consumed
                if not isinstance(exc, self._conn_lost):
                    raise
                # Recoverable loss mid-peek: the stub already healed the
                # connection (or recovery is one call away), so rebuild from
                # stateless full peeks *now* rather than at the next refresh
                # window.  A healed outage must never leave frames analyzing
                # a stale aggregate — which push path noticed the dead socket
                # first would otherwise decide whether the run stays
                # bit-exact.  Still down → ConnectionLost propagates and the
                # caller degrades to the stale aggregate as before.
                self._agg = self._build_aggregate()
                self._refresh_full = False
                return
            self._agg = agg  # atomic ref swap; readers never see torn state
        finally:
            self._refresh_lock.release()

    def snapshot(self) -> StatsTable:
        """Force a fresh aggregation and return it (offline/exact path)."""
        agg = pad_table(self._build_aggregate(), self._num_funcs)  # lint: ignore[lockset-mixed] — snapshots run at a frame barrier, with no concurrent pushes
        return StatsTable(agg.shape[0], agg.copy())

    @property
    def n_shard_pushes(self) -> int:
        return sum(shard.n_pushes for shard in self.shards)

    def shard_load(self) -> List[int]:
        """Per-shard push counts — the load-balance view of the federation."""
        return [shard.n_pushes for shard in self.shards]

    def drain(self) -> None:
        """Barrier: wait out every fire-and-forget socket push (surfacing
        their errors).  No-op for in-process shards."""
        for shard in self.shards:
            drain = getattr(shard, "drain", None)
            if drain is not None:
                drain()

    def close(self) -> None:
        """Release transport resources (no-op for in-process shards).
        Remote shards drain their in-flight pushes first."""
        for shard in self.shards:
            close = getattr(shard, "close", None)
            if close is not None:
                close()


class BatchedPSClient:
    """Client-side delta coalescing for any PS with ``update_and_fetch``.

    Buffers up to ``batch_frames`` per-frame deltas, merging them locally
    with Pébay merges (no locks — the client is single-threaded per rank),
    then pushes the coalesced delta in one server round-trip.  Between
    flushes, fetches return the *last* global snapshot unchanged — up to
    ``batch_frames - 1`` frames stale, the paper's asynchronous regime —
    which keeps the non-flush path allocation-light (one accumulate merge
    per frame, no locks, no view rebuilds).  Callers that want the freshest
    possible view (stale global ⊕ pending local) can ask for :meth:`view`.

    Two buffering granularities:

      * :meth:`update_and_fetch` — the delta path: per-frame (F, 7) deltas,
        one Pébay merge per frame (k merges per flush).
      * :meth:`push_events` — the event path: raw (fid, runtime) buffers are
        only *concatenated* per frame; ONE segment reduction over the whole
        batch runs at flush time.  This trades k O(F) merges for one
        O(E log E) reduction, which wins whenever frames are sparse in fid
        space (the common trace shape) — the client-side merge cost drops
        roughly by the batch factor.

    Both paths may be mixed; a flush folds the event buffer into the pending
    delta before the single server round-trip.

    Not thread-safe: one instance per producing rank, by design.
    """

    def __init__(self, ps, rank: int, batch_frames: int = 8):
        self.ps = ps
        self.rank = rank
        self.batch_frames = max(int(batch_frames), 1)
        self._pending: Optional[np.ndarray] = None
        self._pending_count = 0
        self._last_global: Optional[np.ndarray] = None
        self._ev_fids: List[np.ndarray] = []
        self._ev_vals: List[np.ndarray] = []
        self._ev_funcs = 0
        self.n_flushes = 0

    # --------------------------------------------------------------- client
    def update_and_fetch(
        self, rank: int, step: int, delta: np.ndarray
    ) -> Optional[np.ndarray]:
        if self._pending is None:
            self._pending = delta.copy()
        elif delta.shape[0] == self._pending.shape[0]:
            self._pending = merge_moments(self._pending, delta)
        else:
            self._pending = coalesce_deltas([self._pending, delta])
        self._pending_count += 1
        if self._pending_count >= self.batch_frames:
            return self.flush(step)
        last = self._last_global
        if last is None:
            return self._pending
        # New fids may have grown the local table since the last flush; pad
        # the stale snapshot so callers never see fewer rows than they push
        # (they copy it over their global view and index it by fid).
        self._last_global = last = pad_table(last, self._pending.shape[0])
        return last

    def push_events(
        self, step: int, fids: np.ndarray, runtimes: np.ndarray
    ) -> Optional[np.ndarray]:
        """Buffer one frame's raw (fid, runtime) events; reduce only at flush.

        Returns the same (possibly stale) snapshot contract as
        :meth:`update_and_fetch`; ``None`` until the first flush when no
        snapshot has been fetched yet.
        """
        fids = np.asarray(fids, dtype=np.int64)
        if fids.size:
            self._ev_fids.append(fids)
            self._ev_vals.append(np.asarray(runtimes, dtype=np.float64))
            self._ev_funcs = max(self._ev_funcs, int(fids.max()) + 1)
        self._pending_count += 1
        if self._pending_count >= self.batch_frames:
            return self.flush(step)
        last = self._last_global
        if last is None:
            return None
        self._last_global = last = pad_table(last, self._ev_funcs)
        return last

    def _reduce_events(self) -> None:
        """Fold the raw event buffer into ``_pending``: ONE segment reduction
        over the concatenated batch instead of one per buffered frame."""
        if not self._ev_fids:
            return
        F = max(self._ev_funcs, 1)
        if self._pending is not None:
            F = max(F, self._pending.shape[0])
        delta = StatsTable(F).batch_table(
            np.concatenate(self._ev_fids), np.concatenate(self._ev_vals)
        )
        self._ev_fids, self._ev_vals, self._ev_funcs = [], [], 0
        if self._pending is None:
            self._pending = delta
        else:
            self._pending = merge_moments(pad_table(self._pending, F), delta)

    def view(self) -> Optional[np.ndarray]:
        """Freshest client view: last global snapshot ⊕ pending local delta."""
        self._reduce_events()
        if self._pending is None:
            return self._last_global
        if self._last_global is None:
            return self._pending
        return coalesce_deltas([self._last_global, self._pending])

    def flush(self, step: int = -1) -> Optional[np.ndarray]:
        """Push the coalesced pending delta; returns the fresh global view."""
        self._reduce_events()
        if self._pending is None:
            self._pending_count = 0
            return self._last_global
        snap = self.ps.update_and_fetch(self.rank, step, self._pending)
        self._pending = None
        self._pending_count = 0
        self.n_flushes += 1
        if snap is not None:
            self._last_global = snap
        return self._last_global

    # ------------------------------------------------- passthroughs for viz
    def report_anomalies(self, rank: int, step: int, n_anomalies: int) -> None:
        self.ps.report_anomalies(rank, step, n_anomalies)

    def subscribe(self, cb: Callable[[dict], None]) -> None:
        self.ps.subscribe(cb)


class NonDistributedAD:
    """The Fig. 7 baseline: ONE analysis instance sees every rank's data.

    It has exact statistics (no staleness) but must process all ranks'
    frames serially — the cost that grows with rank count in Fig. 7.
    """

    def __init__(self, num_funcs: int, alpha: float = 6.0, min_samples: int = 10):
        from .ad import OnNodeAD  # local import to avoid cycle

        self._ads: Dict[int, OnNodeAD] = {}
        self._num_funcs = num_funcs
        self._alpha = alpha
        self._min_samples = min_samples
        self.shared = StatsTable(num_funcs)

    def process_frames(self, frames) -> Dict[int, np.ndarray]:
        """Process one step's frames from all ranks with exact global stats."""
        from .ad import SstdDetector

        det = SstdDetector(alpha=self._alpha, min_samples=self._min_samples)
        out: Dict[int, np.ndarray] = {}
        staged = []
        for frame in frames:
            if frame.rank not in self._ads:
                from .callstack import CallStackBuilder

                self._ads[frame.rank] = CallStackBuilder(app=frame.app, rank=frame.rank)
            records, _ctx = self._ads[frame.rank].process(frame)
            fids = records["fid"].astype(np.int64)
            if fids.size and int(fids.max()) >= self.shared.num_funcs:
                self.shared.grow(int(fids.max()) + 1)
            self.shared.update_batch(fids, records["runtime"].astype(np.float64))
            staged.append((frame.rank, records, fids))
        for rank, records, fids in staged:
            labels = det.label(self.shared, fids, records["runtime"].astype(np.float64))
            records["label"] = labels
            out[rank] = records
        return out
