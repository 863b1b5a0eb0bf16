"""Prescriptive provenance (paper §V).

"Prescriptive provenance is the provenance of events identified as anomalies
by the distributed AD" — for every anomaly we persist: the anomalous call with
its rank/thread/entry/exit/runtime/children/messages, its ancestor call stack,
its communication events, the k surrounding same-function calls, plus static
run provenance (environment, configuration, mesh).  Output is JSONL (one
record per anomaly) with an in-memory index for the viz queries.

Two store topologies, mirroring the PS federation (§III-B2, core/ps.py):

  * :class:`ProvenanceDB` — the single-writer store (one JSONL file, one
    index): the degenerate 1-shard case.
  * :class:`FederatedProvenanceDB` — N :class:`ProvenanceShard` partitions
    over (rank, fid) space with the same cyclic slicing the PS uses for fid
    space (``(rank + fid) % S``, the provenance analogue of ``delta[s::S]``).
    Each shard owns its own JSONL file and index, so >100-rank provenance
    capture stops funneling through one writer; a federated ``query()`` fans
    out to the owning shards and merges the hits back in capture-timestamp
    (global ingest sequence) order — identical docs, identical order to the
    single store fed the same stream.

Both stores index docs by (rank, fid, step) posting lists, by secondary
function-name and anomaly-severity posting lists (the viz drill-down axes:
``query(func=, severity=, min_severity=)``), and by a sorted entry-time
index, so point, window, and drill-down queries touch only matching
candidates instead of linear-scanning; both support ``append=True`` resume:
reopening an existing JSONL keeps the prior run's records (loaded back into
the index) instead of truncating.

The federation also runs cross-process: ``transport="socket"`` swaps each
shard for a :mod:`repro.net` remote stub hosted by a
``repro.launch.shard_server`` worker, byte-matched against local mode
(docs/net.md).
"""
# lint: deterministic — byte-identical output across shard counts/transports
from __future__ import annotations

import glob
import heapq
import io
import json
import os
import platform
import sys
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..telemetry import registry as telemetry
from .ad import ADFrameResult
from .events import FunctionRegistry


def static_provenance(extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Static run information (TAU-collected in the paper)."""
    info = {
        "timestamp": time.time(),  # lint: ignore[det-wallclock] — run metadata header, captured once; never in record bodies
        "hostname": platform.node(),
        "platform": platform.platform(),
        "python": sys.version.split()[0],
        "argv": list(sys.argv),
        "env": {
            k: v
            for k, v in os.environ.items()
            if k.startswith(("XLA_", "JAX_", "REPRO_", "TPU_"))
        },
    }
    # The port's copy records torch and the card where the original records
    # jax and its backend.
    import torch

    info["torch_version"] = torch.__version__
    info["cuda_version"] = torch.version.cuda
    if torch.cuda.is_available():
        info["device_count"] = torch.cuda.device_count()
        info["device_name"] = torch.cuda.get_device_name(0)
    else:
        info["device_count"] = 0
        info["device_name"] = "cpu"
    if extra:
        info.update(extra)
    return info


def _record_to_dict(rec: np.ndarray, registry: Optional[FunctionRegistry]) -> Dict[str, Any]:
    d = {name: int(rec[name]) for name in rec.dtype.names}
    if registry is not None:
        d["func"] = registry.name_of(int(rec["fid"]))
        if int(rec["parent_fid"]) >= 0:
            d["parent_func"] = registry.name_of(int(rec["parent_fid"]))
    return d


def shard_of(rank: int, fid: int, num_shards: int) -> int:
    """Cyclic (rank, fid) → shard map: the provenance analogue of the PS's
    fid-space slicing (``stats.partition_table``'s ``fid % S``).  Stable under
    registry growth and new ranks — a new (rank, fid) pair maps to a shard
    without repartitioning any existing doc."""
    return (int(rank) + int(fid)) % int(num_shards)


def build_anomaly_doc(
    result: ADFrameResult,
    idx: int,
    registry: Optional[FunctionRegistry],
    k_neighbors: int,
    comm_events: Optional[np.ndarray] = None,
) -> Dict[str, Any]:
    """Assemble the provenance document for one anomaly of an analyzed frame.

    Comm events are attached by *attribution*: event j belongs to the anomaly
    iff the call-stack builder mapped it to this record's entry
    (``ctx.comm_entry_row[j] == ctx.rec_entry_row[idx]`` on the same tid) —
    not merely because it falls inside the anomaly's [entry, exit] window,
    which would also capture events owned by child/sibling calls.  The
    window test survives only as a fallback for frames with no attribution.
    """
    recs = result.records
    anomaly = _record_to_dict(recs[idx], registry)
    # ancestor call stack at detection time (paper Fig. 6 view)
    stack = [
        {
            "fid": fid,
            "func": registry.name_of(fid) if registry else str(fid),
            "entry": ts,
            "depth": depth,
        }
        for (fid, ts, depth) in result.ctx.ancestors(idx)
    ]
    # k same-function neighbors (paper: k normal calls before/after)
    same = np.nonzero(recs["fid"] == recs["fid"][idx])[0]
    w = int(np.nonzero(same == idx)[0][0])
    neigh = same[max(0, w - k_neighbors) : w + k_neighbors + 1]
    neighbors = [_record_to_dict(recs[j], registry) for j in neigh if j != idx]
    # Severity: doublings of the anomalous runtime over the median runtime
    # of its same-function neighbors, clipped to [0, 10].  Deterministic and
    # self-contained (no detector state), so local and socket stores derive
    # the identical value; 0 when there is no baseline to compare against.
    runtime = float(recs["runtime"][idx])
    severity = 0
    if neighbors:
        base = float(np.median([n["runtime"] for n in neighbors]))
        if base > 0 and runtime > base:
            severity = int(np.clip(np.log2(runtime / base), 0, 10))
    comms: List[Dict[str, Any]] = []
    if comm_events is not None and len(comm_events):
        rows = result.ctx.comm_entry_row
        if rows is not None and len(rows) == len(comm_events) and np.any(rows >= 0):
            tid = int(result.ctx.tid_of_record[idx])
            erow = int(result.ctx.rec_entry_row[idx])
            for j in np.nonzero(rows >= 0)[0]:
                ev = comm_events[j]
                if int(ev["tid"]) == tid and int(rows[j]) == erow:
                    comms.append({k2: int(ev[k2]) for k2 in ev.dtype.names})
        else:
            # Fallback (no attribution available): same-rank window overlap.
            for ev in comm_events:
                if (
                    int(ev["ts"]) >= int(recs["entry"][idx])
                    and int(ev["ts"]) <= int(recs["exit"][idx])
                    and int(ev["rank"]) == int(recs["rank"][idx])
                ):
                    comms.append({k2: int(ev[k2]) for k2 in ev.dtype.names})
    return {
        "type": "anomaly",
        "step": result.step,
        "rank": result.rank,
        "severity": severity,
        "anomaly": anomaly,
        "call_stack": stack,
        "neighbors": neighbors,
        "comm": comms,
    }


def match_doc(
    doc: Dict[str, Any],
    rank: Optional[int] = None,
    fid: Optional[int] = None,
    step: Optional[int] = None,
    t0: Optional[int] = None,
    t1: Optional[int] = None,
    func: Optional[str] = None,
    severity: Optional[int] = None,
    min_severity: Optional[int] = None,
) -> bool:
    """The per-doc query predicate — ONE definition shared by the shard
    filter pass and the offline exporter (repro.export), so file-based and
    live-endpoint queries can never drift apart."""
    a = doc["anomaly"]
    if rank is not None and doc["rank"] != rank:
        return False
    if step is not None and doc["step"] != step:
        return False
    if fid is not None and a["fid"] != fid:
        return False
    if func is not None and a.get("func") != func:
        return False
    if severity is not None and doc.get("severity", 0) != severity:
        return False
    if min_severity is not None and doc.get("severity", 0) < min_severity:
        return False
    if t0 is not None and a["exit"] < t0:
        return False
    if t1 is not None and a["entry"] > t1:
        return False
    return True


def _read_docs(path: str) -> List[Dict[str, Any]]:
    """Parse anomaly docs (run_info headers skipped) out of a JSONL file."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            if doc.get("type") == "run_info":
                continue
            out.append(doc)
    return out


def _resume_order(docs: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Original ingest order of resumed docs: by the persisted ``seq``
    (legacy docs without one sort after, keeping their file order)."""
    ordered = sorted(enumerate(docs), key=lambda kd: (kd[1].get("seq", float("inf")), kd[0]))
    return [doc for _, doc in ordered]


def _truncate_torn_line(path: str) -> None:
    """Drop a torn final line — what a crash mid-append leaves behind.

    Everything after the last newline goes; complete lines are intact by
    construction (appends go through one buffered writer in file order,
    so only the final line can be partial)."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob or blob.endswith(b"\n"):
        return
    cut = blob.rfind(b"\n") + 1
    with open(path, "rb+") as f:
        f.truncate(cut)


class ProvenanceShard:
    """One provenance partition: a JSONL file plus an in-memory query index.

    Docs are indexed by (rank, fid, step) posting lists, by secondary
    function-*name* and anomaly-*severity* posting lists (the viz
    drill-down axes), and by a lazily sorted anomaly-entry-time index, so
    :meth:`query` touches only matching candidates instead of scanning
    every doc.  Each doc carries the global ingest sequence number its
    owner assigned (persisted as ``seq`` in the JSONL), which is what
    federated query merging orders by and what resume uses to reconstruct
    cross-shard ingest order.

    Per-shard seqs are strictly increasing, which makes :meth:`add`
    idempotent: a doc whose seq the shard already holds is skipped — the
    transport may re-send a batch whose response was lost to a connection
    kill, and the retry must neither drop nor duplicate a doc (or a JSONL
    line).

    Concurrency contract (the RPC shard host runs queries on worker threads
    concurrent with adds): every structure is append-only, and :meth:`add`
    appends ``docs``/``seqs`` *before* publishing a position to any posting
    list — so a reader that found a position sees a fully-formed doc, and a
    concurrent :meth:`query`/:meth:`dump` returns a consistent prefix of
    the stream.  Only the lazily-rebuilt entry-time cache is mutated in
    place; it is guarded by its own lock.  One writer at a time is the
    caller's job (the RPC service serializes mutations).
    """

    def __init__(
        self,
        path: Optional[str] = None,
        append: bool = False,
        header: Optional[Dict[str, Any]] = None,
        recover: bool = False,
    ):
        self.path = path
        self.docs: List[Dict[str, Any]] = []
        self.seqs: List[int] = []
        self._by_key: Dict[Tuple[int, int, int], List[int]] = {}
        self._by_rank: Dict[int, List[int]] = {}
        self._by_fid: Dict[int, List[int]] = {}
        self._by_step: Dict[int, List[int]] = {}
        self._by_func: Dict[str, List[int]] = {}
        self._by_severity: Dict[int, List[int]] = {}
        self._entry: List[int] = []
        self._exit: List[int] = []
        self._order: Optional[np.ndarray] = None  # argsort by entry ts
        self._order_vals: Optional[np.ndarray] = None
        self._order_lock = threading.Lock()  # guards the lazy cache only
        self._fh: Optional[io.TextIOBase] = None
        self._resumed: List[Dict[str, Any]] = []
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            if recover and os.path.exists(path):
                # Crash recovery: a SIGKILLed owner can leave a torn final
                # line (partial buffered write); cut it before parsing.
                _truncate_torn_line(path)
            resuming = (
                (append or recover)
                and os.path.exists(path)
                and os.path.getsize(path) > 0
            )
            if resuming:
                self._resumed = _read_docs(path)
                self._fh = open(path, "a")
                if recover:
                    # Re-index our own surviving docs in place (write=False:
                    # they are already on disk).  This restores the seq
                    # dedup horizon, so a front-end replaying un-acked
                    # batches afterwards is exactly-once — applied batches
                    # skip, lost ones append where the crash left off.
                    mine = [d for d in self._resumed if "seq" in d]
                    for doc in _resume_order(mine):
                        self.add(doc, int(doc["seq"]), write=False)
                    self._resumed = [d for d in self._resumed if "seq" not in d]
            else:
                self._fh = open(path, "w")
                if header is not None:
                    self._fh.write(json.dumps(header) + "\n")

    def take_resumed(self) -> List[Dict[str, Any]]:
        """Docs parsed from a pre-existing file on append — the owner re-adds
        them (without re-writing) so resumed runs keep their query index."""
        out, self._resumed = self._resumed, []
        return out

    # ------------------------------------------------------------- mutation
    def add(self, doc: Dict[str, Any], seq: int, write: bool = True) -> None:
        if self.seqs and seq <= self.seqs[-1]:
            return  # duplicate delivery (transport batch retry): already applied
        doc["seq"] = seq  # persisted so resume can rebuild cross-shard order
        pos = len(self.docs)
        self.docs.append(doc)
        self.seqs.append(seq)
        a = doc["anomaly"]
        rank, fid, step = int(doc["rank"]), int(a["fid"]), int(doc["step"])
        self._by_key.setdefault((rank, fid, step), []).append(pos)
        self._by_rank.setdefault(rank, []).append(pos)
        self._by_fid.setdefault(fid, []).append(pos)
        self._by_step.setdefault(step, []).append(pos)
        func = a.get("func")
        if func is not None:
            self._by_func.setdefault(str(func), []).append(pos)
        self._by_severity.setdefault(int(doc.get("severity", 0)), []).append(pos)
        self._entry.append(int(a["entry"]))  # lint: ignore[lockset-mixed] — append-only; _time_index snapshots a stable prefix under _order_lock
        self._exit.append(int(a["exit"]))
        with self._order_lock:
            self._order = None
        if write and self._fh:
            self._fh.write(json.dumps(doc) + "\n")  # lint: ignore[loop-blocking-io] — buffered write of one JSONL line (the original's ingest-throughput design)

    # -------------------------------------------------------------- queries
    def _time_index(self) -> Tuple[np.ndarray, np.ndarray]:
        with self._order_lock:
            if self._order is None:
                # Snapshot a stable prefix: adds may append concurrently.
                n = len(self._entry)
                ent = np.asarray(self._entry[:n], np.int64)
                self._order = np.argsort(ent, kind="stable")
                self._order_vals = ent[self._order]
            return self._order, self._order_vals

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
        """Matching (seq, doc) pairs in global ingest-sequence order.

        ``func`` (function *name*) and ``severity`` (exact bucket) hit their
        own posting lists — the viz drill-down axes skip the filter pass
        over unrelated docs.  ``min_severity`` unions the (≤ 11) severity
        posting lists at or above the threshold when it is the only
        selective key, otherwise it rides the filter pass.
        """
        cands: Iterable[int]
        lists = [
            index.get(key(val), [])
            for val, key, index in (
                (rank, int, self._by_rank),
                (fid, int, self._by_fid),
                (step, int, self._by_step),
                (func, str, self._by_func),
                (severity, int, self._by_severity),
            )
            if val is not None
        ]
        if rank is not None and fid is not None and step is not None:
            cands = self._by_key.get((int(rank), int(fid), int(step)), [])
        elif lists:
            cands = min(lists, key=len)
        elif min_severity is not None:
            cands = sorted(
                pos
                for sev, posting in self._by_severity.items()
                if sev >= int(min_severity)
                for pos in posting
            )
        elif t0 is not None or t1 is not None:
            order, vals = self._time_index()
            hi = len(order) if t1 is None else int(np.searchsorted(vals, int(t1), side="right"))
            cands = order[:hi]
        else:
            cands = range(len(self.docs))
        out: List[Tuple[int, Dict[str, Any]]] = []
        for pos in cands:
            pos = int(pos)
            doc = self.docs[pos]
            if match_doc(doc, rank, fid, step, t0, t1, func, severity, min_severity):
                out.append((self.seqs[pos], doc))
        out.sort(key=lambda sd: sd[0])
        return out

    def dump(self) -> List[Tuple[int, Dict[str, Any]]]:
        """Every (seq, doc) pair in shard-local order (federation merges)."""
        return list(zip(self.seqs, self.docs))

    # ------------------------------------------------------------ lifecycle
    def flush(self) -> None:
        if self._fh:
            self._fh.flush()  # lint: ignore[loop-blocking-io] — durability before ack: buffered flush to the page cache, no fsync

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __len__(self) -> int:
        return len(self.docs)


class ProvenanceDB:
    """JSONL-backed anomaly provenance store with an indexed query path.

    The single-writer store (and the federation's 1-shard degenerate case).
    ``append=True`` resumes an existing JSONL instead of truncating it: the
    run_info header is written only when starting a fresh file, and prior
    records are loaded back into the in-memory index — the elastic/restart
    path keeps its pre-failure anomaly provenance.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        registry: Optional[FunctionRegistry] = None,
        k_neighbors: int = 5,
        run_info: Optional[Dict[str, Any]] = None,
        append: bool = False,
    ):
        self.path = path
        self.registry = registry
        self.k = k_neighbors
        self._seq = 0
        # (seq, severity) per anomaly of the most recent ingest, in
        # anomaly_idx order — what the trace exporter links instants to.
        self.last_ingest: List[Tuple[int, int]] = []
        header = {"type": "run_info", **static_provenance(run_info)} if path else None
        self._shard = ProvenanceShard(path=path, append=append, header=header)
        for doc in _resume_order(self._shard.take_resumed()):
            seq = doc.get("seq", self._seq)
            self._shard.add(doc, seq, write=False)
            self._seq = max(self._seq, seq + 1)

    @property
    def records(self) -> List[Dict[str, Any]]:
        return self._shard.docs

    def ingest(self, result: ADFrameResult, comm_events: Optional[np.ndarray] = None) -> int:
        """Store provenance for every anomaly in an analyzed frame."""
        n = 0
        self.last_ingest = []
        for idx in result.anomaly_idx:
            doc = build_anomaly_doc(result, int(idx), self.registry, self.k, comm_events)
            self.last_ingest.append((self._seq, int(doc["severity"])))
            self._shard.add(doc, self._seq)
            self._seq += 1
            n += 1
        self._shard.flush()
        return n

    # ----------------------------------------------------------- queries
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
    ) -> List[Dict[str, Any]]:
        return [
            doc
            for _, doc in self._shard.query(
                rank, fid, step, t0, t1, func, severity, min_severity
            )
        ]

    def close(self) -> None:
        self._shard.close()

    def __len__(self) -> int:
        return len(self._shard)


def shard_paths(path: Optional[str], num_shards: int) -> List[Optional[str]]:
    """Per-shard JSONL paths.  One shard keeps the caller's path verbatim
    (drop-in for :class:`ProvenanceDB`); N shards interpose ``.shard<s>``
    before the extension: ``prov.jsonl`` → ``prov.shard0.jsonl``, ..."""
    if path is None:
        return [None] * num_shards
    if num_shards == 1:
        return [path]
    root, ext = os.path.splitext(path)
    return [f"{root}.shard{s}{ext}" for s in range(num_shards)]


class FederatedProvenanceDB:
    """Front-end over N (rank, fid)-sharded provenance stores — same API.

    ``ingest`` routes each anomaly doc to the shard owning its
    ``shard_of(rank, fid, S)`` slice; each shard appends to its own JSONL
    and maintains its own index, so at >100 ranks no single writer or
    index serializes provenance capture.  ``query`` fans out to the shards
    that can own matching docs and heap-merges the per-shard hits by
    global ingest sequence — the capture-timestamp order a single
    :class:`ProvenanceDB` would have returned, so ``num_shards=1`` is the
    bit-identical degenerate case and any shard count yields the same
    docs in the same order.

    ``transport="socket"`` swaps every :class:`ProvenanceShard` for a
    :class:`repro.net.shards.RemoteProvenanceShard` stub over one of
    ``endpoints`` (``repro.launch.shard_server`` workers): each shard's
    JSONL file + index live in its worker process, docs/queries travel as
    the same JSON the local shard would have indexed, and the worker assigns
    the same global ``seq`` — so federated query results and shard files are
    byte-identical to local mode while ingest/index work escapes this
    process's GIL.  Shard paths are resolved in the *worker*: same-host
    workers or a shared filesystem keep resume semantics intact.

    Socket ingest is *batched and asynchronous*: a frame's docs for one
    shard coalesce into a single ``prov.add_many`` frame, shipped
    fire-and-forget together with the flush — ingest pays zero RPC
    round-trip waits.  Reads stay exact without barriers (the worker
    executes a connection's requests in order), queries fan out to the
    owning shards concurrently, and write errors surface loudly on the next
    operation or on :meth:`close`.  (The PR 3 ``io_mode="sync"``
    wait-per-ingest fallback is gone; its measured numbers are frozen in
    ``BENCH_net.json`` as the permanent benchmark denominator.)
    """

    def __init__(
        self,
        num_shards: int = 4,
        path: Optional[str] = None,
        registry: Optional[FunctionRegistry] = None,
        k_neighbors: int = 5,
        run_info: Optional[Dict[str, Any]] = None,
        append: bool = False,
        transport: str = "local",
        endpoints=None,
        fault_policy=None,
    ):
        if transport not in ("local", "socket"):
            raise ValueError(f"transport must be 'local' or 'socket', got {transport!r}")
        if transport == "socket":
            if not endpoints:
                raise ValueError("transport='socket' requires endpoints")
            num_shards = len(endpoints)
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.transport = transport
        self.num_shards = num_shards
        self.path = path
        self.registry = registry
        self.k = k_neighbors
        self._seq = 0
        # (seq, severity) per anomaly of the most recent ingest (see
        # ProvenanceDB.last_ingest) — identical across shard counts and
        # transports because the front-end assigns seqs and builds docs.
        self.last_ingest: List[Tuple[int, int]] = []
        self._m_ingest = telemetry.get_registry().histogram(
            "repro_prov_ingest_us",
            "FederatedProvenanceDB.ingest latency in microseconds.",
            ["transport"],
        ).labels(transport=transport)
        header = {"type": "run_info", **static_provenance(run_info)} if path else None
        owned = shard_paths(path, num_shards)
        if transport == "socket":
            from repro_torch.net.shards import RemoteProvenanceShard  # lazy: no core→net dep

            # fault_policy arms crash recovery on every stub: durable worker
            # writes, reconnect + recover-reconfigure + seq-deduped replay
            # on connection loss, degraded-mode spooling (repro_torch.fault).
            self.shards = [
                RemoteProvenanceShard(
                    ep, path=p, append=append, header=header, policy=fault_policy
                )
                for ep, p in zip(endpoints, owned)
            ]
        else:
            self.shards = [
                ProvenanceShard(path=p, append=append, header=header) for p in owned
            ]
        if append:
            # Resume is topology-agnostic: prior docs are gathered from the
            # whole path family (the owned shard files plus any base-path /
            # shardN files a run with a different shard count left behind),
            # re-ordered by their persisted global seq, and re-routed by the
            # *current* cyclic map so queries find them wherever they now
            # belong.  write=False keeps the old files as the docs' only
            # on-disk home — nothing is duplicated or truncated, so a later
            # resume (at any shard count) still sees them.
            resumed: List[Dict[str, Any]] = []
            for shard in self.shards:
                resumed.extend(shard.take_resumed())
            for p in self._extra_resume_paths(owned):
                resumed.extend(_read_docs(p))
            batches: Dict[int, Tuple[List[Dict[str, Any]], List[int]]] = {}
            for doc in _resume_order(resumed):
                seq = doc.get("seq", self._seq)
                s = shard_of(doc["rank"], doc["anomaly"]["fid"], num_shards)
                batches.setdefault(s, ([], []))
                batches[s][0].append(doc)
                batches[s][1].append(seq)
                self._seq = max(self._seq, seq + 1)
            inflight = []
            for s, (docs, seqs) in batches.items():
                shard = self.shards[s]
                add_many_async = getattr(shard, "add_many_async", None)
                if add_many_async is not None:  # one frame per shard, not per doc
                    inflight.append((shard, add_many_async(docs, seqs, write=False)))
                else:
                    for doc, seq in zip(docs, seqs):
                        shard.add(doc, seq, write=False)
            for shard, fut in inflight:
                shard.finish(fut)

    def _extra_resume_paths(self, owned: List[Optional[str]]) -> List[str]:
        """Non-empty provenance files of this path family not owned by the
        current topology (base file and/or stale ``.shard<k>`` files)."""
        if not self.path:
            return []
        root, ext = os.path.splitext(self.path)
        family = [self.path] + sorted(
            glob.glob(glob.escape(root) + ".shard*" + glob.escape(ext))
        )
        owned_set = {p for p in owned if p}
        return [
            p
            for p in family
            if p not in owned_set and os.path.exists(p) and os.path.getsize(p) > 0
        ]

    # ------------------------------------------------------------- mutation
    def ingest(self, result: ADFrameResult, comm_events: Optional[np.ndarray] = None) -> int:
        """Route every anomaly doc of a frame to its owning shard.

        Socket mode coalesces: the frame's docs for one shard travel as a
        single ``prov.add_many`` frame, shipped fire-and-forget together
        with the flush — ingest never waits on a round-trip (per-shard
        order is preserved by the connection, so every later read observes
        the batch).
        """
        t0_ns = time.perf_counter_ns() if telemetry.ENABLED else 0
        batches: Dict[int, Tuple[List[Dict[str, Any]], List[int]]] = {}
        n = 0
        self.last_ingest = []
        for idx in result.anomaly_idx:
            idx = int(idx)
            doc = build_anomaly_doc(result, idx, self.registry, self.k, comm_events)
            s = shard_of(doc["rank"], doc["anomaly"]["fid"], self.num_shards)
            batches.setdefault(s, ([], []))
            batches[s][0].append(doc)
            batches[s][1].append(self._seq)
            self.last_ingest.append((self._seq, int(doc["severity"])))
            self._seq += 1
            n += 1
        for s, (docs, seqs) in batches.items():
            shard = self.shards[s]
            if hasattr(shard, "add_many_nowait"):
                shard.add_many_nowait(docs, seqs)
                shard.flush_nowait()
            else:
                for doc, seq in zip(docs, seqs):
                    shard.add(doc, seq)
                shard.flush()
        if t0_ns:
            self._m_ingest.observe((time.perf_counter_ns() - t0_ns) // 1000)
        return n

    # -------------------------------------------------------------- queries
    def _owning_shards(self, rank: Optional[int], fid: Optional[int]) -> List[ProvenanceShard]:
        """Shards that can hold matching docs: one when (rank, fid) is fully
        specified, all otherwise (cyclic slicing spreads either key alone)."""
        if rank is not None and fid is not None:
            return [self.shards[shard_of(rank, fid, self.num_shards)]]
        return self.shards

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
    ) -> List[Dict[str, Any]]:
        shards = self._owning_shards(rank, fid)
        if shards and hasattr(shards[0], "query_async"):
            # Fan out: one in-flight query per owning shard, collected as
            # they answer — S round-trips overlapped into one.
            futs = [
                s.query_async(rank, fid, step, t0, t1, func, severity, min_severity)
                for s in shards
            ]
            per_shard = [s.finish_query(f) for s, f in zip(shards, futs)]
        else:
            per_shard = [
                s.query(rank, fid, step, t0, t1, func, severity, min_severity)
                for s in shards
            ]
        return [doc for _, doc in heapq.merge(*per_shard, key=lambda sd: sd[0])]

    @property
    def records(self) -> List[Dict[str, Any]]:
        """All docs in global ingest order (the single-store ``records`` view)."""
        if self.shards and hasattr(self.shards[0], "dump_async"):
            futs = [s.dump_async() for s in self.shards]
            per_shard = [s.finish_query(f) for s, f in zip(self.shards, futs)]
        else:
            per_shard = [shard.dump() for shard in self.shards]
        return [doc for _, doc in heapq.merge(*per_shard, key=lambda sd: sd[0])]

    # ------------------------------------------------------------ lifecycle
    def shard_doc_counts(self) -> List[int]:
        """Per-shard doc counts — the load-balance view of the federation."""
        return [len(shard) for shard in self.shards]

    def drain(self) -> None:
        """Barrier: wait out every fire-and-forget socket write (surfacing
        their errors).  No-op for in-process shards."""
        for shard in self.shards:
            drain = getattr(shard, "drain", None)
            if drain is not None:
                drain()

    def flush(self) -> None:
        for shard in self.shards:
            shard.flush()

    def close(self) -> None:
        for shard in self.shards:
            shard.close()

    def __len__(self) -> int:
        return sum(len(shard) for shard in self.shards)
