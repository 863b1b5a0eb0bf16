"""Streaming Trace Event Format (Chrome trace / Perfetto) writer.

Emits the JSON Object Format (``{"traceEvents": [...]}``) incrementally —
one event per line, written as frames arrive — so a full run exports in
O(window) memory at production event rates: the only state carried between
frames is, per (pid, tid) track, the stack of still-open duration events
(bounded by call depth) plus a high-water timestamp.

Event mapping (docs/export.md has the full table):

  * completed exec records (``EXEC_RECORD_DTYPE``) → ``B``/``E`` duration
    pairs on the (pid=rank, tid) track, reconstructed in nesting order from
    the records' entry/exit/depth — the call-stack builder's output replayed
    as brackets.  Within one frame the records are sorted by
    (entry, -exit, depth) and swept with an explicit stack, so the emitted
    order *is* a valid bracket sequence even under timestamp ties.
  * records whose entry precedes the track's emission high-water mark
    (calls carried open across frames whose descendants already exported)
    cannot retro-open a ``B`` without breaking nesting; they are emitted as
    async span pairs (``b``/``e``, cat ``"carried"``) on the same track —
    same data, rendered on Perfetto's async rail instead of the thread
    stack.
  * anomalies → ``i`` (instant) events at the anomalous entry, args carrying
    the provenance doc id (``prov_seq``), severity, runtime; severity picks
    the highlight color.
  * the AD statistics stream → one ``C`` (counter) event per analyzed frame
    (records / kept / anomalies series per rank).

Output is byte-deterministic for a given logical input: events are serialized
with sorted keys and fixed separators, and every derived quantity is a pure
function of the record stream.  :func:`validate_trace` is the schema lock the
tests and CI enforce — per-track B/E balance, name-matched nesting,
non-decreasing duration timestamps, matched async pairs.
"""
# lint: deterministic — byte-identical output across shard counts/transports
from __future__ import annotations

import gzip
import io
import json
from typing import Any, Dict, IO, List, Optional, Sequence, Tuple, Union

import numpy as np

_SEP = (",", ":")


def _dumps(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, separators=_SEP)


def severity_color(severity: int) -> str:
    """Chrome trace ``cname`` for an anomaly severity bucket (0..10)."""
    if severity >= 6:
        return "terrible"
    if severity >= 3:
        return "bad"
    return "yellow"


class _GzipTextFile(io.TextIOWrapper):
    """TextIOWrapper over a GzipFile that also closes the *raw* file.

    ``GzipFile(fileobj=raw)`` never closes ``raw``, so without this the
    buffered tail (gzip trailer included) only reaches disk when the
    interpreter happens to collect the handle."""

    def __init__(self, gzf: gzip.GzipFile, raw: IO[bytes]):
        super().__init__(gzf, encoding="utf-8", newline="\n")
        self._raw = raw

    def close(self) -> None:
        try:
            super().close()  # flushes text + writes the gzip trailer
        finally:
            self._raw.close()


def open_trace_out(path: str, gz: bool = False) -> IO[str]:
    """Text handle for a trace file; gzip output is byte-deterministic
    (fixed mtime, no embedded filename)."""
    if gz or path.endswith(".gz"):
        raw = open(path, "wb")
        gzf = gzip.GzipFile(filename="", mode="wb", fileobj=raw, mtime=0)
        return _GzipTextFile(gzf, raw)
    return open(path, "w", encoding="utf-8", newline="\n")


class _Track:
    __slots__ = ("stack", "max_ts")

    def __init__(self) -> None:
        # stack entries: (exit_ts, depth, name) of emitted-open B events
        self.stack: List[Tuple[int, int, str]] = []
        self.max_ts = 0


class ChromeTraceWriter:
    """Incremental Trace Event Format writer (see module docstring).

    ``out`` is a text file-like; the caller owns it unless it was opened by
    this writer via ``path=``.  Events stream out as they are added; nothing
    but per-track open stacks is retained.  :meth:`close` closes every open
    duration and finalizes the JSON document.
    """

    def __init__(
        self,
        out: Optional[IO[str]] = None,
        path: Optional[str] = None,
        gz: bool = False,
        other_data: Optional[Dict[str, Any]] = None,
    ):
        if (out is None) == (path is None):
            raise ValueError("pass exactly one of out= / path=")
        self._own = out is None
        self._out = open_trace_out(path, gz) if out is None else out
        self._n = 0
        self._async_id = 0
        self._tracks: Dict[Tuple[int, int], _Track] = {}
        self._procs: Dict[int, bool] = {}
        self._threads: Dict[Tuple[int, int], bool] = {}
        self._closed = False
        meta = {"schema": "repro.export/1", "format": "Trace Event Format"}
        if other_data:
            meta.update(other_data)
        self._out.write(
            '{"displayTimeUnit":"ms","otherData":' + _dumps(meta)
            + ',"traceEvents":[\n'
        )

    # --------------------------------------------------------------- low level
    def _emit(self, evt: Dict[str, Any]) -> None:
        prefix = ",\n" if self._n else ""
        self._out.write(prefix + _dumps(evt))
        self._n += 1

    def set_process(self, pid: int, name: str, sort_index: Optional[int] = None) -> None:
        """Name a pid's process group (idempotent; first call wins)."""
        if self._procs.get(pid):
            return
        self._procs[pid] = True
        self._emit({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                    "args": {"name": name}})
        self._emit({"ph": "M", "pid": pid, "tid": 0, "name": "process_sort_index",
                    "args": {"sort_index": pid if sort_index is None else sort_index}})

    def _ensure_thread(self, pid: int, tid: int) -> None:
        if self._threads.get((pid, tid)):
            return
        self._threads[(pid, tid)] = True
        self._emit({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                    "args": {"name": f"tid {tid}"}})

    def instant(self, pid: int, tid: int, name: str, ts: int,
                args: Optional[Dict[str, Any]] = None,
                cname: Optional[str] = None) -> None:
        evt = {"ph": "i", "s": "t", "pid": pid, "tid": tid, "name": name,
               "ts": int(ts), "args": args or {}}
        if cname is not None:
            evt["cname"] = cname
        self._emit(evt)

    def counter(self, pid: int, name: str, ts: int, values: Dict[str, int]) -> None:
        self._emit({"ph": "C", "pid": pid, "tid": 0, "name": name,
                    "ts": int(ts), "args": {k: int(v) for k, v in values.items()}})

    def complete(self, pid: int, tid: int, name: str, ts: int, dur: int,
                 args: Optional[Dict[str, Any]] = None,
                 cat: Optional[str] = None) -> None:
        """Complete event (``ph: "X"``): a span with explicit duration.

        Used for spans whose begin/end arrive together — e.g. the
        telemetry self-trace (the analyzer's own RPC dispatch / heavy
        offload / frame ingest regions), which lands in its own process
        group next to the workload tracks.  Both timestamps come from the
        caller, so this stays inside the module's determinism contract.
        """
        self._ensure_thread(pid, tid)
        evt: Dict[str, Any] = {"ph": "X", "pid": pid, "tid": tid,
                               "name": name, "ts": int(ts),
                               "dur": max(int(dur), 0)}
        if args:
            evt["args"] = args
        if cat is not None:
            evt["cat"] = cat
        self._emit(evt)

    # Flow events (ph "s"/"f"): Perfetto draws an arrow from the start to
    # the finish — how a SEND on one rank points at its RECV on another,
    # or (cat "rpc") a client span at its server span on another process.
    def flow_start(self, pid: int, tid: int, name: str, ts: int, flow_id: int,
                   args: Optional[Dict[str, Any]] = None,
                   cat: str = "comm") -> None:
        self._emit({"ph": "s", "cat": cat, "id": int(flow_id), "pid": pid,
                    "tid": tid, "name": name, "ts": int(ts), "args": args or {}})

    def flow_finish(self, pid: int, tid: int, name: str, ts: int, flow_id: int,
                    args: Optional[Dict[str, Any]] = None,
                    cat: str = "comm") -> None:
        # bp:"e" binds the finish to the enclosing slice (the modern
        # next-slice semantics confuse Perfetto when the finish is bare).
        self._emit({"ph": "f", "bp": "e", "cat": cat, "id": int(flow_id),
                    "pid": pid, "tid": tid, "name": name, "ts": int(ts),
                    "args": args or {}})

    # ------------------------------------------------------------ frame export
    def add_frame(
        self,
        rank: int,
        step: int,
        records: np.ndarray,
        names: Optional[Dict[int, str]] = None,
        anomalies: Sequence[Sequence[int]] = (),
        n_records: Optional[int] = None,
        n_anomalies: Optional[int] = None,
        ts: Optional[int] = None,
        pid: Optional[int] = None,
    ) -> None:
        """Stream one analyzed frame's kept records.

        ``records`` is an ``EXEC_RECORD_DTYPE`` array (the reduced stream for
        one (rank, step)); ``anomalies`` are ``(kept_idx, prov_seq,
        severity)`` triples linking anomalous records to their provenance
        docs (``prov_seq < 0`` = no doc); ``n_records`` / ``n_anomalies`` /
        ``ts`` describe the *full* pre-reduction frame and feed the counter
        track.
        """
        pid = int(rank) if pid is None else int(pid)
        self.set_process(pid, f"rank {int(rank)}")
        names = names or {}
        step = int(step)
        # --- duration sweep, one pass per tid --------------------------------
        tids = np.unique(records["tid"]) if len(records) else []
        for tid in tids:
            tid = int(tid)
            self._ensure_thread(pid, tid)
            track = self._tracks.setdefault((pid, tid), _Track())
            sel = np.nonzero(records["tid"] == tid)[0]
            order = sorted(
                range(len(sel)),
                key=lambda i: (
                    int(records["entry"][sel[i]]),
                    -int(records["exit"][sel[i]]),
                    int(records["depth"][sel[i]]),
                    i,
                ),
            )
            for i in order:
                r = records[sel[i]]
                entry, exit_ = int(r["entry"]), int(r["exit"])
                depth, fid = int(r["depth"]), int(r["fid"])
                name = names.get(fid, f"func_{fid}")
                # close open calls this record does not nest into
                while track.stack and not self._nests(
                    track.stack[-1], exit_, depth
                ):
                    x, _d, n = track.stack.pop()
                    self._emit({"ph": "E", "pid": pid, "tid": tid,
                                "name": n, "ts": x})
                    track.max_ts = max(track.max_ts, x)
                if entry >= track.max_ts:
                    self._emit({"ph": "B", "pid": pid, "tid": tid, "name": name,
                                "ts": entry, "args": {"fid": fid}})
                    track.max_ts = max(track.max_ts, entry)
                    track.stack.append((exit_, depth, name))
                else:
                    # carried-open call completing after its descendants
                    # already exported: async span, same track (see module
                    # docstring).
                    self._async_id += 1
                    common = {"pid": pid, "tid": tid, "cat": "carried",
                              "id": self._async_id, "name": name}
                    self._emit({"ph": "b", "ts": entry,
                                "args": {"fid": fid}, **common})
                    self._emit({"ph": "e", "ts": exit_, **common})
        # --- anomaly instants ------------------------------------------------
        for kept_idx, seq, severity in anomalies:
            r = records[int(kept_idx)]
            fid = int(r["fid"])
            args = {
                "fid": fid,
                "func": names.get(fid, f"func_{fid}"),
                "prov_seq": int(seq) if int(seq) >= 0 else None,
                "runtime_us": int(r["runtime"]),
                "severity": int(severity),
                "step": step,
            }
            self.instant(pid, int(r["tid"]), "anomaly", int(r["entry"]), args,
                         cname=severity_color(int(severity)))
        # --- AD statistics counter track -------------------------------------
        if ts is not None:
            self.counter(pid, "ad_stats", int(ts), {
                "records": len(records) if n_records is None else int(n_records),
                "kept": len(records),
                "anomalies": len(anomalies) if n_anomalies is None else int(n_anomalies),
            })

    @staticmethod
    def _nests(top: Tuple[int, int, str], exit_: int, depth: int) -> bool:
        """Does a call ending at ``exit_`` at ``depth`` nest inside the open
        ``top``?  (Entry containment is implied: the sweep visits records in
        ascending-entry order, so a candidate's entry is ≥ the top's.)"""
        t_exit, t_depth, _ = top
        return exit_ <= t_exit and depth > t_depth

    # ---------------------------------------------------------------- lifecycle
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for (pid, tid) in sorted(self._tracks):
            track = self._tracks[(pid, tid)]
            while track.stack:
                x, _d, n = track.stack.pop()
                self._emit({"ph": "E", "pid": pid, "tid": tid, "name": n, "ts": x})
        self._out.write("\n]}\n")
        self._out.flush()
        if self._own:
            self._out.close()


# ----------------------------------------------------------------- RPC spans
# Span tracks land in their own pid block, above the self-trace group
# (SELF_TRACE_PID = 1<<20) and far above workload ranks.
SPAN_PID_BASE = 1 << 21

# Only spans that are both logically derived (STABLE) and tail-sampled
# (SAMPLED) are exportable — see repro/telemetry/spans.py flag bits.
_SPAN_EXPORT_FLAGS = 3


def _hexid(v: int) -> str:
    return format(int(v), "016x")


def render_spans(
    writer: ChromeTraceWriter,
    spans_by_proc: Dict[str, Sequence[Dict[str, Any]]],
) -> int:
    """Render federated RPC spans as cross-process trees + flow arrows.

    ``spans_by_proc`` maps a process label (``"monitor"``,
    ``"shard:host:port"``) to that process's collected span dicts.  Output
    is a pure function of the *logical* span set: spans are deduplicated by
    ``(trace, span)`` id (crash replay makes duplicates routine), filtered
    to STABLE∧SAMPLED, and drawn on a logical clock — each trace is an
    Euler tour assigning one tick per span entry/exit, traces ordered by
    their root's ``ord`` (step, rank).  Real timings never enter the
    rendering (they differ run to run; the ``/spans`` endpoint serves
    them), so a quiesced run's export is byte-identical across repeats.

    Each span becomes an ``X`` event (``cat: "span"``) on its process's
    track, args carrying the hex trace/span/parent ids and the span kind.
    Every client span with a matched server/worker child gets a ``cat:
    "rpc"`` flow arrow (``s`` at the client entry tick, ``f`` at the server
    entry tick; the child's entry tick is strictly inside the parent's, so
    the pair always validates).  Returns the number of spans rendered.
    """
    by_key: Dict[Tuple[int, int], Tuple[Dict[str, Any], str]] = {}
    for proc in sorted(spans_by_proc):
        for span in spans_by_proc[proc]:
            if (span.get("flags", 0) & _SPAN_EXPORT_FLAGS) != _SPAN_EXPORT_FLAGS:
                continue
            by_key.setdefault((span["trace"], span["span"]), (span, proc))
    if not by_key:
        return 0
    procs = sorted({proc for _s, proc in by_key.values()})
    pid_of = {p: SPAN_PID_BASE + i for i, p in enumerate(procs)}
    for p in procs:
        writer.set_process(pid_of[p], f"spans:{p}", sort_index=pid_of[p])
    traces: Dict[int, Dict[int, Tuple[Dict[str, Any], str]]] = {}
    for (trace, sid), member in by_key.items():
        traces.setdefault(trace, {})[sid] = member

    def _trace_key(item):
        trace, members = item
        ords = [tuple(s["ord"]) for s, _p in members.values() if "ord" in s]
        # Traces with a frame root sort by (step, rank); stragglers after.
        return (0, min(ords), trace) if ords else (1, (), trace)

    tick = 0
    rendered = 0
    for trace, members in sorted(traces.items(), key=_trace_key):
        children: Dict[int, List[int]] = {}
        roots: List[int] = []
        for sid, (span, _proc) in members.items():
            parent = int(span.get("parent", 0))
            if parent and parent in members:
                children.setdefault(parent, []).append(sid)
            else:
                roots.append(sid)

        def _sib_key(sid, _m=members):
            span, _p = _m[sid]
            return (0 if "ord" in span else 1, span["name"], sid)

        entry_tick: Dict[int, int] = {}
        exit_tick: Dict[int, int] = {}
        stack = [(sid, False) for sid in sorted(roots, key=_sib_key, reverse=True)]
        while stack:
            sid, leaving = stack.pop()
            if leaving:
                exit_tick[sid] = tick
                tick += 1
                continue
            entry_tick[sid] = tick
            tick += 1
            stack.append((sid, True))
            for c in sorted(children.get(sid, ()), key=_sib_key, reverse=True):
                stack.append((c, False))
        for sid in sorted(entry_tick, key=entry_tick.get):
            span, proc = members[sid]
            args = {
                "kind": span["kind"],
                "parent": _hexid(span.get("parent", 0)),
                "span": _hexid(sid),
                "trace": _hexid(trace),
            }
            if span.get("err"):
                args["err"] = 1
            writer.complete(
                pid_of[proc], 0, span["name"], entry_tick[sid],
                exit_tick[sid] - entry_tick[sid], args, cat="span",
            )
            rendered += 1
            if span["kind"] != "client":
                continue
            for c in sorted(children.get(sid, ()), key=_sib_key):
                cspan, cproc = members[c]
                if cspan["kind"] in ("server", "worker"):
                    writer.flow_start(
                        pid_of[proc], 0, "rpc", entry_tick[sid], sid, cat="rpc"
                    )
                    writer.flow_finish(
                        pid_of[cproc], 0, "rpc", entry_tick[c], sid, cat="rpc"
                    )
                    break
    return rendered


# --------------------------------------------------------------------- checks
def _load(source: Union[str, IO[str], Dict[str, Any]]) -> Dict[str, Any]:
    if isinstance(source, dict):
        return source
    if hasattr(source, "read"):
        return json.load(source)
    # Sniff the gzip magic rather than trusting the suffix: --gzip output
    # may carry any name, and a .gz-named plain file should still parse.
    with open(source, "rb") as f:
        magic = f.read(2)
    opener = gzip.open if magic == b"\x1f\x8b" else open
    with opener(source, "rt", encoding="utf-8") as f:
        return json.load(f)


def validate_trace(source: Union[str, IO[str], Dict[str, Any]]) -> Dict[str, int]:
    """Parse + structurally validate a trace; returns summary counts.

    Locks the invariants the exporter promises: per (pid, tid) track every
    ``B`` has a name-matched ``E`` in valid nesting order with
    non-decreasing timestamps (so Perfetto's stable timestamp sort preserves
    the emitted bracket order), async ``b``/``e`` pairs match by (cat, id),
    instants carry a scope and args, counters carry numeric args.  Raises
    ``ValueError`` on any violation.
    """
    doc = _load(source)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("traceEvents missing or not a list")
    stacks: Dict[Tuple[int, int], List[Tuple[str, int]]] = {}
    last_ts: Dict[Tuple[int, int], int] = {}
    open_async: Dict[Tuple[str, int], int] = {}
    flow_s: Dict[Tuple[str, int], int] = {}
    flow_f: Dict[Tuple[str, int], int] = {}
    counts = {"events": len(events), "durations": 0, "instants": 0,
              "counters": 0, "async": 0, "metadata": 0, "flows": 0,
              "completes": 0}
    for k, e in enumerate(events):
        ph = e.get("ph")
        key = (e.get("pid"), e.get("tid"))
        if ph == "M":
            counts["metadata"] += 1
            continue
        ts = e.get("ts")
        if not isinstance(ts, int):
            raise ValueError(f"event {k}: non-integer ts {ts!r}")
        if ph in ("B", "E"):
            if ts < last_ts.get(key, 0):
                raise ValueError(f"event {k}: duration ts regressed on {key}")
            last_ts[key] = ts
            stack = stacks.setdefault(key, [])
            if ph == "B":
                stack.append((e.get("name"), ts))
            else:
                if not stack:
                    raise ValueError(f"event {k}: E without open B on {key}")
                name, b_ts = stack.pop()
                if e.get("name") != name:
                    raise ValueError(
                        f"event {k}: E name {e.get('name')!r} != open B {name!r}")
                if ts < b_ts:
                    raise ValueError(f"event {k}: E before its B on {key}")
                counts["durations"] += 1
        elif ph in ("b", "e"):
            akey = (e.get("cat"), e.get("id"))
            if None in akey:
                raise ValueError(f"event {k}: async event missing cat/id")
            if ph == "b":
                if akey in open_async:
                    raise ValueError(f"event {k}: async id reopened {akey}")
                open_async[akey] = ts
            else:
                if akey not in open_async:
                    raise ValueError(f"event {k}: async e without b {akey}")
                if ts < open_async.pop(akey):
                    raise ValueError(f"event {k}: async e before its b {akey}")
                counts["async"] += 1
        elif ph in ("s", "f"):
            fkey = (e.get("cat"), e.get("id"))
            if None in fkey:
                raise ValueError(f"event {k}: flow event missing cat/id")
            # File order between the two halves is NOT constrained — a RECV
            # doc can precede its SEND doc in ingest order — so pairing and
            # the ts ordering are checked after the full pass.
            side = flow_s if ph == "s" else flow_f
            if fkey in side:
                raise ValueError(f"event {k}: duplicate flow {ph!r} for {fkey}")
            side[fkey] = ts
        elif ph == "i":
            if e.get("s") not in ("t", "p", "g"):
                raise ValueError(f"event {k}: instant missing scope")
            if not isinstance(e.get("args"), dict):
                raise ValueError(f"event {k}: instant args missing")
            counts["instants"] += 1
        elif ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not all(
                isinstance(v, (int, float)) for v in args.values()
            ):
                raise ValueError(f"event {k}: counter args must be numeric")
            counts["counters"] += 1
        elif ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, int) or dur < 0:
                raise ValueError(f"event {k}: complete event dur must be a"
                                 f" non-negative integer, got {dur!r}")
            counts["completes"] += 1
        else:
            raise ValueError(f"event {k}: unknown phase {ph!r}")
    unbalanced = {k: v for k, v in stacks.items() if v}
    if unbalanced:
        raise ValueError(f"unbalanced B events on tracks: {sorted(unbalanced)}")
    if open_async:
        raise ValueError(f"unmatched async b events: {sorted(open_async)}")
    if set(flow_s) != set(flow_f):
        lone = sorted(set(flow_s).symmetric_difference(flow_f))
        raise ValueError(f"unpaired flow events: {lone}")
    for fkey, ts_s in flow_s.items():
        if flow_f[fkey] < ts_s:
            raise ValueError(f"flow {fkey}: finish ts precedes start ts")
    counts["flows"] = len(flow_s)
    counts["tracks"] = len(stacks)
    return counts
