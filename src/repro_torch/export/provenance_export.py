"""Provenance windows → self-contained Chrome/Perfetto traces.

Renders a federated provenance query result — from the shard JSONL file
family a finished run left on disk, or from the *live* shard endpoints of a
running job — as a trace in which every anomaly doc becomes its own process
group: the ancestor call stack as enclosing duration events, the anomalous
call and its k same-function neighbors as duration events, the attributed
communication events as instants, and the anomaly itself as a
severity-colored instant carrying its provenance doc id.  Open one in
``ui.perfetto.dev`` and you get the paper's Fig. 6 call-stack view with
zero custom UI.

The rendering is transport- and topology-agnostic by construction: docs are
ordered by their global ingest ``seq``, which the federation assigns
identically at any shard count over any transport (core/provenance.py), so
the emitted trace is byte-identical for the same logical run.
"""
# lint: deterministic — byte-identical output across shard counts/transports
from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, IO, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch._unported import unported
from repro_torch.core.events import EXEC_RECORD_DTYPE
from repro_torch.core.provenance import _read_docs, match_doc

from .chrome_trace import ChromeTraceWriter

DEFAULT_PAD_US = 100


def provenance_path_family(source: str) -> List[str]:
    """Every provenance JSONL of one store, whatever the shard topology.

    ``source`` is a monitor output dir (``provenance.jsonl`` assumed), a
    base path, or one shard file; returns the existing non-empty members of
    the ``base[.shardN].jsonl`` family.
    """
    if os.path.isdir(source):
        source = os.path.join(source, "provenance.jsonl")
    root, ext = os.path.splitext(source)
    # Strip only a trailing ``.shard<N>`` suffix from the *basename* — a
    # ".shard" substring elsewhere in the path must not truncate the root.
    head, base = os.path.split(root)
    root = os.path.join(head, re.sub(r"\.shard\d+$", "", base))
    family = [root + ext] + sorted(
        glob.glob(glob.escape(root) + ".shard*" + glob.escape(ext))
    )
    return [p for p in family if os.path.exists(p) and os.path.getsize(p) > 0]


def load_provenance_docs(source: str, **query: Any) -> List[Dict[str, Any]]:
    """Matching anomaly docs of a run dir / path family, in global ingest
    (``seq``) order — the order a federated query would have returned.
    Filtering is :func:`repro_torch.core.provenance.match_doc`, the same per-doc
    predicate the shards run, so file-based and live-endpoint exports of
    one query can never diverge."""
    docs: List[Dict[str, Any]] = []
    for p in provenance_path_family(source):
        docs.extend(_read_docs(p))
    docs = [d for d in docs if match_doc(d, **query)]
    docs.sort(key=lambda d: d.get("seq", 0))
    return docs


def query_live_endpoints(endpoints: Sequence[Tuple[str, int]],
                         **query: Any) -> List[Dict[str, Any]]:
    """Federated provenance query against *running* shard workers.

    In the JAX package it talks ``prov.query`` over
    ``repro.net.client.RPCClient``; the port raises until ``net/`` is
    ported (ROADMAP.md queue 1, item 2b).
    """
    raise unported("query_live_endpoints (repro.net.client)")


def _doc_records(doc: Dict[str, Any], pad_us: int) -> Tuple[np.ndarray, int, Dict[int, str], int]:
    """(records, anomaly_row, names, window_end) for one provenance doc."""
    a = doc["anomaly"]
    window_end = max(
        [int(a["exit"])] + [int(n["exit"]) for n in doc.get("neighbors", [])]
    ) + int(pad_us)
    rows: List[Dict[str, int]] = []
    names: Dict[int, str] = {}

    def _push(fields: Dict[str, Any], func: Optional[str]) -> None:
        if func is not None:
            names[int(fields["fid"])] = str(func)
        rows.append(fields)

    for anc in doc.get("call_stack", []):
        _push(
            {
                "app": int(a.get("app", 0)), "rank": int(doc["rank"]),
                "tid": int(a["tid"]), "fid": int(anc["fid"]),
                "entry": int(anc["entry"]), "exit": window_end,
                "runtime": window_end - int(anc["entry"]),
                "parent_fid": -1, "depth": int(anc["depth"]),
                "n_children": 0, "n_msgs": 0, "label": 0,
            },
            anc.get("func"),
        )
    anomaly_row = len(rows)
    for rec in [a] + list(doc.get("neighbors", [])):
        _push({f: int(rec[f]) for f in EXEC_RECORD_DTYPE.names}, rec.get("func"))
    recs = np.zeros(len(rows), dtype=EXEC_RECORD_DTYPE)
    for i, row in enumerate(rows):
        for f in EXEC_RECORD_DTYPE.names:
            recs[f][i] = row[f]
    return recs, anomaly_row, names, window_end


def _pair_comm_flows(
    docs: Sequence[Dict[str, Any]],
) -> Dict[Tuple[int, int], Tuple[str, int]]:
    """Match SEND/RECV comm instants across ranks into Chrome-trace flows.

    Returns ``{(doc_index, comm_index): ("s"|"f", flow_id)}`` — which comm
    events open/finish a flow arrow.  A SEND on rank A to partner B matches
    the earliest unmatched RECV on rank B from partner A with the same tag,
    equal nbytes, and ``recv.ts >= send.ts`` (FIFO channel order — MPI's
    non-overtaking guarantee for one (src, dst, tag) channel).

    Everything is a pure function of the docs in their global ``seq``
    order: duplicates (one physical event captured by several overlapping
    windows) attach the flow to the first occurrence only, and flow ids
    are assigned in send order — so the emitted trace stays
    byte-deterministic across shard counts and transports.
    """
    sends: Dict[Tuple[int, int, int], List[Tuple[int, int, int, int]]] = {}
    recvs: Dict[Tuple[int, int, int], List[Tuple[int, int, int, int]]] = {}
    seen: set = set()
    for i, doc in enumerate(docs):
        rank = int(doc["rank"])
        for j, c in enumerate(doc.get("comm", [])):
            ctype = int(c.get("ctype", 0))
            partner, tag = int(c["partner"]), int(c.get("tag", 0))
            ts, nbytes = int(c["ts"]), int(c["nbytes"])
            key = (rank, ctype, partner, tag, ts, nbytes, int(c["tid"]))
            if key in seen:
                continue  # same physical event in an overlapping window
            seen.add(key)
            if ctype == 0:  # SEND: channel is (src=rank, dst=partner, tag)
                sends.setdefault((rank, partner, tag), []).append((ts, nbytes, i, j))
            else:  # RECV: the same channel seen from the destination
                recvs.setdefault((partner, rank, tag), []).append((ts, nbytes, i, j))
    flows: Dict[Tuple[int, int], Tuple[str, int]] = {}
    pairs: List[Tuple[Tuple[int, int], Tuple[int, int]]] = []
    for chan, ss in sends.items():
        rr = sorted(recvs.get(chan, []))
        used = [False] * len(rr)
        for ts, nbytes, i, j in sorted(ss):
            for k, (rts, rnb, ri, rj) in enumerate(rr):
                if not used[k] and rts >= ts and rnb == nbytes:
                    used[k] = True
                    pairs.append(((i, j), (ri, rj)))
                    break
    # Flow ids in send (doc, comm) order: stable however channels iterate.
    for flow_id, (s_at, f_at) in enumerate(sorted(pairs), start=1):
        flows[s_at] = ("s", flow_id)
        flows[f_at] = ("f", flow_id)
    return flows


def render_provenance_trace(
    docs: Sequence[Dict[str, Any]],
    out: Optional[IO[str]] = None,
    path: Optional[str] = None,
    gz: bool = False,
    pad_us: int = DEFAULT_PAD_US,
) -> int:
    """Write one self-contained provenance-window trace; returns doc count.

    Each doc renders into its own process group (pid = the doc's global
    ``seq``) so overlapping windows from different anomalies never fight
    over one thread track.  SEND/RECV comm instants whose counterpart
    appears in another doc additionally carry flow events (``ph "s"/"f"``,
    :func:`_pair_comm_flows`), so Perfetto draws the message arrow from
    the sending rank's window to the receiving rank's.
    """
    writer = ChromeTraceWriter(
        out=out, path=path, gz=gz,
        other_data={"content": "provenance windows", "n_docs": len(docs)},
    )
    flows = _pair_comm_flows(docs)
    try:
        for i, doc in enumerate(docs):
            a = doc["anomaly"]
            seq = int(doc.get("seq", 0))
            severity = int(doc.get("severity", 0))
            recs, anomaly_row, names, _end = _doc_records(doc, pad_us)
            func = a.get("func", f"func_{int(a['fid'])}")
            writer.set_process(
                seq, f"anomaly seq={seq} rank={int(doc['rank'])} {func}",
                sort_index=seq,
            )
            writer.add_frame(
                rank=doc["rank"], step=doc["step"], records=recs, names=names,
                anomalies=[(anomaly_row, seq, severity)], pid=seq,
            )
            for j, c in enumerate(doc.get("comm", [])):
                kind = "send" if int(c.get("ctype", 0)) == 0 else "recv"
                args = {
                    "partner": int(c["partner"]), "nbytes": int(c["nbytes"]),
                    "tag": int(c.get("tag", 0)),
                }
                writer.instant(seq, int(c["tid"]), f"comm {kind}",
                               int(c["ts"]), args=args)
                flow = flows.get((i, j))
                if flow is None:
                    continue
                side, flow_id = flow
                emit = writer.flow_start if side == "s" else writer.flow_finish
                emit(seq, int(c["tid"]), "msg", int(c["ts"]), flow_id, args=args)
    finally:
        writer.close()
    return len(docs)
