"""Visualization backend (data products of paper Figs. 3–6).

No web stack offline — this module reproduces exactly the *data* each view
renders, with the same two-client structure as the paper's server (§IV):
data senders (PS + on-node modules via ChimbukoMonitor) and users (queries
below).  A JSON dump stands in for the websocket broadcast.

  rank_dashboard    Fig. 3: most/least problematic ranks by a chosen stat
  frame_series      Fig. 4: streaming (step, #anomalies) scatter per rank
  function_view     Fig. 5: executed functions of one (rank, frame) with
                    selectable axes (entry/exit/runtime/fid/label/children/messages)
  call_stack_view   Fig. 6: call stack around an anomaly with comm arrows
  provenance_view   §V: raw provenance docs for a (rank, fid, step, window)
                    query, served through the (possibly sharded) provenance DB
  trace             the reduced record stream as a Perfetto-openable Chrome
                    trace (repro_torch.export) — fetchable from a running job

JSON schemas for all endpoints (and which paper figure each
reproduces) are documented in docs/viz.md.  The endpoints are agnostic to
the PS topology: a sharded ``FederatedPS`` serves them through the same
``AnomalyFeed`` interface as the single-instance server, and its stats
snapshots come from the federation's lock-free aggregation pass.
"""
# lint: deterministic — byte-identical output across shard counts/transports
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.trace.monitor import ChimbukoMonitor

_AXES = {"fid", "entry", "exit", "runtime", "label", "n_children", "n_msgs", "depth"}


class VizServer:
    def __init__(self, monitor: ChimbukoMonitor):
        self.monitor = monitor

    # ---------------------------------------------------------------- Fig 3
    def rank_dashboard(
        self, stat: str = "stddev", top: int = 5, bottom: int = 5
    ) -> Dict[str, Any]:
        dash = self.monitor.ps.rank_dashboard()
        key = {"average": "average", "stddev": "stddev", "maximum": "maximum",
               "minimum": "minimum", "total": "total"}[stat]
        ranked = sorted(dash.items(), key=lambda kv: kv[1][key], reverse=True)
        # top and bottom must not double-report a rank when there are fewer
        # than top + bottom ranks: bottom draws from the remainder only, and
        # is returned least-problematic first (ascending stat).
        rest = ranked[top:]
        return {
            "stat": stat,
            "top": [{"rank": r, **v} for r, v in ranked[:top]],
            "bottom": [
                {"rank": r, **v}
                for r, v in rest[max(len(rest) - bottom, 0):][::-1]
            ],
        }

    # ---------------------------------------------------------------- Fig 4
    def frame_series(self, rank: int) -> List[Dict[str, int]]:
        return [
            {"step": s, "n_anomalies": n}
            for s, n in self.monitor.ps.frame_series(rank)
        ]

    # ---------------------------------------------------------------- Fig 5
    def function_view(
        self, rank: int, step: int, x: str = "entry", y: str = "fid"
    ) -> Dict[str, Any]:
        assert x in _AXES and y in _AXES, (x, y)
        recs = self.monitor.kept.get((rank, step))
        if recs is None or not len(recs):
            return {"rank": rank, "step": step, "points": []}
        reg = self.monitor.registry
        pts = [
            {
                "x": int(r[x]), "y": int(r[y]),
                "func": reg.name_of(int(r["fid"])),
                "label": int(r["label"]),
                "runtime": int(r["runtime"]),
                "n_children": int(r["n_children"]),
                "n_msgs": int(r["n_msgs"]),
            }
            for r in recs
        ]
        return {"rank": rank, "step": step, "x": x, "y": y, "points": pts}

    # ---------------------------------------------------------------- Fig 6
    def call_stack_view(
        self, rank: int, t0: int, t1: int, fid: Optional[int] = None
    ) -> Dict[str, Any]:
        docs = self.monitor.provdb.query(rank=rank, fid=fid, t0=t0, t1=t1)
        reg = self.monitor.registry
        bars, arrows = [], []
        for doc in docs:
            a = doc["anomaly"]
            bars.append(
                {
                    "func": a.get("func", str(a["fid"])), "entry": a["entry"],
                    "exit": a["exit"], "depth": a["depth"], "label": 1,
                }
            )
            for anc in doc["call_stack"]:
                bars.append(
                    {"func": anc["func"], "entry": anc["entry"], "exit": t1,
                     "depth": anc["depth"], "label": 0}
                )
            for nb in doc["neighbors"]:
                bars.append(
                    {"func": nb.get("func", str(nb["fid"])), "entry": nb["entry"],
                     "exit": nb["exit"], "depth": nb["depth"], "label": int(nb["label"] == 1)}
                )
            for c in doc["comm"]:
                arrows.append(
                    {"ts": c["ts"], "partner": c["partner"], "nbytes": c["nbytes"],
                     "kind": "send" if c["ctype"] == 0 else "recv"}
                )
        return {"rank": rank, "t0": t0, "t1": t1, "bars": bars, "comm": arrows}

    # ---------------------------------------------------------- provenance
    def provenance_view(
        self,
        rank: Optional[int] = None,
        fid: Optional[int] = None,
        step: Optional[int] = None,
        t0: Optional[int] = None,
        t1: Optional[int] = None,
        func: Optional[str] = None,
        severity: Optional[int] = None,
        min_severity: Optional[int] = None,
        limit: int = 100,
    ) -> Dict[str, Any]:
        """Raw provenance query endpoint (paper §V) over the provenance DB.

        Transparent to the store topology: a ``FederatedProvenanceDB`` fans
        the query out to the owning shards and merge-returns docs in the
        same global ingest order a single store would.  ``func`` (function
        name), ``severity`` (exact bucket), and ``min_severity``
        (threshold) are the drill-down axes backed by the shards' secondary
        posting lists.
        """
        docs = self.monitor.provdb.query(
            rank=rank, fid=fid, step=step, t0=t0, t1=t1,
            func=func, severity=severity, min_severity=min_severity,
        )
        return {
            "query": {"rank": rank, "fid": fid, "step": step, "t0": t0, "t1": t1,
                      "func": func, "severity": severity,
                      "min_severity": min_severity},
            "n_total": len(docs),
            "docs": docs[:limit],
            "topology": {
                "shards": getattr(self.monitor.provdb, "num_shards", 1),
                "n_records": len(self.monitor.provdb),
            },
        }

    # ------------------------------------------------------------- export
    def write_trace(self, out) -> int:
        """Stream the monitor's reduced record stream into ``out`` (a text
        file-like) as a Chrome trace; returns the frame count.

        Drives the same writer the live ``export_trace=`` path and the
        offline ``python -m repro_torch.export`` CLI drive, in the same ingestion
        order — so whatever consumes ``out`` (a buffer, the gateway's
        chunked-transfer stream) gets byte-for-byte the file the finished
        run would export.
        """
        from repro_torch.export.chrome_trace import ChromeTraceWriter

        writer = ChromeTraceWriter(out=out)
        names = self.monitor.registry.names
        n = 0
        for (rank, step), kept in self.monitor.kept.items():
            ts, n_records, n_anoms = self.monitor.frame_meta.get(
                (rank, step), (None, len(kept), 0)
            )
            writer.add_frame(
                rank, step, kept, names,
                anomalies=self.monitor.anom_meta.get((rank, step), ()),
                n_records=n_records, n_anomalies=n_anoms, ts=ts,
            )
            n += 1
        writer.close()
        return n

    def trace(self, path: Optional[str] = None) -> bytes:
        """``/trace`` endpoint: the monitor's reduced record stream as a
        Perfetto-openable Chrome trace (docs/export.md).  Returns the bytes;
        also writes them to ``path`` when given."""
        import io as _io

        buf = _io.StringIO()
        self.write_trace(buf)
        data = buf.getvalue().encode("utf-8")
        if path:
            with open(path, "wb") as f:
                f.write(data)
        return data

    def dump(self, path: str, ranks: Optional[List[int]] = None) -> None:
        ranks = ranks if ranks is not None else sorted(self.monitor.ads.keys())
        doc = {
            "dashboard": self.rank_dashboard(),
            "series": {r: self.frame_series(r) for r in ranks},
            "summary": self.monitor.summary(),
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)
