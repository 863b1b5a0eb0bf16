"""Persisted reduced record stream (``stream.jsonl``) + offline replay.

The monitor's in-situ path reduces each analyzed frame to anomalies + k
neighbors (core/reduction.py); this module gives that reduced stream a
durable, replayable on-disk form so ``python -m repro_torch.export`` can produce a
trace from a *finished* monitor output dir byte-identical to the one the
live ``export_trace=`` writer produced during the run.

One JSON line per ingested frame, written as frames arrive (streaming, like
everything else in this package):

    {"type": "header", "version": 1}
    {"type": "frame", "rank": R, "step": S, "ts": T|null,
     "n_records": M, "n_anomalies": A,
     "records": [[app, rank, tid, fid, entry, exit, runtime, parent_fid,
                  depth, n_children, n_msgs, label], ...],
     "anom": [[kept_idx, prov_seq, severity], ...],
     "new_funcs": {"<fid>": "<name>", ...}}

``records`` rows are the kept ``EXEC_RECORD_DTYPE`` fields in dtype order;
``anom`` links anomalous kept records to their provenance doc ids (the
global ingest ``seq`` the provenance store assigned — identical across
shard counts and transports, which is what makes the export byte-identical
across topologies); ``new_funcs`` carries each function name the first time
one of its records appears, so a single forward pass can name every event.
"""
# lint: deterministic — byte-identical output across shard counts/transports
from __future__ import annotations

import json
from typing import Any, Dict, IO, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.core.events import EXEC_RECORD_DTYPE

from .chrome_trace import ChromeTraceWriter

_FIELDS = list(EXEC_RECORD_DTYPE.names)


class RecordStreamWriter:
    """Append-per-frame JSONL writer for the reduced record stream.

    ``append=True`` resumes a prior run's stream the way the provenance
    store does: the existing file keeps its single header and all complete
    frames, a torn final line (the prior run died mid-write) is truncated
    away, and the fid → name dedup state (``new_funcs`` emission) is
    recovered from the surviving prefix so resumed frames never re-announce
    a name — the replay contract stays "one header, names before first
    use" across any number of resume segments.
    """

    def __init__(self, path: str, append: bool = False):
        self.path = path
        self._seen_fids: set = set()
        resumed = append and self._recover(path)
        if resumed:
            self._fh: Optional[IO[str]] = open(
                path, "a", encoding="utf-8", newline="\n"
            )
        else:
            self._fh = open(path, "w", encoding="utf-8", newline="\n")
            self._fh.write(json.dumps({"type": "header", "version": 1},
                                      sort_keys=True, separators=(",", ":")) + "\n")

    def _recover(self, path: str) -> bool:
        """Scan an existing stream: rebuild ``_seen_fids``, truncate any
        torn tail.  Returns False (start fresh) when there is nothing to
        resume from."""
        import os

        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return False
        if not raw:
            return False
        good_end = 0
        for line in raw.splitlines(keepends=True):
            if not line.endswith(b"\n"):
                break  # torn tail of a killed run
            text = line.strip()
            if text:
                try:
                    doc = json.loads(text)
                except json.JSONDecodeError:
                    break  # complete but corrupt line: cut here too
                for fid in doc.get("new_funcs", {}):
                    self._seen_fids.add(int(fid))
            good_end += len(line)
        if good_end == 0:
            self._seen_fids.clear()
            return False
        if good_end < len(raw):
            with open(path, "r+b") as f:
                f.truncate(good_end)
        return True

    def add_frame(
        self,
        rank: int,
        step: int,
        records: np.ndarray,
        names: Dict[int, str],
        anomalies: Sequence[Sequence[int]] = (),
        n_records: int = 0,
        n_anomalies: int = 0,
        ts: Optional[int] = None,
    ) -> None:
        new_funcs = {}
        for fid in np.unique(records["fid"]) if len(records) else []:
            fid = int(fid)
            if fid not in self._seen_fids:
                self._seen_fids.add(fid)
                new_funcs[str(fid)] = names.get(fid, f"func_{fid}")
        line = {
            "type": "frame",
            "rank": int(rank),
            "step": int(step),
            "ts": None if ts is None else int(ts),
            "n_records": int(n_records),
            "n_anomalies": int(n_anomalies),
            "records": [[int(r[f]) for f in _FIELDS] for r in records],
            "anom": [[int(a), int(b), int(c)] for a, b, c in anomalies],
            "new_funcs": new_funcs,
        }
        self._fh.write(json.dumps(line, sort_keys=True, separators=(",", ":")) + "\n")
        # Per-frame flush, like the provenance store: a killed run leaves a
        # replayable prefix on disk, not a tail stuck in a userspace buffer.
        self._fh.flush()

    def flush(self) -> None:
        if self._fh:
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def iter_stream_frames(path: str) -> Iterator[Dict[str, Any]]:
    """Replay a ``stream.jsonl``: yields frame dicts with ``records`` as an
    ``EXEC_RECORD_DTYPE`` array and ``names`` as the registry accumulated so
    far (grows across yields — consume before advancing).

    A torn final line (the writer was killed mid-write) ends the replay:
    the complete prefix exports, matching the crashed run's observable
    history."""
    names: Dict[int, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except json.JSONDecodeError:
                break  # torn tail of a killed run: the prefix is the stream
            if doc.get("type") != "frame":
                continue
            for fid, name in doc.get("new_funcs", {}).items():
                names[int(fid)] = name
            rows = doc["records"]
            recs = np.zeros(len(rows), dtype=EXEC_RECORD_DTYPE)
            if rows:
                cols = np.asarray(rows, dtype=np.int64)
                for j, fname in enumerate(_FIELDS):
                    recs[fname] = cols[:, j]
            yield {
                "rank": doc["rank"],
                "step": doc["step"],
                "ts": doc["ts"],
                "n_records": doc["n_records"],
                "n_anomalies": doc["n_anomalies"],
                "records": recs,
                "anom": doc["anom"],
                "names": names,
            }


def export_stream(
    stream_path: str,
    out: Optional[IO[str]] = None,
    path: Optional[str] = None,
    gz: bool = False,
    other_data: Optional[Dict[str, Any]] = None,
) -> int:
    """Replay a persisted record stream through :class:`ChromeTraceWriter`.

    Byte-identical to the live ``export_trace=`` output for the same run —
    both drive the same writer with the same per-frame inputs in the same
    order.  Returns the number of frames exported.
    """
    writer = ChromeTraceWriter(out=out, path=path, gz=gz, other_data=other_data)
    n = 0
    try:
        for fr in iter_stream_frames(stream_path):
            writer.add_frame(
                fr["rank"], fr["step"], fr["records"], names=fr["names"],
                anomalies=fr["anom"], n_records=fr["n_records"],
                n_anomalies=fr["n_anomalies"], ts=fr["ts"],
            )
            n += 1
    finally:
        writer.close()
    return n
