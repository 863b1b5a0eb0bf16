"""``python -m repro_torch.export`` — trace export CLI (copy of ``repro.export.cli``).

Three modes:

  * **record stream** (default): replay a monitor output dir's
    ``stream.jsonl`` (or a stream file given directly) into
    ``trace.json[.gz]`` — the Fig. 5-style timeline of the reduced record
    stream, openable in ui.perfetto.dev.

        python -m repro_torch.export /tmp/mon -o trace.json [--gzip]

  * **provenance windows** (``--provenance``): render matching anomaly docs
    (the Fig. 6 call-stack windows) from the dir's provenance JSONL family —
    any shard count — or, with ``--endpoints``, from the live shard workers
    of a running job.

        python -m repro_torch.export /tmp/mon --provenance --min-severity 3
        python -m repro_torch.export --provenance --endpoints host:port,...

  * **validate** (``--validate``): parse an existing trace and check the
    exporter's invariants (B/E balance per track, nesting, async pairing) —
    the CI smoke gate.

        python -m repro_torch.export --validate trace.json
"""
# lint: deterministic — byte-identical output across shard counts/transports
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from .chrome_trace import validate_trace
from .provenance_export import (
    load_provenance_docs,
    query_live_endpoints,
    render_provenance_trace,
)
from .record_stream import export_stream


def _resolve_stream(source: str) -> str:
    if os.path.isdir(source):
        return os.path.join(source, "stream.jsonl")
    return source


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.export",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "source", nargs="?",
        help="monitor output dir (stream.jsonl + provenance*.jsonl) or a "
        "stream.jsonl path",
    )
    ap.add_argument("-o", "--out", help="output trace path (default: "
                    "<dir>/trace.json, or <dir>/prov_trace.json with "
                    "--provenance)")
    ap.add_argument("--gzip", action="store_true", help="gzip the output "
                    "(deterministic: fixed mtime)")
    ap.add_argument("--validate", metavar="TRACE",
                    help="validate an existing trace file and exit")
    ap.add_argument("--provenance", action="store_true",
                    help="export provenance windows instead of the record "
                    "stream")
    ap.add_argument("--endpoints", default=None,
                    help="live provenance shard endpoints host:port,... "
                    "(query a running job's workers instead of files)")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--fid", type=int, default=None)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--func", default=None)
    ap.add_argument("--severity", type=int, default=None)
    ap.add_argument("--min-severity", type=int, default=None)
    ap.add_argument("--pad-us", type=int, default=100,
                    help="provenance window padding (µs) past the last "
                    "neighbor exit")
    args = ap.parse_args(list(argv) if argv is not None else None)

    if args.validate:
        counts = validate_trace(args.validate)
        print(json.dumps(counts, sort_keys=True))
        return 0

    if args.provenance:
        query = {
            "rank": args.rank, "fid": args.fid, "step": args.step,
            "func": args.func, "severity": args.severity,
            "min_severity": args.min_severity,
        }
        name = "prov_trace.json" + (".gz" if args.gzip else "")
        if args.endpoints:
            from repro_torch.launch.shard_server import parse_endpoints

            docs = query_live_endpoints(parse_endpoints(args.endpoints), **query)
            default_out = name
        elif args.source:
            docs = load_provenance_docs(args.source, **query)
            base = args.source if os.path.isdir(args.source) else os.path.dirname(args.source)
            default_out = os.path.join(base, name)
        else:
            ap.error("--provenance needs a source dir or --endpoints")
        out = args.out or default_out
        n = render_provenance_trace(docs, path=out, gz=args.gzip,
                                    pad_us=args.pad_us)
        print(f"[export] {n} provenance windows -> {out}", file=sys.stderr)
        return 0

    if not args.source:
        ap.error("need a monitor output dir or stream.jsonl (or --validate)")
    stream = _resolve_stream(args.source)
    if not os.path.exists(stream):
        ap.error(f"no record stream at {stream} (run the monitor with "
                 "stream_path= / train.py with --monitor-dir)")
    base = args.source if os.path.isdir(args.source) else os.path.dirname(args.source)
    out = args.out or os.path.join(base, "trace.json" + (".gz" if args.gzip else ""))
    n = export_stream(stream, path=out, gz=args.gzip)
    print(f"[export] {n} frames -> {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
