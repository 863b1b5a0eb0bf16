"""CLI: validate Prometheus text exposition with the stdlib checker.

    python -m repro_torch.telemetry --validate metrics.txt
    curl -s http://host:port/metrics | python -m repro_torch.telemetry --validate -

CI pipes the live gateway's ``/metrics`` output through this to prove
the exposition parses line by line (names, labels, values, histogram
bucket invariants) before uploading it as an artifact.
"""

from __future__ import annotations

import argparse
import sys

from .exposition import parse_exposition


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.telemetry")
    ap.add_argument("--validate", metavar="FILE", required=True,
                    help="exposition text file to validate ('-' for stdin)")
    args = ap.parse_args(argv)

    if args.validate == "-":
        text = sys.stdin.read()
    else:
        with open(args.validate, "r", encoding="utf-8") as fh:
            text = fh.read()
    try:
        families = parse_exposition(text)
    except ValueError as exc:
        print("INVALID exposition: %s" % exc, file=sys.stderr)
        return 1
    n_samples = sum(len(f["samples"]) for f in families.values())
    print("OK: %d families, %d samples" % (len(families), n_samples))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
