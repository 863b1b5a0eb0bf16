"""Command line: ``python -m repro_torch.lint src/ [--format=text|json] ...``.

Exit codes: 0 — clean (or fully covered by the baseline); 2 — new findings
or stale baseline entries; 3 — bad invocation / malformed baseline.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from . import RULE_IDS
from . import baseline as baseline_mod
from .model import Finding
from .rules import analyze

DEFAULT_BASELINE = "tools/lint_baseline.json"


def _text_report(findings: List[Finding], stale: List[dict]) -> str:
    lines = [
        f"{f.path}:{f.line}: {f.rule}: {f.message} [{f.symbol}]"
        for f in findings
    ]
    for e in stale:
        lines.append(
            f"stale baseline entry: {e['rule']} {e['path']} [{e['symbol']}] "
            f"(count {e['count']}) no longer reported — delete it"
        )
    return "\n".join(lines)


def _json_report(
    findings: List[Finding], stale: List[dict], elapsed: float, target: str
) -> str:
    return json.dumps(
        {
            "target": target,
            "elapsed_s": round(elapsed, 3),
            "rules": list(RULE_IDS),
            "findings": [
                {
                    "rule": f.rule,
                    "path": f.path,
                    "line": f.line,
                    "symbol": f.symbol,
                    "message": f.message,
                }
                for f in findings
            ],
            "stale_baseline": stale,
        },
        indent=2,
    )


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="Concurrency & determinism static analysis for repro_torch.",
    )
    parser.add_argument("target", help="package directory or file to analyze")
    parser.add_argument(
        "--format", choices=("text", "json"), default="text", dest="fmt"
    )
    parser.add_argument(
        "--rule",
        action="append",
        choices=RULE_IDS,
        help="restrict to specific rule(s); repeatable",
    )
    parser.add_argument(
        "--baseline",
        default=DEFAULT_BASELINE,
        help=f"baseline file (default {DEFAULT_BASELINE}; "
        f"'none' disables baselining)",
    )
    parser.add_argument(
        "--write-baseline",
        metavar="PATH",
        help="write a fresh baseline for the current findings (with TODO "
        "justifications) and exit 0",
    )
    parser.add_argument(
        "--report",
        metavar="PATH",
        help="also write the full JSON report to PATH (CI artifact)",
    )
    args = parser.parse_args(argv)

    if not os.path.exists(args.target):
        print(f"error: no such file or directory: {args.target}", file=sys.stderr)
        return 3

    t0 = time.perf_counter()
    findings = analyze(args.target, rules=args.rule)
    elapsed = time.perf_counter() - t0

    if args.write_baseline:
        with open(args.write_baseline, "w", encoding="utf-8") as f:
            f.write(baseline_mod.render(findings))
        print(
            f"wrote {len(findings)} finding(s) to {args.write_baseline}; "
            f"fill in the TODO justifications before committing",
            file=sys.stderr,
        )
        return 0

    stale: List[dict] = []
    if args.baseline and args.baseline != "none":
        try:
            base = baseline_mod.load(args.baseline)
        except FileNotFoundError:
            base = {}
        except baseline_mod.BaselineError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 3
        findings, stale = baseline_mod.apply(findings, base)

    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            f.write(_json_report(findings, stale, elapsed, args.target))

    if args.fmt == "json":
        print(_json_report(findings, stale, elapsed, args.target))
    else:
        report = _text_report(findings, stale)
        if report:
            print(report)
        print(
            f"repro_torch.lint: {len(findings)} finding(s), "
            f"{len(stale)} stale baseline entr{'y' if len(stale) == 1 else 'ies'} "
            f"({elapsed:.2f}s)",
            file=sys.stderr,
        )
    return 2 if (findings or stale) else 0
