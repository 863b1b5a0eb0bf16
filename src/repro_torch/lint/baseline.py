"""Baseline file support: accepted findings with written justifications.

``tools/lint_baseline.json`` pins the findings we have reviewed and chosen
to live with (each entry carries a non-empty ``justification``). The gate
then fails in *both* directions: a finding not covered by the baseline is
a regression, and a baseline entry no longer produced is stale cruft that
must be deleted (so the file can only shrink, never silently rot).

Entries match findings by ``(rule, path, symbol)`` — line numbers churn
too much to key on — with a ``count`` so a function that legitimately has
two baselined hits does not absorb a third.
"""
from __future__ import annotations

import collections
import json
from typing import Dict, List, Sequence, Tuple

from .model import Finding

VERSION = 1


class BaselineError(ValueError):
    """Malformed baseline file (bad schema or empty justification)."""


def load(path: str) -> Dict[Tuple[str, str, str], Dict]:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict) or data.get("version") != VERSION:
        raise BaselineError(f"{path}: expected {{'version': {VERSION}, ...}}")
    entries = data.get("entries")
    if not isinstance(entries, list):
        raise BaselineError(f"{path}: 'entries' must be a list")
    out: Dict[Tuple[str, str, str], Dict] = {}
    for i, e in enumerate(entries):
        for field in ("rule", "path", "symbol", "count", "justification"):
            if field not in e:
                raise BaselineError(f"{path}: entry {i} missing {field!r}")
        if not str(e["justification"]).strip():
            raise BaselineError(
                f"{path}: entry {i} ({e['rule']} {e['path']}:{e['symbol']}) "
                f"has an empty justification — every accepted finding needs "
                f"a written reason"
            )
        key = (e["rule"], e["path"], e["symbol"])
        if key in out:
            raise BaselineError(f"{path}: duplicate entry {key}")
        out[key] = e
    return out


def apply(
    findings: Sequence[Finding], baseline: Dict[Tuple[str, str, str], Dict]
) -> Tuple[List[Finding], List[Dict]]:
    """Split findings into (new, stale-baseline-entries).

    A finding whose key has remaining baseline budget is absorbed; findings
    beyond an entry's ``count`` are new. Entries never matched (or matched
    fewer times than ``count``) are stale.
    """
    counts = collections.Counter(f.key() for f in findings)
    new: List[Finding] = []
    used: collections.Counter = collections.Counter()
    for f in findings:
        entry = baseline.get(f.key())
        if entry is not None and used[f.key()] < int(entry["count"]):
            used[f.key()] += 1
        else:
            new.append(f)
    stale = [
        e
        for key, e in baseline.items()
        if counts.get(key, 0) < int(e["count"])
    ]
    return new, stale


def render(findings: Sequence[Finding]) -> str:
    """A fresh baseline document for the current findings (justifications
    left as TODO placeholders for the author to fill in)."""
    counts = collections.Counter(f.key() for f in findings)
    messages = {}
    for f in findings:
        messages.setdefault(f.key(), f.message)
    entries = [
        {
            "rule": rule,
            "path": path,
            "symbol": symbol,
            "count": n,
            "justification": "TODO: " + messages[(rule, path, symbol)],
        }
        for (rule, path, symbol), n in sorted(counts.items())
    ]
    return json.dumps({"version": VERSION, "entries": entries}, indent=2) + "\n"
