"""Prometheus text exposition (format 0.0.4): render and validate.

``render_exposition`` turns a registry snapshot (or a federated merge of
several) into the classic ``# HELP`` / ``# TYPE`` / sample-line format
the viz gateway serves at ``/metrics``.  ``parse_exposition`` is the
matching stdlib-only checker: it re-parses the text line by line,
enforcing name/label syntax and the histogram invariants (cumulative
monotone buckets, ``+Inf`` bucket == ``_count``).  CI runs the parser
over the gateway's live output; the tests run it over everything.

Output is deterministic: families alphabetically, series by canonical
label key, buckets in ascending ``le`` order.
"""

from __future__ import annotations

import json
import math
import re
from typing import Dict, List, Mapping, Tuple

from .registry import BUCKET_COUNT, bucket_bounds

__all__ = ["render_exposition", "parse_exposition", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# One sample line: name, optional {labels}, value.  Label values are
# double-quoted with \\ \" \n escapes.
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r" (?P<value>\S+)$"
)
_LABEL_PAIR_RE = re.compile(
    r'\s*(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<value>(?:[^"\\]|\\.)*)"\s*(?:,|$)'
)


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(text: str) -> str:
    return text.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_le(bound: float) -> str:
    if math.isinf(bound):
        return "+Inf"
    return _fmt_value(bound)


def _labels_text(pairs: List[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, _escape_label_value(str(v))) for k, v in pairs
    )
    return "{%s}" % inner


def render_exposition(snapshot: Mapping[str, dict]) -> str:
    """Render a registry snapshot (see ``MetricRegistry.snapshot``) as
    Prometheus text exposition 0.0.4."""
    lines: List[str] = []
    bounds = bucket_bounds()
    for name in sorted(snapshot):
        fam = snapshot[name]
        kind = fam["type"]
        lines.append("# HELP %s %s" % (name, _escape_help(fam.get("help", ""))))
        lines.append("# TYPE %s %s" % (name, kind))
        for key in sorted(fam["series"]):
            pairs = [(k, v) for k, v in json.loads(key)]
            val = fam["series"][key]
            if kind == "histogram":
                counts, hsum, hcount = val[:BUCKET_COUNT], val[BUCKET_COUNT], val[BUCKET_COUNT + 1]
                cum = 0
                for i, c in enumerate(counts):
                    cum += c
                    le_pairs = pairs + [("le", _fmt_le(bounds[i]))]
                    lines.append(
                        "%s_bucket%s %d" % (name, _labels_text(le_pairs), cum)
                    )
                lines.append("%s_sum%s %s" % (name, _labels_text(pairs), _fmt_value(hsum)))
                lines.append("%s_count%s %d" % (name, _labels_text(pairs), hcount))
            else:
                lines.append("%s%s %s" % (name, _labels_text(pairs), _fmt_value(val)))
    return "\n".join(lines) + "\n" if lines else ""


def _parse_value(text: str) -> float:
    if text == "+Inf":
        return math.inf
    if text == "-Inf":
        return -math.inf
    if text == "NaN":
        return math.nan
    return float(text)


def _parse_labels(text: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    pos = 0
    while pos < len(text):
        m = _LABEL_PAIR_RE.match(text, pos)
        if m is None:
            raise ValueError("malformed label section: %r" % (text,))
        name = m.group("name")
        if name in labels:
            raise ValueError("duplicate label %r" % (name,))
        raw = m.group("value")
        labels[name] = (
            raw.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")
        )
        pos = m.end()
    return labels


def parse_exposition(text: str) -> Dict[str, dict]:
    """Parse + validate Prometheus 0.0.4 text, line by line.

    Returns ``{family_name: {"type": ..., "help": ..., "samples":
    [(name, labels_dict, value), ...]}}``.  Raises ``ValueError`` with
    the offending line number on any format violation, including
    histogram bucket invariants.
    """
    families: Dict[str, dict] = {}
    types: Dict[str, str] = {}
    for lineno, line in enumerate(text.split("\n"), start=1):
        if line == "":
            continue
        if line != line.strip():
            raise ValueError("line %d: leading/trailing whitespace" % lineno)
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(" ", 1)
            name = parts[0]
            if not _NAME_RE.match(name):
                raise ValueError("line %d: bad metric name %r" % (lineno, name))
            families.setdefault(name, {"type": None, "help": "", "samples": []})
            families[name]["help"] = parts[1] if len(parts) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split(" ")
            if len(parts) != 2:
                raise ValueError("line %d: malformed TYPE line" % lineno)
            name, kind = parts
            if not _NAME_RE.match(name):
                raise ValueError("line %d: bad metric name %r" % (lineno, name))
            if kind not in ("counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError("line %d: unknown type %r" % (lineno, kind))
            if name in types:
                raise ValueError("line %d: duplicate TYPE for %r" % (lineno, name))
            types[name] = kind
            families.setdefault(name, {"type": None, "help": "", "samples": []})
            families[name]["type"] = kind
            continue
        if line.startswith("#"):
            continue  # comment
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError("line %d: malformed sample line %r" % (lineno, line))
        sname = m.group("name")
        labels = _parse_labels(m.group("labels") or "")
        for lname in labels:
            if not _LABEL_RE.match(lname):
                raise ValueError("line %d: bad label name %r" % (lineno, lname))
        try:
            value = _parse_value(m.group("value"))
        except ValueError:
            raise ValueError(
                "line %d: bad sample value %r" % (lineno, m.group("value"))
            )
        # Attribute the sample to its family (strip histogram suffixes).
        fname = sname
        for suffix in ("_bucket", "_sum", "_count"):
            base = sname[: -len(suffix)] if sname.endswith(suffix) else None
            if base and types.get(base) == "histogram":
                fname = base
                break
        if fname not in families:
            raise ValueError(
                "line %d: sample %r before any HELP/TYPE for it" % (lineno, sname)
            )
        if sname.endswith("_bucket") and fname != sname and "le" not in labels:
            raise ValueError("line %d: histogram bucket without le label" % lineno)
        families[fname]["samples"].append((sname, labels, value))

    _check_histograms(families)
    return families


def _series_key(labels: Mapping[str, str], drop: Tuple[str, ...] = ()) -> str:
    return json.dumps(sorted((k, v) for k, v in labels.items() if k not in drop))


def _check_histograms(families: Mapping[str, dict]) -> None:
    for name, fam in families.items():
        if fam["type"] != "histogram":
            continue
        buckets: Dict[str, List[Tuple[float, float]]] = {}
        counts: Dict[str, float] = {}
        for sname, labels, value in fam["samples"]:
            if sname == name + "_bucket":
                key = _series_key(labels, drop=("le",))
                buckets.setdefault(key, []).append(
                    (_parse_value(labels["le"]), value)
                )
            elif sname == name + "_count":
                counts[_series_key(labels)] = value
        for key, pairs in buckets.items():
            les = [le for le, _ in pairs]
            if les != sorted(les):
                raise ValueError(
                    "histogram %r series %s: buckets out of le order" % (name, key)
                )
            vals = [v for _, v in pairs]
            if vals != sorted(vals):
                raise ValueError(
                    "histogram %r series %s: bucket counts not cumulative" % (name, key)
                )
            if not math.isinf(les[-1]):
                raise ValueError(
                    "histogram %r series %s: missing +Inf bucket" % (name, key)
                )
            if key in counts and vals[-1] != counts[key]:
                raise ValueError(
                    "histogram %r series %s: +Inf bucket %s != _count %s"
                    % (name, key, vals[-1], counts[key])
                )
