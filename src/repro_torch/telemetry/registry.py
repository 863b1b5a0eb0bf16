"""Lock-disciplined metrics registry for the analysis fleet.

The tool that monitors a workflow must be able to monitor itself.  This
module provides the three classic metric kinds -- Counter, Gauge,
Histogram -- with two properties the rest of the repo depends on:

* **Lock discipline.**  Every mutable field is private and every access
  happens under the metric's own ``threading.Lock``.  Metrics are safe
  to touch from the event-loop thread, worker-pool threads, and client
  caller threads simultaneously; ``repro.lint``'s lockset rules see no
  bare shared state here.

* **Determinism / mergeability.**  Histograms use *fixed* log2 bucket
  boundaries (1, 2, 4, ... 2^N, +Inf) and integer counts, so a snapshot
  is a plain integer vector.  Merging snapshots from different shards is
  element-wise integer addition -- associative, commutative, and
  bitwise-reproducible regardless of arrival order.  That is what lets
  the viz gateway federate ``metrics.snapshot`` replies from
  out-of-process shards the same way ``FederatedPS`` federates rows.

Telemetry is on by default and disabled fleet-wide with
``REPRO_TELEMETRY=0`` (inherited by spawned shard processes).  When
disabled, every mutator is a cheap no-op so instrumented hot paths cost
a single attribute load + truth test.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "ENABLED",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "get_registry",
    "is_enabled",
    "merge_snapshots",
    "set_enabled",
    "BUCKET_COUNT",
    "bucket_bounds",
]

# Process-wide enable flag.  Read at import so spawned shard workers
# (which inherit os.environ) agree with their parent; mutable at runtime
# so benchmarks can A/B the overhead in one process.
ENABLED = os.environ.get("REPRO_TELEMETRY", "1") != "0"


def set_enabled(value: bool) -> None:
    """Flip telemetry on/off process-wide (used by the overhead bench)."""
    global ENABLED
    ENABLED = bool(value)


def is_enabled() -> bool:
    return ENABLED


# --------------------------------------------------------------------------
# Histogram bucket scheme: fixed log2 boundaries.
#
# Bucket i (0-based) counts observations v with le <= 2**i, i.e. upper
# bounds 1, 2, 4, ..., 2**(BUCKET_COUNT-1), plus a final +Inf bucket.
# 31 finite buckets cover [0, 2**30] -- with microsecond observations
# that is ~18 minutes, far beyond any per-call latency we care about.
# --------------------------------------------------------------------------

BUCKET_COUNT = 32  # 31 finite log2 buckets + the +Inf bucket


def bucket_bounds() -> List[float]:
    """Upper bounds (``le`` values) for each bucket, +Inf last."""
    return [float(1 << i) for i in range(BUCKET_COUNT - 1)] + [float("inf")]


def bucket_index(value: float) -> int:
    """Index of the first bucket whose upper bound is >= value."""
    if value <= 1.0:
        return 0
    iv = int(value)
    if float(iv) < value:
        iv += 1  # round up so the bucket bound stays an upper bound
    idx = (iv - 1).bit_length()
    if idx >= BUCKET_COUNT:
        return BUCKET_COUNT - 1
    return idx


class Counter:
    """Monotonic counter.  ``inc`` is exact under arbitrary contention."""

    kind = "counter"

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if not ENABLED:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def _snapshot(self) -> int:
        return self.value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Point-in-time value (queue depth, buffer occupancy, inflight)."""

    kind = "gauge"

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def set(self, v: float) -> None:
        if not ENABLED:
            return
        with self._lock:
            self._value = v

    def inc(self, n: float = 1) -> None:
        if not ENABLED:
            return
        with self._lock:
            self._value += n

    def dec(self, n: float = 1) -> None:
        if not ENABLED:
            return
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _snapshot(self) -> float:
        return self.value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0


class Histogram:
    """Fixed-log2-bucket histogram with integer state.

    Observations are expected to be non-negative (latencies in
    microseconds, sizes in bytes).  State is ``(counts[32], sum, count)``
    -- all integers, so two snapshots merge by element-wise addition with
    no rounding and no order sensitivity.
    """

    kind = "histogram"

    __slots__ = ("_lock", "_counts", "_sum", "_count")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts = [0] * BUCKET_COUNT
        self._sum = 0
        self._count = 0

    def observe(self, value: float) -> None:
        if not ENABLED:
            return
        if value < 0:
            value = 0
        iv = int(value)
        idx = bucket_index(value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += iv
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> int:
        with self._lock:
            return self._sum

    def _snapshot(self) -> List[int]:
        with self._lock:
            return list(self._counts) + [self._sum, self._count]

    def _reset(self) -> None:
        with self._lock:
            for i in range(BUCKET_COUNT):
                self._counts[i] = 0
            self._sum = 0
            self._count = 0

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]) from the buckets.

        Linear interpolation inside the winning bucket; exact enough for
        p50/p95 reporting when buckets are log2-spaced.
        """
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return 0.0
        target = (q / 100.0) * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            prev_cum = cum
            cum += c
            if cum >= target:
                lo = 0.0 if i == 0 else float(1 << (i - 1))
                hi = float(1 << i) if i < BUCKET_COUNT - 1 else lo * 2.0
                frac = (target - prev_cum) / c
                return lo + (hi - lo) * frac
        return float(1 << (BUCKET_COUNT - 1))


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def _label_key(labelnames: Sequence[str], labels: Mapping[str, str]) -> str:
    if set(labels) != set(labelnames):
        raise ValueError(
            "labels %r do not match declared labelnames %r"
            % (sorted(labels), list(labelnames))
        )
    # Canonical, order-independent, JSON-safe child key.
    return json.dumps([[k, str(labels[k])] for k in sorted(labels)])


class MetricFamily:
    """A named metric plus its labeled children.

    ``family.labels(server="PS:9000")`` returns (creating on first use)
    the child metric for that label set.  A family declared with no
    labelnames proxies the metric API straight to its single anonymous
    child, so ``registry.counter("x", "help").inc()`` just works.
    """

    __slots__ = ("name", "help", "kind", "labelnames", "_lock", "_children",
                 "_anon_child")

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[str, object] = {}
        # Immutable after __init__ (never rebound), so the no-label proxy
        # path reads it bare -- no lock, no key encode, on every inc().
        self._anon_child = None
        if not self.labelnames:
            self._anon_child = _METRIC_TYPES[kind]()
            self._children[_label_key((), {})] = self._anon_child

    def labels(self, **labels: str):
        key = _label_key(self.labelnames, labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _METRIC_TYPES[self.kind]()
                self._children[key] = child
            return child

    def _anon(self):
        if self._anon_child is None:
            raise ValueError(
                "metric %r has labelnames %r; use .labels(...)"
                % (self.name, self.labelnames)
            )
        return self._anon_child

    # -- no-label convenience proxies ------------------------------------
    def inc(self, n: int = 1) -> None:
        self._anon().inc(n)

    def dec(self, n: float = 1) -> None:
        self._anon().dec(n)

    def set(self, v: float) -> None:
        self._anon().set(v)

    def observe(self, v: float) -> None:
        self._anon().observe(v)

    @property
    def value(self):
        return self._anon().value

    def percentile(self, q: float) -> float:
        return self._anon().percentile(q)

    @property
    def count(self) -> int:
        return self._anon().count

    @property
    def sum(self) -> int:
        return self._anon().sum

    def _series(self) -> Dict[str, object]:
        with self._lock:
            children = dict(self._children)
        return {key: child._snapshot() for key, child in sorted(children.items())}

    def _reset(self) -> None:
        with self._lock:
            children = list(self._children.values())
        for child in children:
            child._reset()


class MetricRegistry:
    """Process-wide collection of metric families.

    ``snapshot()`` returns a JSON-able dict suitable for the
    ``metrics.snapshot`` RPC verb; ``merge_snapshots`` federates them.
    Re-registering an existing name returns the same family (so servers,
    clients, and monitors can all say ``registry.counter(...)`` without
    coordinating), but a kind or labelnames mismatch is a hard error.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}

    def _get_or_create(self, name: str, help: str, kind: str,
                       labelnames: Sequence[str]) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        "metric %r re-registered with kind=%s labels=%r "
                        "(was kind=%s labels=%r)"
                        % (name, kind, tuple(labelnames), fam.kind, fam.labelnames)
                    )
                return fam
            fam = MetricFamily(name, help, kind, labelnames)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> MetricFamily:
        return self._get_or_create(name, help, "counter", labelnames)

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> MetricFamily:
        return self._get_or_create(name, help, "gauge", labelnames)

    def histogram(self, name: str, help: str,
                  labelnames: Sequence[str] = ()) -> MetricFamily:
        return self._get_or_create(name, help, "histogram", labelnames)

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[MetricFamily]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able state of every family: name -> {type, help, series}."""
        out: Dict[str, dict] = {}
        for fam in self.families():
            out[fam.name] = {
                "type": fam.kind,
                "help": fam.help,
                "labelnames": list(fam.labelnames),
                "series": fam._series(),
            }
        return out

    def reset(self) -> None:
        """Zero every metric in place (children keep identity -- servers
        hold direct references to their child metrics)."""
        for fam in self.families():
            fam._reset()


def merge_snapshots(snapshots: Iterable[Mapping[str, dict]],
                    proc_label: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Merge snapshot dicts from several processes into one.

    Counters and histogram vectors are summed element-wise (exact -- all
    integers); gauges are summed too (a fleet-wide queue depth is the sum
    of per-process depths).  If ``proc_label`` is given it must parallel
    ``snapshots``; each input's series get an extra ``proc`` label so
    per-process series stay distinguishable instead of collapsing.
    """
    merged: Dict[str, dict] = {}
    procs: List[Optional[str]]
    snaps = list(snapshots)
    if proc_label is None:
        procs = [None] * len(snaps)
    else:
        procs = list(proc_label)
        if len(procs) != len(snaps):
            raise ValueError("proc_label length mismatch")

    for snap, proc in zip(snaps, procs):
        for name, fam in snap.items():
            dst = merged.get(name)
            if dst is None:
                labelnames = list(fam.get("labelnames", []))
                if proc is not None and "proc" not in labelnames:
                    labelnames = labelnames + ["proc"]
                dst = {
                    "type": fam["type"],
                    "help": fam.get("help", ""),
                    "labelnames": labelnames,
                    "series": {},
                }
                merged[name] = dst
            elif dst["type"] != fam["type"]:
                raise ValueError("metric %r type mismatch in merge" % (name,))
            for key, val in fam["series"].items():
                if proc is not None:
                    pairs = json.loads(key)
                    pairs = [p for p in pairs if p[0] != "proc"]
                    pairs.append(["proc", proc])
                    key = json.dumps(sorted(pairs))
                cur = dst["series"].get(key)
                if cur is None:
                    dst["series"][key] = list(val) if isinstance(val, list) else val
                elif isinstance(val, list):
                    dst["series"][key] = [a + b for a, b in zip(cur, val)]
                else:
                    dst["series"][key] = cur + val
    for fam in merged.values():
        fam["series"] = dict(sorted(fam["series"].items()))
    return merged


_registry_lock = threading.Lock()
_registry: Optional[MetricRegistry] = None


def get_registry() -> MetricRegistry:
    """The process-wide registry singleton."""
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = MetricRegistry()
        return _registry
