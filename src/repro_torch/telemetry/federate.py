"""Federate metric snapshots and span dumps from out-of-process shards.

Every RPC shard host registers the reserved ``metrics.snapshot`` and
``spans.dump`` verbs (see ``repro_torch.net.shards.build_shard_table``); this
module is the front-end side -- it dials each endpoint, collects the
replies, and merges them under per-process ``proc`` labels.  Same
federation pattern as ``FederatedPS``: metric merges are element-wise
integer addition over histogram vectors and span merges dedup on
deterministic ``(trace, span)`` ids, so the result is identical no
matter which shard replies first.

Scrapes are *bounded*: each shard gets an exclusive single-dial-attempt
client with a per-call deadline, so one stalled or dead shard costs one
failed connect (or one timed-out call) and degrades to an ``errors``
entry -- it can never stall the whole scrape behind a shared client's
full reconnect-backoff budget.  The scrape's own latency lands in the
``repro_federation_scrape_us`` histogram.

Blocking RPC lives here, so callers must run it off the event loop --
the viz gateway invokes it from the worker pool (its ``/metrics`` and
``/spans`` handlers are offloaded exactly like ``/provenance``).
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Mapping, Sequence, Tuple

from .registry import get_registry, merge_snapshots
from .ring import get_ring

__all__ = [
    "METRICS_SNAPSHOT_VERB",
    "SPANS_DUMP_VERB",
    "fetch_shard_snapshot",
    "fetch_shard_spans",
    "federated_snapshot",
    "federated_spans",
]

# Reserved RPC verbs every shard table exposes.
METRICS_SNAPSHOT_VERB = "metrics.snapshot"
SPANS_DUMP_VERB = "spans.dump"


def _scrape_hist():
    return get_registry().histogram(
        "repro_federation_scrape_us",
        "Wall time of one federated scrape (all shards), microseconds.",
        labelnames=["verb"],
    )


def _scrape_call(endpoint: Tuple[str, int], verb: str, env: dict,
                 timeout: float) -> dict:
    """One bounded shard scrape: exclusive client, single dial attempt,
    per-call deadline.  Raises fast when the shard is down or stalled."""
    from ..net.client import RPCClient
    from ..net.framing import ConnectionLost

    client = RPCClient((endpoint[0], int(endpoint[1])), timeout=timeout,
                       connect_retries=1, retry_delay=0.05)
    try:
        if not client.try_dial():
            raise ConnectionLost(f"{endpoint[0]}:{int(endpoint[1])} unreachable")
        reply_env, _arrays = client.call(verb, env, timeout=timeout)
    finally:
        client.close()
    return reply_env


def fetch_shard_snapshot(endpoint: Tuple[str, int],
                         timeout: float = 5.0) -> Mapping[str, dict]:
    """Fetch one shard's registry snapshot over RPC (blocking, bounded)."""
    return _scrape_call(endpoint, METRICS_SNAPSHOT_VERB, {}, timeout).get(
        "snapshot", {}
    )


def fetch_shard_spans(endpoint: Tuple[str, int], dump: bool = False,
                      reason: str = "federate", timeout: float = 5.0) -> dict:
    """Fetch one shard's span flight recorder (blocking, bounded).

    ``dump=True`` freezes the remote ring into its archive first -- the
    on-demand flight-recorder trigger."""
    env = {"dump": True, "reason": reason} if dump else {}
    reply = _scrape_call(endpoint, SPANS_DUMP_VERB, env, timeout)
    return {
        "spans": reply.get("spans", []),
        "triggers": reply.get("triggers", []),
        "stats": reply.get("stats", {}),
    }


def federated_snapshot(
    shard_endpoints: Sequence[Tuple[str, int]] = (),
    local_proc: str = "gateway",
    timeout: float = 5.0,
) -> Tuple[Dict[str, dict], List[str]]:
    """Local snapshot + every reachable shard's, merged under ``proc`` labels.

    Returns ``(merged_snapshot, errors)``.  A shard that cannot be
    reached degrades to an entry in ``errors`` (and a mark in the
    ``repro_metrics_federation_errors`` gauge) rather than failing the
    whole exposition -- a scraper should still see the healthy processes.
    """
    t0 = time.perf_counter_ns()
    snaps: List[Mapping[str, dict]] = [get_registry().snapshot()]
    procs: List[str] = [local_proc]
    errors: List[str] = []
    for i, ep in enumerate(shard_endpoints):
        try:
            snaps.append(fetch_shard_snapshot(ep, timeout=timeout))
            procs.append("shard%d" % i)
        except Exception as exc:  # degraded, not fatal
            errors.append("shard%d %s:%d: %s" % (i, ep[0], int(ep[1]), exc))
    merged = merge_snapshots(snaps, proc_label=procs)
    if errors:
        fam = merged.setdefault(
            "repro_metrics_federation_errors",
            {
                "type": "gauge",
                "help": "Shards that failed to answer metrics.snapshot this scrape.",
                "labelnames": ["proc"],
                "series": {},
            },
        )
        fam["series"][json.dumps([["proc", local_proc]])] = len(errors)
    _scrape_hist().labels(verb=METRICS_SNAPSHOT_VERB).observe(
        (time.perf_counter_ns() - t0) // 1000
    )
    return merged, errors


def federated_spans(
    shard_endpoints: Sequence[Tuple[str, int]] = (),
    local_proc: str = "gateway",
    dump: bool = False,
    reason: str = "federate",
    timeout: float = 5.0,
) -> Tuple[Dict[str, dict], List[str]]:
    """The local flight recorder + every reachable shard's, keyed by proc.

    Returns ``(procs, errors)`` where ``procs`` maps a process label
    (``local_proc``, ``shard0``, ...) to its ``{"spans", "triggers",
    "stats"}`` view -- the shape ``repro_torch.export.chrome_trace.render_spans``
    consumes (after projecting out the span lists).  ``dump=True``
    freezes every ring (local included) before collecting.  Unreachable
    shards degrade to ``errors`` entries, bounded per shard like the
    metrics scrape.
    """
    t0 = time.perf_counter_ns()
    ring = get_ring()
    if dump:
        ring.dump(reason)
    out: Dict[str, dict] = {
        local_proc: {
            "spans": ring.collect(),
            "triggers": ring.triggers(),
            "stats": ring.stats(),
        }
    }
    errors: List[str] = []
    for i, ep in enumerate(shard_endpoints):
        try:
            out["shard%d" % i] = fetch_shard_spans(
                ep, dump=dump, reason=reason, timeout=timeout
            )
        except Exception as exc:  # degraded, not fatal
            errors.append("shard%d %s:%d: %s" % (i, ep[0], int(ep[1]), exc))
    _scrape_hist().labels(verb=SPANS_DUMP_VERB).observe(
        (time.perf_counter_ns() - t0) // 1000
    )
    return out, errors
