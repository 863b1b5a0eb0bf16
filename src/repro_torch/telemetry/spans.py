"""Distributed request tracing with deterministic, causally-linked spans.

W3C-style trace context — ``(trace_id, span_id, flags)`` — propagates
across the fleet inside the RPC frame envelope (``"tc"`` key, see
``repro/net/framing.py``): :class:`~repro.net.client.RPCClient` injects
the caller's ambient context on every call and the server extracts it, so
server, heavy-worker, PS-apply and prov-ingest spans are causal children
of the originating monitor-frame span.  Every process records its spans
into the bounded :mod:`~repro.telemetry.ring` flight recorder; the viz
gateway federates them at ``/spans`` and the monitor renders them into
the Chrome-trace export as cross-process flow arrows.

**Determinism.**  Span ids are 63-bit blake2b hashes of *logical* keys,
never of wall-clock or randomness:

* trace id         = H(rank, step)               — one trace per frame
* frame root span  = H(trace, "frame")
* write-path client span = H(trace, method, seq) — the stub's per-shard
  write sequence number, captured in the resend closure, so a write
  replayed after a crash (``repro.fault``) carries the *identical*
  context and its server-side spans dedup to one tree
* server span      = H(trace, client_span, "server")
* handler child    = H(parent_span, name)

Spans whose ids derive only from such logical keys carry the ``STABLE``
flag and are byte-reproducible across runs; the default per-call client
derivation H(trace, "call", endpoint, generation, request_id) — used for
verbs with no logical sequence (peeks, queries) — is recorded to the
ring for the flight recorder but *not* exported, because request ids
drift under retries.

**Tail-based sampling.**  The frame root starts with a provisional
sampled bit (1 every ``sample_every`` steps); the monitor upgrades it
after anomaly detection and *before* any RPC ships, so every span of an
anomalous frame — on every process — carries the sampled bit.  The ring
records everything regardless (that is what a flight recorder is for);
sampling gates only what the export keeps.

Off by default; enable with ``REPRO_SPANS=1`` (inherited by spawned
shard workers) or ``ChimbukoMonitor(trace_spans=True)``.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import time
from typing import NamedTuple, Optional, Tuple

from .ring import get_ring

__all__ = [
    "SAMPLED",
    "STABLE",
    "TraceContext",
    "WireSpan",
    "current",
    "derive_call_context",
    "hexid",
    "install_health_trigger",
    "is_enabled",
    "mark_sampled",
    "now_us",
    "record",
    "root_context",
    "server_context",
    "set_enabled",
    "span",
    "span_id",
    "use",
    "wire_context",
]

# Flag bits carried on the wire (third element of the tc triple).
SAMPLED = 1  # keep this trace in the export (tail sampling verdict)
STABLE = 2   # every id on the path to the root is logically derived

# Off by default: tracing must not perturb the byte-identity guarantees
# of untraced runs.  Read at import so spawned shard workers agree.
ENABLED = os.environ.get("REPRO_SPANS", "0") == "1"

_MASK63 = (1 << 63) - 1


def set_enabled(value: bool) -> None:
    """Flip tracing on/off process-wide (monitor kwarg, overhead bench)."""
    global ENABLED
    ENABLED = bool(value)


def is_enabled() -> bool:
    return ENABLED


def span_id(*parts) -> int:
    """Deterministic 63-bit id from logical parts (blake2b, JSON-safe)."""
    h = hashlib.blake2b(
        "\x1f".join(str(p) for p in parts).encode(), digest_size=8
    )
    v = int.from_bytes(h.digest(), "big") & _MASK63
    return v or 1  # 0 means "no parent"


def hexid(v: int) -> str:
    return format(v, "016x")


def now_us() -> int:
    return time.perf_counter_ns() // 1000


_now_us = now_us


class TraceContext(NamedTuple):
    """The ambient context: the span the current code runs *inside*."""

    trace_id: int
    span_id: int
    flags: int

    @property
    def sampled(self) -> bool:
        return bool(self.flags & SAMPLED)

    def tc(self) -> Tuple[int, int, int]:
        """The wire form (what rides in the frame envelope)."""
        return (self.trace_id, self.span_id, self.flags)


class WireSpan(NamedTuple):
    """A pre-derived client span: what the client stamps on a frame plus
    what it needs to record the client-side span when the reply lands."""

    trace_id: int
    span_id: int
    parent_id: int
    flags: int

    def tc(self) -> Tuple[int, int, int]:
        return (self.trace_id, self.span_id, self.flags)


_tls = threading.local()


def current() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def use(ctx: Optional[TraceContext]):
    """Make ``ctx`` the ambient context for the calling thread."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


def root_context(rank: int, step: int, sample_every: int = 8) -> TraceContext:
    """The per-frame trace root.  Provisionally sampled 1/``sample_every``
    steps; :func:`mark_sampled` upgrades anomalous frames."""
    trace = span_id("trace", rank, step)
    flags = STABLE
    if sample_every and step % sample_every == 0:
        flags |= SAMPLED
    return TraceContext(trace, span_id(trace, "frame"), flags)


def mark_sampled() -> Optional[TraceContext]:
    """Upgrade the ambient context's sampled bit (tail sampling: the
    monitor calls this when a frame turns out anomalous, before any of
    the frame's RPCs ship)."""
    ctx = current()
    if ctx is None or ctx.sampled:
        return ctx
    ctx = ctx._replace(flags=ctx.flags | SAMPLED)
    _tls.ctx = ctx
    return ctx


def wire_context(method: str, key) -> Optional[WireSpan]:
    """A *stable* client span for a write with a logical sequence key.

    The fault-tolerant stubs capture the returned WireSpan in their
    resend closures: a replayed write carries the identical context, so
    its server-side spans deduplicate instead of forking the tree."""
    if not ENABLED:
        return None
    ctx = current()
    if ctx is None:
        return None
    return WireSpan(
        ctx.trace_id,
        span_id(ctx.trace_id, method, key),
        ctx.span_id,
        ctx.flags,
    )


def derive_call_context(endpoint: str, generation: int, rid: int) -> Optional[WireSpan]:
    """The default per-call client span: (endpoint, connection generation,
    request id).  Unique and causally linked, but request ids drift under
    retries, so the STABLE bit is dropped — flight-recorder only."""
    ctx = current()
    if ctx is None:
        return None
    return WireSpan(
        ctx.trace_id,
        span_id(ctx.trace_id, "call", endpoint, generation, rid),
        ctx.span_id,
        ctx.flags & ~STABLE,
    )


def server_context(tc: Tuple[int, int, int]) -> TraceContext:
    """The server-side span context for an incoming frame: a child of the
    client span that carried it (id is a pure function of the wire
    context, so replayed frames re-derive the identical server span)."""
    trace, client_span, flags = tc
    return TraceContext(trace, span_id(trace, client_span, "server"), flags)


def record(
    trace_id: int,
    sid: int,
    parent_id: int,
    name: str,
    kind: str,
    flags: int,
    t0_us: int,
    dur_us: int,
    err: bool = False,
    order: Optional[Tuple[int, int]] = None,
) -> None:
    """Append one finished span to the process flight recorder."""
    span = {
        "trace": trace_id,
        "span": sid,
        "parent": parent_id,
        "name": name,
        "kind": kind,
        "flags": flags,
        "t0": t0_us,
        "dur": dur_us,
    }
    if err:
        span["err"] = 1
    if order is not None:
        span["ord"] = list(order)
    get_ring().record(span)


@contextlib.contextmanager
def span(name: str, kind: str = "span"):
    """Record the enclosed region as a child span of the ambient context
    (id = H(parent_span, name)) and make it ambient inside the block.
    Cheap no-op when tracing is off or no context is armed."""
    if not ENABLED:
        yield None
        return
    parent = current()
    if parent is None:
        yield None
        return
    child = TraceContext(
        parent.trace_id, span_id(parent.span_id, name), parent.flags
    )
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = child
    t0 = _now_us()
    err = False
    try:
        yield child
    except BaseException:
        err = True
        raise
    finally:
        _tls.ctx = prev
        record(
            child.trace_id, child.span_id, parent.span_id,
            name, kind, child.flags, t0, _now_us() - t0, err=err,
        )


_health_lock = threading.Lock()
_health_installed = False


def install_health_trigger() -> None:
    """Dump the flight recorder on fault-health transitions: the moment a
    shard goes degraded (or comes back) is exactly when the recent span
    history is worth keeping.  Idempotent."""
    global _health_installed
    with _health_lock:
        if _health_installed:
            return
        _health_installed = True
    from ..fault.health import get_health

    def _on_transition(event: str, endpoint: str) -> None:
        if ENABLED:
            get_ring().dump(f"health:{event}:{endpoint}")

    get_health().add_listener(_on_transition)
