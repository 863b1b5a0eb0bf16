"""Reconnecting, multiplexed async RPC client for :mod:`repro_torch.net.server`.

One :class:`RPCClient` owns one TCP connection plus a reader thread.  Calls
are multiplexed: ``call_async`` assigns a request id, appends the frame to
the socket under a send lock, and returns a future immediately — an
*unlimited* number of requests can be in flight before the first response
arrives, and the reader thread resolves futures by request id as responses
stream back (the server answers a connection's requests in execution order,
but correlation is by id, never by position).  ``call`` is the synchronous
wrapper with a per-call timeout.

Because correlation is by request id, many logical streams can share one
connection: :meth:`RPCClient.shared` hands out one ref-counted client per
endpoint, so e.g. a PS shard stub and a provenance shard stub talking to
the same worker multiplex over a single socket.  Request ids wrap at 2³²
and skip ids still in flight, so arbitrarily long-lived connections never
collide a new call with a slow old one.

Failure semantics are typed and loud (the federation must degrade visibly,
never silently):

  * server unreachable / connection dropped → :class:`ConnectionLost`
    (every in-flight future fails; the *next* call transparently retries the
    connection, so a restarted server is picked up without client surgery),
  * response later than the per-call timeout   → :class:`CallTimeout`,
  * handler raised on the server               → :class:`RemoteError`
    carrying the remote exception type and message.

Method names are resolved to numeric ids during a synchronous connect-time
handshake through the reserved ``METHOD_RESOLVE`` id, so the client needs no
compiled-in method constants.  Connections are generation-numbered: a late
error from a dead connection's reader can never fail calls already riding a
newer connection.
"""
from __future__ import annotations

import concurrent.futures
import socket
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..telemetry import registry as telemetry
from ..telemetry import spans
from .framing import (
    ERROR,
    METHOD_RESOLVE,
    REQUEST,
    RESPONSE,
    CallTimeout,
    ConnectionLost,
    FrameDecoder,
    FramingError,
    RemoteError,
    encode_frame,
)

CallResult = Tuple[dict, Tuple[np.ndarray, ...]]


def _shutdown_close(sock: socket.socket) -> None:
    """Shutdown *then* close: close() alone may not wake a thread blocked in
    recv() on this socket (the in-flight syscall keeps the fd alive on some
    kernels), which would leak the reader thread."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class RPCClient:
    """One connection to one RPC server; thread-safe, multiplexed, reconnecting."""

    _shared_lock = threading.Lock()
    _shared: Dict[Tuple[str, int], "RPCClient"] = {}

    @classmethod
    def shared(cls, endpoint: Tuple[str, int], timeout: float = 30.0, **kw) -> "RPCClient":
        """Ref-counted client shared per endpoint.

        Multiple stubs (PS + provenance shards on one worker, several
        federations in one process) multiplex their calls over a single
        connection; ``close()`` disconnects only when the last user leaves.

        Connection parameters belong to the *first* creator: a later caller
        joins the existing client, its ``**kw`` (connect_retries, ...) are
        ignored, and the shared default timeout unifies on the longest
        requested — per-call deadlines still exist via ``call(...,
        timeout=)``.  Callers needing different dial behavior should
        construct an exclusive ``RPCClient`` instead.
        """
        key = (endpoint[0], int(endpoint[1]))
        with cls._shared_lock:
            client = cls._shared.get(key)
            if client is not None and not client._closed:
                client._refs += 1
                client.timeout = max(client.timeout, timeout)
                return client
            client = cls(endpoint, timeout=timeout, **kw)
            client._refs = 1
            cls._shared[key] = client
            return client

    def __init__(
        self,
        endpoint: Tuple[str, int],
        timeout: float = 30.0,
        connect_retries: int = 40,
        retry_delay: float = 0.25,
        retry_delay_max: float = 2.0,
    ):
        self.endpoint = (endpoint[0], int(endpoint[1]))
        self.timeout = timeout
        self.connect_retries = connect_retries
        self.retry_delay = retry_delay
        self.retry_delay_max = retry_delay_max
        self._lock = threading.Lock()  # guards socket/gen/methods + sends + rid
        self._sock: Optional[socket.socket] = None
        self._gen = 0  # connection generation; tags pending calls
        self._methods: Dict[str, int] = {}
        self._pending_lock = threading.Lock()
        self._pending: Dict[int, Tuple[int, str, concurrent.futures.Future]] = {}
        self._next_rid = 1
        self._refs: Optional[int] = None  # set by shared(); None = exclusive
        # Send-side coalescing for fire-and-forget traffic: buffered frames
        # accumulate here and go out in one sendall once the buffer crosses
        # ``sendbuf_max`` bytes — or immediately before any unbuffered send,
        # so the wire order always equals the call order.
        self._sendbuf = bytearray()
        self.sendbuf_max = 256 << 10
        self._closed = False
        # Client-side telemetry, labeled by endpoint: per-method call
        # latency (request append → future resolution), reconnect count,
        # and send-buffer occupancy for the buffered fire-and-forget path.
        _ep = f"{self.endpoint[0]}:{self.endpoint[1]}"
        _reg = telemetry.get_registry()
        self._m_latency_family = _reg.histogram(
            "repro_client_call_latency_us",
            "Client-observed call latency in microseconds (send to resolve;"
            " buffered calls include their coalescing delay).",
            ["endpoint", "method"],
        )
        self._m_reconnects = _reg.counter(
            "repro_client_reconnects_total",
            "Connections re-dialed after the initial connect.",
            ["endpoint"],
        ).labels(endpoint=_ep)
        self._m_sendbuf = _reg.gauge(
            "repro_client_sendbuf_bytes",
            "Bytes of buffered fire-and-forget frames awaiting a flush.",
            ["endpoint"],
        ).labels(endpoint=_ep)
        self._telemetry_endpoint = _ep
        self._m_by_method: Dict[str, object] = {}
        with self._lock:
            self._connect()

    @property
    def generation(self) -> int:
        """Connection generation: bumps on every successful (re)dial.

        Fault-tolerant stubs (repro_torch.net.shards) compare this with the
        generation they last ``configure``d on: a mismatch means the
        connection bounced — possibly to a blank respawned worker — while
        their in-flight window was empty, so nothing else would have
        noticed that a recovery reconfigure is due."""
        with self._lock:
            return self._gen

    def _method_latency(self, name: str):
        m = self._m_by_method.get(name)
        if m is None:
            m = self._m_by_method.setdefault(
                name,
                self._m_latency_family.labels(
                    endpoint=self._telemetry_endpoint, method=name
                ),
            )
        return m

    # ------------------------------------------------------------ connection
    def _connect(self) -> None:  # lint: ignore[lockset-mixed] — caller holds _lock
        """Dial + handshake synchronously; caller holds ``_lock``.

        Between attempts the dial backs off on the shared capped-exponential
        schedule (``repro_torch.fault.policy``): delay k is ``min(cap, base*2**k)``
        — a pure function of the attempt index (deterministic, no jitter).
        A reconnect storm against a restarting server therefore decays to at
        most one dial per client per ``retry_delay_max`` seconds, instead of
        every client hammering at a fixed ``retry_delay`` period.
        """
        from repro_torch.fault.policy import backoff_delay  # lazy: no import cycle

        if self._closed:
            raise ConnectionLost(f"client for {self.endpoint} is closed")
        last: Optional[Exception] = None
        sock = None
        for attempt in range(max(self.connect_retries, 1)):
            try:
                sock = socket.create_connection(self.endpoint, timeout=self.timeout)
                break
            except OSError as e:
                last = e
                if attempt + 1 < max(self.connect_retries, 1):
                    time.sleep(
                        backoff_delay(attempt, self.retry_delay, self.retry_delay_max)
                    )
        if sock is None:
            raise ConnectionLost(
                f"cannot connect to {self.endpoint[0]}:{self.endpoint[1]}: {last}"
            ) from last
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Method-table handshake, synchronous on the fresh socket (no reader
        # thread yet, so no future/lock interplay during connect).
        try:
            sock.settimeout(self.timeout)
            sock.sendall(encode_frame(METHOD_RESOLVE, REQUEST, 0, {}))
            decoder = FrameDecoder()
            frames = []
            while not frames:
                data = sock.recv(1 << 20)
                if not data:
                    raise ConnectionLost(
                        f"server {self.endpoint} closed during handshake"
                    )
                frames = decoder.feed(data)
            sock.settimeout(None)
        except (OSError, FramingError) as e:
            sock.close()
            raise ConnectionLost(f"handshake with {self.endpoint} failed: {e}") from e
        self._methods = {
            str(k): int(v) for k, v in frames[0].env.get("methods", {}).items()
        }
        self._gen += 1
        if self._gen > 1:
            self._m_reconnects.inc()
        self._sock = sock
        # Frames buffered for the dead connection died with it (their
        # futures were failed by generation); never replay them here.
        self._sendbuf.clear()
        threading.Thread(
            target=self._read_loop, args=(sock, self._gen), daemon=True,
            name=f"rpc-reader:{self.endpoint[1]}",
        ).start()

    def _send_locked(  # lint: ignore[lockset-mixed] — caller holds _lock
        self,
        method_id: int,
        env: dict,
        arrays: Sequence[np.ndarray],
        name: str,
        buffered: bool = False,
        tc: Optional[spans.WireSpan] = None,
    ) -> concurrent.futures.Future:
        """Frame + send (or buffer) one request; caller holds ``_lock``."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        fut._rpc_method = name  # lets wait() name the call in CallTimeout
        with self._pending_lock:
            # Request ids live in [1, 2³²-1] (0 is the handshake) and wrap.
            # Skip ids still in flight: after 2³² calls on one connection a
            # naive wrap would hand a slow old call's id to a new call and
            # cross their responses.
            rid = self._next_rid
            while rid in self._pending:
                rid = rid % 0xFFFFFFFF + 1
            self._next_rid = rid % 0xFFFFFFFF + 1
            self._pending[rid] = (self._gen, name, fut)
        # Trace-context injection: an explicit WireSpan (the fault-tolerant
        # stubs pass one with a replay-stable id) wins; otherwise derive the
        # default per-call span from (endpoint, generation, request id).
        if tc is None and spans.ENABLED:
            tc = spans.derive_call_context(self._telemetry_endpoint, self._gen, rid)
        frame = encode_frame(
            method_id, REQUEST, rid, env, arrays,
            tc.tc() if tc is not None else None,
        )
        if tc is not None:
            t0_us = spans.now_us()

            def _record_client_span(f, _tc=tc, _t0=t0_us, _name=name):
                err = f.cancelled() or f.exception() is not None
                spans.record(
                    _tc.trace_id, _tc.span_id, _tc.parent_id,
                    "rpc.client:" + _name, "client", _tc.flags,
                    _t0, spans.now_us() - _t0, err=err,
                )

            fut.add_done_callback(_record_client_span)
        if telemetry.ENABLED:
            latency = self._method_latency(name)
            t0_ns = time.perf_counter_ns()
            fut.add_done_callback(
                lambda _f: latency.observe((time.perf_counter_ns() - t0_ns) // 1000)
            )
        try:
            assert self._sock is not None
            if buffered:
                # Fire-and-forget coalescing: syscalls are the socket-mode
                # overhead, so small frames ride together.  Order vs
                # unbuffered sends is preserved below.
                self._sendbuf += frame
                if len(self._sendbuf) >= self.sendbuf_max:
                    self._flush_sends_locked()
                elif telemetry.ENABLED:
                    self._m_sendbuf.set(len(self._sendbuf))
            else:
                if self._sendbuf:
                    self._flush_sends_locked()
                self._sock.sendall(frame)
        except OSError as e:
            # Inline cleanup — we already hold _lock, so no _drop_connection
            # here.  The reader thread will fail this gen's other in-flight
            # calls when it observes the dead socket.
            with self._pending_lock:
                self._pending.pop(rid, None)
            _shutdown_close(self._sock)
            self._sock = None
            raise ConnectionLost(f"send to {self.endpoint} failed: {e}") from e
        return fut

    def _flush_sends_locked(self) -> None:  # lint: ignore[lockset-mixed] — caller holds _lock
        buf, self._sendbuf = self._sendbuf, bytearray()
        if telemetry.ENABLED:
            self._m_sendbuf.set(0)
        self._sock.sendall(buf)

    def try_dial(self) -> bool:
        """One quick dial attempt; True when connected (or already).

        The degraded-mode recovery probe (repro_torch.net.shards): a down shard
        must cost one failed ``connect()`` per probe, never the full
        ``connect_retries`` backoff budget the blocking paths use.
        """
        with self._lock:
            if self._sock is not None:
                return True
            saved = self.connect_retries
            self.connect_retries = 1
            try:
                self._connect()
                return True
            except ConnectionLost:
                return False
            finally:
                self.connect_retries = saved

    def flush_sends(self) -> None:
        """Put every buffered fire-and-forget frame on the wire."""
        with self._lock:
            if self._sendbuf and self._sock is not None:
                try:
                    self._flush_sends_locked()
                except OSError as e:
                    _shutdown_close(self._sock)
                    self._sock = None
                    raise ConnectionLost(
                        f"send to {self.endpoint} failed: {e}"
                    ) from e

    def _read_loop(self, sock: socket.socket, gen: int) -> None:
        decoder = FrameDecoder()
        err: Exception
        try:
            while True:
                data = sock.recv(1 << 20)
                if not data:
                    decoder.close()  # raises TruncatedStream on a partial frame
                    err = ConnectionLost(
                        f"server {self.endpoint} closed the connection"
                    )
                    break
                for frame in decoder.feed(data):
                    self._resolve(frame)
        except FramingError as e:
            err = e
        except Exception as e:  # incl. OSError — a dead reader must fail its
            # callers with a typed error, never strand them on the futures
            err = ConnectionLost(f"connection to {self.endpoint} lost: {e}")
        self._drop_connection(err, gen)

    def _resolve(self, frame) -> None:
        with self._pending_lock:
            entry = self._pending.pop(frame.request_id, None)
        if entry is None:
            return  # response to a timed-out/abandoned call
        _gen, name, fut = entry
        if frame.kind == ERROR:
            fut.set_exception(
                RemoteError(
                    frame.env.get("method", name),
                    frame.env.get("etype", "Exception"),
                    frame.env.get("message", ""),
                )
            )
        elif frame.kind == RESPONSE:
            fut.set_result((frame.env, frame.arrays))

    def _drop_connection(self, err: Exception, gen: Optional[int]) -> None:
        """Tear down generation ``gen`` (all generations when ``None``) and
        fail its in-flight calls.  Never touches a newer connection."""
        with self._lock:
            if (gen is None or gen == self._gen) and self._sock is not None:
                _shutdown_close(self._sock)
                self._sock = None
        with self._pending_lock:
            doomed = [
                rid for rid, (g, _n, _f) in self._pending.items()
                if gen is None or g == gen
            ]
            entries = [self._pending.pop(rid) for rid in doomed]
        for _g, _name, fut in entries:
            if not fut.done():
                fut.set_exception(err)

    # ----------------------------------------------------------------- calls
    def call_async(
        self,
        name: str,
        env: Optional[dict] = None,
        arrays: Sequence[np.ndarray] = (),
        buffered: bool = False,
        tc: Optional[spans.WireSpan] = None,
    ) -> concurrent.futures.Future:
        """Pipeline one request; returns a future of ``(env, arrays)``.

        ``buffered=True`` coalesces the frame with other buffered sends
        (fire-and-forget hot path); it reaches the wire when the buffer
        fills, before the next unbuffered send, or on :meth:`flush_sends` —
        callers waiting such a future should flush first (``wait`` does).

        ``tc`` pins the frame's trace context (replay-stable write spans);
        by default the ambient context, when armed, is injected with a
        per-call derived span id.
        """
        with self._lock:
            if self._sock is None:
                self._connect()
            try:
                mid = self._methods[name]
            except KeyError:
                raise RemoteError(
                    name, "KeyError", f"server has no method {name!r}"
                ) from None
            return self._send_locked(
                mid, env or {}, arrays, name=name, buffered=buffered, tc=tc
            )

    def call(
        self,
        name: str,
        env: Optional[dict] = None,
        arrays: Sequence[np.ndarray] = (),
        timeout: Optional[float] = None,
    ) -> CallResult:
        return self.wait(self.call_async(name, env, arrays), timeout=timeout, name=name)

    def wait(
        self,
        fut: concurrent.futures.Future,
        timeout: Optional[float] = None,
        name: str = "?",
    ) -> CallResult:
        """Resolve a pipelined call's future with the per-call timeout."""
        name = getattr(fut, "_rpc_method", name)  # always the method *name*
        if not fut.done() and self._sendbuf:
            self.flush_sends()  # the awaited frame may still be buffered
        try:
            return fut.result(self.timeout if timeout is None else timeout)
        except concurrent.futures.TimeoutError:
            raise CallTimeout(
                f"call {name!r} to {self.endpoint} exceeded its timeout"
            ) from None

    def close(self) -> None:
        if self._refs is not None:
            with RPCClient._shared_lock:
                self._refs -= 1
                if self._refs > 0:
                    return  # other stubs still multiplex over this connection
                if RPCClient._shared.get(self.endpoint) is self:
                    del RPCClient._shared[self.endpoint]
        self._closed = True
        self._drop_connection(
            ConnectionLost(f"client for {self.endpoint} closed"), gen=None
        )
