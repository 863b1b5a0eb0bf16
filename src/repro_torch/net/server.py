"""Socket servers on one shared selectors event loop.

Two layers live here:

:class:`EventLoopServer` is the protocol-agnostic machinery PR 4 built for
the RPC transport, factored out so any byte protocol can run on it: one IO
thread owns the listening socket and every connection; sockets are
non-blocking; each connection carries a protocol decoder on the inbound
side and a queue of partially-written responses on the outbound side, so
thousands of connections cost file descriptors, not threads.  Outbound
queues have a high/low-watermark: a connection whose peer stops reading is
unsubscribed from READ until its queue drains (backpressure, counted in
``backpressure_pauses`` / ``backpressure_resumes``), so one slow consumer
can neither wedge the loop nor balloon server memory.  Subclasses implement
``_make_conn`` / ``_on_data`` and get worker-thread offload via
:meth:`EventLoopServer._offload` plus a thread-safe "run this on the loop"
primitive via :meth:`EventLoopServer._post`.  ``repro_torch.viz.gateway`` serves
HTTP + WebSocket on exactly this base.

:class:`RPCServer` is the shard RPC protocol on top: an incremental
:class:`~repro_torch.net.framing.FrameDecoder` per connection, light handlers
inline on the loop, handlers registered ``heavy=True`` (bulk queries, table
dumps) offloaded to the worker pool — the ``ps.push`` / ``prov.add_many``
hot path never pays a thread handoff.

The RPC server preserves the ordering contract multiplexed clients rely on:
requests of one connection are *executed* strictly in arrival order (a
heavy handler blocks later requests of its own connection only), so a
pipelined read observes every write that preceded it on the same
connection.  Responses carry the request id, so clients correlate them even
though many logical calls share the connection.

Handlers have the uniform signature ``fn(env, arrays) -> (env, arrays)``
(returning ``None`` means "empty reply").  Any exception a handler raises is
serialized back as an ERROR frame carrying the exception type and message —
the client rethrows it as :class:`~repro_torch.net.framing.RemoteError` — so a
server-side failure is always a loud, typed client-side failure.

Method ids are assigned at registration time and are *not* part of the
public contract: clients resolve ``{name: id}`` at connect time through the
reserved ``METHOD_RESOLVE`` id 0, so the wire stays stable when services
add methods.
"""
from __future__ import annotations

import collections
import queue
import selectors
import socket
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..lint import runtime as san
from ..telemetry import registry as telemetry
from ..telemetry import spans
from ..telemetry.selftrace import get_self_tracer
from .framing import (
    ERROR,
    METHOD_RESOLVE,
    REQUEST,
    RESPONSE,
    Frame,
    FrameDecoder,
    FramingError,
    encode_frame,
)

Handler = Callable[[dict, tuple], Optional[Tuple[dict, tuple]]]


class MethodTable:
    """Name → handler registry with server-assigned numeric method ids.

    ``heavy=True`` marks a handler as too expensive for the event loop's IO
    thread (bulk queries, full-table serialization): the event-loop server
    runs it on a worker thread while the loop keeps serving other
    connections.  Per-connection request order is preserved either way.
    """

    def __init__(self) -> None:
        self._by_id: Dict[int, Tuple[str, Handler, bool]] = {}
        self._ids: Dict[str, int] = {}
        self._next_id = METHOD_RESOLVE + 1
        self._closers: List[Callable[[], None]] = []

    def register_closer(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` when the hosting server stops — services use this to
        release state the registry otherwise keeps alive (e.g. a shard's
        write-ahead log file handle)."""
        self._closers.append(fn)

    def close_all(self) -> None:
        for fn in self._closers:
            try:
                fn()
            except Exception:
                pass  # teardown must release every closer it can

    def register(self, name: str, fn: Handler, heavy: bool = False) -> int:
        if name in self._ids:
            raise ValueError(f"method {name!r} already registered")
        mid = self._next_id
        self._next_id += 1
        self._by_id[mid] = (name, fn, heavy)
        self._ids[name] = mid
        return mid

    def names(self) -> Dict[str, int]:
        return dict(self._ids)

    def lookup(self, method_id: int) -> Tuple[str, Handler, bool]:
        try:
            return self._by_id[method_id]
        except KeyError:
            raise KeyError(f"unknown method id {method_id}") from None


def _run_traced(name: str, fn: Handler, frame: Frame, kind: str):
    """Execute a handler under the frame's trace context: the server span
    is a deterministic child of the client span that carried the context,
    and the context is ambient while the handler runs so handler-internal
    spans (PS apply, prov ingest) become its children."""
    ctx = spans.server_context(frame.tc)
    t0 = spans.now_us()
    err = False
    try:
        with spans.use(ctx):
            return fn(frame.env, frame.arrays)
    except BaseException:
        err = True
        raise
    finally:
        spans.record(
            ctx.trace_id, ctx.span_id, frame.tc[1],
            "rpc.server:" + name, kind, ctx.flags,
            t0, spans.now_us() - t0, err=err,
        )


def _run_method(
    name: str, fn: Handler, frame: Frame, kind: str = "server"
) -> Optional[bytes]:
    """Execute one handler; return the reply frame bytes.

    ``None`` means the reply itself could not be framed (e.g. over-size
    payload) — the caller must drop the connection, because skipping a
    response would desynchronize the client's request-id bookkeeping.
    """
    try:
        if spans.ENABLED and frame.tc is not None:
            out = _run_traced(name, fn, frame, kind)
        else:
            out = fn(frame.env, frame.arrays)
        env, arrays = out if out is not None else ({}, ())
        return encode_frame(frame.method_id, RESPONSE, frame.request_id, env, arrays)
    except Exception as e:  # noqa: BLE001 - every handler error goes on the wire
        try:
            return encode_frame(
                frame.method_id, ERROR, frame.request_id,
                {"method": name, "etype": type(e).__name__, "message": str(e)},
            )
        except Exception:
            return None


def _dispatch_light(table: MethodTable, frame: Frame):
    """Resolve one request frame without running it.

    Returns either ready reply ``bytes`` (resolve/unknown-method) or the
    ``(name, fn, heavy)`` triple to execute.
    """
    if frame.method_id == METHOD_RESOLVE:
        return encode_frame(
            METHOD_RESOLVE, RESPONSE, frame.request_id, {"methods": table.names()}
        )
    try:
        return table.lookup(frame.method_id)
    except KeyError as e:
        return encode_frame(
            frame.method_id, ERROR, frame.request_id,
            {"method": f"#{frame.method_id}", "etype": "KeyError", "message": str(e)},
        )


class EventLoopConn:
    """Per-connection IO state owned by the event loop thread.

    Protocol servers subclass to add their decoder/queue state (slots keep
    the per-connection footprint small at high fan-out).
    ``close_when_flushed`` lets a protocol queue a final farewell (an HTTP
    error body, a WebSocket close frame) and have the loop drop the
    connection once it reaches the kernel.
    """

    __slots__ = (
        "sock", "fd", "outq", "out_bytes", "paused", "closed", "events",
        "close_when_flushed",
    )

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.fd = sock.fileno()
        self.outq: Deque[memoryview] = collections.deque()
        self.out_bytes = 0
        self.paused = False  # READ unsubscribed: outbound queue over high water
        self.closed = False
        self.close_when_flushed = False
        self.events = selectors.EVENT_READ


class EventLoopServer:
    """Protocol-agnostic selectors event-loop server base.

    One IO thread multiplexes the listener and every connection.  Protocol
    subclasses implement:

      * :meth:`_make_conn`   — build the per-connection state object
      * :meth:`_on_data`     — consume received bytes (runs on the loop)

    and may override:

      * :meth:`_wants_read`     — extra inbound gating (e.g. a bounded
        pipeline of decoded-but-unexecuted requests)
      * :meth:`_on_conn_closed` — cleanup when a connection dies

    Two primitives bridge threads:

      * :meth:`_offload` runs a callable on a small daemon worker pool
        (heavy handlers that would stall the loop)
      * :meth:`_post` schedules a callable onto the loop thread from any
        thread (worker completions, external broadcasts) — the only safe
        way to touch connection state from outside the loop

    ``high_water``/``low_water`` bound the per-connection outbound queue: a
    connection whose peer reads slower than the server writes stops being
    *read* once ``high_water`` bytes are queued, and resumes below
    ``low_water`` — the event-loop version of TCP backpressure, end to end.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        workers: int = 2,
        high_water: int = 8 << 20,
        low_water: int = 1 << 20,
    ):
        self._workers = max(int(workers), 1)
        self._high_water = int(high_water)
        self._low_water = min(int(low_water), int(high_water))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self._sock.setblocking(False)
        self._host = host
        self._port = self._sock.getsockname()[1]
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._sock, selectors.EVENT_READ, "accept")
        # Self-pipe: wakes the loop for stop(), _post() and worker completions.
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._conns: Dict[int, EventLoopConn] = {}
        # Posted callables carry their schedule timestamp so the loop can
        # observe its own lag (scheduled-vs-actual wakeup delta).
        self._posted: Deque[Tuple[Callable[[], None], int]] = collections.deque()
        self._jobs: "queue.SimpleQueue" = queue.SimpleQueue()
        self._worker_threads: List[threading.Thread] = []
        self._loop_thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        # Observability: every counter lives in the telemetry registry
        # (internally locked, exact under contention, snapshot-mergeable
        # across shards) instead of ad-hoc _stats_lock fields.  The public
        # backpressure_pauses/resumes names survive as read properties.
        self._telemetry_server = f"{type(self).__name__}:{self._port}"
        _reg = telemetry.get_registry()
        _srv = self._telemetry_server
        self._m_backpressure_pauses = _reg.counter(
            "repro_backpressure_pauses_total",
            "Slow-reader connections paused at the outbound high watermark.",
            ["server"],
        ).labels(server=_srv)
        self._m_backpressure_resumes = _reg.counter(
            "repro_backpressure_resumes_total",
            "Paused connections drained back under the low watermark.",
            ["server"],
        ).labels(server=_srv)
        self._m_loop_lag = _reg.histogram(
            "repro_loop_lag_us",
            "Event-loop lag: delta between a callable's _post() and its run.",
            ["server"],
        ).labels(server=_srv)
        self._m_queue_depth = _reg.gauge(
            "repro_worker_queue_depth",
            "Jobs queued for the worker pool (heavy handlers, offloads).",
            ["server"],
        ).labels(server=_srv)
        self._m_connections = _reg.gauge(
            "repro_connections",
            "Open connections owned by the event loop.",
            ["server"],
        ).labels(server=_srv)
        self._selftrace = get_self_tracer()

    # ----------------------------------------------------- observability
    @property
    def backpressure_pauses(self) -> int:
        """Slow-reader pauses taken (0 when REPRO_TELEMETRY=0)."""
        return self._m_backpressure_pauses.value

    @property
    def backpressure_resumes(self) -> int:
        """Pauses drained back under low water (0 when REPRO_TELEMETRY=0)."""
        return self._m_backpressure_resumes.value

    # --------------------------------------------------------- protocol hooks
    def _make_conn(self, sock: socket.socket) -> EventLoopConn:
        raise NotImplementedError

    def _on_data(self, conn: EventLoopConn, data: bytes) -> None:
        raise NotImplementedError

    def _wants_read(self, conn: EventLoopConn) -> bool:
        return True

    def _on_conn_closed(self, conn: EventLoopConn) -> None:
        pass

    # ------------------------------------------------------------- lifecycle
    @property
    def endpoint(self) -> Tuple[str, int]:
        return (self._host, self._port)

    def start(self) -> "EventLoopServer":
        self._loop_thread = threading.Thread(
            target=self._loop, name=f"{type(self).__name__}:{self._port}",
            daemon=True,
        )
        self._loop_thread.start()
        return self

    def serve_forever(self) -> None:
        """Blocking variant for worker processes / CLI entrypoints."""
        if self._loop_thread is None:
            self.start()
        self._stopping.wait()

    def stop(self) -> None:
        self._stopping.set()
        self._wake()
        if self._loop_thread is None:
            # Never started: the loop's teardown (which normally owns the
            # sockets' lifecycle) will never run — release the fds here.
            self._force_close(self._sock)
            self._force_close(self._wake_r)
            self._force_close(self._wake_w)
            try:
                self._sel.close()
            except OSError:
                pass
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5)
        # Normally the loop thread tore everything down on exit.  If it is
        # wedged (a light handler blocking the loop), force-close the
        # sockets from here so clients observe a dropped connection instead
        # of hanging; the daemon loop thread dies with the process.
        if self._loop_thread is not None and self._loop_thread.is_alive():
            for conn in list(self._conns.values()):
                self._force_close(conn.sock)
            self._force_close(self._sock)
        for _ in self._worker_threads:
            self._jobs.put(None)  # wake idle workers so they can exit

    @staticmethod
    def _force_close(sock: socket.socket) -> None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, OSError):
            pass  # a wake is already pending, or we are shutting down

    # --------------------------------------------------------- thread bridges
    def _post(self, fn: Callable[[], None]) -> None:
        """Schedule ``fn`` to run on the loop thread (thread-safe)."""
        self._posted.append((fn, time.perf_counter_ns()))
        self._wake()

    def _offload(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` on the daemon worker pool (spawned lazily)."""
        if len(self._worker_threads) < self._workers:
            t = threading.Thread(
                target=self._worker_main,
                name=f"{type(self).__name__}-worker:{self._port}:"
                f"{len(self._worker_threads)}",
                daemon=True,
            )
            t.start()
            self._worker_threads.append(t)
        self._jobs.put(fn)
        if telemetry.ENABLED:
            self._m_queue_depth.set(self._jobs.qsize())

    def _worker_main(self) -> None:
        while True:
            job = self._jobs.get()
            if telemetry.ENABLED:
                self._m_queue_depth.set(self._jobs.qsize())
            if job is None:
                return
            try:
                job()
            except Exception:  # pragma: no cover - worker survival net
                pass

    # ------------------------------------------------------------- the loop
    def _loop(self) -> None:
        try:
            while not self._stopping.is_set():
                for key, _mask in self._sel.select(timeout=1.0):
                    if key.data == "accept":
                        self._accept()
                    elif key.data == "wake":
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                    else:
                        self._service(key.data, _mask)
                while self._posted:
                    fn, scheduled_ns = self._posted.popleft()
                    if telemetry.ENABLED:
                        self._m_loop_lag.observe(
                            (time.perf_counter_ns() - scheduled_ns) // 1000
                        )
                    fn()
        finally:
            for conn in list(self._conns.values()):
                self._close_conn(conn)
            try:
                self._sel.unregister(self._sock)
            except (KeyError, ValueError):
                pass
            self._force_close(self._sock)
            self._force_close(self._wake_r)
            self._force_close(self._wake_w)
            try:
                self._sel.close()
            except OSError:
                pass

    def _accept(self) -> None:
        while True:
            try:
                sock, _addr = self._sock.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = self._make_conn(sock)
            self._conns[conn.fd] = conn
            self._sel.register(sock, selectors.EVENT_READ, conn)
            if telemetry.ENABLED:
                self._m_connections.set(len(self._conns))

    def _service(self, conn: EventLoopConn, mask: int) -> None:
        if san.ENABLED:
            san.assert_loop_thread(self)
        if conn.closed:
            return
        if mask & selectors.EVENT_WRITE:
            self._flush_out(conn)
        if conn.closed or not (mask & selectors.EVENT_READ):
            return
        try:
            data = conn.sock.recv(1 << 20)
        except BlockingIOError:
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:
            self._close_conn(conn)  # peer closed; a partial frame is its problem
            return
        self._on_data(conn, data)

    # --------------------------------------------------------------- writes
    def _send(self, conn: EventLoopConn, data: bytes, flush: bool = True) -> None:
        if san.ENABLED:
            san.assert_loop_thread(self)
        if conn.closed:
            return
        conn.outq.append(memoryview(data))
        conn.out_bytes += len(data)
        if flush:
            # Opportunistic immediate write: the common case (small reply,
            # empty socket buffer) completes without an extra poll round.
            self._flush_out(conn)
        else:
            self._update_events(conn)

    def _flush_out(self, conn: EventLoopConn) -> None:
        if san.ENABLED:
            san.assert_loop_thread(self)
        while conn.outq:
            if len(conn.outq) > 1 and len(conn.outq[0]) < (32 << 10):
                # Coalesce queued small replies into one send() — the
                # syscall, not the copy, is the per-frame cost that made
                # thread-per-connection mode slow.
                chunk = bytearray()
                while (
                    conn.outq
                    and len(chunk) < (128 << 10)
                    and len(conn.outq[0]) < (32 << 10)  # never copy big frames
                ):
                    chunk += conn.outq.popleft()
                conn.outq.appendleft(memoryview(bytes(chunk)))
            head = conn.outq[0]
            try:
                n = conn.sock.send(head)
            except BlockingIOError:
                break
            except OSError:
                self._close_conn(conn)
                return
            conn.out_bytes -= n
            if n == len(head):
                conn.outq.popleft()
            else:
                conn.outq[0] = head[n:]
                break  # kernel buffer full; wait for EVENT_WRITE
        if not conn.outq and conn.close_when_flushed:
            self._close_conn(conn)
            return
        self._update_events(conn)

    def _update_events(self, conn: EventLoopConn) -> None:
        """Recompute the selector interest set: READ unless backpressured,
        WRITE while responses are queued."""
        if san.ENABLED:
            san.assert_loop_thread(self)
        if conn.closed:
            return
        if not conn.paused and conn.out_bytes > self._high_water:
            conn.paused = True
            self._m_backpressure_pauses.inc()
        elif conn.paused and conn.out_bytes <= self._low_water:
            conn.paused = False
            self._m_backpressure_resumes.inc()
        events = selectors.EVENT_WRITE if conn.outq else 0
        # Inbound backpressure: the protocol may additionally gate reads
        # (e.g. requests buffered behind an in-flight heavy handler).
        if not conn.paused and self._wants_read(conn):
            events |= selectors.EVENT_READ
        if events != conn.events:
            # events == 0 (fully backpressured, nothing to write) must leave
            # the selector entirely: a zero mask is invalid, and a WRITE
            # placeholder would busy-spin on an always-writable socket.
            try:
                if events == 0:
                    self._sel.unregister(conn.sock)
                elif conn.events == 0:
                    self._sel.register(conn.sock, events, conn)
                else:
                    self._sel.modify(conn.sock, events, conn)
                conn.events = events
            except (KeyError, ValueError, OSError):
                self._close_conn(conn)

    def _close_conn(self, conn: EventLoopConn) -> None:
        if san.ENABLED:
            san.assert_loop_thread(self)
        if conn.closed:
            return
        conn.closed = True
        self._conns.pop(conn.fd, None)
        if telemetry.ENABLED:
            self._m_connections.set(len(self._conns))
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        self._force_close(conn.sock)
        conn.outq.clear()
        conn.out_bytes = 0
        self._on_conn_closed(conn)


class _RPCConn(EventLoopConn):
    """RPC per-connection state: frame decoder + bounded request pipeline."""

    __slots__ = ("decoder", "pending", "busy")

    def __init__(self, sock: socket.socket):
        super().__init__(sock)
        self.decoder = FrameDecoder()
        self.pending: Deque[Frame] = collections.deque()
        self.busy = False  # a heavy handler for this conn is on a worker


class RPCServer(EventLoopServer):
    """The shard RPC protocol on the event-loop base (the default server).

    Light handlers run inline on the loop; ``heavy=True`` handlers run on
    the worker pool, with strict per-connection request order preserved (a
    connection's later requests wait for its in-flight heavy handler; other
    connections don't).  ``pending_max`` bounds the decoded-but-unexecuted
    request pipeline per connection: past it the server stops *reading*
    that connection (frames stay in kernel buffers, not server memory).
    """

    def __init__(
        self,
        table: MethodTable,
        host: str = "127.0.0.1",
        port: int = 0,
        workers: int = 2,
        high_water: int = 8 << 20,
        low_water: int = 1 << 20,
        pending_max: int = 1024,
    ):
        super().__init__(host=host, port=port, workers=workers,
                         high_water=high_water, low_water=low_water)
        self.table = table
        self._pending_max = max(int(pending_max), 1)
        _reg = telemetry.get_registry()
        self._rpc_requests = _reg.counter(
            "repro_rpc_requests_total",
            "RPC requests executed, by server instance and method.",
            ["server", "method"],
        )
        self._rpc_latency = _reg.histogram(
            "repro_rpc_latency_us",
            "Server-side handler latency in microseconds, by method.",
            ["server", "method"],
        )
        self._rpc_reply_bytes = _reg.histogram(
            "repro_rpc_reply_bytes",
            "Encoded reply frame size in bytes, by method.",
            ["server", "method"],
        )
        self._m_heavy_inflight = _reg.gauge(
            "repro_rpc_heavy_inflight",
            "Heavy handlers currently running on the worker pool.",
            ["server"],
        ).labels(server=self._telemetry_server)
        # Per-method child cache: labels() costs a canonical-key encode, so
        # the hot path resolves each method's children once.  dict reads and
        # setdefault are GIL-atomic; labels() dedupes children, so racing
        # threads converge on the same objects.
        self._m_by_method: Dict[str, tuple] = {}

    def stop(self) -> None:
        super().stop()
        # Loop + idle workers are done: release service-held state that the
        # registry otherwise keeps alive (a PS shard's WAL file handle, a
        # provenance shard's JSONL handle).
        self.table.close_all()

    def _method_metrics(self, name: str) -> tuple:
        m = self._m_by_method.get(name)
        if m is None:
            srv = self._telemetry_server
            m = self._m_by_method.setdefault(name, (
                self._rpc_requests.labels(server=srv, method=name),
                self._rpc_latency.labels(server=srv, method=name),
                self._rpc_reply_bytes.labels(server=srv, method=name),
            ))
        return m

    def _observe_rpc(self, name: str, t0_ns: int, reply: Optional[bytes]) -> None:
        requests, latency, reply_bytes = self._method_metrics(name)
        requests.inc()
        latency.observe((time.perf_counter_ns() - t0_ns) // 1000)
        if reply is not None:
            reply_bytes.observe(len(reply))

    # --------------------------------------------------------- protocol hooks
    def _make_conn(self, sock: socket.socket) -> _RPCConn:
        return _RPCConn(sock)

    def _wants_read(self, conn: _RPCConn) -> bool:
        return len(conn.pending) < self._pending_max

    def _on_data(self, conn: _RPCConn, data: bytes) -> None:
        try:
            conn.pending.extend(conn.decoder.feed(data))
        except FramingError:
            self._close_conn(conn)  # corrupt stream: drop the connection
            return
        self._drain_pending(conn)

    # ------------------------------------------------------------- execution
    def _drain_pending(self, conn: _RPCConn) -> None:
        """Execute queued requests in arrival order until one offloads.

        Replies are queued and flushed once at the end: requests that
        arrived coalesced (a client's send buffer) answer in one syscall.
        """
        if san.ENABLED:
            san.assert_loop_thread(self)
        while conn.pending and not conn.busy and not conn.closed:
            frame = conn.pending.popleft()
            if frame.kind != REQUEST:
                continue  # only clients originate the other kinds
            resolved = _dispatch_light(self.table, frame)
            if isinstance(resolved, bytes):
                self._send(conn, resolved, flush=False)
                continue
            name, fn, heavy = resolved
            if heavy:
                conn.busy = True
                self._m_heavy_inflight.inc()
                self._offload(
                    lambda c=conn, n=name, f=fn, fr=frame: self._run_heavy(c, n, f, fr)
                )
            else:
                if telemetry.ENABLED:
                    t0 = time.perf_counter_ns()
                    reply = _run_method(name, fn, frame)
                    self._observe_rpc(name, t0, reply)
                    if self._selftrace.recording:
                        self._selftrace.record(
                            f"rpc:{name}", t0 // 1000,
                            (time.perf_counter_ns() - t0) // 1000,
                        )
                else:
                    reply = _run_method(name, fn, frame)
                if reply is None:
                    self._close_conn(conn)  # unframeable reply: drop conn
                    return
                self._send(conn, reply, flush=False)
        if not conn.closed:
            if conn.outq:
                self._flush_out(conn)  # one syscall for the whole batch
            else:
                self._update_events(conn)  # may resume a pending-full pause

    def _run_heavy(self, conn: _RPCConn, name: str, fn: Handler, frame: Frame) -> None:
        """Worker-side: execute, then post the completion back to the loop."""
        if san.ENABLED:
            san.assert_worker_thread(self)
        if telemetry.ENABLED:
            t0 = time.perf_counter_ns()
            reply = _run_method(name, fn, frame, kind="worker")
            self._observe_rpc(name, t0, reply)
            if self._selftrace.recording:
                self._selftrace.record(
                    f"rpc.heavy:{name}", t0 // 1000,
                    (time.perf_counter_ns() - t0) // 1000,
                )
        else:
            reply = _run_method(name, fn, frame, kind="worker")
        self._post(lambda: self._complete_heavy(conn, reply))

    def _complete_heavy(self, conn: _RPCConn, reply: Optional[bytes]) -> None:
        if san.ENABLED:
            san.assert_loop_thread(self)
        conn.busy = False
        self._m_heavy_inflight.dec()
        if conn.closed:
            return  # connection died while the handler ran
        if reply is None:
            self._close_conn(conn)
            return
        self._send(conn, reply)
        self._drain_pending(conn)
