"""Live viz gateway: HTTP + WebSocket on the repro_torch.net event loop.

The paper's visualization module (§IV) is an *online* server with two
client classes — data senders and human viewers.  :class:`VizGateway` is
the viewer-facing half, built on the same :class:`repro_torch.net.server`
machinery the RPC shards run on: one selectors IO thread, non-blocking
sockets, incremental per-connection protocol decoders, high/low-watermark
slow-reader backpressure, and worker-thread offload for heavy handlers.

Two protocols share each connection's lifecycle:

  * **HTTP GET** for the :class:`~repro_torch.viz.server.VizServer` view
    endpoints plus ``/trace`` — the monitor's reduced record stream as a
    Chrome trace, byte-identical to offline ``python -m repro_torch.export``
    output, streamed with chunked transfer so Perfetto's "Open trace with
    URL" can attach to a *running* job.  Responses carry an ``ETag`` keyed
    on the monitor's frame counter; ``If-None-Match`` answers 304 until a
    new frame arrives.
  * **WebSocket** (RFC 6455 server side) at ``/ws``: after the upgrade
    handshake the gateway pushes one JSON text message per ingested frame
    — ``{"type": "frame", "rank": R, "step": S, "n_anomalies": A,
    "severity": V}`` — to every connected viewer.  Each viewer has its own
    send queue under the loop's watermarks, so one stalled browser tab
    pauses only its own reads; a viewer hopelessly behind (queue past
    ``ws_kill_water``) is shed with close code 1013.

Protocol errors never reach the loop: malformed HTTP answers the right
4xx/5xx status and closes that connection; malformed WebSocket frames
answer the RFC close code (1002/1007/1009).  ``tests/test_viz_gateway.py``
drives both parsers byte-by-byte and adversarially.

``python -m repro_torch.viz.gateway <monitor_dir>`` serves a *finished* run from
its on-disk artifacts (``stream.jsonl`` + provenance family) through the
identical endpoints, for CI and post-hoc browsing.
"""
from __future__ import annotations

import json
import socket
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.lint import runtime as san
from repro_torch.net.server import EventLoopConn, EventLoopServer
from repro_torch.fault.health import get_health
from repro_torch.telemetry import registry as telemetry
from repro_torch.telemetry.exposition import CONTENT_TYPE as _METRICS_CONTENT_TYPE
from repro_torch.telemetry.exposition import render_exposition
from repro_torch.telemetry import spans
from repro_torch.telemetry.buildinfo import register_build_info
from repro_torch.telemetry.federate import federated_snapshot, federated_spans

from . import http as H
from . import ws as W

_DASH_STATS = frozenset(("average", "stddev", "maximum", "minimum", "total"))
_VIEW_AXES = frozenset(
    ("fid", "entry", "exit", "runtime", "label", "n_children", "n_msgs", "depth")
)


def _dumps(obj: Any) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode("utf-8")


def _int_param(req: H.HttpRequest, name: str, default: Optional[int] = None,
               required: bool = False) -> Optional[int]:
    raw = req.param(name)
    if raw is None:
        if required:
            raise H.HttpError(400, f"missing required parameter {name!r}")
        return default
    try:
        return int(raw)
    except ValueError:
        raise H.HttpError(400, f"parameter {name}={raw!r} is not an integer") from None


class _VizConn(EventLoopConn):
    """Gateway per-connection state: HTTP parser, then maybe a WS decoder."""

    __slots__ = ("parser", "requests", "busy", "mode", "ws", "ws_closing")

    def __init__(self, sock: socket.socket):
        super().__init__(sock)
        self.parser = H.HttpRequestParser()
        self.requests: Deque[H.HttpRequest] = deque()
        self.busy = False  # a heavy handler for this conn is on a worker
        self.mode = "http"  # -> "ws" after a successful upgrade
        self.ws: Optional[W.WSDecoder] = None
        self.ws_closing = False  # close sent/received: ignore further input


class _TraceStream:
    """Text sink bridging a worker-side ChromeTraceWriter to one connection.

    Buffers writer output and posts it to the loop as chunked-transfer
    chunks once ``chunk_size`` accumulates.  When the viewer's outbound
    queue is over the high watermark the *producer* blocks here (it runs on
    a worker thread, never the loop), so a slow trace consumer bounds
    server memory instead of ballooning it.  A dead connection aborts the
    export with ``ConnectionError``.
    """

    def __init__(self, gw: "VizGateway", conn: _VizConn, chunk_size: int = 64 << 10):
        self._gw = gw
        self._conn = conn
        self._chunk = int(chunk_size)
        self._buf = bytearray()
        self.sent = 0

    def write(self, s: str) -> int:
        self._buf += s.encode("utf-8")
        if len(self._buf) >= self._chunk:
            self._emit()
        return len(s)

    def flush(self) -> None:  # file-like contract (ChromeTraceWriter.close)
        pass

    def finish(self) -> None:
        if self._buf:
            self._emit()
        self._post_bytes(H.CHUNK_END)

    def _emit(self) -> None:
        data = H.chunk(bytes(self._buf))
        del self._buf[:]
        # Single-writer counter: only this stream's own worker thread ever
        # increments; cross-thread readers are monitoring-only.
        self.sent += len(data)  # lint: ignore[lockset-counter]
        self._post_bytes(data)

    def _post_bytes(self, data: bytes) -> None:
        conn, gw = self._conn, self._gw
        if conn.closed or gw._stopping.is_set():
            raise ConnectionError("viewer went away mid-trace")
        gw._post(lambda: gw._send(conn, data))
        # Producer-side backpressure: wait for the viewer to drain below the
        # high watermark before generating more trace.
        while conn.out_bytes > gw._high_water and not conn.closed:
            if gw._stopping.is_set():
                raise ConnectionError("gateway stopping mid-trace")
            time.sleep(0.002)


class VizGateway(EventLoopServer):
    """HTTP + WebSocket viz server for one monitor (live or replayed).

    ``monitor`` is anything with the :class:`ChimbukoMonitor` viz surface
    (``ps``/``provdb``/``kept``/``frame_meta``/``anom_meta``/``registry``/
    ``frames_ingested``) — the live monitor object or a
    :class:`ReplayMonitor` over a finished run's artifacts.
    """

    def __init__(
        self,
        monitor,
        host: str = "127.0.0.1",
        port: int = 0,
        workers: int = 2,
        high_water: int = 8 << 20,
        low_water: int = 1 << 20,
        ws_kill_water: Optional[int] = None,
        max_pipeline: int = 64,
    ):
        super().__init__(host=host, port=port, workers=workers,
                         high_water=high_water, low_water=low_water)
        from .server import VizServer  # local: viz.server imports trace.monitor

        self.monitor = monitor
        self.viz = VizServer(monitor)
        # Past this many queued outbound bytes a viewer is not slow, it is
        # gone (a wedged tab): shed it so broadcast memory stays bounded.
        self._ws_kill_water = (
            int(ws_kill_water) if ws_kill_water is not None else 4 * int(high_water)
        )
        self._max_pipeline = max(int(max_pipeline), 1)
        self._viewers: Set[_VizConn] = set()  # loop-thread-owned
        # Registry counters (internally locked, exposed at /metrics); the
        # public broadcasts/viewers_dropped names survive as properties.
        _reg = telemetry.get_registry()
        self._m_broadcasts = _reg.counter(
            "repro_ws_broadcasts_total",
            "WebSocket frame broadcasts fanned out to viewers.",
            ["server"],
        ).labels(server=self._telemetry_server)
        self._m_viewers_dropped = _reg.counter(
            "repro_ws_viewers_dropped_total",
            "Viewers shed past ws_kill_water (close 1013).",
            ["server"],
        ).labels(server=self._telemetry_server)
        self._m_viewers = _reg.gauge(
            "repro_ws_viewers",
            "Connected WebSocket viewers.",
            ["server"],
        ).labels(server=self._telemetry_server)

    @property
    def broadcasts(self) -> int:
        """Broadcasts fanned out (0 when REPRO_TELEMETRY=0)."""
        return self._m_broadcasts.value

    @property
    def viewers_dropped(self) -> int:
        """Viewers shed past ws_kill_water (0 when REPRO_TELEMETRY=0)."""
        return self._m_viewers_dropped.value

    # ------------------------------------------------------------ data senders
    def publish(self, payload: Dict[str, Any]) -> None:
        """Broadcast one JSON message to every WebSocket viewer.

        Called from any thread (the ingest path, a test driver): the
        message encodes to one wire frame here, and the fan-out is posted
        to the loop thread — the only place connection state may be
        touched.
        """
        frame = W.encode_frame(W.OP_TEXT, _dumps(payload))
        self._post(lambda: self._broadcast(frame))

    def publish_frame(self, rank: int, step: int, n_anomalies: int,
                      severity: int = 0) -> None:
        """Broadcast one ingested frame's delta (the per-frame schema).

        When telemetry is on, the payload carries a small ``metrics``
        summary so dashboards see gateway health without scraping
        ``/metrics``.  Composed once here, so every viewer of one
        broadcast receives the identical message.
        """
        payload: Dict[str, Any] = {
            "type": "frame", "rank": int(rank), "step": int(step),
            "n_anomalies": int(n_anomalies), "severity": int(severity),
            # Fleet health (repro_torch.fault): ok flag + degraded endpoints +
            # spooled write depth, so dashboards show an outage-in-progress
            # (and the recovery) live instead of on the next scrape.
            "health": get_health().snapshot(),
        }
        if telemetry.ENABLED:
            payload["metrics"] = self.metrics_summary()
        self.publish(payload)

    def metrics_summary(self) -> Dict[str, int]:
        """Gateway-health counters riding the /ws frame broadcast."""
        return {
            "frames": int(getattr(self.monitor, "frames_ingested", 0)),
            "viewers": len(self._viewers),
            "broadcasts": self.broadcasts,
            "backpressure_pauses": self.backpressure_pauses,
            "viewers_dropped": self.viewers_dropped,
        }

    def _broadcast(self, frame: bytes) -> None:
        if san.ENABLED:
            san.assert_loop_thread(self)
        self._m_broadcasts.inc()
        for conn in list(self._viewers):
            if conn.closed:
                self._viewers.discard(conn)
                continue
            if conn.ws_closing:
                continue
            if conn.out_bytes > self._ws_kill_water:
                self._m_viewers_dropped.inc()
                self._ws_fail(conn, W.CLOSE_TRY_AGAIN, "viewer too far behind")
                continue
            self._send(conn, frame)

    @property
    def n_viewers(self) -> int:
        return len(self._viewers)

    # --------------------------------------------------------- protocol hooks
    def _make_conn(self, sock: socket.socket) -> _VizConn:
        return _VizConn(sock)

    def _wants_read(self, conn: _VizConn) -> bool:
        if conn.ws_closing:
            return False  # farewell queued; the rest of the stream is noise
        return len(conn.requests) < self._max_pipeline

    def _on_conn_closed(self, conn: _VizConn) -> None:
        self._viewers.discard(conn)
        if telemetry.ENABLED:
            self._m_viewers.set(len(self._viewers))

    def _on_data(self, conn: _VizConn, data: bytes) -> None:
        if conn.mode == "ws":
            self._on_ws_data(conn, data)
            return
        try:
            conn.requests.extend(conn.parser.feed(data))
        except H.HttpError as e:
            self._http_fail(conn, e)
            return
        self._drain_requests(conn)

    # ----------------------------------------------------------- HTTP serving
    def _http_fail(self, conn: _VizConn, err: H.HttpError) -> None:
        """Answer the status, then drop the connection once it's flushed —
        after malformed input the stream state is unrecoverable."""
        conn.ws_closing = True  # stop reading (shared flag; see _wants_read)
        conn.close_when_flushed = True
        self._send(conn, H.error_response(err))

    def _drain_requests(self, conn: _VizConn) -> None:
        if san.ENABLED:
            san.assert_loop_thread(self)
        while (conn.requests and not conn.busy and not conn.closed
               and not conn.ws_closing and conn.mode == "http"):
            req = conn.requests.popleft()
            try:
                self._handle_request(conn, req)
            except H.HttpError as e:
                self._http_fail(conn, e)
                return
            except Exception as e:  # noqa: BLE001 - handler bug answers 500
                self._http_fail(conn, H.HttpError(500, f"{type(e).__name__}: {e}"))
                return
        if not conn.closed:
            if conn.outq:
                self._flush_out(conn)  # answer a pipelined batch in one syscall
            else:
                self._update_events(conn)

    def _etag(self) -> str:
        return '"%d"' % int(getattr(self.monitor, "frames_ingested", 0))

    def _handle_request(self, conn: _VizConn, req: H.HttpRequest) -> None:
        if req.wants_upgrade():
            self._upgrade(conn, req)
            return
        if req.method != "GET":
            raise H.HttpError(405, f"method {req.method} not allowed")
        path = req.path.rstrip("/") or "/"
        etag = self._etag()
        if req.header("if-none-match") == etag:
            self._finish_response(
                conn, req,
                H.build_response(304, headers=(("ETag", etag),),
                                 keep_alive=req.keep_alive),
            )
            return
        if path == "/trace":
            conn.busy = True
            self._offload(lambda: self._run_trace(conn, req, etag))
            return
        if path == "/provenance":
            q = {
                k: _int_param(req, k)
                for k in ("rank", "fid", "step", "t0", "t1",
                          "severity", "min_severity")
            }
            q["func"] = req.param("func")
            limit = _int_param(req, "limit", 100)
            conn.busy = True
            self._offload(lambda: self._run_heavy_json(
                conn, req, etag,
                lambda: self.viz.provenance_view(limit=limit, **q),
            ))
            return
        if path == "/metrics":
            # Prometheus exposition.  Federating the shard snapshots is
            # blocking RPC, so like /provenance it runs on a worker.
            conn.busy = True
            self._offload(lambda: self._run_metrics(conn, req, etag))
            return
        if path == "/spans":
            # Federated span flight recorders; ?dump=1 freezes every ring
            # first (the on-demand flight-recorder trigger).  Blocking RPC
            # like /metrics, so it runs on a worker.
            dump = bool(_int_param(req, "dump", 0))
            conn.busy = True
            self._offload(lambda: self._run_spans(conn, req, etag, dump))
            return
        if path == "/":
            # Pure loop-owned counters: the only view that stays inline.
            body = _dumps({
                "service": "repro_torch.viz.gateway",
                "endpoints": ["/dashboard", "/series", "/function",
                              "/callstack", "/provenance", "/trace",
                              "/metrics", "/spans", "/ws"],
                "frames": int(getattr(self.monitor, "frames_ingested", 0)),
                "viewers": len(self._viewers),
            })
            self._finish_response(
                conn, req,
                H.build_response(200, body, headers=(("ETag", etag),),
                                 keep_alive=req.keep_alive),
            )
            return
        # Views touch the stores behind VizServer — on a live federation
        # that means blocking RPC round-trips, which must never run on the
        # loop thread (repro_torch.lint: loop-blocking-sync/-socket).  Parameter
        # validation happens here (inline 400/404), the store work runs on
        # a worker via the thunk.
        view = self._view_thunk(path, req)
        conn.busy = True
        self._offload(lambda: self._run_heavy_json(conn, req, etag, view))

    def _view_thunk(self, path: str, req: H.HttpRequest):
        """Validate a view request inline; return the worker-side thunk.

        Raises HttpError(400/404) on the loop thread so protocol errors
        keep their status codes instead of surfacing as worker 500s.
        """
        if path == "/dashboard":
            stat = req.param("stat", "stddev")
            if stat not in _DASH_STATS:
                raise H.HttpError(400, f"unknown dashboard stat {stat!r}")
            top = _int_param(req, "top", 5)
            bottom = _int_param(req, "bottom", 5)
            return lambda: self.viz.rank_dashboard(stat=stat, top=top,
                                                   bottom=bottom)
        if path == "/series":
            rank = _int_param(req, "rank", required=True)
            return lambda: self.viz.frame_series(rank)
        if path == "/function":
            x = req.param("x", "entry")
            y = req.param("y", "fid")
            if x not in _VIEW_AXES or y not in _VIEW_AXES:
                raise H.HttpError(400, f"unknown axis x={x!r} y={y!r}")
            rank = _int_param(req, "rank", required=True)
            step = _int_param(req, "step", required=True)
            return lambda: self.viz.function_view(rank, step, x=x, y=y)
        if path == "/callstack":
            rank = _int_param(req, "rank", required=True)
            t0 = _int_param(req, "t0", required=True)
            t1 = _int_param(req, "t1", required=True)
            fid = _int_param(req, "fid")
            return lambda: self.viz.call_stack_view(rank, t0, t1, fid=fid)
        raise H.HttpError(404, f"no endpoint {path!r}")

    def _finish_response(self, conn: _VizConn, req: H.HttpRequest,
                         resp: bytes) -> None:
        if not req.keep_alive:
            conn.close_when_flushed = True
        self._send(conn, resp, flush=False)

    # Heavy endpoints: run on a worker, post the completion to the loop —
    # the connection's later pipelined requests wait (conn.busy), other
    # connections don't.
    def _run_heavy_json(self, conn: _VizConn, req: H.HttpRequest, etag: str,
                        fn) -> None:
        if san.ENABLED:
            san.assert_worker_thread(self)
        try:
            resp = H.build_response(200, _dumps(fn()), headers=(("ETag", etag),),
                                    keep_alive=req.keep_alive)
            fail = not req.keep_alive
        except Exception as e:  # noqa: BLE001 - worker bug answers 500
            resp = H.error_response(H.HttpError(500, f"{type(e).__name__}: {e}"))
            fail = True
        self._post(lambda: self._complete_heavy(conn, resp, fail))

    def _run_metrics(self, conn: _VizConn, req: H.HttpRequest, etag: str) -> None:
        """Worker-side ``/metrics``: local registry + federated shard
        snapshots rendered as Prometheus text exposition 0.0.4.

        A shard that fails to answer ``metrics.snapshot`` degrades to a
        ``repro_metrics_federation_errors`` gauge instead of a 500 — a
        scraper should still see the healthy processes.
        """
        if san.ENABLED:
            san.assert_worker_thread(self)
        try:
            register_build_info()  # idempotent: every scrape is attributable
            endpoints = list(getattr(self.monitor, "shard_endpoints", None) or ())
            merged, _errors = federated_snapshot(endpoints, local_proc="gateway")
            body = render_exposition(merged).encode("utf-8")
            resp = H.build_response(
                200, body, content_type=_METRICS_CONTENT_TYPE,
                headers=(("ETag", etag),), keep_alive=req.keep_alive,
            )
            fail = not req.keep_alive
        except Exception as e:  # noqa: BLE001 - worker bug answers 500
            resp = H.error_response(H.HttpError(500, f"{type(e).__name__}: {e}"))
            fail = True
        self._post(lambda: self._complete_heavy(conn, resp, fail))

    def _run_spans(self, conn: _VizConn, req: H.HttpRequest, etag: str,
                   dump: bool) -> None:
        """Worker-side ``/spans``: the fleet's span flight recorders, keyed
        by process label, plus their trigger logs and ring stats.

        Each shard scrape is bounded (single dial attempt + per-call
        deadline, see ``repro_torch.telemetry.federate``), so a stalled shard
        degrades to an ``errors`` entry instead of stalling the response.
        """
        if san.ENABLED:
            san.assert_worker_thread(self)
        try:
            endpoints = list(getattr(self.monitor, "shard_endpoints", None) or ())
            procs, errors = federated_spans(
                endpoints, local_proc="gateway", dump=dump,
                reason="http:/spans",
            )
            body = _dumps({
                "enabled": spans.is_enabled(),
                "errors": errors,
                "procs": procs,
            })
            resp = H.build_response(200, body, headers=(("ETag", etag),),
                                    keep_alive=req.keep_alive)
            fail = not req.keep_alive
        except Exception as e:  # noqa: BLE001 - worker bug answers 500
            resp = H.error_response(H.HttpError(500, f"{type(e).__name__}: {e}"))
            fail = True
        self._post(lambda: self._complete_heavy(conn, resp, fail))

    def _run_trace(self, conn: _VizConn, req: H.HttpRequest, etag: str) -> None:
        """Worker-side ``/trace``: stream the export through chunked
        transfer with producer-side backpressure (see _TraceStream)."""
        if san.ENABLED:
            san.assert_worker_thread(self)
        stream = _TraceStream(self, conn)
        started = False
        try:
            head = H.chunked_head(headers=(("ETag", etag),),
                                  keep_alive=req.keep_alive)
            self._post(lambda: self._send(conn, head))
            started = True
            self.viz.write_trace(stream)
            stream.finish()
            self._post(lambda: self._complete_heavy(conn, b"",
                                                    close=not req.keep_alive))
        except ConnectionError:
            pass  # viewer disconnected mid-export: nothing left to tell it
        except Exception as e:  # noqa: BLE001
            if started:
                # Chunked body already under way: the only honest signal is
                # an unterminated stream + close (no trailing 0-chunk).
                self._post(lambda: self._close_conn(conn))
            else:
                resp = H.error_response(H.HttpError(500, f"{type(e).__name__}: {e}"))
                self._post(lambda: self._complete_heavy(conn, resp, close=True))

    def _complete_heavy(self, conn: _VizConn, resp: bytes, close: bool) -> None:
        if san.ENABLED:
            san.assert_loop_thread(self)
        conn.busy = False
        if conn.closed:
            return
        if close:
            conn.ws_closing = True
            conn.close_when_flushed = True
        if resp:
            self._send(conn, resp)
        elif conn.close_when_flushed and not conn.outq:
            self._close_conn(conn)
            return
        self._drain_requests(conn)

    # ------------------------------------------------------------- WebSocket
    def _upgrade(self, conn: _VizConn, req: H.HttpRequest) -> None:
        if req.path.rstrip("/") != "/ws":
            raise H.HttpError(404, f"no WebSocket endpoint {req.path!r}")
        if req.method != "GET":
            raise H.HttpError(405, "WebSocket upgrade requires GET")
        key = req.header("sec-websocket-key")
        if not key:
            raise H.HttpError(400, "missing Sec-WebSocket-Key")
        if req.header("sec-websocket-version").strip() != "13":
            raise H.HttpError(426, "only WebSocket version 13 is supported")
        self._send(conn, H.build_response(101, headers=(
            ("Upgrade", "websocket"),
            ("Connection", "Upgrade"),
            ("Sec-WebSocket-Accept", W.accept_key(key)),
        )), flush=False)
        conn.mode = "ws"
        conn.ws = W.WSDecoder(require_mask=True)
        conn.requests.clear()  # bytes after the upgrade head are WS frames
        self._viewers.add(conn)
        if telemetry.ENABLED:
            self._m_viewers.set(len(self._viewers))
        hello = _dumps({
            "type": "hello",
            "frames": int(getattr(self.monitor, "frames_ingested", 0)),
            "viewers": len(self._viewers),
        })
        self._send(conn, W.encode_frame(W.OP_TEXT, hello))
        leftover = conn.parser.take_buffer()
        if leftover and not conn.closed:
            self._on_ws_data(conn, leftover)

    def _ws_fail(self, conn: _VizConn, code: int, reason: str) -> None:
        """Answer a close frame with the violation's code, then drop the
        connection once it reaches the kernel (RFC 6455 §7.1.7)."""
        conn.ws_closing = True
        conn.close_when_flushed = True
        self._send(conn, W.encode_close(code, reason[:100]))

    def _on_ws_data(self, conn: _VizConn, data: bytes) -> None:
        if conn.ws_closing:
            return
        try:
            msgs = conn.ws.feed(data)
        except W.WSProtocolError as e:
            self._ws_fail(conn, e.code, e.reason)
            return
        for msg in msgs:
            if msg.opcode == W.OP_PING:
                self._send(conn, W.encode_frame(W.OP_PONG, msg.data))
            elif msg.opcode == W.OP_CLOSE:
                code = msg.close_code
                self._ws_fail(conn, W.CLOSE_NORMAL if code is None else code, "")
                return
            # OP_PONG and client data messages are legal and ignored: the
            # broadcast stream has no client-configurable state (yet).


# ---------------------------------------------------------------- replay mode
class _ReplayFeed:
    """AnomalyFeed view surface recomputed from a persisted record stream."""

    def __init__(self) -> None:
        self._series: Dict[int, List[Tuple[int, int]]] = {}

    def add(self, rank: int, step: int, n_anomalies: int) -> None:
        self._series.setdefault(int(rank), []).append((int(step), int(n_anomalies)))

    def rank_dashboard(self) -> Dict[int, Dict[str, float]]:
        out = {}
        for rank, series in self._series.items():
            xs = np.asarray([n for _s, n in series], np.float64)
            if xs.size == 0:
                continue
            out[rank] = {
                "average": float(xs.mean()),
                "stddev": float(xs.std()),
                "maximum": float(xs.max()),
                "minimum": float(xs.min()),
                "total": float(xs.sum()),
            }
        return out

    def frame_series(self, rank: int) -> List[Tuple[int, int]]:
        return list(self._series.get(int(rank), []))


class _ReplayProvDB:
    """Read-only provenance query surface over a run's on-disk doc family."""

    def __init__(self, run_dir: str):
        from repro_torch.core.provenance import match_doc
        from repro_torch.export.provenance_export import (
            load_provenance_docs,
            provenance_path_family,
        )

        self._match = match_doc
        self._docs = load_provenance_docs(run_dir)
        self.num_shards = max(len(provenance_path_family(run_dir)), 1)

    def query(self, **kw: Any) -> List[Dict[str, Any]]:
        return [d for d in self._docs if self._match(d, **kw)]

    def __len__(self) -> int:
        return len(self._docs)


class ReplayMonitor:
    """The monitor viz surface rebuilt from a finished run's artifacts.

    Replays ``<run_dir>/stream.jsonl`` (+ the provenance JSONL family) into
    exactly the state :class:`~repro_torch.viz.server.VizServer` reads, so a
    gateway over a finished run serves the same endpoints as a live one —
    and its ``/trace`` is byte-identical to ``python -m repro_torch.export``.
    """

    def __init__(self, run_dir: str, stream_name: str = "stream.jsonl"):
        import os

        from repro_torch.core.events import FunctionRegistry
        from repro_torch.export.record_stream import iter_stream_frames

        self.run_dir = run_dir
        self.kept: Dict[Tuple[int, int], np.ndarray] = {}
        self.frame_meta: Dict[Tuple[int, int], Tuple[Optional[int], int, int]] = {}
        self.anom_meta: Dict[Tuple[int, int], List[Tuple[int, int, int]]] = {}
        self.ps = _ReplayFeed()
        self.frames_ingested = 0
        names: Dict[int, str] = {}
        stream = os.path.join(run_dir, stream_name)
        if os.path.exists(stream):
            for fr in iter_stream_frames(stream):
                key = (int(fr["rank"]), int(fr["step"]))
                self.kept[key] = fr["records"]
                self.frame_meta[key] = (fr["ts"], fr["n_records"],
                                        fr["n_anomalies"])
                self.anom_meta[key] = [tuple(a) for a in fr["anom"]]
                self.ps.add(fr["rank"], fr["step"], fr["n_anomalies"])
                names = fr["names"]  # grows across yields; keep the last
                self.frames_ingested += 1
        self.registry = FunctionRegistry()
        for fid in sorted(names):
            self.registry.names[fid] = names[fid]
            self.registry._ids[names[fid]] = fid
        self.provdb = _ReplayProvDB(run_dir)
        self.ads: Dict[int, None] = {r: None for r, _ in self.kept}

    def summary(self) -> dict:
        return {
            "frames": self.frames_ingested,
            "anomalies": sum(n for _t, _m, n in self.frame_meta.values()),
            "provenance_records": len(self.provdb),
            "replayed_from": self.run_dir,
        }


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.viz.gateway",
        description="Serve a finished monitor output dir over HTTP + WebSocket",
    )
    ap.add_argument("run_dir", help="monitor output dir (stream.jsonl + provenance)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    args = ap.parse_args(argv)
    monitor = ReplayMonitor(args.run_dir)
    gw = VizGateway(monitor, host=args.host, port=args.port)
    gw.start()
    host, port = gw.endpoint
    print(f"viz gateway: http://{host}:{port}/ ({monitor.frames_ingested} frames, "
          f"{len(monitor.provdb)} provenance docs)", flush=True)
    try:
        gw.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        gw.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
