"""Minimal HTTP/1.1 server-side protocol for the viz gateway.

Only the slice of HTTP the gateway speaks: GET/HEAD requests, keep-alive,
Content-Length bodies, chunked *responses*, and the WebSocket upgrade
head.  The parser is **incremental** — feed it whatever ``recv`` returned
(split reads, coalesced pipelined requests, or both) and it yields every
complete request while buffering the remainder — and **bounded**: request
heads over ``max_head`` bytes, more than ``max_headers`` header lines, or
bodies over ``max_body`` raise :class:`HttpError` with the right status
before the server buffers unbounded attacker-controlled bytes.

Malformed input is always a typed :class:`HttpError` (status + reason),
never an uncaught exception: the gateway turns it into an error response
and drops the connection, keeping the event loop alive — the same
"corrupt stream closes the connection, not the server" discipline as
``repro_torch.net.framing``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlsplit

CRLF = b"\r\n"
HEAD_END = b"\r\n\r\n"

REASONS = {
    101: "Switching Protocols",
    200: "OK",
    304: "Not Modified",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    408: "Request Timeout",
    413: "Payload Too Large",
    426: "Upgrade Required",
    431: "Request Header Fields Too Large",
    500: "Internal Server Error",
    501: "Not Implemented",
    503: "Service Unavailable",
}

_TOKEN = frozenset(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"
    "!#$%&'*+-.^_`|~"
)


class HttpError(Exception):
    """Malformed/oversized/unsupported request → (status, reason)."""

    def __init__(self, status: int, detail: str = ""):
        self.status = int(status)
        self.detail = detail or REASONS.get(status, "Bad Request")
        super().__init__(f"{self.status} {self.detail}")


@dataclasses.dataclass
class HttpRequest:
    method: str
    target: str  # raw request target, e.g. "/series?rank=3"
    path: str  # decoded path component
    query: Dict[str, List[str]]  # parsed query string (repeats preserved)
    version: str  # "HTTP/1.0" | "HTTP/1.1"
    headers: Dict[str, str]  # lower-cased names; duplicates comma-joined
    body: bytes
    keep_alive: bool

    def header(self, name: str, default: str = "") -> str:
        return self.headers.get(name.lower(), default)

    def param(self, name: str, default: Optional[str] = None) -> Optional[str]:
        vals = self.query.get(name)
        return vals[0] if vals else default

    def wants_upgrade(self, protocol: str = "websocket") -> bool:
        conn_tokens = [t.strip().lower() for t in self.header("connection").split(",")]
        return (
            "upgrade" in conn_tokens
            and self.header("upgrade").strip().lower() == protocol
        )


class HttpRequestParser:
    """Incremental request parser over an arbitrary chunking of the stream.

    ``feed(data)`` returns every request the chunk completed (maybe none).
    After a request carrying ``Connection: upgrade`` the parser pauses —
    later bytes belong to the upgraded protocol, not HTTP — and the gateway
    collects them with :meth:`take_buffer` to seed the WebSocket decoder.
    """

    def __init__(
        self,
        max_head: int = 32 << 10,
        max_headers: int = 100,
        max_body: int = 1 << 20,
    ):
        self._buf = bytearray()
        self._max_head = int(max_head)
        self._max_headers = int(max_headers)
        self._max_body = int(max_body)
        self._pending: Optional[Tuple[HttpRequest, int]] = None  # (req, body len)
        self._paused = False

    @property
    def paused(self) -> bool:
        return self._paused

    def take_buffer(self) -> bytes:
        """Drain the unparsed remainder (the upgraded protocol's bytes)."""
        out = bytes(self._buf)
        del self._buf[:]
        return out

    def feed(self, data: bytes) -> List[HttpRequest]:
        self._buf += data
        out: List[HttpRequest] = []
        while not self._paused:
            if self._pending is not None:
                req, clen = self._pending
                if len(self._buf) < clen:
                    break
                req.body = bytes(self._buf[:clen])
                del self._buf[:clen]
                self._pending = None
                out.append(req)
                if req.wants_upgrade():
                    self._paused = True
                continue
            end = self._buf.find(HEAD_END)
            if end < 0:
                if len(self._buf) > self._max_head:
                    raise HttpError(431, "request head exceeds limit")
                break
            head = bytes(self._buf[:end])
            del self._buf[: end + len(HEAD_END)]
            if len(head) > self._max_head:
                raise HttpError(431, "request head exceeds limit")
            req = self._parse_head(head)
            clen = self._content_length(req)
            if clen:
                self._pending = (req, clen)
                continue
            out.append(req)
            if req.wants_upgrade():
                self._paused = True
        return out

    # ---------------------------------------------------------------- parsing
    def _parse_head(self, head: bytes) -> HttpRequest:
        try:
            text = head.decode("latin-1")
        except ValueError as e:  # pragma: no cover - latin-1 decodes anything
            raise HttpError(400, f"undecodable head: {e}") from e
        lines = text.split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3:
            raise HttpError(400, f"malformed request line {lines[0]!r}")
        method, target, version = parts
        if not method or not all(c in _TOKEN for c in method):
            raise HttpError(400, f"malformed method {method!r}")
        if version not in ("HTTP/1.0", "HTTP/1.1"):
            raise HttpError(400, f"unsupported version {version!r}")
        if not target.startswith("/"):
            raise HttpError(400, f"unsupported request target {target!r}")
        if len(lines) - 1 > self._max_headers:
            raise HttpError(431, "too many header lines")
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            if line[0] in " \t":
                raise HttpError(400, "obsolete header line folding")
            name, sep, value = line.partition(":")
            if not sep or not name or not all(c in _TOKEN for c in name):
                raise HttpError(400, f"malformed header line {line!r}")
            key = name.lower()
            value = value.strip()
            headers[key] = f"{headers[key]},{value}" if key in headers else value
        try:
            split = urlsplit(target)
            path = unquote(split.path)
            query = parse_qs(split.query, keep_blank_values=True)
        except ValueError as e:
            raise HttpError(400, f"malformed request target: {e}") from e
        conn_tokens = [
            t.strip() for t in headers.get("connection", "").lower().split(",")
        ]
        keep_alive = (
            "close" not in conn_tokens
            if version == "HTTP/1.1"
            else "keep-alive" in conn_tokens
        )
        return HttpRequest(
            method=method, target=target, path=path, query=query,
            version=version, headers=headers, body=b"", keep_alive=keep_alive,
        )

    def _content_length(self, req: HttpRequest) -> int:
        if "transfer-encoding" in req.headers:
            raise HttpError(501, "chunked request bodies not supported")
        raw = req.headers.get("content-length")
        if raw is None:
            return 0
        try:
            clen = int(raw)
            if clen < 0:
                raise ValueError(raw)
        except ValueError:
            raise HttpError(400, f"malformed Content-Length {raw!r}") from None
        if clen > self._max_body:
            raise HttpError(413, "request body exceeds limit")
        return clen


# ------------------------------------------------------------------ responses
_BASE_HEADERS = (
    # Perfetto's "Open trace with URL" fetches cross-origin from
    # ui.perfetto.dev, so every response must carry CORS allowance.
    ("Access-Control-Allow-Origin", "*"),
    ("Server", "repro-viz"),
)

_NO_BODY = frozenset((101, 304))


def build_response(
    status: int,
    body: bytes = b"",
    content_type: str = "application/json",
    headers: Tuple[Tuple[str, str], ...] = (),
    keep_alive: bool = True,
) -> bytes:
    """One full HTTP/1.1 response as bytes (Content-Length framed)."""
    reason = REASONS.get(status, "Unknown")
    lines = [f"HTTP/1.1 {status} {reason}"]
    for k, v in _BASE_HEADERS:
        lines.append(f"{k}: {v}")
    for k, v in headers:
        lines.append(f"{k}: {v}")
    if status not in _NO_BODY:
        lines.append(f"Content-Type: {content_type}")
        lines.append(f"Content-Length: {len(body)}")
    lines.append("Connection: " + ("keep-alive" if keep_alive else "close"))
    head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
    return head if status in _NO_BODY else head + body


def error_response(err: HttpError) -> bytes:
    """Error responses always close: the stream state is suspect."""
    body = (err.detail + "\n").encode()
    return build_response(
        err.status, body, content_type="text/plain", keep_alive=False
    )


def chunked_head(
    status: int = 200,
    content_type: str = "application/json",
    headers: Tuple[Tuple[str, str], ...] = (),
    keep_alive: bool = True,
) -> bytes:
    """Response head announcing a chunked body (the streaming /trace path)."""
    lines = [f"HTTP/1.1 {status} {REASONS.get(status, 'Unknown')}"]
    for k, v in _BASE_HEADERS:
        lines.append(f"{k}: {v}")
    for k, v in headers:
        lines.append(f"{k}: {v}")
    lines.append(f"Content-Type: {content_type}")
    lines.append("Transfer-Encoding: chunked")
    lines.append("Connection: " + ("keep-alive" if keep_alive else "close"))
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


def chunk(data: bytes) -> bytes:
    """One chunked-transfer chunk (never call with b"" — that terminates)."""
    return b"%x\r\n%s\r\n" % (len(data), data)


CHUNK_END = b"0\r\n\r\n"
