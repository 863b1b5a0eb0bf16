"""Length-prefixed binary framing for the shard RPC transport (`repro_torch.net`).

One frame is one request or one response:

    header   ``!4s H H I Q`` — magic ``b"RPN1"``, method id (u16), kind
             (u16: REQUEST / RESPONSE / ERROR), request id (u32, the
             client's multiplexing correlation token — responses are
             matched by id, so any number of logical calls share one
             connection), payload length (u64)
    payload  ``!I`` envelope length, a compact JSON envelope, then the raw
             bytes of each ndarray the envelope describes, concatenated in
             order.  A zero-length payload means "empty envelope, no arrays".

The envelope is ``{"env": {...}, "arrays": [{"dtype": "<f8", "shape": [...]},
...]}`` — numbers/strings/nested JSON ride in ``env``; bulk numeric data
(stats-table deltas, snapshots) rides as raw ndarray bytes so a PS push is
one ``json.dumps`` of a tiny dict plus a memcpy, never a float→text→float
round-trip (which would break the federation's bit-match guarantee).

Distributed-tracing context (``repro_torch.telemetry.spans``) rides as an
*optional* third top-level envelope key ``"tc": [trace_id, span_id,
flags]`` (three non-negative ints).  The extension is version-tolerant in
both directions: a decoder that predates it reads ``env``/``arrays`` via
``.get`` and counts only declared arrays, so the extra key is ignored; a
frame without the key decodes with ``tc=None``.  Frames encoded with
``tc=None`` are byte-identical to the pre-extension encoding.

:class:`FrameDecoder` is an incremental parser: feed it whatever ``recv``
returned — split reads, coalesced frames, or both — and it yields every
complete frame while buffering the remainder.  A stream that ends mid-frame
raises :class:`TruncatedStream` from ``close()`` so a dying peer is loud,
never a silent partial result.
"""
from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"RPN1"
HEADER = struct.Struct("!4sHHIQ")  # magic, method_id, kind, request_id, payload_len
ENVLEN = struct.Struct("!I")

# Frame kinds.
REQUEST, RESPONSE, ERROR = 0, 1, 2

# Hard cap on a single frame's payload: large enough for any stats table or
# provenance dump we ship, small enough that a corrupt length field can't
# make the decoder buffer gigabytes before noticing.
MAX_PAYLOAD = 1 << 30

# Reserved method id: returns the server's {name: id} method table, so
# clients resolve names at connect time instead of sharing constants.
METHOD_RESOLVE = 0


class RPCError(Exception):
    """Base class for every error the transport surfaces."""


class FramingError(RPCError):
    """The byte stream is not a valid frame sequence (bad magic/length)."""


class TruncatedStream(FramingError):
    """The peer closed the connection mid-frame."""


class ConnectionLost(RPCError):
    """The transport could not reach (or lost) the server."""


class CallTimeout(RPCError):
    """A call's response did not arrive within its per-call timeout."""


class RemoteError(RPCError):
    """The server-side handler raised; carries the remote type and message."""

    def __init__(self, method: str, remote_type: str, message: str):
        super().__init__(f"{method} failed remotely: {remote_type}: {message}")
        self.method = method
        self.remote_type = remote_type
        self.remote_message = message


@dataclasses.dataclass
class Frame:
    method_id: int
    kind: int
    request_id: int
    env: Dict[str, Any]
    arrays: Tuple[np.ndarray, ...]
    # Trace context: (trace_id, span_id, flags) or None (see module doc).
    tc: Optional[Tuple[int, int, int]] = None


def pack_payload(
    env: Dict[str, Any],
    arrays: Sequence[np.ndarray] = (),
    tc: Optional[Sequence[int]] = None,
) -> bytes:
    if not env and not arrays and tc is None:
        return b""
    specs = []
    blobs = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        specs.append({"dtype": a.dtype.str, "shape": list(a.shape)})
        blobs.append(a.tobytes())
    doc: Dict[str, Any] = {"env": env, "arrays": specs}
    if tc is not None:
        doc["tc"] = [int(x) for x in tc]
    envelope = json.dumps(doc, separators=(",", ":")).encode()
    return b"".join([ENVLEN.pack(len(envelope)), envelope] + blobs)


def unpack_payload(
    payload: bytes,
) -> Tuple[Dict[str, Any], Tuple[np.ndarray, ...], Optional[Tuple[int, int, int]]]:
    if not payload:
        return {}, (), None
    if len(payload) < ENVLEN.size:
        raise FramingError(f"payload too short for envelope length: {len(payload)}")
    (elen,) = ENVLEN.unpack_from(payload)
    off = ENVLEN.size
    if len(payload) < off + elen:
        raise FramingError("payload shorter than its declared envelope")
    try:
        envelope = json.loads(payload[off : off + elen])
    except ValueError as e:
        raise FramingError(f"bad envelope JSON: {e}") from e
    if not isinstance(envelope, dict) or not isinstance(envelope.get("env", {}), dict):
        raise FramingError("envelope is not an object")
    off += elen
    arrays: List[np.ndarray] = []
    for spec in envelope.get("arrays", ()):
        # A corrupt spec must surface as FramingError: anything else would
        # escape the stream-error handlers in the reader threads (client
        # reader dies silently -> wedged client, the opposite of "loud").
        try:
            dt = np.dtype(spec["dtype"])
            shape = tuple(int(d) for d in spec["shape"])
            if any(d < 0 for d in shape):
                raise ValueError(f"negative dim in shape {shape}")
            count = int(np.prod(shape, dtype=np.int64))
        except Exception as e:
            raise FramingError(f"bad array spec {spec!r}: {e}") from e
        nbytes = dt.itemsize * count
        if len(payload) < off + nbytes:
            raise FramingError("payload shorter than its declared arrays")
        arrays.append(
            np.frombuffer(payload, dtype=dt, count=count, offset=off).reshape(shape)
        )
        off += nbytes
    if off != len(payload):
        raise FramingError(f"{len(payload) - off} trailing bytes in payload")
    raw_tc = envelope.get("tc")
    tc: Optional[Tuple[int, int, int]] = None
    if raw_tc is not None:
        try:
            trace_id, span_id, flags = (int(x) for x in raw_tc)
        except (TypeError, ValueError) as e:
            raise FramingError(f"bad trace context {raw_tc!r}: {e}") from e
        tc = (trace_id, span_id, flags)
    return envelope.get("env", {}), tuple(arrays), tc


def encode_frame(
    method_id: int,
    kind: int,
    request_id: int,
    env: Dict[str, Any],
    arrays: Sequence[np.ndarray] = (),
    tc: Optional[Sequence[int]] = None,
) -> bytes:
    payload = pack_payload(env, arrays, tc)
    if len(payload) > MAX_PAYLOAD:
        raise FramingError(f"payload of {len(payload)} bytes exceeds MAX_PAYLOAD")
    return HEADER.pack(MAGIC, method_id, kind, request_id, len(payload)) + payload


class FrameDecoder:
    """Incremental frame parser over an arbitrary chunking of the stream."""

    def __init__(self, max_payload: int = MAX_PAYLOAD):
        self._buf = bytearray()
        self._max_payload = max_payload

    def feed(self, data: bytes) -> List[Frame]:
        """Absorb one chunk; return every frame it completed (maybe none)."""
        self._buf += data
        frames: List[Frame] = []
        while len(self._buf) >= HEADER.size:
            magic, method_id, kind, request_id, plen = HEADER.unpack_from(self._buf)
            if magic != MAGIC:
                raise FramingError(f"bad magic {bytes(magic)!r}")
            if plen > self._max_payload:
                raise FramingError(
                    f"declared payload of {plen} bytes exceeds cap {self._max_payload}"
                )
            if len(self._buf) < HEADER.size + plen:
                break
            payload = bytes(self._buf[HEADER.size : HEADER.size + plen])
            del self._buf[: HEADER.size + plen]
            env, arrays, tc = unpack_payload(payload)
            frames.append(Frame(method_id, kind, request_id, env, arrays, tc))
        return frames

    @property
    def pending_bytes(self) -> int:
        return len(self._buf)

    def close(self) -> None:
        """Call at EOF: a partially-buffered frame means the peer died mid-send."""
        if self._buf:
            raise TruncatedStream(
                f"stream ended with {len(self._buf)} bytes of an incomplete frame"
            )


def iter_frames(chunks: Iterable[bytes], max_payload: int = MAX_PAYLOAD):
    """Decode a finite chunk iterable; raises TruncatedStream on a short tail."""
    dec = FrameDecoder(max_payload)
    for chunk in chunks:
        yield from dec.feed(chunk)
    dec.close()
