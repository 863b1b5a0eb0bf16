"""RFC 6455 WebSocket server-side protocol: handshake + frame codec.

The gateway's broadcast channel.  :class:`WSDecoder` is an incremental
parser with the same contract as ``repro_torch.net.framing.FrameDecoder``: feed
it whatever ``recv`` returned — split reads, coalesced frames, fragmented
messages — and it yields every complete message while buffering the rest.
Every protocol violation RFC 6455 names is a typed
:class:`WSProtocolError` carrying the close code the server must answer
with before dropping the connection:

  * nonzero RSV bits (no extension negotiated) ........ 1002
  * unknown opcode .................................... 1002
  * unmasked client frame (server side) ............... 1002
  * masked server frame (client side) ................. 1002
  * fragmented or >125-byte control frame ............. 1002
  * CONT without an open message / new data mid-message 1002
  * close frame with a 1-byte or reserved-code payload . 1002
  * invalid UTF-8 in a text message or close reason .... 1007
  * message over ``max_message`` bytes ................. 1009

The oversize check fires off the declared length *before* payload bytes
are buffered, so a hostile 2⁶³-byte header cannot balloon server memory —
mirroring ``FrameDecoder``'s MAX_PAYLOAD discipline.
"""
from __future__ import annotations

import base64
import dataclasses
import hashlib
import struct
from typing import List, Optional, Tuple

import numpy as np

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# Opcodes (RFC 6455 §5.2).
OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA
_KNOWN_OPS = frozenset((OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG))

# Close codes (RFC 6455 §7.4.1).
CLOSE_NORMAL = 1000
CLOSE_GOING_AWAY = 1001
CLOSE_PROTOCOL_ERROR = 1002
CLOSE_UNSUPPORTED = 1003
CLOSE_INVALID_DATA = 1007
CLOSE_POLICY = 1008
CLOSE_TOO_BIG = 1009
CLOSE_TRY_AGAIN = 1013
# Codes that must never appear on the wire inside a close frame.
_RESERVED_CLOSE = frozenset((1004, 1005, 1006, 1015))

MAX_MESSAGE = 1 << 20


def accept_key(key: str) -> str:
    """Sec-WebSocket-Accept for a client's Sec-WebSocket-Key (§4.2.2)."""
    digest = hashlib.sha1((key.strip() + GUID).encode("latin-1")).digest()
    return base64.b64encode(digest).decode("ascii")


class WSProtocolError(Exception):
    """A framing/protocol violation; ``code`` is the close code to send."""

    def __init__(self, code: int, reason: str):
        self.code = int(code)
        self.reason = reason
        super().__init__(f"ws protocol error {code}: {reason}")


@dataclasses.dataclass
class WSMessage:
    """One complete message (data frames reassembled) or control frame."""

    opcode: int
    data: bytes

    @property
    def close_code(self) -> Optional[int]:
        if self.opcode != OP_CLOSE or len(self.data) < 2:
            return None
        return struct.unpack("!H", self.data[:2])[0]


def mask_bytes(data: bytes, mask: bytes) -> bytes:
    """XOR-mask/unmask a payload (vectorized; masking is its own inverse)."""
    if not data:
        return b""
    arr = np.frombuffer(data, dtype=np.uint8)
    key = np.frombuffer((mask * (len(arr) // 4 + 1))[: len(arr)], dtype=np.uint8)
    return np.bitwise_xor(arr, key).tobytes()


def encode_frame(
    opcode: int,
    payload: bytes = b"",
    fin: bool = True,
    mask: Optional[bytes] = None,
    rsv: int = 0,
) -> bytes:
    """One wire frame.  Servers send unmasked (``mask=None``); test clients
    pass a 4-byte mask.  ``rsv`` exists so the fuzz suite can build the
    illegal frames the decoder must reject."""
    b0 = (0x80 if fin else 0) | ((rsv & 0x7) << 4) | (opcode & 0xF)
    mask_bit = 0x80 if mask is not None else 0
    n = len(payload)
    if n < 126:
        head = struct.pack("!BB", b0, mask_bit | n)
    elif n < (1 << 16):
        head = struct.pack("!BBH", b0, mask_bit | 126, n)
    else:
        head = struct.pack("!BBQ", b0, mask_bit | 127, n)
    if mask is not None:
        if len(mask) != 4:
            raise ValueError("mask must be exactly 4 bytes")
        return head + mask + mask_bytes(payload, mask)
    return head + payload


def encode_close(code: int = CLOSE_NORMAL, reason: str = "",
                 mask: Optional[bytes] = None) -> bytes:
    return encode_frame(
        OP_CLOSE, struct.pack("!H", code) + reason.encode("utf-8"), mask=mask
    )


def _validate_close_payload(payload: bytes) -> None:
    if len(payload) == 1:
        raise WSProtocolError(CLOSE_PROTOCOL_ERROR, "1-byte close payload")
    if len(payload) >= 2:
        (code,) = struct.unpack("!H", payload[:2])
        if code < 1000 or code in _RESERVED_CLOSE or 1016 <= code <= 2999:
            raise WSProtocolError(
                CLOSE_PROTOCOL_ERROR, f"reserved close code {code}"
            )
        try:
            payload[2:].decode("utf-8")
        except UnicodeDecodeError as e:
            raise WSProtocolError(
                CLOSE_INVALID_DATA, f"close reason not UTF-8: {e}"
            ) from e


class WSDecoder:
    """Incremental frame parser + message reassembler.

    ``require_mask=True`` is the server side (client frames MUST be masked,
    §5.1); ``require_mask=False`` is the client side, where a *masked*
    frame is the violation.
    """

    def __init__(self, require_mask: bool = True, max_message: int = MAX_MESSAGE):
        self._buf = bytearray()
        self._require_mask = require_mask
        self._max_message = int(max_message)
        self._frag_op: Optional[int] = None
        self._frag: bytearray = bytearray()

    @property
    def pending_bytes(self) -> int:
        return len(self._buf)

    def feed(self, data: bytes) -> List[WSMessage]:
        """Absorb one chunk; return every message/control it completed."""
        self._buf += data
        out: List[WSMessage] = []
        while True:
            parsed = self._parse_one()
            if parsed is None:
                return out
            fin, opcode, payload = parsed
            msg = self._assemble(fin, opcode, payload)
            if msg is not None:
                out.append(msg)

    # ------------------------------------------------------------ internals
    def _parse_one(self) -> Optional[Tuple[bool, int, bytes]]:
        buf = self._buf
        if len(buf) < 2:
            return None
        b0, b1 = buf[0], buf[1]
        fin = bool(b0 & 0x80)
        if b0 & 0x70:
            raise WSProtocolError(
                CLOSE_PROTOCOL_ERROR, f"nonzero RSV bits 0x{(b0 & 0x70) >> 4:x}"
            )
        opcode = b0 & 0x0F
        if opcode not in _KNOWN_OPS:
            raise WSProtocolError(CLOSE_PROTOCOL_ERROR, f"unknown opcode {opcode}")
        masked = bool(b1 & 0x80)
        if self._require_mask and not masked:
            raise WSProtocolError(CLOSE_PROTOCOL_ERROR, "unmasked client frame")
        if not self._require_mask and masked:
            raise WSProtocolError(CLOSE_PROTOCOL_ERROR, "masked server frame")
        n = b1 & 0x7F
        off = 2
        if n == 126:
            if len(buf) < off + 2:
                return None
            (n,) = struct.unpack_from("!H", buf, off)
            off += 2
        elif n == 127:
            if len(buf) < off + 8:
                return None
            (n,) = struct.unpack_from("!Q", buf, off)
            off += 8
            if n & (1 << 63):
                raise WSProtocolError(CLOSE_PROTOCOL_ERROR, "length MSB set")
        if opcode >= OP_CLOSE:  # control frame constraints (§5.5)
            if not fin:
                raise WSProtocolError(CLOSE_PROTOCOL_ERROR,
                                      "fragmented control frame")
            if n > 125:
                raise WSProtocolError(CLOSE_PROTOCOL_ERROR,
                                      f"{n}-byte control frame")
        # Declared-size check BEFORE buffering the payload.
        if n + len(self._frag) > self._max_message:
            raise WSProtocolError(
                CLOSE_TOO_BIG, f"message over {self._max_message} bytes"
            )
        mask = b""
        if masked:
            if len(buf) < off + 4:
                return None
            mask = bytes(buf[off : off + 4])
            off += 4
        if len(buf) < off + n:
            return None
        payload = bytes(buf[off : off + n])
        del buf[: off + n]
        if masked:
            payload = mask_bytes(payload, mask)
        return fin, opcode, payload

    def _assemble(self, fin: bool, opcode: int, payload: bytes) -> Optional[WSMessage]:
        if opcode >= OP_CLOSE:
            if opcode == OP_CLOSE:
                _validate_close_payload(payload)
            return WSMessage(opcode, payload)
        if opcode == OP_CONT:
            if self._frag_op is None:
                raise WSProtocolError(CLOSE_PROTOCOL_ERROR,
                                      "continuation without a message")
            self._frag += payload
            if not fin:
                return None
            opcode, data = self._frag_op, bytes(self._frag)
            self._frag_op, self._frag = None, bytearray()
        else:
            if self._frag_op is not None:
                raise WSProtocolError(CLOSE_PROTOCOL_ERROR,
                                      "data frame inside a fragmented message")
            if not fin:
                self._frag_op = opcode
                self._frag = bytearray(payload)
                return None
            data = payload
        if opcode == OP_TEXT:
            try:
                data.decode("utf-8")
            except UnicodeDecodeError as e:
                raise WSProtocolError(
                    CLOSE_INVALID_DATA, f"text message not UTF-8: {e}"
                ) from e
        return WSMessage(opcode, data)
