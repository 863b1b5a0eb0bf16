"""repro_torch.net: socket RPC transport that moves PS and provenance shards out
of process (ROADMAP: cross-node PS / cross-process provenance shards).

Layers: :mod:`framing` (length-prefixed binary frames: raw ndarray bytes +
a compact JSON envelope), :mod:`server` (selectors-based event-loop socket
server over a registered method table), :mod:`client` (reconnecting,
request-id-multiplexed async client with per-call timeouts and typed
errors), :mod:`shards` (PS / provenance shard services and the remote
stubs the federations consume).  See ``docs/net.md`` for the wire format
and failure semantics.
"""
from .framing import (
    CallTimeout,
    ConnectionLost,
    FrameDecoder,
    FramingError,
    RemoteError,
    RPCError,
    TruncatedStream,
    encode_frame,
)
from .client import RPCClient
from .server import EventLoopConn, EventLoopServer, MethodTable, RPCServer
from .shards import (
    PSShardService,
    ProvenanceShardService,
    RemotePSShard,
    RemoteProvenanceShard,
    build_shard_table,
)

__all__ = [
    "CallTimeout",
    "ConnectionLost",
    "EventLoopConn",
    "EventLoopServer",
    "FrameDecoder",
    "FramingError",
    "MethodTable",
    "PSShardService",
    "ProvenanceShardService",
    "RPCClient",
    "RPCError",
    "RPCServer",
    "RemoteError",
    "RemotePSShard",
    "RemoteProvenanceShard",
    "TruncatedStream",
    "build_shard_table",
    "encode_frame",
]
